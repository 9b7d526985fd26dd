"""xDeepFM — linear ⊕ CIN ⊕ DNN (arXiv:1803.05170; SURVEY.md §2b model 6;
BASELINE.json:11: CIN(128,128) + DNN, the flagship config).

Field matrix ``X⁰ ∈ R^{m×D}``; CIN layer k:
``Xᵏ_{h,d} = Σ_{i,j} Wᵏ_{h,i,j} (Xᵏ⁻¹_{i,d} · X⁰_{j,d})`` with per-layer sum
pooling ``pᵏ_h = Σ_d Xᵏ_{h,d}``; logit = linear + w_cinᵀ concat(p¹..p^K) +
DNN + bias. The CIN contraction is the model's hot op; the reference einsum
in ``ops.interactions.cin_layer`` contracts without building the
[B, H, m, D] Hadamard tensor explicitly (SURVEY.md §7 hard part 5).
"""

from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, flatten_slots, wide_schema
from recmodels.nn.mlp import mlp_apply, mlp_init
from recmodels.ops.interactions import (
    cin_stack_dm_flat,
    cin_stack_flat,
    flatten_cin_w,
    split_fused_rows,
)


class XDeepFMModel(CTRModel):
    name = "xdeepfm"

    def __init__(
        self,
        schema: Schema,
        cin_sizes: Sequence[int] = (128, 128),
        hidden: Sequence[int] = (400, 400),
        compute_dtype=jnp.float32,
    ):
        super().__init__(schema)
        self.cin_sizes = tuple(cin_sizes)
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, rng: jax.Array):
        m = self.schema.n_slots
        keys = jax.random.split(rng, len(self.cin_sizes) + 3)
        # CIN weights are stored flat [H_prev, m*H_next]
        # (ops.interactions.flatten_cin_w). The same 3-D normal is drawn
        # then flattened, so the seeded init stream matches a 3-D layout.
        cin_w = []
        h_prev = m
        for i, h_next in enumerate(self.cin_sizes):
            cin_w.append(
                flatten_cin_w(
                    jax.random.normal(keys[i], (h_next, h_prev, m), jnp.float32)
                    * jnp.sqrt(2.0 / (h_prev * m))
                )
            )
            h_prev = h_next
        p_dim = sum(self.cin_sizes)
        in_dim = m * self.schema.max_dim + self.schema.n_dense
        return {
            "cin_w": cin_w,
            "w_cin": jax.random.normal(keys[-3], (p_dim,), jnp.float32) / jnp.sqrt(p_dim),
            "mlp": mlp_init(keys[-2], in_dim, self.hidden, out_dim=1),
            "w_dense": jnp.zeros((self.schema.n_dense,), jnp.float32),
            "bias": jnp.zeros((), jnp.float32),
        }

    def _cin_ws(self, params, dtype):
        return [w.astype(dtype) for w in params["cin_w"]]

    def apply_fused_rows(self, params, dense: jnp.ndarray, full: jnp.ndarray) -> jnp.ndarray:
        """Forward from wide-fused rows [B, m, D+1] (engine fast path).

        ``split_fused_rows`` yields the D-major field matrix for CIN plus
        the summed first-order column; the MLP consumes
        the D-major view flattened — a fixed feature permutation relative
        to ``apply``, which is distribution-identical under the iid MLP
        init (weights just learn the permuted pairing)."""
        b, m, _ = full.shape
        x_dm, wide_sum = split_fused_rows(
            full.astype(self.compute_dtype), self.schema.max_dim
        )
        p = cin_stack_dm_flat(
            x_dm, self._cin_ws(params, self.compute_dtype)
        ).astype(jnp.float32)
        y_lin = wide_sum + dense @ params["w_dense"]
        h = jnp.concatenate(
            [x_dm.reshape(b, -1), dense.astype(x_dm.dtype)], axis=1
        )
        y_dnn = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + y_lin + p @ params["w_cin"] + y_dnn

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        x0 = emb["emb"]  # [B, m, D]
        if self.compute_dtype != jnp.float32:
            # CIN in bf16 with f32 accumulation (preferred_element_type
            # inside the einsum)
            p = cin_stack_flat(
                x0.astype(self.compute_dtype),
                self._cin_ws(params, self.compute_dtype),
            ).astype(jnp.float32)
        else:
            p = cin_stack_flat(x0, self._cin_ws(params, jnp.float32))  # [B, sum(H_k)]
        y_lin = jnp.sum(emb["wide"][..., 0], axis=1) + dense @ params["w_dense"]
        # concat in the embedding activations' dtype — mixing bf16 rows with
        # f32 dense would promote (and materialize) the whole MLP input f32
        h = jnp.concatenate([flatten_slots(x0), dense.astype(x0.dtype)], axis=1)
        y_dnn = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + y_lin + p @ params["w_cin"] + y_dnn
