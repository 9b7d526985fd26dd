"""PNN — product-based neural network (arXiv:1611.00144; SURVEY.md §2b
model 4; BASELINE.json:9: inner AND outer variants, per-slot embedding dims).

embedding -> product layer -> MLP -> logit. The paper's first hidden layer
``l1 = relu(W_z·z + W_p·p + b)`` is expressed here as one MLP whose input is
``concat(z, p)`` — mathematically identical (W_z, W_p are the corresponding
column blocks of the first weight matrix).

Product signals:
  * inner (IPNN): p_ij = <e_i, e_j> for i<j -> F(F-1)/2 scalars.
  * outer (OPNN): superposition trick p = f_Σ f_Σᵀ, f_Σ = Σ_i e_i -> D².
Per-slot dims are handled upstream by zero-padding to max_dim, which makes
every inner product the dot over the shared low dims (the documented
alignment choice for SURVEY.md §7 hard part 4).
"""

from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, flatten_slots
from recmodels.nn.mlp import mlp_apply, mlp_init
from recmodels.ops.interactions import pnn_inner_products, pnn_outer_product


class PNNModel(CTRModel):
    name = "pnn"

    def __init__(
        self,
        schema: Schema,
        mode: str = "inner",  # "inner" | "outer" | "both"
        hidden: Sequence[int] = (400, 400),
        compute_dtype=jnp.float32,
    ):
        super().__init__(schema)
        if mode not in ("inner", "outer", "both"):
            raise ValueError(f"bad PNN mode: {mode}")
        self.mode = mode
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"emb": self.schema}

    def _product_width(self) -> int:
        f, d = self.schema.n_slots, self.schema.max_dim
        w = 0
        if self.mode in ("inner", "both"):
            w += f * (f - 1) // 2
        if self.mode in ("outer", "both"):
            w += d * d
        return w

    def init_dense(self, rng: jax.Array):
        in_dim = (
            self.schema.n_slots * self.schema.max_dim
            + self.schema.n_dense
            + self._product_width()
        )
        return {"mlp": mlp_init(rng, in_dim, self.hidden, out_dim=1)}

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        e = emb["emb"]
        feats = [flatten_slots(e), dense.astype(e.dtype)]
        if self.mode in ("inner", "both"):
            feats.append(pnn_inner_products(e))
        if self.mode in ("outer", "both"):
            b = e.shape[0]
            feats.append(pnn_outer_product(e).reshape(b, -1))
        h = jnp.concatenate(feats, axis=1)
        return mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
