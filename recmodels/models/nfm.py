"""NFM — Neural Factorization Machine (arXiv:1708.05027).

``ŷ = σ(b + Σ w[c_i] + w_d·x + MLP(bi_interaction(e)))`` where
bi-interaction pooling is the per-dim FM pairwise vector
(ops.fm_bi_interaction) — FM generalized with a nonlinear tower over the
interaction vector instead of a plain sum."""

from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, wide_schema
from recmodels.nn.mlp import mlp_apply, mlp_init
from recmodels.ops.interactions import fm_bi_interaction


class NFMModel(CTRModel):
    name = "nfm"

    def __init__(self, schema: Schema, hidden: Sequence[int] = (128, 128), compute_dtype=jnp.float32):
        super().__init__(schema)
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, rng: jax.Array):
        return {
            "mlp": mlp_init(rng, self.schema.max_dim, self.hidden, out_dim=1),
            "w_dense": jnp.zeros((self.schema.n_dense,), jnp.float32),
            "bias": jnp.zeros((), jnp.float32),
        }

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        bi = fm_bi_interaction(emb["emb"])  # [B, D]
        y_mlp = mlp_apply(params["mlp"], bi, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        first = jnp.sum(emb["wide"][..., 0], axis=1)
        return params["bias"] + first + dense @ params["w_dense"] + y_mlp
