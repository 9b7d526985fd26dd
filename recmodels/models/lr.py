"""LR — sparse logistic regression (SURVEY.md §2b model 1; BASELINE.json:7).

``logit = b + Σ_i w[c_i] + w_d · x_dense`` — one scalar weight per hash
bucket (the ``wide`` dim-1 embedding collection) plus a dense linear term.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, wide_schema


class LRModel(CTRModel):
    name = "lr"

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema)}

    def init_dense(self, rng: jax.Array):
        return {
            "w_dense": jnp.zeros((self.schema.n_dense,), jnp.float32),
            "bias": jnp.zeros((), jnp.float32),
        }

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        wide = emb["wide"][..., 0]  # [B, n_slots]
        return params["bias"] + jnp.sum(wide, axis=1) + dense @ params["w_dense"]
