"""FM — second-order factorization machine (Rendle 2010; SURVEY.md §2b
model 2; BASELINE.json:8).

``logit = b + Σ_i w[c_i] + w_d·x + ½ Σ_d [(Σ_i e_i)_d² − Σ_i (e_i)_d²]``
The pairwise term is ``ops.interactions.fm_pairwise``.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, wide_schema
from recmodels.ops.interactions import fm_pairwise


class FMModel(CTRModel):
    name = "fm"

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, rng: jax.Array):
        return {
            "w_dense": jnp.zeros((self.schema.n_dense,), jnp.float32),
            "bias": jnp.zeros((), jnp.float32),
        }

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        first = jnp.sum(emb["wide"][..., 0], axis=1)
        second = fm_pairwise(emb["emb"])
        return params["bias"] + first + dense @ params["w_dense"] + second
