"""Wide & Deep (arXiv:1606.07792) — wide linear (first-order hashed weights
+ dense) ⊕ deep MLP over embeddings. A natural member of the reference-era
CTR zoo; trivially expressible in this engine (wide = the dim-1 collection,
deep = the shared engine MLP)."""

from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, flatten_slots, wide_schema
from recmodels.nn.mlp import mlp_apply, mlp_init


class WideDeepModel(CTRModel):
    name = "widedeep"

    def __init__(self, schema: Schema, hidden: Sequence[int] = (256, 128), compute_dtype=jnp.float32):
        super().__init__(schema)
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, rng: jax.Array):
        in_dim = self.schema.n_slots * self.schema.max_dim + self.schema.n_dense
        return {
            "mlp": mlp_init(rng, in_dim, self.hidden, out_dim=1),
            "w_dense": jnp.zeros((self.schema.n_dense,), jnp.float32),
            "bias": jnp.zeros((), jnp.float32),
        }

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        y_wide = jnp.sum(emb["wide"][..., 0], axis=1) + dense @ params["w_dense"]
        e = emb["emb"]
        h = jnp.concatenate([flatten_slots(e), dense.astype(e.dtype)], axis=1)
        y_deep = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + y_wide + y_deep
