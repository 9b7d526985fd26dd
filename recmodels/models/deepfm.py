"""DeepFM (arXiv:1703.04247; SURVEY.md §2b model 3; BASELINE.json:8).

``ŷ = σ(y_FM + y_DNN)`` with **shared** embedding tables between the FM part
and the DNN part — the paper's defining property. Sharing falls out of the
engine design for free: both parts read the same ``emb`` activation tensor,
so there is exactly one ``emb`` collection, one lookup, one sparse update.
"""

from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, flatten_slots, wide_schema
from recmodels.nn.mlp import mlp_apply, mlp_init
from recmodels.ops.interactions import fm_pairwise


class DeepFMModel(CTRModel):
    name = "deepfm"

    def __init__(
        self,
        schema: Schema,
        hidden: Sequence[int] = (400, 400, 400),
        compute_dtype=jnp.float32,
    ):
        super().__init__(schema)
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, rng: jax.Array):
        r1, r2 = jax.random.split(rng)
        in_dim = self.schema.n_slots * self.schema.max_dim + self.schema.n_dense
        return {
            "mlp": mlp_init(r1, in_dim, self.hidden, out_dim=1),
            "w_dense": jnp.zeros((self.schema.n_dense,), jnp.float32),
            "bias": jnp.zeros((), jnp.float32),
        }

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        e = emb["emb"]
        y_fm = jnp.sum(emb["wide"][..., 0], axis=1) + fm_pairwise(e)
        h = jnp.concatenate([flatten_slots(e), dense.astype(e.dtype)], axis=1)
        y_dnn = mlp_apply(params["mlp"], h, final_linear=True, compute_dtype=self.compute_dtype)[:, 0]
        return params["bias"] + dense @ params["w_dense"] + y_fm + y_dnn
