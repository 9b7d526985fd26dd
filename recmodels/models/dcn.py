"""DCN — Deep & Cross network (arXiv:1708.05123; SURVEY.md §2b model 5;
BASELINE.json:10: 3 cross layers + deep tower).

``x0 = concat(e_1..e_F, x_dense)``; cross layer
``x_{l+1} = x0 (x_lᵀ w_l) + b_l + x_l`` stacked L times, parallel deep MLP,
``logit = w_outᵀ concat(x_L, h_deep)``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, flatten_slots
from recmodels.nn.mlp import mlp_apply, mlp_init
from recmodels.ops.interactions import dcn_cross_stack


class DCNModel(CTRModel):
    name = "dcn"

    def __init__(
        self,
        schema: Schema,
        n_cross: int = 3,
        hidden: Sequence[int] = (512, 256),
        compute_dtype=jnp.float32,
    ):
        super().__init__(schema)
        self.n_cross = n_cross
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"emb": self.schema}

    @property
    def x0_dim(self) -> int:
        return self.schema.n_slots * self.schema.max_dim + self.schema.n_dense

    def init_dense(self, rng: jax.Array):
        d = self.x0_dim
        keys = jax.random.split(rng, 3)
        cross = {
            "w": jax.random.normal(keys[0], (self.n_cross, d), jnp.float32) / jnp.sqrt(d),
            "b": jnp.zeros((self.n_cross, d), jnp.float32),
        }
        mlp = mlp_init(keys[1], d, self.hidden)
        out_dim = d + (self.hidden[-1] if self.hidden else 0)
        w_out = jax.random.normal(keys[2], (out_dim,), jnp.float32) / jnp.sqrt(out_dim)
        return {"cross": cross, "mlp": mlp, "w_out": w_out, "bias": jnp.zeros((), jnp.float32)}

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        e = emb["emb"]
        x0 = jnp.concatenate([flatten_slots(e), dense.astype(e.dtype)], axis=1)
        xl = dcn_cross_stack(
            x0,
            params["cross"]["w"].astype(x0.dtype),
            params["cross"]["b"].astype(x0.dtype),
        )
        parts = [xl]
        if self.hidden:
            parts.append(
                mlp_apply(params["mlp"], x0, final_linear=False, compute_dtype=self.compute_dtype)
            )
        h = jnp.concatenate(parts, axis=1)
        return h @ params["w_out"] + params["bias"]
