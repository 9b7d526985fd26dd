"""AFM — Attentional Factorization Machine (arXiv:1708.04617).

``ŷ = b + Σ w[c_i] + w_d·x + pᵀ Σ_{ij} a_ij (e_i ∘ e_j)`` with attention
``a_ij = softmax(hᵀ relu(W (e_i∘e_j) + b_att))`` over the F(F-1)/2 pairs.
The pair products come from ops.afm_pair_products; everything downstream is
batched matmul + softmax."""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema
from recmodels.models.base import CTRModel, EmbActivations, wide_schema
from recmodels.ops.interactions import afm_pair_products


class AFMModel(CTRModel):
    name = "afm"

    def __init__(self, schema: Schema, attention_dim: int = 32, compute_dtype=jnp.float32):
        super().__init__(schema)
        self.attention_dim = attention_dim
        self.compute_dtype = compute_dtype

    def embedding_schemas(self) -> Dict[str, Schema]:
        return {"wide": wide_schema(self.schema), "emb": self.schema}

    def init_dense(self, rng: jax.Array):
        d = self.schema.max_dim
        a = self.attention_dim
        k1, k2, k3 = jax.random.split(rng, 3)
        return {
            "w_att": jax.random.normal(k1, (d, a), jnp.float32) * jnp.sqrt(2.0 / d),
            "b_att": jnp.zeros((a,), jnp.float32),
            "h_att": jax.random.normal(k2, (a,), jnp.float32) / jnp.sqrt(a),
            "p": jax.random.normal(k3, (d,), jnp.float32) / jnp.sqrt(d),
            "w_dense": jnp.zeros((self.schema.n_dense,), jnp.float32),
            "bias": jnp.zeros((), jnp.float32),
        }

    def apply(self, params, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        # Mixed precision à la mlp_apply: the [B, P, *] attention tensors
        # stay in compute_dtype (f32 params would otherwise promote every
        # einsum over the 325-pair axis to f32 — measured 1.13M -> bf16
        # keeps the heavy traffic half-width); softmax runs in f32.
        cd = self.compute_dtype
        pp = afm_pair_products(emb["emb"]).astype(cd)  # [B, P, D]
        att_h = jax.nn.relu(
            jnp.einsum("bpd,da->bpa", pp, params["w_att"].astype(cd))
            + params["b_att"].astype(cd)
        )
        scores = jnp.einsum("bpa,a->bp", att_h, params["h_att"].astype(cd))
        a = jax.nn.softmax(scores.astype(jnp.float32), axis=1)  # [B, P]
        pooled = jnp.einsum("bp,bpd->bd", a.astype(cd), pp)
        y_att = pooled.astype(jnp.float32) @ params["p"]
        first = jnp.sum(emb["wide"][..., 0], axis=1)
        return params["bias"] + first + dense @ params["w_dense"] + y_att
