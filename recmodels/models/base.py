"""Model abstraction: a CTR model is a pure function of (dense features,
embedded slots) -> logit.

Key design decision (vs the reference's BigDL ``Graph`` of modules,
SURVEY.md §2a #9): embedding *lookup* is factored OUT of the model. A model
declares which embedding collections it needs via ``embedding_schemas()``
(e.g. ``emb`` for dim-D vectors, ``wide`` for dim-1 first-order weights —
this is how LR/FM first-order terms and DeepFM's *shared* tables are
expressed), and ``apply`` consumes the already-gathered activations
``{name: [B, n_slots, dim]}``. The same model code then runs under local
tables, row-sharded tables + all_to_all, or any future placement — sharding
is entirely the engine's concern (engine/train loop + parallel/).
"""

from __future__ import annotations

import abc
from typing import Any, Dict

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema

# alias for readability: {collection_name: [B, n_slots, dim]} activations
EmbActivations = Dict[str, jnp.ndarray]


def wide_schema(schema: Schema) -> Schema:
    """The dim-1 'first order weight per bucket' companion schema."""
    import dataclasses

    return Schema(
        n_dense=schema.n_dense,
        slots=tuple(dataclasses.replace(s, embed_dim=1) for s in schema.slots),
    )


class CTRModel(abc.ABC):
    """Pure-functional CTR model. Subclasses hold only static config."""

    name: str

    def __init__(self, schema: Schema):
        self.schema = schema

    @abc.abstractmethod
    def embedding_schemas(self) -> Dict[str, Schema]:
        """Collections this model needs, keyed by activation name."""

    @abc.abstractmethod
    def init_dense(self, rng: jax.Array) -> Any:
        """Initialize the dense-tower params pytree (may be empty dict)."""

    @abc.abstractmethod
    def apply(self, params: Any, dense: jnp.ndarray, emb: EmbActivations) -> jnp.ndarray:
        """(dense [B, n_dense], emb activations) -> logits [B]."""


def flatten_slots(emb: jnp.ndarray) -> jnp.ndarray:
    """[B, F, D] -> [B, F*D] for MLP input."""
    b = emb.shape[0]
    return emb.reshape(b, -1)
