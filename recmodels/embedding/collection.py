"""EmbeddingCollection — per-slot tables as dim-grouped stacked matrices.

The reference gives every categorical slot its own replica-local
``LookupTable`` (SURVEY.md §2a #8, BASELINE.json:5 "local embedding
matrices"). This design instead stacks all slots that share an embedding
dim into ONE ``[total_rows, dim]`` matrix per dim group:

  * one fused gather per group instead of 26 small gathers (each lookup is
    a single large XLA gather);
  * a single flat row index space per group is exactly what row-sharding
    needs — shard rows round-robin (``row % n_shards``) across the mesh and
    exchange indices with one all_to_all (parallel/sharded_embedding.py);
  * per-slot dims (BASELINE.json:9) become multiple groups; slots are
    reassembled into ``[B, n_slots, max_dim]`` with zero padding, which is
    exact for every downstream interaction op (ops/interactions.py docstring).

Training path: models never differentiate through the gather. The train step
gathers rows, differentiates the loss wrt the *gathered rows*, and applies a
sparse row-wise optimizer update (embedding/optim.py). This keeps gradients
O(batch) instead of O(vocab) — the replacement for BigDL's
LookupTable.backward scatter-add hot spot (SURVEY.md §3.2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from recmodels.data.schema import Schema


ALLOC_MULTIPLE = 1024  # table allocations round up to this many rows;
# pad rows are never addressed by hashed ids. The unit fixes table shapes
# and so the seeded init stream (ROADMAP design debt D2 revisits it).


@dataclasses.dataclass(frozen=True)
class DimGroup:
    """Slots sharing one embedding dim, stacked into one table."""

    name: str
    dim: int
    slot_indices: tuple[int, ...]  # positions in schema.slots
    row_offsets: tuple[int, ...]  # per slot, offset into the stacked table
    total_rows: int  # logical rows (sum of vocabs)

    @property
    def alloc_rows(self) -> int:
        return -(-self.total_rows // ALLOC_MULTIPLE) * ALLOC_MULTIPLE


def build_groups(schema: Schema) -> tuple[DimGroup, ...]:
    by_dim: dict[int, list[int]] = {}
    for i, spec in enumerate(schema.slots):
        by_dim.setdefault(spec.embed_dim, []).append(i)
    groups = []
    for dim in sorted(by_dim):
        slots = by_dim[dim]
        offsets, acc = [], 0
        for s in slots:
            offsets.append(acc)
            acc += schema.slots[s].vocab_size
        groups.append(
            DimGroup(
                name=f"d{dim}",
                dim=dim,
                slot_indices=tuple(slots),
                row_offsets=tuple(offsets),
                total_rows=acc,
            )
        )
    return tuple(groups)


class EmbeddingCollection:
    """Stateless descriptor + functional ops over embedding table params.

    Params pytree: ``{group.name: f32[total_rows, dim]}``.
    """

    def __init__(self, schema: Schema, dtype=jnp.float32):
        self.schema = schema
        self.dtype = dtype
        self.groups = build_groups(schema)
        self.max_dim = schema.max_dim
        # host-side constant lookup tables for slot -> (group, offset)
        self._np_offsets = {
            g.name: np.asarray(g.row_offsets, dtype=np.int32) for g in self.groups
        }

    # ---------------------------------------------------------------- init
    def init(self, rng: jax.Array, scale: float | None = None) -> Dict[str, jnp.ndarray]:
        """Default init: dim-1 (first-order weight) groups start at zero, like
        LR/FM linear terms; vector groups N(0, 0.05) per the DeepFM/xDeepFM
        convention of small-normal embedding init.

        LAYOUT: dim-1 tables are stored as 1-D ``[rows]`` arrays, so no
        backend can pad a trailing unit dim in memory."""
        params = {}
        for g in self.groups:
            rng, sub = jax.random.split(rng)
            s = scale if scale is not None else (0.0 if g.dim == 1 else 0.05)
            shape = (g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim)
            params[g.name] = (
                jax.random.normal(sub, shape, dtype=jnp.float32) * s
            ).astype(self.dtype)
        return params

    def param_shapes(self) -> Dict[str, tuple]:
        return {
            g.name: ((g.alloc_rows,) if g.dim == 1 else (g.alloc_rows, g.dim))
            for g in self.groups
        }

    # ------------------------------------------------------------ indexing
    def group_row_ids(self, ids: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """[B, n_slots] slot-local ids -> per-group global row ids [B, n_g].

        PRECONDITION: slot-local ids must lie in
        [0, vocab_size) for their slot. The hashing pipeline guarantees
        this; engine callers passing raw ids must not exceed the slot
        vocab — an out-of-range id lands in the NEXT slot's row range,
        which silently breaks the per-slot-sorted == globally-sorted
        invariant the sharded exchange plan relies on
        (``optim.slot_sorted_ids``). Set ``RECMODELS_DEBUG_IDS=1`` to
        clip-and-report instead of trusting callers (debug aid: clipping
        changes semantics, so it is not on by default).
        """
        import os

        debug = bool(os.environ.get("RECMODELS_DEBUG_IDS"))
        out = {}
        for g in self.groups:
            cols = ids[:, np.asarray(g.slot_indices, dtype=np.int32)]
            if debug:
                vocabs = jnp.asarray(
                    [self.schema.slots[s].vocab_size for s in g.slot_indices],
                    jnp.int32,
                )[None, :]
                oob = jnp.sum((cols < 0) | (cols >= vocabs))
                jax.debug.print(
                    "group_row_ids[{g}]: {n} out-of-range slot-local ids "
                    "(clipped under RECMODELS_DEBUG_IDS)", g=g.name, n=oob)
                cols = jnp.clip(cols, 0, vocabs - 1)
            out[g.name] = cols + jnp.asarray(self._np_offsets[g.name])[None, :]
        return out

    # ------------------------------------------------------------- lookup
    def gather_rows(
        self, params: Dict[str, jnp.ndarray], gids: Dict[str, jnp.ndarray],
        dtype=None,
    ) -> Dict[str, jnp.ndarray]:
        """Per-group gather: {g: [B, n_g]} -> {g: [B, n_g, dim]}.
        (dim-1 tables are 1-D; the trailing axis is re-expanded transiently —
        XLA fuses it, only the persistent table layout matters.)

        ``dtype``: emit rows in this dtype. XLA fuses the cast INTO the
        gather, so a bf16 gather writes half the output bytes."""
        out = {}
        for g in self.groups:
            r = params[g.name][gids[g.name]]
            if dtype is not None and r.dtype != dtype:
                r = r.astype(dtype)
            out[g.name] = r[..., None] if g.dim == 1 else r
        return out

    def combine(self, rows: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        """Reassemble per-group rows into [B, n_slots, max_dim], zero-padded.

        Differentiable; ``split_grad`` is its exact transpose. Uniform-dim
        schemas (the common case) short-circuit to the rows themselves —
        no scatter, no copy.
        """
        if len(self.groups) == 1:
            return rows[self.groups[0].name]
        some = next(iter(rows.values()))
        b = some.shape[0]
        out = jnp.zeros((b, self.schema.n_slots, self.max_dim), dtype=some.dtype)
        for g in self.groups:
            r = rows[g.name]
            if g.dim < self.max_dim:
                r = jnp.pad(r, ((0, 0), (0, 0), (0, self.max_dim - g.dim)))
            out = out.at[:, np.asarray(g.slot_indices, dtype=np.int32), :].set(r)
        return out

    def split_grad(self, emb_grad: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """[B, n_slots, max_dim] cotangent -> per-group [B, n_g, dim]."""
        out = {}
        for g in self.groups:
            sl = emb_grad[:, np.asarray(g.slot_indices, dtype=np.int32), : g.dim]
            out[g.name] = sl
        return out

    def lookup(self, params: Dict[str, jnp.ndarray], ids: jnp.ndarray) -> jnp.ndarray:
        """Inference-path lookup: [B, n_slots] ids -> [B, n_slots, max_dim]."""
        gids = self.group_row_ids(ids)
        return self.combine(self.gather_rows(params, gids))

    # --------------------------------------------------------------- misc
    def nbytes(self) -> int:
        per = jnp.dtype(self.dtype).itemsize
        return sum(g.total_rows * g.dim * per for g in self.groups)
