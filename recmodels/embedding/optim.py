"""Sparse row-wise embedding optimizers (Adagrad / lazy Adam).

The reference trains with BigDL Adam/Adagrad applied to dense parameter
partitions (SURVEY.md §2a #11, §3.4). For embedding tables that is wasteful
— gradients touch only O(batch) rows — so this design keeps optimizer state
sharded with its rows and can update *touched rows only*:

  1. flatten this step's (row_id, grad_row) pairs;
  2. ``dedup_segment_sum``: sort by row id + segment-sum so duplicate ids
     accumulate exactly once (SURVEY.md §7 hard part 1 "duplicate-ID gradient
     accumulation"; sort + segment-sum, no atomics — hard part 3);
  3. gather old state rows, compute the update, scatter back with
     ``mode='drop'`` so padding segments (sentinel row id == num_rows, out of
     bounds) are dropped in hardware rather than corrupting row 0.

Semantics notes (SURVEY.md §7 hard part 2):
  * Adagrad: sparse update is *bit-identical* to a dense Adagrad step
    (untouched rows get zero grad -> zero accumulator change, zero delta).
  * Adam: this is **lazy Adam** — moments of untouched rows do not decay.
    Matches the touched-rows-only math documented in SURVEY.md; a dense-Adam
    parity test covers the single-step case where they agree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import jax
import jax.numpy as jnp


def slot_sorted_ids(ids_2d: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sort a [B, n_slots] batch of GLOBAL row ids into one monotonic stream
    via a batched per-slot sort instead of one flat sort (the sharded
    exchange plan, ``parallel/sharded_embedding.py``).

    Valid by construction: ``collection.build_groups`` assigns each slot a
    disjoint row range with offsets increasing in column order, so column
    s's ids all sort strictly below column s+1's — concatenating per-column
    sorted blocks IS the global sort. XLA CSE shares the one batched sort
    between the gather plan and the update plan.

    Duplicate order is preserved exactly: equal ids can only collide within
    one column (ranges are disjoint) and the stable sort keeps them in
    ascending-b order, the same relative order the flat b-major sort gave.

    Returns (sorted_ids [N], order [N], order_2d [ns, B]): ``order`` maps
    sorted position -> original position in the b-major flat stream
    (ids_2d.reshape(-1)), i.e. a drop-in for the permutation from
    ``sort_key_val(flat, iota)``.
    """
    b, ns = ids_2d.shape
    iota_b = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[None, :], (ns, b))
    sorted_2d, order_2d = jax.lax.sort_key_val(ids_2d.T, iota_b, dimension=1)
    # original (b, s) lives at b-major flat position b*ns + s
    order = (order_2d * ns + jnp.arange(ns, dtype=jnp.int32)[:, None]).reshape(-1)
    return sorted_2d.reshape(-1), order, order_2d


def slot_sorted_inverse(order_2d: jnp.ndarray) -> jnp.ndarray:
    """Inverse permutation for ``slot_sorted_ids``: inv [N] (b-major) with
    inv[b*ns + s] = sorted position of (b, s), computed with a second
    batched sort instead of a second flat [N] sort."""
    ns, b = order_2d.shape
    iota_b = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[None, :], (ns, b))
    inv_2d = jax.lax.sort_key_val(order_2d, iota_b, dimension=1)[1]  # [ns, B]
    return (inv_2d + (jnp.arange(ns, dtype=jnp.int32) * b)[:, None]).T.reshape(-1)


def dedup_segment_sum(
    gids: jnp.ndarray, grads: jnp.ndarray, num_rows: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Deduplicate row ids and sum their gradient rows.

    gids: [N] int32 row ids (may repeat); grads: [N, D].
    Returns (uids [N], summed [N, D], valid [N] bool): position k < U holds
    the k-th distinct id with its summed gradient; positions k >= U hold the
    sentinel id ``num_rows`` (out of bounds -> scatter-dropped) with zero rows.
    Static shapes throughout (U is data-dependent, so the arrays stay [N]).
    """
    n = gids.shape[0]
    order = jnp.argsort(gids)
    sg = gids[order]
    gr = grads[order]
    is_start = jnp.concatenate([jnp.ones((1,), jnp.bool_), sg[1:] != sg[:-1]])
    seg = jnp.cumsum(is_start) - 1  # [N] in [0, U)
    summed = jax.ops.segment_sum(gr, seg, num_segments=n)
    counts = jax.ops.segment_sum(jnp.ones_like(sg), seg, num_segments=n)
    valid = counts > 0
    uids = jax.ops.segment_max(sg, seg, num_segments=n)
    # Padding positions get DISTINCT ascending out-of-bounds sentinels
    # (num_rows + k) so the whole uids array is strictly sorted AND unique —
    # letting every downstream gather/scatter pass the
    # indices_are_sorted/unique_indices hints. Callers keep real ids in
    # [0, num_rows] for this to hold.
    uids = jnp.where(
        valid, uids, num_rows + jnp.arange(n, dtype=gids.dtype)
    ).astype(jnp.int32)
    return uids, summed, valid


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    """Functional sparse optimizer over one stacked table.

    init(num_rows, dim) -> state pytree
    apply(table, state, uids, gsum, step, lr) -> (table, state)
      uids/gsum from ``dedup_segment_sum`` (sentinel = num_rows).
    apply_dense(table, state, ids, grads, step, lr) -> (table, state)
      optional bandwidth-bound path: scatter-add raw (id, grad) pairs into a
      dense grad and update the FULL table elementwise — no sort, a few
      full-table passes. Only present when dense math equals this
      optimizer's sparse semantics (Adagrad yes; lazy Adam no).
    """

    name: str
    init: Callable[[int, int], Dict[str, jnp.ndarray]]
    apply: Callable[..., tuple[jnp.ndarray, Dict[str, jnp.ndarray]]]
    apply_dense: Callable[..., tuple[jnp.ndarray, Dict[str, jnp.ndarray]]] | None = None


def choose_dense_update(num_rows: int, dim: int, n_ids: int,
                        has_dense: bool) -> bool:
    """Auto strategy: dense when the table has at most 512 rows per id of
    this step and the transient dense grad stays modest (<=512MB). The
    thresholds are not yet measured on the current card (ROADMAP Speed 4b)."""
    if not has_dense:
        return False
    return num_rows <= 512 * n_ids and num_rows * dim * 4 <= 512 * 2**20


def apply_updates(opt: "SparseOptimizer", table, state, ids_flat, grads_flat, step, lr):
    """Apply one group's update through one of two XLA routes:

    1. dense full-table update (``opt.apply_dense``) when
       ``choose_dense_update`` picks it;
    2. ``dedup_segment_sum`` + the sparse touched-rows update (``opt.apply``).

    Ids ``>= num_rows`` are padding sentinels and update nothing.
    """
    grads_flat = grads_flat.astype(jnp.float32)  # f32 segment sums / scatter-adds
    num_rows = table.shape[0]
    dim = 1 if table.ndim == 1 else table.shape[1]
    if choose_dense_update(num_rows, dim, ids_flat.shape[0], opt.apply_dense is not None):
        return opt.apply_dense(table, state, ids_flat, grads_flat, step, lr)
    uids, gsum, _ = dedup_segment_sum(ids_flat, grads_flat, num_rows)
    return opt.apply(table, state, uids, gsum, step, lr)


def sparse_adagrad(eps: float = 1e-8, initial_accumulator: float = 0.1) -> SparseOptimizer:
    """Per-element Adagrad on touched rows (== dense Adagrad semantics)."""

    def init(num_rows: int, dim: int) -> Dict[str, jnp.ndarray]:
        shape = (num_rows,) if dim == 1 else (num_rows, dim)
        return {"acc": jnp.full(shape, initial_accumulator, jnp.float32)}

    def apply(table, state, uids, gsum, step, lr):
        del step
        hints = dict(indices_are_sorted=True, unique_indices=True)
        acc_rows = state["acc"].at[uids].get(
            mode="fill", fill_value=initial_accumulator, **hints
        )
        acc_new = acc_rows + gsum * gsum
        delta = -lr * gsum / (jnp.sqrt(acc_new) + eps)
        acc = state["acc"].at[uids].set(acc_new, mode="drop", **hints)
        table = table.at[uids].add(delta.astype(table.dtype), mode="drop", **hints)
        return table, {"acc": acc}

    def apply_dense(table, state, ids, grads, step, lr):
        del step
        g = jnp.zeros(table.shape, jnp.float32).at[ids].add(grads, mode="drop")
        acc = state["acc"] + g * g
        table = table - (lr * g / (jnp.sqrt(acc) + eps)).astype(table.dtype)
        return table, {"acc": acc}

    return SparseOptimizer("adagrad", init, apply, apply_dense)


def sparse_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> SparseOptimizer:
    """Lazy Adam: moment updates and decay applied to touched rows only.

    Bias correction uses the global step counter (standard lazy-Adam choice;
    per-row step counters would double state memory for negligible effect).
    """

    def init(num_rows: int, dim: int) -> Dict[str, jnp.ndarray]:
        shape = (num_rows,) if dim == 1 else (num_rows, dim)
        return {
            "m": jnp.zeros(shape, jnp.float32),
            "v": jnp.zeros(shape, jnp.float32),
        }

    def apply(table, state, uids, gsum, step, lr):
        hints = dict(indices_are_sorted=True, unique_indices=True)
        m_rows = state["m"].at[uids].get(mode="fill", fill_value=0.0, **hints)
        v_rows = state["v"].at[uids].get(mode="fill", fill_value=0.0, **hints)
        m_new = b1 * m_rows + (1.0 - b1) * gsum
        v_new = b2 * v_rows + (1.0 - b2) * gsum * gsum
        t = (step + 1).astype(jnp.float32)
        m_hat = m_new / (1.0 - b1**t)
        v_hat = v_new / (1.0 - b2**t)
        delta = -lr * m_hat / (jnp.sqrt(v_hat) + eps)
        m = state["m"].at[uids].set(m_new, mode="drop", **hints)
        v = state["v"].at[uids].set(v_new, mode="drop", **hints)
        table = table.at[uids].add(delta.astype(table.dtype), mode="drop", **hints)
        return table, {"m": m, "v": v}

    return SparseOptimizer("adam", init, apply)


def dense_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> SparseOptimizer:
    """DENSE Adam over the full table every step — the reference's exact
    semantics (BigDL's DistriOptimizer treats embedding tables as ordinary
    dense parameter partitions, SURVEY.md §3.4): moments of untouched rows
    DO decay. Bandwidth-bound (~7 table passes); preferable to lazy Adam
    when parity with dense-Adam training is wanted and tables fit the
    dense-update regime."""

    def init(num_rows: int, dim: int) -> Dict[str, jnp.ndarray]:
        shape = (num_rows,) if dim == 1 else (num_rows, dim)
        return {
            "m": jnp.zeros(shape, jnp.float32),
            "v": jnp.zeros(shape, jnp.float32),
        }

    def apply_dense(table, state, ids, grads, step, lr):
        g = jnp.zeros(table.shape, jnp.float32).at[ids].add(grads, mode="drop")
        m = b1 * state["m"] + (1.0 - b1) * g
        v = b2 * state["v"] + (1.0 - b2) * g * g
        t = (step + 1).astype(jnp.float32)
        m_hat = m / (1.0 - b1**t)
        v_hat = v / (1.0 - b2**t)
        table = table - (lr * m_hat / (jnp.sqrt(v_hat) + eps)).astype(table.dtype)
        return table, {"m": m, "v": v}

    def apply(table, state, uids, gsum, step, lr):
        # dense semantics cannot be reproduced from dedup'd rows alone
        # (untouched rows must decay); route through the dense path.
        return apply_dense(table, state, uids, gsum, step, lr)

    return SparseOptimizer("adam_dense", init, apply, apply_dense)


def get_sparse_optimizer(name: str, **kwargs) -> SparseOptimizer:
    if name == "adagrad":
        return sparse_adagrad(**kwargs)
    if name == "adam":
        return sparse_adam(**kwargs)
    if name == "adam_dense":
        return dense_adam(**kwargs)
    raise ValueError(f"unknown sparse optimizer: {name}")
