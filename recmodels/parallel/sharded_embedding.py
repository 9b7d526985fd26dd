"""Row-sharded embedding tables with all-to-all ID exchange.

THE central architectural change vs the reference (BASELINE.json:5 "local
embedding matrices -> sharded table shards + all-to-all"; SURVEY.md §2a #8,
§5.8): BigDL keeps every table replicated in every model replica; here each
device owns a contiguous block of every stacked table's rows, and lookups are
a three-hop exchange executed *inside* the jit'd step:

  1. bucket this device's flat row ids by owning shard (fixed capacity C per
     destination + overflow counting — SURVEY.md §7 hard part 1);
  2. ``all_to_all`` the id buckets (requester -> owner);
  3. owners gather rows from their local shard; ``all_to_all`` the rows back;
  4. un-permute into the batch's original order.

The gradient path runs the same route in reverse: per-occurrence grad rows
go requester -> owner, the owner dedups them with sort+segment-sum and
applies the sparse optimizer to its local shard + local optimizer state
(optimizer state lives with its rows — the ZeRO-1-like partitioning the
reference also had, SURVEY.md §3.4).

This is exactly expert-parallelism's token->owner exchange (SURVEY.md §2c),
expressed with ``jax.lax.all_to_all`` under ``shard_map`` so XLA emits the
collectives — no transport code.

Sharding layout: tables pad ``total_rows`` up to a multiple of n_shards and
block-shard: shard s owns global rows [s*R, (s+1)*R). Hashed ids are uniform
over each slot's vocab range, so block shards are load-balanced in
expectation; overflow capacity ``C = ceil(N/S * capacity_factor)`` absorbs
the multinomial tail (overflowed lookups return zero rows and drop their
grads; the count is observable via ``gather_with_stats``).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from recmodels.embedding.collection import ALLOC_MULTIPLE, EmbeddingCollection
from recmodels.embedding.optim import SparseOptimizer


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ShardedTables:
    """Table strategy (engine.py API) that runs under ``shard_map``.

    All methods other than init_* assume they execute per-device inside a
    ``shard_map`` over ``axis_name``, with ``emb_params[coll][group]`` being
    the LOCAL shard ``[padded_rows / n_shards, dim]``.
    """

    def __init__(
        self,
        collections: Dict[str, EmbeddingCollection],
        sparse_opt: SparseOptimizer,
        n_shards: int,
        axis_name: str = "data",
        # every exchange buffer scales linearly with capacity_factor;
        # hashed ids are near-uniform over shards, so 1.25 leaves ~50+
        # sigma of binomial headroom at the flagship shape
        capacity_factor: float = 1.25,
        local_batch_hint: int | None = None,
    ):
        self.collections = collections
        self.sparse_opt = sparse_opt
        self.n_shards = n_shards
        self.axis_name = axis_name
        self.capacity_factor = capacity_factor

    # ------------------------------------------------------------ geometry
    def padded_rows(self, coll: str, group) -> int:
        # every shard owns the same whole number of allocation units
        # (collection.ALLOC_MULTIPLE rows; ROADMAP design debt D2)
        unit = self.n_shards * ALLOC_MULTIPLE
        return _cdiv(group.alloc_rows, unit) * unit

    def rows_per_shard(self, coll: str, group) -> int:
        return self.padded_rows(coll, group) // self.n_shards

    def _capacity(self, n_flat_ids: int) -> int:
        # per-destination bucket capacity, rounded up to a multiple of 8
        c = _cdiv(int(n_flat_ids * self.capacity_factor), self.n_shards)
        return max(8, _cdiv(c, 8) * 8)

    # ---------------------------------------------------------------- init
    def init_params(self, rng: jax.Array) -> Dict[str, Dict[str, jnp.ndarray]]:
        """GLOBAL (unsharded-shape) params; shard with parallel.shard_state."""
        out = {}
        for name, coll in self.collections.items():
            rng, sub = jax.random.split(rng)
            tables = coll.init(sub)
            out[name] = {}
            for g in coll.groups:
                pad = self.padded_rows(name, g) - g.alloc_rows
                widths = ((0, pad),) if g.dim == 1 else ((0, pad), (0, 0))
                out[name][g.name] = jnp.pad(tables[g.name], widths)
        return out

    def init_opt(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: {
                g.name: self.sparse_opt.init(self.padded_rows(name, g), g.dim)
                for g in coll.groups
            }
            for name, coll in self.collections.items()
        }

    # ------------------------------------------------------------ exchange
    def _plan(self, ids_2d: jnp.ndarray, rows_per_shard: int, cap: int):
        """Routing plan for one group's [B, n_g] global row ids (N = B·n_g).

        *Owner is monotonic in the globally-sorted id stream* (block
        sharding: owner = id // R), and the batched per-slot sort
        (``slot_sorted_ids``) yields that stream cheaply. So:

          * per-destination buckets are SLICES of the sorted stream —
            ``bounds = searchsorted(sorted_ids, o·R)`` — no scatter and no
            argsort by owner;
          * the requester readback composes the bucket-slot map with the
            sort's inverse permutation into ONE row-take.

        Every buffer move is d dynamic-slices (and the readback d
        dynamic-update-slices into zeros): contiguous copies, no
        per-element indexing beyond the one take.

        Returns (sorted_ids [N], order [N] sorted-pos -> b-major-pos,
        order_2d [n_g, B], bounds [d+1], counts [d], overflow count).
        XLA CSEs all of it between gather and apply_grads (same inputs,
        pure ops), so the plan is computed once per step.
        """
        from recmodels.embedding.optim import slot_sorted_ids

        d = self.n_shards
        sorted_ids, order, order_2d = slot_sorted_ids(ids_2d)
        boundaries = (jnp.arange(d + 1, dtype=jnp.int32) * rows_per_shard)
        bounds = jnp.searchsorted(
            sorted_ids, boundaries, method="compare_all"
        ).astype(jnp.int32)
        counts = bounds[1:] - bounds[:-1]
        overflow = jnp.sum(jnp.maximum(counts - cap, 0))
        return sorted_ids, order, order_2d, bounds, counts, overflow

    def _bucketize_ids(self, sorted_ids, bounds, counts, cap):
        """[N] sorted -> [d, cap] buckets: d dynamic-slices at bounds[o] +
        an iota<count mask for the INT32_MAX sentinel (each row stays
        sorted: real ids ascend, sentinels trail)."""
        d = self.n_shards
        sentinel = jnp.iinfo(jnp.int32).max
        src = jnp.concatenate(
            [sorted_ids, jnp.full((cap,), sentinel, jnp.int32)]
        )
        buf = jnp.stack(
            [jax.lax.dynamic_slice(src, (bounds[o],), (cap,)) for o in range(d)]
        )
        mask = jnp.arange(cap, dtype=jnp.int32)[None, :] < counts[:, None]
        return jnp.where(mask, buf, sentinel)

    def _bucketize_rows(self, sorted_rows, bounds, cap):
        """[N(, D)] sorted-order rows -> [d, cap(, D)] buckets via d
        dynamic-slices. Tail rows beyond counts[o] carry neighboring
        buckets' data — harmless: their ids are the sentinel, which every
        consumer drops (scatter-drop / zero-fill)."""
        d = self.n_shards
        one_d = sorted_rows.ndim == 1
        pad_shape = (cap,) if one_d else (cap, sorted_rows.shape[1])
        src = jnp.concatenate(
            [sorted_rows, jnp.zeros(pad_shape, sorted_rows.dtype)]
        )
        if one_d:
            return jnp.stack(
                [jax.lax.dynamic_slice(src, (bounds[o],), (cap,)) for o in range(d)]
            )
        width = sorted_rows.shape[1]
        return jnp.stack([
            jax.lax.dynamic_slice(src, (bounds[o], 0), (cap, width))
            for o in range(d)
        ])

    def _unbucketize_rows(self, flat_rows, bounds, cap, n):
        """[d·cap(, D)] bucket-slot rows -> [N(, D)] sorted order: ascending
        dynamic-update-slices into zeros. Bucket o's garbage tail (slots
        counts[o]..cap) lands exactly where bucket o+1's valid data begins,
        so ascending writes leave every position with its own bucket's row;
        overflow positions (pos >= cap, only when counts[o] > cap) are
        never written and stay zero — the drop-lookup contract."""
        d = self.n_shards
        one_d = flat_rows.ndim == 1
        cap_d = cap if one_d else (cap, flat_rows.shape[1])
        acc_shape = (n + cap,) if one_d else (n + cap, flat_rows.shape[1])
        acc = jnp.zeros(acc_shape, flat_rows.dtype)
        for o in range(d):
            blk = (
                jax.lax.dynamic_slice(flat_rows, (o * cap,), (cap,))
                if one_d
                else jax.lax.dynamic_slice(flat_rows, (o * cap, 0), cap_d)
            )
            start = (bounds[o],) if one_d else (bounds[o], 0)
            acc = jax.lax.dynamic_update_slice(acc, blk, start)
        return acc[:n]

    @staticmethod
    def _owner_local_ids(local_idx, rows_per_shard):
        """Owner-side ids: sentinel / out-of-range ids -> ``rows_per_shard``,
        the sparse optimizer's drop sentinel (``optim.apply_updates``)."""
        flat = local_idx.reshape(-1).astype(jnp.int32)
        return jnp.where((flat >= 0) & (flat < rows_per_shard), flat, rows_per_shard)

    def _gather_group(self, table_local, ids_2d, rows_per_shard,
                      with_stats=False, dtype=None):
        d = self.n_shards
        n = ids_2d.shape[0] * ids_2d.shape[1]
        one_d = table_local.ndim == 1  # dim-1 tables are stored 1-D
        cap = self._capacity(n)
        sorted_ids, order, order_2d, bounds, counts, overflow = self._plan(
            ids_2d, rows_per_shard, cap
        )
        send_ids = self._bucketize_ids(sorted_ids, bounds, counts, cap)
        # hop 1: requester -> owner (ids)
        recv_ids = jax.lax.all_to_all(
            send_ids, self.axis_name, split_axis=0, concat_axis=0
        )
        my_index = jax.lax.axis_index(self.axis_name)
        local_idx = recv_ids - my_index * rows_per_shard  # sentinel stays OOB
        rows = table_local.at[local_idx.reshape(-1)].get(mode="fill", fill_value=0.0)
        if dtype is not None and rows.dtype != dtype:
            rows = rows.astype(dtype)  # before hop 2: halves return-trip bytes
        # hop 2: owner -> requester (rows)
        shape = (d, cap) if one_d else (d, cap, rows.shape[-1])
        back = jax.lax.all_to_all(
            rows.reshape(shape), self.axis_name, split_axis=0, concat_axis=0
        )
        flat_rows = back.reshape((d * cap,) if one_d else (d * cap, -1))
        # readback: unbucketize to sorted order (d update-slices; overflow
        # rows stay zero), then one un-permute take to batch order.
        from recmodels.embedding.optim import slot_sorted_inverse

        rows_sorted_b = self._unbucketize_rows(flat_rows, bounds, cap, n)
        out = jnp.take(rows_sorted_b, slot_sorted_inverse(order_2d), axis=0)
        if with_stats:
            return out, overflow
        return out

    def _scatter_group(self, table_local, opt_state, ids_2d, grads_flat,
                       rows_per_shard, step, lr):
        d = self.n_shards
        n = ids_2d.shape[0] * ids_2d.shape[1]
        one_d = grads_flat.ndim == 1  # dim-1 group: grads are [N]
        cap = self._capacity(n)
        sorted_ids, order, order_2d, bounds, counts, _ = self._plan(
            ids_2d, rows_per_shard, cap
        )
        send_ids = self._bucketize_ids(sorted_ids, bounds, counts, cap)
        # grad buckets: ONE permute take to sorted order + d
        # dynamic-slices. Tail rows beyond counts[o] carry neighbors' grads —
        # their ids are the sentinel, which every update path drops.
        sorted_grads = jnp.take(grads_flat, order, axis=0)
        send_grads = self._bucketize_rows(sorted_grads, bounds, cap)
        # grads ride requester -> owner, aligned with the id buckets
        recv_ids = jax.lax.all_to_all(
            send_ids, self.axis_name, split_axis=0, concat_axis=0
        )
        recv_grads = jax.lax.all_to_all(
            send_grads, self.axis_name, split_axis=0, concat_axis=0
        )
        my_index = jax.lax.axis_index(self.axis_name)
        local_idx = recv_ids - my_index * rows_per_shard
        recv_flat = recv_grads.reshape((-1,) if one_d else (-1, grads_flat.shape[-1]))
        from recmodels.embedding.optim import apply_updates

        # duplicates arrive source-major, each source's run in batch order,
        # so the stable dedup sort sums them in the local oracle's order
        return apply_updates(
            self.sparse_opt, table_local, opt_state,
            self._owner_local_ids(local_idx, rows_per_shard), recv_flat, step, lr,
        )

    # ----------------------------------------------------- engine strategy
    def gather(self, emb_params, gids, dtype=None, emb_opt=None, with_stats=False):
        """``with_stats``: also return the total dropped-lookup (overflow)
        count, so the training loop can surface capacity misconfiguration
        instead of silently training on zero rows."""
        del emb_opt
        out, total = {}, jnp.zeros((), jnp.int32)
        for name, coll in self.collections.items():
            out[name] = {}
            for g in coll.groups:
                ids = gids[name][g.name]
                b, ns = ids.shape
                src = emb_params[name][g.name]
                res = self._gather_group(
                    src, ids,
                    self.rows_per_shard(name, g), with_stats=with_stats,
                    dtype=dtype,
                )
                rows, ovf = res if with_stats else (res, None)
                out[name][g.name] = rows.reshape(b, ns, g.dim)  # 1-D groups expand here
                if with_stats:
                    total = total + ovf
        if with_stats:
            return out, total
        return out

    def gather_with_stats(self, emb_params, gids):
        """gather + total overflow count (for logging/monitoring)."""
        return self.gather(emb_params, gids, with_stats=True)

    def apply_grads(self, emb_params, emb_opt, gids, grad_rows, step, lr):
        new_params, new_opt = {}, {}
        for name, coll in self.collections.items():
            new_params[name], new_opt[name] = {}, {}
            for g in coll.groups:
                gr0 = grad_rows[name][g.name]
                gr = gr0.reshape(-1) if g.dim == 1 else gr0.reshape(-1, g.dim)
                table, opt = self._scatter_group(
                    emb_params[name][g.name],
                    emb_opt[name][g.name],
                    gids[name][g.name],
                    gr,
                    self.rows_per_shard(name, g),
                    step,
                    lr,
                )
                new_params[name][g.name] = table
                new_opt[name][g.name] = opt
        return new_params, new_opt
