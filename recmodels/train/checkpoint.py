"""Checkpoint / resume via orbax (SURVEY.md §5.3-5.4).

Replaces the reference's ``Optimizer.setCheckpoint`` + ``Module.saveModule``
(BigDL snapshots to disk every N iterations): an orbax ``CheckpointManager``
snapshots ``{train_state, data_source_state}`` — params, BOTH optimizer
states (dense + sparse rows), step counter, and the data cursor — so a
preempted run resumes bit-identically (test_checkpoint.py asserts this).

Geometry: ``restore`` handles same-shape restores, including onto a
different DEVICE layout of the same global shapes (orbax resharding).
Changing the TABLE geometry (local <-> row-sharded, different shard
counts) changes array SHAPES — ``ShardedTables.padded_rows`` depends on
``n_shards`` — which plain resharding cannot fix. Use
``restore_cross_geometry`` for that: it routes every table (and its
optimizer-state rows) through the canonical 2-D form (the same unpad
serve.py exports) and re-pads to the target state's shapes. Rows beyond a
group's logical allocation are padding in both geometries (never gathered
or updated), so the slice/pad is lossless.

orbax is imported only when a ``CheckpointManager`` is created, so training
without a checkpoint directory does not need it.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from recmodels.train.engine import TrainState


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "checkpointing needs the 'orbax-checkpoint' package (import "
            "orbax.checkpoint failed); install it or run without a "
            "checkpoint directory"
        ) from e
    return ocp


def _fit_geometry(src: np.ndarray, target) -> np.ndarray:
    """Convert one saved tensor ([rows, d] or [rows]) to the target leaf's
    row count. Same-shape tensors pass through untouched (keeps
    bit-identical same-geometry behavior for dense params / scalars)."""
    tshape = tuple(target.shape)
    if src.shape == tshape:
        return src
    canon = src
    if len(tshape) == 2:
        canon2 = canon if canon.ndim == 2 else canon[:, None]
        canon2 = _pad_rows(canon2, tshape[0])
        if canon2.shape[1] < tshape[1]:
            canon2 = np.pad(canon2, ((0, 0), (0, tshape[1] - canon2.shape[1])))
        return canon2[:, : tshape[1]]
    if len(tshape) == 1:  # dim-1 wide table
        flat = canon.reshape(canon.shape[0], -1)[:, 0] if canon.ndim > 1 else canon
        return _pad_rows(flat[:, None], tshape[0])[:, 0]
    raise ValueError(f"cannot fit {src.shape} into {tshape}")


def _pad_rows(arr2: np.ndarray, rows: int) -> np.ndarray:
    if arr2.shape[0] < rows:
        return np.pad(arr2, ((0, rows - arr2.shape[0]), (0, 0)))
    return arr2[:rows]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1):
        self._ocp = ocp = _orbax()
        self._mgr = ocp.CheckpointManager(
            os.path.abspath(directory),
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps,
                enable_async_checkpointing=True,
            ),
        )

    def save(self, step: int, state: TrainState, data_state: dict | None = None,
             force: bool = False) -> bool:
        """``force=True`` bypasses save_interval_steps (use for the final
        save — otherwise orbax silently skips it and a restore resumes from
        a much older step)."""
        ocp = self._ocp
        return self._mgr.save(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardSave(state),
                data=ocp.args.JsonSave(data_state or {}),
            ),
            force=force,
        )

    def latest_step(self) -> int | None:
        return self._mgr.latest_step()

    def restore(self, abstract_state: TrainState, step: int | None = None):
        """Restore (state, data_state). ``abstract_state`` provides shapes/
        shardings (pass a freshly-initialized state — e.g. engine.init —
        possibly device_put onto the current mesh; orbax reshards to it)."""
        step = step if step is not None else self._mgr.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        ocp = self._ocp
        out = self._mgr.restore(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardRestore(abstract_state),
                data=ocp.args.JsonRestore(),
            ),
        )
        return out["state"], out["data"]

    def restore_cross_geometry(self, target_state: TrainState, step: int | None = None):
        """Restore into a DIFFERENT table geometry (local <-> sharded,
        other shard counts).

        ``target_state``: a live state from the TARGET engine (e.g.
        ``engine.init`` + shard) — supplies shapes, dtypes, and shardings.
        Every embedding table / optimizer-state tensor is converted
        source-geometry -> canonical [rows, dim] -> target-geometry; dense
        params/opt and the step counter copy through unchanged. Returns
        (state, data_state) like ``restore``.

        SINGLE-HOST / fully-addressable only: each restored
        leaf is materialized whole on this host (``np.asarray``) before
        conversion, so every saved array must be addressable here and fit
        host memory. On a genuinely multi-host sharded checkpoint, restore
        on one host (or use plain ``restore`` with matching geometry)."""
        step = step if step is not None else self._mgr.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        ocp = self._ocp
        raw = self._mgr.restore(
            step,
            args=ocp.args.Composite(
                state=ocp.args.StandardRestore(),
                data=ocp.args.JsonRestore(),
            ),
        )
        src = raw["state"]
        if not isinstance(src, dict):  # already a TrainState-like
            src = {f: getattr(src, f) for f in TrainState._fields}

        def fit_field(target_leaf, src_leaf):
            out = _fit_geometry(np.asarray(src_leaf), target_leaf)
            return jax.device_put(out.astype(target_leaf.dtype), target_leaf.sharding)

        def map_tree(target_tree, src_tree):
            t_leaves, tdef = jax.tree_util.tree_flatten(target_tree)
            s_leaves = jax.tree_util.tree_leaves(src_tree)
            assert len(t_leaves) == len(s_leaves), (
                f"checkpoint structure mismatch: {len(s_leaves)} saved leaves"
                f" vs {len(t_leaves)} target leaves")
            return jax.tree_util.tree_unflatten(
                tdef, [fit_field(t, s) for t, s in zip(t_leaves, s_leaves)]
            )

        state = TrainState(
            step=map_tree(target_state.step, src["step"]),
            dense_params=map_tree(target_state.dense_params, src["dense_params"]),
            dense_opt=map_tree(target_state.dense_opt, src["dense_opt"]),
            emb_params=map_tree(target_state.emb_params, src["emb_params"]),
            emb_opt=map_tree(target_state.emb_opt, src["emb_opt"]),
        )
        return state, raw["data"]

    def wait(self):
        self._mgr.wait_until_finished()

    def close(self):
        self._mgr.wait_until_finished()
        self._mgr.close()
