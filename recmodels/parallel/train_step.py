"""shard_map-wrapped training: the whole distributed step is ONE XLA program.

The reference's per-iteration distributed choreography (SURVEY.md §3.1:
driver task dispatch, BlockManager weight fetch, per-core replicas, gradient
put/fetch, partition-local optimizer) collapses here into a single jit'd
``shard_map``: batch split over the ``data`` axis, dense params replicated
(psum'd grads — the reduce-scatter/all-gather equivalent, §3.4), embedding
shards + optimizer state partitioned row-wise with all_to_all exchange
(sharded_embedding.py). The driver-side Python does nothing per-step but feed
arrays.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

try:  # jax >= 0.7 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from recmodels.parallel.mesh import DATA_AXIS
from recmodels.parallel.sharded_embedding import ShardedTables
from recmodels.train.engine import Engine, TrainState


def build_parallel_engine(
    model,
    mesh,
    dense_optimizer: str = "adam",
    sparse_optimizer: str = "adagrad",
    dense_lr: float = 1e-3,
    emb_lr: float = 1e-2,
    capacity_factor: float = 1.25,
    **kwargs,
) -> Engine:
    """Engine configured for this mesh: DP over ``data`` + row-sharded tables."""
    n_shards = mesh.shape[DATA_AXIS]

    def factory(collections, sparse_opt):
        return ShardedTables(
            collections,
            sparse_opt,
            n_shards=n_shards,
            axis_name=DATA_AXIS,
            capacity_factor=capacity_factor,
        )

    return Engine(
        model,
        dense_optimizer=dense_optimizer,
        sparse_optimizer=sparse_optimizer,
        dense_lr=dense_lr,
        emb_lr=emb_lr,
        axis_name=DATA_AXIS,
        table_strategy=factory,
        **kwargs,
    )


def state_specs(state: TrainState) -> TrainState:
    """PartitionSpecs for a TrainState: dense replicated, tables row-sharded."""
    return TrainState(
        step=P(),
        dense_params=jax.tree.map(lambda _: P(), state.dense_params),
        dense_opt=jax.tree.map(lambda _: P(), state.dense_opt),
        emb_params=jax.tree.map(lambda _: P(DATA_AXIS), state.emb_params),
        emb_opt=jax.tree.map(lambda _: P(DATA_AXIS), state.emb_opt),
    )


def shard_state(state: TrainState, mesh) -> TrainState:
    """Place a host-initialized global state onto the mesh."""
    specs = state_specs(state)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs,
        is_leaf=lambda x: isinstance(x, jnp.ndarray) or hasattr(x, "shape"),
    )


def build_parallel_steps(engine: Engine, mesh, donate: bool = True):
    """(train_step, eval_step) jitted over the mesh.

    train_step(state, dense [B,*], ids [B,26], labels [B]) — B is the GLOBAL
    batch, split over ``data``; returns (state, {'loss': replicated scalar}).
    """
    assert engine.axis_name == DATA_AXIS
    dummy = None  # specs depend only on pytree structure; built lazily below

    def make_specs(state):
        return state_specs(state)

    batch_p = P(DATA_AXIS)

    def train(state, dense, ids, labels):
        specs = make_specs(state)
        fn = _shard_map(
            engine.train_step,
            mesh=mesh,
            in_specs=(specs, batch_p, batch_p, batch_p),
            out_specs=(specs, {"loss": P(), "overflow": P()}),
            check_vma=False,
        )
        return fn(state, dense, ids, labels)

    def evaluate(state, auc_state, dense, ids, labels):
        specs = make_specs(state)
        fn = _shard_map(
            engine.eval_step,
            mesh=mesh,
            in_specs=(specs, jax.tree.map(lambda _: P(), auc_state), batch_p, batch_p, batch_p),
            out_specs=jax.tree.map(lambda _: P(), auc_state),
            check_vma=False,
        )
        return fn(state, auc_state, dense, ids, labels)

    train_jit = jax.jit(train, donate_argnums=(0,) if donate else ())
    eval_jit = jax.jit(evaluate, donate_argnums=(1,))
    return train_jit, eval_jit


def build_parallel_scan(engine: Engine, mesh, donate: bool = True):
    """Multi-step variant: K steps per dispatch (lax.scan inside shard_map).
    Batches stacked [K, B, ...], B split over ``data``. Returns
    (state, {'loss': last, 'losses': [K]})."""
    assert engine.axis_name == DATA_AXIS
    xs_p = P(None, DATA_AXIS)

    def scan_steps(state, dense, ids, labels):
        specs = state_specs(state)
        fn = _shard_map(
            engine.train_scan,
            mesh=mesh,
            in_specs=(specs, xs_p, xs_p, xs_p),
            out_specs=(specs, {"loss": P(), "losses": P(), "overflow": P()}),
            check_vma=False,
        )
        return fn(state, dense, ids, labels)

    return jax.jit(scan_steps, donate_argnums=(0,) if donate else ())


def build_parallel_accum(engine: Engine, mesh, scan: bool = False,
                         donate: bool = True):
    """Gradient-accumulation step over the mesh (SURVEY §2c): micro-batch
    axis A is replicated; the per-micro batch Bm splits over ``data``.
    ``scan=False``: batches [A, Bm, ...]; ``scan=True``: [K, A, Bm, ...]."""
    assert engine.axis_name == DATA_AXIS
    xs_p = P(None, None, DATA_AXIS) if scan else P(None, DATA_AXIS)
    inner = engine.train_scan_accum if scan else engine.train_step_accum
    out_m = (
        {"loss": P(), "losses": P(), "overflow": P()}
        if scan
        else {"loss": P(), "overflow": P()}
    )

    def step(state, dense, ids, labels):
        specs = state_specs(state)
        fn = _shard_map(
            inner,
            mesh=mesh,
            in_specs=(specs, xs_p, xs_p, xs_p),
            out_specs=(specs, out_m),
            check_vma=False,
        )
        return fn(state, dense, ids, labels)

    return jax.jit(step, donate_argnums=(0,) if donate else ())
