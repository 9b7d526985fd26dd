"""Sharded-table correctness vs single-device oracle (SURVEY.md §4 item 3,
§7 hard part 1): the full shard_map step — all_to_all id exchange, row
gather, grad return, sharded sparse optimizer — on 8 fake CPU devices must
match LocalTables bit-for-bit (up to float noise)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from recmodels.data import SyntheticSource, criteo_schema
from recmodels.models import build_model
from recmodels.parallel import (
    build_parallel_engine,
    build_parallel_steps,
    make_mesh,
    shard_state,
)
from recmodels.train.engine import Engine
from recmodels.train.metrics import auc_compute, auc_init

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (fake) devices"
)

SCH = criteo_schema(vocab_size=500, embed_dim=8)


def _batch(b=64, seed=0):
    src = SyntheticSource(SCH, batch_size=b, seed=seed)
    batch = next(iter(src))
    return (
        jnp.asarray(batch.dense),
        jnp.asarray(batch.ids),
        jnp.asarray(batch.labels),
    )


def _unshard_tables(sharded_emb_params, local_collections):
    """Sharded padded tables -> dict trimmed to true row counts."""
    out = {}
    for cname, groups in sharded_emb_params.items():
        out[cname] = {}
        for gname, table in groups.items():
            out[cname][gname] = np.asarray(table)
    return out


@pytest.mark.parametrize("sparse_opt", ["adagrad", "adam"])
def test_sharded_step_matches_local_oracle(sparse_opt):
    mesh = make_mesh(8)
    model_s = build_model("fm", SCH)
    eng_s = build_parallel_engine(
        model_s, mesh, dense_lr=1e-2, emb_lr=5e-2, sparse_optimizer=sparse_opt,
        capacity_factor=4.0,
    )
    state_s = shard_state(eng_s.init(jax.random.key(0)), mesh)
    train_s, _ = build_parallel_steps(eng_s, mesh, donate=False)

    model_l = build_model("fm", SCH)
    eng_l = Engine(
        model_l, dense_lr=1e-2, emb_lr=5e-2, sparse_optimizer=sparse_opt, axis_name=None
    )
    state_l = eng_l.init(jax.random.key(0))
    train_l = eng_l.jit_train_step(donate=False)

    # identical init? sharded init pads rows; compare the unpadded prefix
    for cname, coll in eng_l.collections.items():
        for g in coll.groups:
            np.testing.assert_allclose(
                np.asarray(state_s.emb_params[cname][g.name])[: g.total_rows],
                np.asarray(state_l.emb_params[cname][g.name])[: g.total_rows],
                atol=0,
            )

    for step_i in range(3):
        dense, ids, labels = _batch(b=64, seed=step_i)
        state_s, ms = train_s(state_s, dense, ids, labels)
        state_l, ml = train_l(state_l, dense, ids, labels)
        np.testing.assert_allclose(float(ms["loss"]), float(ml["loss"]), rtol=1e-5)

    # dense params identical
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5),
        state_s.dense_params,
        state_l.dense_params,
    )
    # embedding tables identical on the unpadded prefix. atol reflects the
    # f32 noise floor of 3 chaotic steps: the sharded and local programs
    # compile the SAME model math with different fusion groupings (verified:
    # gathered rows and step-0 loss are bit-identical; g_rows differ by
    # ~1 ulp), and Adam's sqrt(v_hat) normalization amplifies fresh-row
    # grad ulps — observed ≤ 2.4e-6 abs on <1e-5 of elements vs 5e-2-scale
    # updates.
    for cname, coll in eng_l.collections.items():
        for g in coll.groups:
            got = np.asarray(state_s.emb_params[cname][g.name])[: g.total_rows]
            want = np.asarray(state_l.emb_params[cname][g.name])[: g.total_rows]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_eval_matches_local():
    mesh = make_mesh(8)
    model = build_model("dcn", SCH, hidden=(16,), n_cross=2)
    # capacity 4.0: at tiny test vocab the table's 8x1024-padding skews
    # shard loads by padded/used ≈ 1.26x, above the production default's
    # 1.25 headroom (at vocab 1e5 the same skew is 0.3%)
    eng_s = build_parallel_engine(model, mesh, capacity_factor=4.0)
    state_s = shard_state(eng_s.init(jax.random.key(1)), mesh)
    _, eval_s = build_parallel_steps(eng_s, mesh, donate=False)

    eng_l = Engine(model)
    state_l = eng_l.init(jax.random.key(1))
    eval_l = eng_l.jit_eval_step()

    dense, ids, labels = _batch(b=128, seed=9)
    auc_s = eval_s(state_s, auc_init(), dense, ids, labels)
    auc_l = eval_l(state_l, auc_init(), dense, ids, labels)
    np.testing.assert_allclose(
        float(auc_compute(auc_s)["auc"]), float(auc_compute(auc_l)["auc"]), atol=1e-6
    )
    np.testing.assert_allclose(
        float(auc_compute(auc_s)["logloss"]), float(auc_compute(auc_l)["logloss"]), atol=1e-5
    )


def test_overflow_counting_and_zero_rows():
    """With a tiny capacity factor, overflowed lookups must return zero rows
    and report a nonzero overflow count — never wrong data."""
    mesh = make_mesh(8)
    model = build_model("fm", SCH)
    eng = build_parallel_engine(model, mesh, capacity_factor=0.05)
    state = shard_state(eng.init(jax.random.key(0)), mesh)

    try:  # jax >= 0.7 exposes shard_map at top level
        from jax import shard_map as smap
    except ImportError:
        from jax.experimental.shard_map import shard_map as smap

    from recmodels.parallel.train_step import state_specs

    dense, ids, labels = _batch(b=64, seed=2)

    def probe(state, ids):
        gids = eng._group_ids(ids)
        rows, overflow = eng.table_strategy.gather_with_stats(state.emb_params, gids)
        return overflow

    specs = state_specs(state)
    fn = jax.jit(
        smap(
            probe,
            mesh=mesh,
            in_specs=(specs, P("data")),
            out_specs=P(),
            check_vma=False,
        )
    )
    # per-device overflow counts differ; out_specs P() takes device 0's — use
    # psum inside instead for a deterministic total
    def probe_sum(state, ids):
        return jax.lax.psum(probe(state, ids), "data")

    fn2 = jax.jit(
        smap(probe_sum, mesh=mesh, in_specs=(specs, P("data")), out_specs=P(), check_vma=False)
    )
    total = int(fn2(state, ids))
    assert total > 0


def test_per_slot_dims_sharded():
    dims = [4] * 13 + [8] * 13
    sch = criteo_schema(vocab_size=300, embed_dim=dims)
    mesh = make_mesh(8)
    model = build_model("xdeepfm", sch, hidden=(16,), cin_sizes=(8,))
    eng_s = build_parallel_engine(model, mesh, capacity_factor=4.0)
    state_s = shard_state(eng_s.init(jax.random.key(3)), mesh)
    train_s, _ = build_parallel_steps(eng_s, mesh, donate=False)

    eng_l = Engine(model)
    state_l = eng_l.init(jax.random.key(3))
    train_l = eng_l.jit_train_step(donate=False)

    src = SyntheticSource(sch, batch_size=64, seed=4)
    b = next(iter(src))
    args = (jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels))
    state_s, ms = train_s(state_s, *args)
    state_l, ml = train_l(state_l, *args)
    np.testing.assert_allclose(float(ms["loss"]), float(ml["loss"]), rtol=1e-5)


def test_parallel_scan_matches_stepwise():
    from recmodels.parallel import build_parallel_scan

    mesh = make_mesh(8)
    model = build_model("fm", SCH)
    eng = build_parallel_engine(model, mesh, emb_lr=5e-2, capacity_factor=4.0)
    s1 = shard_state(eng.init(jax.random.key(5)), mesh)
    s2 = shard_state(eng.init(jax.random.key(5)), mesh)
    step, _ = build_parallel_steps(eng, mesh, donate=False)
    scan = build_parallel_scan(eng, mesh, donate=False)

    batches = [_batch(b=64, seed=100 + i) for i in range(3)]
    for d, i, l in batches:
        s1, m1 = step(s1, d, i, l)
    xs = tuple(jnp.stack([b[k] for b in batches]) for k in range(3))
    s2, m2 = scan(s2, *xs)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["losses"][-1]), rtol=1e-6)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6),
        s1.emb_params,
        s2.emb_params,
    )


def test_sharded_bf16_matches_local_oracle():
    """bf16-compute models gather rows in bf16 on each owner shard before
    the return all_to_all; three steps must match the LocalTables path."""
    mesh = make_mesh(8)
    model = build_model("deepfm", SCH, hidden=(16,), compute_dtype=jnp.bfloat16)
    eng_s = build_parallel_engine(
        model, mesh, dense_lr=1e-2, emb_lr=5e-2, capacity_factor=4.0
    )
    state_s = shard_state(eng_s.init(jax.random.key(7)), mesh)
    train_s, _ = build_parallel_steps(eng_s, mesh, donate=False)

    eng_l = Engine(model, dense_lr=1e-2, emb_lr=5e-2)
    state_l = eng_l.init(jax.random.key(7))
    train_l = eng_l.jit_train_step(donate=False)

    for step_i in range(3):
        dense, ids, labels = _batch(b=64, seed=40 + step_i)
        state_s, ms = train_s(state_s, dense, ids, labels)
        state_l, ml = train_l(state_l, dense, ids, labels)
        np.testing.assert_allclose(float(ms["loss"]), float(ml["loss"]), rtol=1e-4)

    for cname, coll in eng_l.collections.items():
        for g in coll.groups:
            got = np.asarray(state_s.emb_params[cname][g.name])[: g.total_rows]
            want = np.asarray(state_l.emb_params[cname][g.name])[: g.total_rows]
            np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-4)
