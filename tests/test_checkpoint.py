"""Checkpoint/resume: bit-identical continuation after restore
(SURVEY.md §5.3 'asserts bitwise-identical resume')."""

import numpy as np
import jax
import jax.numpy as jnp

from recmodels.data import SyntheticSource, criteo_schema
from recmodels.models import build_model
from recmodels.train.checkpoint import CheckpointManager
from recmodels.train.engine import Engine

SCH = criteo_schema(vocab_size=700, embed_dim=8)


def _args(b):
    return jnp.asarray(b.dense), jnp.asarray(b.ids), jnp.asarray(b.labels)


def test_save_restore_resume_bitwise(tmp_path):
    model = build_model("fm", SCH)
    eng = Engine(model, dense_lr=1e-2, emb_lr=5e-2)
    state = eng.init(jax.random.key(0))
    step = eng.jit_train_step(donate=False)
    src = SyntheticSource(SCH, batch_size=64, seed=0)
    it = iter(src)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=1)
    for i in range(5):
        state, _ = step(state, *_args(next(it)))
    mgr.save(5, state, data_state=src.state())
    mgr.wait()

    # continue original run 3 more steps
    cont_state = state
    for i in range(3):
        cont_state, _ = step(cont_state, *_args(next(it)))

    # fresh process simulation: new engine, restore, re-run the same 3 steps
    eng2 = Engine(model, dense_lr=1e-2, emb_lr=5e-2)
    abstract = eng2.init(jax.random.key(1))  # different rng: values overwritten
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr2.latest_step() == 5
    restored, data_state = mgr2.restore(abstract)
    assert int(restored.step) == 5
    src2 = SyntheticSource(SCH, batch_size=64, seed=0)
    src2.set_state(data_state)
    it2 = iter(src2)
    step2 = eng2.jit_train_step(donate=False)
    for i in range(3):
        restored, _ = step2(restored, *_args(next(it2)))

    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        cont_state,
        restored,
    )
    mgr.close()
    mgr2.close()


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    model = build_model("lr", SCH)
    eng = Engine(model)
    try:
        mgr.restore(eng.init(jax.random.key(0)))
        assert False, "should raise"
    except FileNotFoundError:
        pass


def test_cross_geometry_restore_local_to_sharded_and_reshard(tmp_path):
    """geometry-changing restores route through the
    canonical 2-D form — local -> 8-shard and 8-shard -> 4-shard both
    reproduce the source model's logits (padded_rows depends on n_shards,
    so the array SHAPES differ across geometries)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from recmodels.data import SyntheticSource, criteo_schema
    from recmodels.models import build_model
    from recmodels.parallel import (
        build_parallel_engine, build_parallel_steps, make_mesh, shard_state,
    )
    from recmodels.train.checkpoint import CheckpointManager
    from recmodels.train.engine import Engine

    sch = criteo_schema(vocab_size=700, embed_dim=8)
    model = build_model("fm", sch)
    eng_l = Engine(model, dense_lr=1e-2, emb_lr=5e-2)
    state_l = eng_l.init(jax.random.key(0))
    src = iter(SyntheticSource(sch, batch_size=64, seed=1))
    ts = eng_l.jit_train_step()
    for _ in range(3):
        b = next(src)
        state_l, _ = ts(state_l, jnp.asarray(b.dense), jnp.asarray(b.ids),
                        jnp.asarray(b.labels))
    b = next(src)
    dense, ids = jnp.asarray(b.dense), jnp.asarray(b.ids)
    want = np.asarray(eng_l.logits(state_l, dense, ids))

    mgr = CheckpointManager(str(tmp_path / "ckpt_local"), save_interval_steps=1)
    mgr.save(int(state_l.step), jax.device_get(state_l), {"cursor": 7})
    mgr.wait()

    # ---- local -> 8-shard ----
    mesh8 = make_mesh(8)
    eng_8 = build_parallel_engine(build_model("fm", sch), mesh8,
                                  dense_lr=1e-2, emb_lr=5e-2,
                                  capacity_factor=4.0)
    tgt8 = shard_state(eng_8.init(jax.random.key(1)), mesh8)
    assert (tgt8.emb_params["emb"]["d9"].shape
            != state_l.emb_params["emb"]["d9"].shape)  # geometry truly differs
    st8, data = mgr.restore_cross_geometry(tgt8)
    assert data == {"cursor": 7}
    assert int(st8.step) == int(state_l.step)
    _, eval8 = build_parallel_steps(eng_8, mesh8, donate=False)
    got8 = np.asarray(_sharded_logits(eng_8, mesh8, st8, dense, ids))
    np.testing.assert_allclose(got8, want, rtol=1e-5, atol=1e-5)

    # ---- 8-shard -> 4-shard ----
    mgr8 = CheckpointManager(str(tmp_path / "ckpt_8"), save_interval_steps=1)
    mgr8.save(int(st8.step), jax.device_get(st8), {})
    mgr8.wait()
    mesh4 = make_mesh(4)
    eng_4 = build_parallel_engine(build_model("fm", sch), mesh4,
                                  dense_lr=1e-2, emb_lr=5e-2,
                                  capacity_factor=4.0)
    tgt4 = shard_state(eng_4.init(jax.random.key(2)), mesh4)
    assert (tgt4.emb_params["emb"]["d9"].shape
            != tgt8.emb_params["emb"]["d9"].shape)
    st4, _ = mgr8.restore_cross_geometry(tgt4)
    got4 = np.asarray(_sharded_logits(eng_4, mesh4, st4, dense, ids))
    np.testing.assert_allclose(got4, want, rtol=1e-5, atol=1e-5)
    mgr.close(); mgr8.close()


def _sharded_logits(eng, mesh, state, dense, ids):
    import jax
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map

    from recmodels.parallel import state_specs

    fn = shard_map(
        lambda st, d, i: eng.logits(st, d, i), mesh=mesh,
        in_specs=(state_specs(state), P("data"), P("data")),
        out_specs=P("data"),
        check_rep=False,
    )
    return jax.jit(fn)(state, dense, ids)
