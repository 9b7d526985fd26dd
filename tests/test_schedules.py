"""LR schedules + dense weight decay (reference parity: BigDL OptimMethod
LearningRateSchedule family and per-layer L2 regularizers, SURVEY.md §2a
#11)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from recmodels.data import SyntheticSource, criteo_schema
from recmodels.models import build_model
from recmodels.train.engine import Engine
from recmodels.train.schedules import build_lr_schedule


def test_constant_returns_float():
    assert build_lr_schedule(0.1) == 0.1
    assert build_lr_schedule(0.1, "constant", warmup_steps=0) == 0.1


def test_warmup_ramps_then_holds():
    s = build_lr_schedule(0.1, "constant", warmup_steps=10)
    assert float(s(0)) == 0.0
    assert float(s(5)) == pytest.approx(0.05)
    assert float(s(10)) == pytest.approx(0.1)
    assert float(s(1000)) == pytest.approx(0.1)


def test_linear_decays_to_end_scale():
    s = build_lr_schedule(0.2, "linear", total_steps=100, end_scale=0.1)
    assert float(s(0)) == pytest.approx(0.2)
    assert float(s(100)) == pytest.approx(0.02)


def test_cosine_peak_and_end():
    s = build_lr_schedule(0.2, "cosine", warmup_steps=10, total_steps=100,
                          end_scale=0.05)
    assert float(s(0)) == pytest.approx(0.0)
    assert float(s(10)) == pytest.approx(0.2)
    assert float(s(100)) == pytest.approx(0.01, rel=1e-3)


def test_exponential_decay():
    s = build_lr_schedule(0.1, "exponential", decay_rate=0.5, decay_every=10)
    assert float(s(0)) == pytest.approx(0.1)
    assert float(s(10)) == pytest.approx(0.05)
    assert float(s(20)) == pytest.approx(0.025)


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        build_lr_schedule(0.1, "step")


def _train(engine, steps=20, batch=128):
    schema = engine.model.schema
    state = engine.init(jax.random.key(0))
    ts = engine.jit_train_step()
    it = iter(SyntheticSource(schema, batch_size=batch, seed=1))
    for _ in range(steps):
        b = next(it)
        state, m = ts(state, jnp.asarray(b.dense), jnp.asarray(b.ids),
                      jnp.asarray(b.labels))
    return state, float(m["loss"])


def test_engine_trains_with_schedules():
    schema = criteo_schema(vocab_size=500, embed_dim=8)
    model = build_model("deepfm", schema, hidden=(16,))
    sched = build_lr_schedule(1e-3, "cosine", warmup_steps=5, total_steps=20)
    emb_sched = build_lr_schedule(5e-2, "cosine", warmup_steps=5, total_steps=20)
    eng = Engine(model, dense_lr_schedule=sched, emb_lr_schedule=emb_sched)
    _, loss = _train(eng)
    assert np.isfinite(loss) and loss < 0.75


def test_weight_decay_shrinks_dense_params():
    schema = criteo_schema(vocab_size=500, embed_dim=8)

    def run(wd):
        model = build_model("deepfm", schema, hidden=(16,))
        eng = Engine(model, dense_weight_decay=wd)
        state, loss = _train(eng, steps=50)
        norm = sum(
            float(jnp.sum(x.astype(jnp.float32) ** 2))
            for x in jax.tree.leaves(state.dense_params)
        )
        return norm, loss

    n0, l0 = run(0.0)
    n1, l1 = run(0.1)
    assert n1 < n0  # decay pulls dense weights toward zero
    assert np.isfinite(l1) and l1 < 0.75  # and training still works


def test_trainer_wires_schedules():
    from recmodels.train.loop import Trainer
    from recmodels.utils.config import TrainConfig

    cfg = TrainConfig(model="fm", vocab_size=500, embed_dim=8, steps=8,
                      batch_size=64, lr_schedule="cosine", warmup_steps=2,
                      dense_weight_decay=0.01, eval_every=0, log_every=100,
                      n_devices=1)
    t = Trainer(cfg)
    assert t.engine.dense_lr_schedule is not None
    assert t.engine.emb_lr_schedule is not None
    t.run()  # converging end-to-end is covered above; this checks plumbing
