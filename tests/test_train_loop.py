"""Trainer loop + CLI + config tests."""

import numpy as np
import jax

from recmodels.utils.config import TrainConfig
from recmodels.train.loop import Trainer
from recmodels.utils.logging import MetricsLogger


def _cfg(**kw):
    base = dict(
        model="fm",
        vocab_size=500,
        embed_dim=8,
        batch_size=256,
        steps=150,
        log_every=50,
        eval_every=150,
        eval_batches=5,
        emb_lr=5e-2,
        n_devices=1,
    )
    base.update(kw)
    return TrainConfig(**base)


def test_trainer_single_device_learns(tmp_path):
    t = Trainer(_cfg(tb_dir=None), logger=MetricsLogger())
    final = t.run()
    assert final["auc"] > 0.65


def test_trainer_sharded_8dev(tmp_path):
    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 fake devices")
    t = Trainer(_cfg(n_devices=8, capacity_factor=4.0))
    final = t.run()
    assert final["auc"] > 0.65


def test_trainer_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "run")
    # full run: 40 steps straight
    t1 = Trainer(_cfg(steps=40, eval_every=0, ckpt_dir=ckpt + "_a", ckpt_every=10))
    t1.run()
    # interrupted run: 20 steps, then a NEW trainer resumes to 40
    t2 = Trainer(_cfg(steps=20, eval_every=0, ckpt_dir=ckpt + "_b", ckpt_every=10))
    t2.run()
    t3 = Trainer(_cfg(steps=40, eval_every=0, ckpt_dir=ckpt + "_b", ckpt_every=10))
    t3.run()
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        t1.state,
        t3.state,
    )


def test_config_roundtrip_and_overrides():
    cfg = TrainConfig()
    s = cfg.to_json()
    cfg2 = TrainConfig.from_json(s)
    assert cfg == cfg2
    cfg3 = cfg.apply_overrides(["batch_size=64", "hidden=(8, 8)", "data='x.tsv'"])
    assert cfg3.batch_size == 64 and cfg3.hidden == (8, 8) and cfg3.data == "x.tsv"
    try:
        cfg.apply_overrides(["nope=1"])
        assert False
    except KeyError:
        pass


def test_cli_smoke(capsys):
    import train as cli

    rc = cli.main(
        [
            "--model", "lr", "--steps", "20", "--batch-size", "64", "--devices", "1",
            "--set", "vocab_size=200", "--set", "eval_every=20", "--set", "eval_batches=2",
            "--set", "log_every=10",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "done:" in out and "auc" in out


def test_grad_accumulation_matches_full_batch():
    """train_step_accum over A micro-batches == train_step on the
    concatenated batch (SURVEY.md §2c optional accumulation; up to f32
    summation order)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from recmodels.data import SyntheticSource, criteo_schema
    from recmodels.models import build_model
    from recmodels.train.engine import Engine

    sch = criteo_schema(vocab_size=500, embed_dim=8)
    for sparse_opt in ("adagrad", "adam"):
        eng = Engine(build_model("deepfm", sch, hidden=(32,)), dense_lr=1e-2,
                     emb_lr=5e-2, sparse_optimizer=sparse_opt)
        state_a = eng.init(jax.random.key(0))
        state_b = eng.init(jax.random.key(0))
        src = iter(SyntheticSource(sch, batch_size=64, seed=1))
        accum = jax.jit(eng.train_step_accum)
        full = jax.jit(eng.train_step)
        for _ in range(3):
            b = next(src)
            d = jnp.asarray(b.dense).reshape(2, 32, -1)
            i = jnp.asarray(b.ids).reshape(2, 32, -1)
            l = jnp.asarray(b.labels).reshape(2, 32)
            state_a, ma = accum(state_a, d, i, l)
            state_b, mb = full(state_b, jnp.asarray(b.dense), jnp.asarray(b.ids),
                               jnp.asarray(b.labels))
            np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                                       rtol=1e-5)
        # tolerance note: Adam's 1/(sqrt(v)+eps) amplifies f32
        # summation-order ulps on near-zero-v rows (observed: 1 element in
        # 120k at 0.3% rel after 3 steps); a real accumulation bug (wrong
        # 1/A scaling, dropped micro-batch) shifts everything by >=50%.
        for xa, xb in zip(jax.tree_util.tree_leaves(state_a),
                          jax.tree_util.tree_leaves(state_b)):
            np.testing.assert_allclose(np.asarray(xa, np.float32),
                                       np.asarray(xb, np.float32),
                                       rtol=5e-3, atol=1e-4)


def test_trainer_accum_steps_matches_full_batch():
    """The PRODUCT path: Trainer with accum_steps=4
    must train the same trajectory as accum_steps=1 on the identical stream
    (same total batch, split into micro-batches)."""
    t1 = Trainer(_cfg(steps=30, eval_every=30, producer_workers=1))
    f1 = t1.run()
    t2 = Trainer(_cfg(steps=30, eval_every=30, producer_workers=1, accum_steps=4))
    f2 = t2.run()
    assert abs(f1["auc"] - f2["auc"]) < 2e-3
    for xa, xb in zip(jax.tree.leaves(t1.state), jax.tree.leaves(t2.state)):
        np.testing.assert_allclose(np.asarray(xa, np.float32),
                                   np.asarray(xb, np.float32),
                                   rtol=5e-3, atol=1e-4)


def test_trainer_accum_steps_scan_and_sharded():
    """accum_steps composes with scan_steps, and with the sharded mesh."""
    t1 = Trainer(_cfg(steps=80, eval_every=80, scan_steps=4, accum_steps=2,
                      producer_workers=1))
    f1 = t1.run()
    assert f1["auc"] > 0.62
    if len(jax.devices()) >= 8:
        t2 = Trainer(_cfg(steps=80, eval_every=80, scan_steps=4, accum_steps=2,
                          n_devices=8, capacity_factor=4.0, producer_workers=1))
        f2 = t2.run()
        assert abs(f1["auc"] - f2["auc"]) < 5e-3
