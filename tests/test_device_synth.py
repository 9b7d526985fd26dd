"""Device-resident synthetic stream (data/device_synth.py): learnability
goldens + Trainer integration (the product loop at device rate without a
host producer)."""

import numpy as np
import jax
import jax.numpy as jnp

from recmodels.data import criteo_schema
from recmodels.data.device_synth import make_device_batch_fn
from recmodels.train.loop import Trainer
from recmodels.utils.config import TrainConfig


def test_device_batch_shapes_and_determinism():
    sch = criteo_schema(vocab_size=1000, embed_dim=8)
    fn = jax.jit(make_device_batch_fn(sch, 256, seed=3))
    d1, i1, l1 = fn(jnp.asarray(5, jnp.int32))
    d2, i2, l2 = fn(jnp.asarray(5, jnp.int32))
    d3, i3, l3 = fn(jnp.asarray(6, jnp.int32))
    assert d1.shape == (256, sch.n_dense) and i1.shape == (256, sch.n_slots)
    assert l1.shape == (256,) and i1.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    assert not np.array_equal(np.asarray(i1), np.asarray(i3))
    # ids within vocab ranges
    vs = np.asarray(sch.vocab_sizes)
    ids = np.asarray(i1)
    assert (ids >= 0).all() and (ids < vs[None, :]).all()
    # dense is log1p(gamma): positive, plausible scale
    dd = np.asarray(d1)
    assert (dd >= 0).all() and 2.0 < dd.mean() < 5.0
    # labels balanced-ish (planted logit is centered)
    assert 0.3 < np.asarray(l1).mean() < 0.7


def test_trainer_device_synth_learns(tmp_path):
    """Same AUC band as the host SyntheticSource drive (verify skill: val
    AUC > 0.70 for deepfm at these settings)."""
    cfg = TrainConfig(model="deepfm", hidden=(128, 128), vocab_size=5000,
                      embed_dim=16, batch_size=512, steps=300, scan_steps=10,
                      log_every=100, eval_every=300, eval_batches=20,
                      dense_lr=1e-3, emb_lr=5e-2, n_devices=1,
                      data="device_synth")
    t = Trainer(cfg)
    final = t.run()
    assert final["auc"] > 0.70, final
    assert int(t.state.step) == 300


def test_trainer_device_synth_resume(tmp_path):
    ckpt = str(tmp_path / "ds")
    base = dict(model="fm", vocab_size=500, embed_dim=8, batch_size=128,
                steps=40, scan_steps=5, eval_every=0, log_every=20,
                emb_lr=5e-2, n_devices=1, data="device_synth",
                ckpt_every=10)
    t1 = Trainer(TrainConfig(**{**base, "ckpt_dir": ckpt + "_a"}))
    t1.run()
    t2 = Trainer(TrainConfig(**{**base, "steps": 20, "ckpt_dir": ckpt + "_b"}))
    t2.run()
    t3 = Trainer(TrainConfig(**{**base, "ckpt_dir": ckpt + "_b"}))
    t3.run()
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        t1.state, t3.state,
    )
