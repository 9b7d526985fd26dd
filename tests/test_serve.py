"""Model export / load / forward-only serving (recmodels.serve) —
parity with the reference's Module.saveModule/loadModule + predict path
(SURVEY.md §2a #15, §3.3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from recmodels.data import SyntheticSource
from recmodels.serve import Predictor, export_model, load_predictor
from recmodels.train.engine import Engine
from recmodels.train.loop import Trainer, build_schema
from recmodels.models import build_model
from recmodels.utils.config import TrainConfig


def _train_a_bit(cfg, steps=30):
    schema = build_schema(cfg)
    model = build_model(cfg.model, schema, **cfg.model_kwargs())
    eng = Engine(model, dense_lr=1e-3, emb_lr=5e-2)
    state = eng.init(jax.random.key(0))
    ts = eng.jit_train_step()
    it = iter(SyntheticSource(schema, batch_size=256, seed=1))
    for _ in range(steps):
        b = next(it)
        state, _ = ts(state, jnp.asarray(b.dense), jnp.asarray(b.ids),
                      jnp.asarray(b.labels))
    return eng, state, schema


@pytest.mark.parametrize("model,kw", [
    ("deepfm", {"hidden": (32, 32)}),
    ("xdeepfm", {"cin_sizes": (8, 8), "hidden": (16,)}),  # list-of-arrays tree
])
def test_export_load_roundtrip_exact(tmp_path, model, kw):
    cfg = TrainConfig(model=model, vocab_size=1000, embed_dim=8,
                      hidden=kw.get("hidden", (32,)),
                      cin_sizes=kw.get("cin_sizes", (8, 8)))
    eng, state, schema = _train_a_bit(cfg)
    out = str(tmp_path / "artifact")
    export_model(out, cfg, eng, jax.device_get(state))
    pred = load_predictor(out, min_bucket=64)

    b = next(iter(SyntheticSource(schema, batch_size=64, seed=9)))
    # jit the reference too: eager op-by-op f32 differs from the compiled
    # graph by fusion ulps; two identical jitted graphs are bit-exact
    want = np.asarray(
        jax.jit(eng.logits)(state, jnp.asarray(b.dense), jnp.asarray(b.ids))
    )
    got = pred.predict_logits(b.dense, b.ids)
    np.testing.assert_array_equal(got, want)  # same f32 math, bit-exact


def test_predictor_ragged_batches(tmp_path):
    cfg = TrainConfig(model="fm", vocab_size=500, embed_dim=8)
    eng, state, schema = _train_a_bit(cfg, steps=5)
    out = str(tmp_path / "artifact")
    export_model(out, cfg, eng, jax.device_get(state))
    pred = load_predictor(out, min_bucket=16)

    b = next(iter(SyntheticSource(schema, batch_size=64, seed=3)))
    full = pred.predict_proba(b.dense, b.ids)
    for n in (1, 7, 16, 33):  # ragged sizes pad to buckets, outputs slice
        part = pred.predict_proba(b.dense[:n], b.ids[:n])
        assert part.shape == (n,)
        np.testing.assert_allclose(part, full[:n], rtol=1e-6, atol=1e-6)
    assert np.all((full > 0) & (full < 1))


def test_structure_mismatch_rejected(tmp_path):
    cfg = TrainConfig(model="deepfm", vocab_size=500, embed_dim=8, hidden=(16,))
    eng, state, _ = _train_a_bit(cfg, steps=2)
    out = str(tmp_path / "artifact")
    export_model(out, cfg, eng, jax.device_get(state))
    # doctor the config to a structurally different model
    import json, os
    p = os.path.join(out, "model.json")
    d = json.loads(open(p).read())
    d["hidden"] = [16, 16]  # extra MLP layer -> different dense tree
    open(p, "w").write(json.dumps(d))
    with pytest.raises(ValueError, match="structure mismatch"):
        load_predictor(out)


def test_export_from_checkpoint_cli(tmp_path):
    """End-to-end: train.py-style run with a checkpoint -> export.py ->
    predictor scores (exercises the restore + canonicalize path)."""
    ckpt = str(tmp_path / "run")
    cfg = TrainConfig(model="deepfm", vocab_size=500, embed_dim=8,
                      hidden=(16,), steps=12, batch_size=128, log_every=50,
                      eval_every=0, ckpt_dir=ckpt, ckpt_every=10,
                      n_devices=1)
    t = Trainer(cfg)
    t.run()

    from recmodels.serve import export_from_checkpoint

    out = str(tmp_path / "artifact")
    export_from_checkpoint(ckpt, out)
    pred = load_predictor(out, min_bucket=32)
    schema = build_schema(cfg)
    b = next(iter(SyntheticSource(schema, batch_size=32, seed=5)))
    probs = pred(b.dense, b.ids)
    assert probs.shape == (32,) and np.all(np.isfinite(probs))


def test_predict_cli_model_dir(tmp_path):
    """predict.py --model-dir scores a serving artifact end to end."""
    import subprocess, sys, os
    ckpt = str(tmp_path / "run")
    cfg = TrainConfig(model="fm", vocab_size=500, embed_dim=8, steps=10,
                      batch_size=128, log_every=50, eval_every=0,
                      ckpt_dir=ckpt, ckpt_every=10, n_devices=1)
    Trainer(cfg).run()
    from recmodels.serve import export_from_checkpoint
    art = str(tmp_path / "artifact")
    export_from_checkpoint(ckpt, art)
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    out = subprocess.run(
        [sys.executable, "predict.py", "--cpu", "--model-dir", art,
         "--data", "synthetic", "--max-batches", "3"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "auc=" in out.stdout + out.stderr
