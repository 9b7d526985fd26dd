"""End-to-end CI drill on the checked-in REAL-FORMAT Criteo TSV fixture:
train -> checkpoint -> export -> predict, all through the
product entry points' code paths. The fixture is 96 dac-format rows
(label \t 13 ints with gaps \t 26 8-hex tokens with gaps); the day the full
dataset is reachable, docs/CRITEO.md's one-command invocation runs this
exact pipeline at scale."""

import os

import numpy as np

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "criteo_sample.tsv")


def test_fixture_trains_checkpoints_exports_predicts(tmp_path):
    import jax

    from recmodels.serve import export_from_checkpoint, load_predictor
    from recmodels.train.loop import Trainer
    from recmodels.utils.config import TrainConfig

    ckpt_dir = str(tmp_path / "run")
    cfg = TrainConfig(
        model="deepfm", hidden=(32, 32), vocab_size=2000, embed_dim=8,
        data=FIXTURE, batch_size=32, steps=8, scan_steps=2, log_every=4,
        eval_every=4, eval_batches=2, ckpt_dir=ckpt_dir, ckpt_every=4,
        n_devices=1, seed=0,
    )
    tr = Trainer(cfg)
    final = tr.run()
    assert np.isfinite(final["logloss"])
    assert tr.ckpt.latest_step() == cfg.steps
    tr.ckpt.close()

    # export the checkpoint as a serving artifact
    art = str(tmp_path / "artifact")
    export_from_checkpoint(ckpt_dir, art)
    pred = load_predictor(art, min_bucket=32)

    # score the fixture itself; parity vs the live engine's logits
    from recmodels.data import CriteoTSVSource
    from recmodels.train.loop import build_schema

    src = CriteoTSVSource(FIXTURE, build_schema(cfg), batch_size=96)
    b = next(iter(src))
    got = pred.predict_logits(b.dense, b.ids)
    want = np.asarray(jax.jit(tr.engine.logits)(
        tr.state, np.asarray(b.dense), np.asarray(b.ids)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # probabilities sane
    p = pred.predict_proba(b.dense, b.ids)
    assert np.all((p > 0) & (p < 1))
