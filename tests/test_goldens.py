"""Fixed-seed regression goldens (SURVEY.md §4 item 4): a deterministic
400-step run must reproduce the recorded validation AUC/logloss. Guards the
whole numerical stack — hashing, init, interaction math, optimizers,
metrics — against silent drift. Tolerance covers CPU fp reassociation
across XLA versions, not semantic change."""

import pytest

from recmodels.train.loop import Trainer
from recmodels.utils.config import TrainConfig

GOLDENS = {
    # recorded 2026-08-17 (fm, xdeepfm) / 2026-08-19 (rest) on CPU backend,
    # jax 0.9.0, after wide-column fusion (which changes init RNG stream
    # consumption — re-pin goldens whenever the init stream intentionally
    # changes). xdeepfm_bf16 pins the flagship bench's actual compute dtype
    # against f32 drift.
    "fm": {"auc": 0.780055, "logloss": 0.592241},
    "xdeepfm": {"auc": 0.787954, "logloss": 0.560821},
    "lr": {"auc": 0.787772, "logloss": 0.589657},
    "deepfm": {"auc": 0.785176, "logloss": 0.563252},
    "pnn": {"auc": 0.787036, "logloss": 0.558047},
    "dcn": {"auc": 0.788326, "logloss": 0.55889},
    "widedeep": {"auc": 0.788162, "logloss": 0.558975},
    "nfm": {"auc": 0.78792, "logloss": 0.590233},
    "afm": {"auc": 0.78777, "logloss": 0.589658},
    "xdeepfm_bf16": {"auc": 0.787581, "logloss": 0.561356},
}


def _golden_cfg(model: str) -> TrainConfig:
    bf16 = model.endswith("_bf16")
    return TrainConfig(
        model=model[: -len("_bf16")] if bf16 else model,
        bf16=bf16,
        vocab_size=2000,
        embed_dim=8,
        batch_size=256,
        steps=400,
        log_every=1000,
        eval_every=400,
        eval_batches=10,
        emb_lr=5e-2,
        dense_lr=2e-3,
        n_devices=1,
        seed=123,
        hidden=(64, 64),
        cin_sizes=(16, 16),
    )


@pytest.mark.slow
@pytest.mark.parametrize("model", sorted(GOLDENS))
def test_fixed_seed_golden(model):
    out = Trainer(_golden_cfg(model)).run()
    g = GOLDENS[model]
    assert abs(out["auc"] - g["auc"]) < 2e-3, (out, g)
    assert abs(out["logloss"] - g["logloss"]) < 4e-3, (out, g)


def test_bf16_matches_f32_quality():
    """The bf16 flagship golden must sit within loose tolerance of the f32
    one — guards against a bf16-specific numerical regression going
    unnoticed because only the bf16 golden is re-pinned."""
    f32, b16 = GOLDENS["xdeepfm"], GOLDENS["xdeepfm_bf16"]
    assert abs(f32["auc"] - b16["auc"]) < 3e-3, (f32, b16)
    assert abs(f32["logloss"] - b16["logloss"]) < 5e-3, (f32, b16)


@pytest.mark.slow
def test_debug_nans_clean_run():
    """SURVEY.md §5.2 sanitizer lane: a short train run under
    ``jax.debug_nans`` + ``jax.enable_checks`` must produce no NaN/Inf in
    any jitted computation (checks fire inside every primitive)."""
    import jax

    cfg = TrainConfig(
        model="xdeepfm",
        vocab_size=1000,
        embed_dim=8,
        batch_size=128,
        steps=30,
        log_every=100,
        eval_every=30,
        eval_batches=2,
        n_devices=1,
        seed=7,
        hidden=(32, 32),
        cin_sizes=(8, 8),
    )
    with jax.debug_nans(True), jax.enable_checks(True):
        out = Trainer(cfg).run()
    assert 0.0 < out["logloss"] < 10.0
