"""Model-zoo tests: shapes, overfit-a-tiny-batch, LR vs sklearn-style
closed form (SURVEY.md §4 item 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from recmodels.data import SyntheticSource, criteo_schema
from recmodels.models import MODEL_REGISTRY, build_model
from recmodels.train.engine import Engine

SMALL = criteo_schema(vocab_size=200, embed_dim=8)

MODEL_KW = {
    "lr": {},
    "fm": {},
    "deepfm": {"hidden": (32, 32)},
    "pnn": {"hidden": (32, 32), "mode": "both"},
    "dcn": {"hidden": (32,), "n_cross": 3},
    "xdeepfm": {"hidden": (32,), "cin_sizes": (16, 16)},
    "widedeep": {"hidden": (32, 32)},
    "nfm": {"hidden": (32,)},
    "afm": {"attention_dim": 8},
}


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_forward_shapes_and_finiteness(name):
    model = build_model(name, SMALL, **MODEL_KW[name])
    eng = Engine(model)
    state = eng.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    dense = jnp.asarray(rng.normal(size=(7, 13)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, 200, size=(7, 26)).astype(np.int32))
    logits = eng.logits(state, dense, ids)
    assert logits.shape == (7,)
    assert np.isfinite(np.asarray(logits)).all()


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_overfit_small_batch(name):
    """Every model drives training loss well below chance on a fixed batch."""
    model = build_model(name, SMALL, **MODEL_KW[name])
    eng = Engine(model, dense_lr=3e-3, emb_lr=5e-2, sparse_optimizer="adagrad")
    state = eng.init(jax.random.key(1))
    step = eng.jit_train_step()
    src = SyntheticSource(SMALL, batch_size=256, seed=7)
    batch = next(iter(src))
    dense = jnp.asarray(batch.dense)
    ids = jnp.asarray(batch.ids)
    labels = jnp.asarray(batch.labels)
    first = None
    for i in range(300):
        state, m = step(state, dense, ids, labels)
        if first is None:
            first = float(m["loss"])
    last = float(m["loss"])
    assert np.isfinite(last)
    assert last < 0.45, f"{name}: loss {first:.3f} -> {last:.3f} did not overfit"


def test_lr_matches_dense_logistic_regression():
    """LR on one-hot-able data == plain logistic regression (closed-form-ish:
    compare against a numpy GD implementation with identical updates)."""
    sch = criteo_schema(vocab_size=50, embed_dim=8)
    model = build_model("lr", sch)
    eng = Engine(model, dense_optimizer="sgd", dense_lr=0.1, sparse_optimizer="adagrad", emb_lr=0.1)
    state = eng.init(jax.random.key(0))
    step = eng.jit_train_step()
    rng = np.random.default_rng(3)
    n = 128
    dense = rng.normal(size=(n, 13)).astype(np.float32)
    ids = rng.integers(0, 50, size=(n, 26)).astype(np.int32)
    labels = (rng.random(n) < 0.4).astype(np.float32)
    # numpy replica of the same model/optimizers
    w_dense = np.zeros(13, np.float32)
    bias = 0.0
    tables = np.zeros((26, 50), np.float32)  # per-slot weights
    acc = np.full((26, 50), 0.1, np.float32)
    for it in range(10):
        state, _ = step(state, jnp.asarray(dense), jnp.asarray(ids), jnp.asarray(labels))
        # numpy step
        logits = bias + dense @ w_dense + tables[np.arange(26)[None, :], ids].sum(1)
        p = 1 / (1 + np.exp(-logits))
        g = (p - labels) / n
        gw = dense.T @ g
        gb = g.sum()
        gt = np.zeros_like(tables)
        for s in range(26):
            np.add.at(gt[s], ids[:, s], g)
        w_dense -= 0.1 * gw
        bias -= 0.1 * gb
        acc += gt * gt
        tables -= 0.1 * gt / (np.sqrt(acc) + 1e-8)
    got_logits = np.asarray(eng.logits(state, jnp.asarray(dense), jnp.asarray(ids)))
    ref_logits = bias + dense @ w_dense + tables[np.arange(26)[None, :], ids].sum(1)
    np.testing.assert_allclose(got_logits, ref_logits, rtol=2e-4, atol=2e-4)


def test_deepfm_shares_tables_between_parts():
    model = build_model("deepfm", SMALL, hidden=(16,))
    schemas = model.embedding_schemas()
    assert set(schemas) == {"wide", "emb"}  # exactly one vector collection
    # zeroing the emb activation must kill both FM-second-order AND DNN signal
    eng = Engine(model)
    state = eng.init(jax.random.key(0))
    dense = jnp.zeros((2, 13))
    emb0 = {"wide": jnp.zeros((2, 26, 1)), "emb": jnp.zeros((2, 26, 8))}
    out = model.apply(state.dense_params, dense, emb0)
    assert out.shape == (2,)


def test_per_slot_dims_models_run():
    dims = [4] * 13 + [8] * 13
    sch = criteo_schema(vocab_size=100, embed_dim=dims)
    for name in ("pnn", "dcn", "xdeepfm"):
        model = build_model(name, sch, **MODEL_KW[name])
        eng = Engine(model)
        state = eng.init(jax.random.key(0))
        rng = np.random.default_rng(0)
        dense = jnp.asarray(rng.normal(size=(3, 13)).astype(np.float32))
        ids = jnp.asarray(rng.integers(0, 100, size=(3, 26)).astype(np.int32))
        logits = eng.logits(state, dense, ids)
        assert np.isfinite(np.asarray(logits)).all()


def test_bench_configs_expressible_via_trainconfig():
    """every bench.py MODEL_KW config must be reproducible
    from a TrainConfig (i.e. via `train.py --set`), so benched models are
    trainable from the CLI with identical architecture."""
    import importlib.util
    import os

    from recmodels.utils.config import TrainConfig

    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(os.path.dirname(__file__), "..", "bench.py")
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    remap = {"mode": "pnn_mode"}  # bench kw name -> TrainConfig field
    for model, kw in bench.MODEL_KW.items():
        fields = {remap.get(k, k): v for k, v in kw.items()}
        cfg = TrainConfig(model=model, **fields)
        got = cfg.model_kwargs()
        for k, v in kw.items():
            assert k in got, f"{model}: {k} not plumbed through TrainConfig"
            assert got[k] == (tuple(v) if isinstance(v, (list, tuple)) else v), (
                model, k, got[k], v)
        # and the config round-trips through JSON (ckpt-dir reproducibility)
        assert TrainConfig.from_json(cfg.to_json()).model_kwargs() == got
