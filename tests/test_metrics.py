"""Streaming AUC/logloss vs exact computations (SURVEY.md §7 hard part 6:
histogram-AUC bias must stay below 1e-4)."""

import numpy as np
import jax.numpy as jnp

from recmodels.train.metrics import auc_compute, auc_init, auc_merge, auc_update


def exact_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """O(n log n) exact ROC-AUC via rank statistic (ties -> midranks)."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    r = np.arange(1, len(scores) + 1, dtype=np.float64)
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = r[i : j + 1].mean()
        i = j + 1
    pos = labels == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def logistic(x):
    return 1.0 / (1.0 + np.exp(-x))


def test_streaming_auc_matches_exact():
    rng = np.random.default_rng(0)
    n = 20000
    labels = (rng.random(n) < 0.3).astype(np.float32)
    # informative but noisy scores
    logits = (labels * 1.2 - 0.6 + rng.normal(0, 1.0, n)).astype(np.float32)
    state = auc_init()
    # stream in 7 uneven chunks
    for chunk in np.array_split(np.arange(n), 7):
        state = auc_update(state, jnp.asarray(logits[chunk]), jnp.asarray(labels[chunk]))
    out = auc_compute(state)
    ref = exact_auc(logistic(logits), labels)
    assert abs(float(out["auc"]) - ref) < 1e-4
    # logloss vs direct mean BCE
    p = logistic(logits)
    ref_ll = -np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p))
    np.testing.assert_allclose(float(out["logloss"]), ref_ll, rtol=1e-5)
    assert float(out["count"]) == n


def test_auc_merge_is_exactly_additive():
    rng = np.random.default_rng(1)
    n = 4000
    labels = (rng.random(n) < 0.5).astype(np.float32)
    logits = rng.normal(0, 2, n).astype(np.float32)
    full = auc_update(auc_init(), jnp.asarray(logits), jnp.asarray(labels))
    a = auc_update(auc_init(), jnp.asarray(logits[: n // 2]), jnp.asarray(labels[: n // 2]))
    b = auc_update(auc_init(), jnp.asarray(logits[n // 2 :]), jnp.asarray(labels[n // 2 :]))
    merged = auc_merge(a, b)
    np.testing.assert_allclose(
        float(auc_compute(merged)["auc"]), float(auc_compute(full)["auc"]), atol=1e-7
    )


def test_degenerate_single_class_does_not_nan():
    out = auc_compute(auc_update(auc_init(), jnp.zeros(10), jnp.ones(10)))
    assert np.isfinite(float(out["auc"]))


def test_accuracy_from_histograms():
    import numpy as np
    import jax.numpy as jnp
    from recmodels.train import metrics as M

    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.normal(scale=2.0, size=(4096,)).astype(np.float32))
    labels = jnp.asarray((rng.random(4096) < 0.4).astype(np.float32))
    st = M.auc_update(M.auc_init(), logits, labels)
    out = M.auc_compute(st)
    p = 1.0 / (1.0 + np.exp(-np.asarray(logits)))
    want = np.mean((p >= 0.5) == (np.asarray(labels) > 0.5))
    assert abs(float(out["accuracy"]) - want) < 2e-3  # binning tolerance


def test_counts_exact_past_2pow24():
    """i32 histograms accumulate exactly past 2^24 per bin.
    Constructs a state at 20M counts per bin directly, then verifies a
    single additional example still moves the count and the f64 finalize
    is exact."""
    import jax.numpy as jnp
    from recmodels.train import metrics as M

    big = 20_000_000  # > 2**24: f32 would absorb +1 into rounding
    st = M.AUCState(
        pos_hist=jnp.zeros((M.DEFAULT_BINS,), jnp.int32).at[100].set(big),
        neg_hist=jnp.zeros((M.DEFAULT_BINS,), jnp.int32).at[50].set(big),
        loss_sum=jnp.zeros((), jnp.float32),
        count=jnp.asarray(2 * big, jnp.int32),
    )
    # one more positive scoring into a high bin: exact increment
    st2 = M.auc_update(st, jnp.asarray([4.0]), jnp.asarray([1.0]))
    assert int(st2.count) == 2 * big + 1
    assert int(jnp.sum(st2.pos_hist)) == big + 1
    out = M.auc_compute(st2)
    # all negatives sit strictly below all positives -> AUC exactly 1
    assert out["auc"] == 1.0
    # f32 control: the same +1 would have been lost
    assert np.float32(big) + np.float32(1.0) == np.float32(big)
