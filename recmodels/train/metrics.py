"""Streaming, mergeable evaluation metrics: ROC-AUC and logloss.

The reference computes validation AUC/Loss by merging per-partition
``ValidationMethod`` partial results on the Spark driver (SURVEY.md §3.3).
The equivalent here must be a state that merges with ``psum`` across
the mesh: a fixed-bin score histogram (SURVEY.md §5.8, §7 hard part 6).

AUC from histograms: with positives/negatives histogrammed over K score
bins, AUC = P(s⁺ > s⁻) + ½P(s⁺ = s⁻) ≈
``Σ_k pos_k · (cumneg_{<k} + ½ neg_k) / (P·N)``. Bias vs exact AUC is
O(1/K); K=16384 keeps it far below the 1e-4 validation tolerance
(verified against sklearn-style exact AUC in tests/test_metrics.py).

Counts are INT32: f32 bin counts lose exact
increments past 2²⁴ (~16.7M) examples per bin — reachable on a
full-Criteo eval split concentrated in few bins. i32 accumulates exactly
to 2³¹ per bin (psum-safe — integer adds commute exactly across devices);
``auc_compute`` finalizes on the HOST in float64, so the only
approximation anywhere is the histogram binning itself. Example weights
(``auc_update(weight=...)``) must be 0/1 masks — they exist for tail-batch
padding (predict.py), not for fractional weighting.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_BINS = 16384


class AUCState(NamedTuple):
    """psum-mergeable streaming state for AUC + logloss."""

    pos_hist: jnp.ndarray  # i32 exact counts [K]
    neg_hist: jnp.ndarray  # i32 [K]
    loss_sum: jnp.ndarray  # f32 scalar Σ bce
    count: jnp.ndarray  # i32 scalar n


def auc_init(n_bins: int = DEFAULT_BINS) -> AUCState:
    return AUCState(
        pos_hist=jnp.zeros((n_bins,), jnp.int32),
        neg_hist=jnp.zeros((n_bins,), jnp.int32),
        loss_sum=jnp.zeros((), jnp.float32),
        count=jnp.zeros((), jnp.int32),
    )


def auc_update(
    state: AUCState, logits: jnp.ndarray, labels: jnp.ndarray, weight: jnp.ndarray | None = None
) -> AUCState:
    """Accumulate a batch. logits: [B]; labels: [B] in {0,1}; weight (if
    given): [B] 0/1 mask for padded tail rows."""
    n_bins = state.pos_hist.shape[0]
    p = jax.nn.sigmoid(logits)
    idx = jnp.clip((p * n_bins).astype(jnp.int32), 0, n_bins - 1)
    w = jnp.ones_like(labels) if weight is None else weight
    wi = w.astype(jnp.int32)
    li = (labels > 0.5).astype(jnp.int32)
    pos = jax.ops.segment_sum(li * wi, idx, num_segments=n_bins)
    neg = jax.ops.segment_sum((1 - li) * wi, idx, num_segments=n_bins)
    bce = jnp.maximum(logits, 0) - logits * labels + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    return AUCState(
        pos_hist=state.pos_hist + pos,
        neg_hist=state.neg_hist + neg,
        loss_sum=state.loss_sum + jnp.sum(bce * w.astype(bce.dtype)),
        count=state.count + jnp.sum(wi),
    )


def auc_merge(a: AUCState, b: AUCState) -> AUCState:
    return AUCState(*(x + y for x, y in zip(a, b)))


def auc_compute(state: AUCState) -> dict:
    """Finalize: {'auc', 'logloss', 'accuracy', 'count'} — HOST-side in
    float64 (exact given the exact i32 histograms; called once per eval,
    not jitted). Accuracy is at the 0.5 threshold — BigDL
    ``ValidationMethod`` family parity; derived from the same histograms,
    so it shares the O(1/K) binning tolerance."""
    pos = np.asarray(jax.device_get(state.pos_hist), np.float64)
    neg = np.asarray(jax.device_get(state.neg_hist), np.float64)
    total_pos = pos.sum()
    total_neg = neg.sum()
    cum_neg = np.cumsum(neg) - neg  # negatives strictly below this bin
    wins = float((pos * (cum_neg + 0.5 * neg)).sum())
    denom = max(total_pos * total_neg, 1.0)
    auc = wins / denom
    # denominator from the histogram sums, NOT state.count: the i32 scalar
    # wraps past 2^31 examples in one stream, while per-bin counts stay
    # exact. state.count is still reported for callers.
    count = float(total_pos + total_neg)
    logloss = float(jax.device_get(state.loss_sum)) / max(count, 1.0)
    half = state.pos_hist.shape[0] // 2  # bin index of score 0.5
    correct = pos[half:].sum() + neg[:half].sum()
    accuracy = correct / max(total_pos + total_neg, 1.0)
    return {"auc": np.float64(auc), "logloss": np.float64(logloss),
            "accuracy": np.float64(accuracy), "count": count}
