"""The sparse optimizers' two XLA update routes against numpy oracles.

Routes: ``dense`` (``apply_dense``: scatter-add raw pairs into a full-table
grad, update every row) and ``dedup`` (``dedup_segment_sum`` + ``apply`` on
the touched rows). ``apply_updates`` picks one by ``choose_dense_update``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from recmodels.embedding.optim import (
    apply_updates,
    choose_dense_update,
    dedup_segment_sum,
    get_sparse_optimizer,
)

LR, EPS, B1, B2 = 0.05, 1e-8, 0.9, 0.999
# (optimizer, route) pairs that exist: lazy Adam has no dense route, and
# adam_dense's sparse entry point is its dense update
PAIRS = [("adagrad", "dense"), ("adagrad", "dedup"), ("adam", "dedup"), ("adam_dense", "dense")]
LAZY = PAIRS[:3]  # routes whose untouched rows never move


def _run_route(opt, route, table, state, ids, grads, step):
    ids, grads = jnp.asarray(ids), jnp.asarray(grads)
    if route == "dense":
        return opt.apply_dense(table, state, ids, grads, jnp.asarray(step), LR)
    uids, gsum, _ = dedup_segment_sum(ids, grads, table.shape[0])
    return opt.apply(table, state, uids, gsum, jnp.asarray(step), LR)


class _Oracle:
    """Dense numpy optimizer with the same semantics as each route."""

    def __init__(self, name, table):
        self.name, self.t = name, np.array(table, np.float64)
        self.acc = np.full_like(self.t, 0.1)
        self.m, self.v = np.zeros_like(self.t), np.zeros_like(self.t)

    def step(self, ids, grads, step):
        keep = ids < self.t.shape[0]  # sentinel ids update nothing
        g = np.zeros_like(self.t)
        np.add.at(g, ids[keep], grads[keep])
        if self.name == "adagrad":
            self.acc += g * g
            self.t -= LR * g / (np.sqrt(self.acc) + EPS)
            return
        rows = np.unique(ids[keep]) if self.name == "adam" else np.arange(self.t.shape[0])
        self.m[rows] = B1 * self.m[rows] + (1 - B1) * g[rows]
        self.v[rows] = B2 * self.v[rows] + (1 - B2) * g[rows] ** 2
        t = step + 1
        mh, vh = self.m[rows] / (1 - B1**t), self.v[rows] / (1 - B2**t)
        self.t[rows] -= LR * mh / (np.sqrt(vh) + EPS)


def _ids(kind, rows, n, rng):
    if kind == "unique":
        return rng.permutation(rows)[:n].astype(np.int32)
    return rng.choice([3, 17, rows - 1], size=n).astype(np.int32)  # heavy duplicates


@pytest.mark.parametrize("shape", [(64, 4), (64,)], ids=["2d", "1d"])
@pytest.mark.parametrize("ids_kind", ["unique", "duplicates"])
@pytest.mark.parametrize("opt_name,route", PAIRS)
def test_route_matches_numpy_oracle(opt_name, route, ids_kind, shape):
    rng = np.random.default_rng(0)
    rows, dim = shape[0], (shape[1] if len(shape) > 1 else 1)
    table0 = rng.normal(size=shape).astype(np.float32)
    opt = get_sparse_optimizer(opt_name)
    table, state = jnp.asarray(table0), opt.init(rows, dim)
    oracle = _Oracle(opt_name, table0)
    for step in range(3):
        ids = _ids(ids_kind, rows, 24, rng)
        grads = rng.normal(size=(24,) + shape[1:]).astype(np.float32)
        table, state = _run_route(opt, route, table, state, ids, grads, step)
        oracle.step(ids, grads, step)
    np.testing.assert_allclose(np.asarray(table), oracle.t, rtol=1e-5, atol=1e-6)
    if opt_name == "adagrad":
        np.testing.assert_allclose(np.asarray(state["acc"]), oracle.acc, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(np.asarray(state["m"]), oracle.m, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(state["v"]), oracle.v, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("opt_name,route", LAZY)
def test_route_leaves_untouched_rows_bitwise(opt_name, route):
    rng = np.random.default_rng(1)
    rows, dim = 256, 8
    table0 = rng.normal(size=(rows, dim)).astype(np.float32)
    opt = get_sparse_optimizer(opt_name)
    state0 = opt.init(rows, dim)
    ids = rng.integers(0, rows, size=40).astype(np.int32)
    grads = rng.normal(size=(40, dim)).astype(np.float32)
    table, state = _run_route(opt, route, jnp.asarray(table0), state0, ids, grads, 0)
    untouched = np.setdiff1d(np.arange(rows), ids)
    assert untouched.size > 100
    np.testing.assert_array_equal(np.asarray(table)[untouched], table0[untouched])
    for k in state:
        np.testing.assert_array_equal(
            np.asarray(state[k])[untouched], np.asarray(state0[k])[untouched])


@pytest.mark.parametrize("opt_name,route", LAZY)
def test_route_sentinel_padding_ids_are_noops(opt_name, route):
    """Ids equal to ``num_rows`` (padding sentinels) carry nonzero grads
    and must change nothing; pad rows beyond the logical vocab are never
    addressed and must stay exactly as they were."""
    rng = np.random.default_rng(2)
    rows, logical, dim = 128, 100, 4
    table0 = rng.normal(size=(rows, dim)).astype(np.float32)
    opt = get_sparse_optimizer(opt_name)
    real = rng.integers(0, logical, size=20).astype(np.int32)
    ids = np.concatenate([real, np.full(12, rows, np.int32)])
    grads = rng.normal(size=(32, dim)).astype(np.float32)
    got, st_got = _run_route(opt, route, jnp.asarray(table0), opt.init(rows, dim), ids, grads, 0)
    want, st_want = _run_route(opt, route, jnp.asarray(table0), opt.init(rows, dim),
                               real, grads[:20], 0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for k in st_got:
        np.testing.assert_array_equal(np.asarray(st_got[k]), np.asarray(st_want[k]))
    np.testing.assert_array_equal(np.asarray(got)[logical:], table0[logical:])


@pytest.mark.parametrize("rows,n,dense", [(256, 64, True), (1 << 16, 16, False)])
def test_apply_updates_takes_the_chosen_route(rows, n, dense):
    rng = np.random.default_rng(3)
    opt = get_sparse_optimizer("adagrad")
    assert choose_dense_update(rows, 4, n, True) is dense
    table = jnp.asarray(rng.normal(size=(rows, 4)).astype(np.float32))
    ids = rng.integers(0, rows, size=n).astype(np.int32)
    grads = rng.normal(size=(n, 4)).astype(np.float32)
    got, _ = apply_updates(opt, table, opt.init(rows, 4), jnp.asarray(ids),
                           jnp.asarray(grads, jnp.bfloat16), jnp.asarray(0), LR)
    grads32 = np.asarray(jnp.asarray(grads, jnp.bfloat16).astype(jnp.float32))
    want, _ = _run_route(opt, "dense" if dense else "dedup", table, opt.init(rows, 4),
                         ids, grads32, 0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
