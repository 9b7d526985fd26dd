"""Interaction-op reference tests: math vs brute force + torch cross-checks
(SURVEY.md §4 item 2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from recmodels.ops import interactions as I


@pytest.fixture
def emb():
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.normal(size=(5, 7, 6)).astype(np.float32))


def test_fm_pairwise_matches_bruteforce(emb):
    e = np.asarray(emb)
    brute = np.zeros(e.shape[0], np.float32)
    f = e.shape[1]
    for i in range(f):
        for j in range(i + 1, f):
            brute += (e[:, i, :] * e[:, j, :]).sum(-1)
    got = np.asarray(I.fm_pairwise(emb))
    np.testing.assert_allclose(got, brute, rtol=1e-5, atol=1e-5)


def test_pnn_inner_matches_bruteforce(emb):
    e = np.asarray(emb)
    f = e.shape[1]
    cols = []
    for i in range(f):
        for j in range(i + 1, f):
            cols.append((e[:, i, :] * e[:, j, :]).sum(-1))
    brute = np.stack(cols, axis=1)
    got = np.asarray(I.pnn_inner_products(emb))
    np.testing.assert_allclose(got, brute, rtol=1e-5, atol=1e-5)


def test_pnn_outer_superposition(emb):
    e = np.asarray(emb)
    s = e.sum(1)
    brute = s[:, :, None] * s[:, None, :]
    got = np.asarray(I.pnn_outer_product(emb))
    np.testing.assert_allclose(got, brute, rtol=1e-5, atol=1e-5)


def test_dcn_cross_layer():
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.normal(size=(4, 9)).astype(np.float32))
    xl = jnp.asarray(rng.normal(size=(4, 9)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(9,)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(9,)).astype(np.float32))
    got = np.asarray(I.dcn_cross_layer(x0, xl, w, b))
    brute = np.asarray(x0) * (np.asarray(xl) @ np.asarray(w))[:, None] + np.asarray(b) + np.asarray(xl)
    np.testing.assert_allclose(got, brute, rtol=1e-5, atol=1e-5)


def test_cin_layer_matches_explicit_hadamard():
    rng = np.random.default_rng(2)
    b, h, m, d, hn = 3, 5, 4, 6, 7
    xk = rng.normal(size=(b, h, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    w = rng.normal(size=(hn, h, m)).astype(np.float32)
    # explicit: z[b,h,m,d] = xk[b,h,d]*x0[b,m,d]; out[b,n,d] = sum_{h,m} w[n,h,m] z
    z = xk[:, :, None, :] * x0[:, None, :, :]
    brute = np.einsum("bhmd,nhm->bnd", z, w)
    got = np.asarray(I.cin_layer(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w)))
    np.testing.assert_allclose(got, brute, rtol=1e-4, atol=1e-4)


def test_fm_pairwise_grads_finite_difference(emb):
    f = lambda e: jnp.sum(I.fm_pairwise(e))
    g = jax.grad(f)(emb)
    eps = 1e-3
    e0 = np.asarray(emb).copy()
    idx = (1, 2, 3)
    ep = e0.copy(); ep[idx] += eps
    em = e0.copy(); em[idx] -= eps
    fd = (float(f(jnp.asarray(ep))) - float(f(jnp.asarray(em)))) / (2 * eps)
    np.testing.assert_allclose(float(g[idx]), fd, rtol=1e-2)


def test_cin_vs_torch():
    torch = pytest.importorskip("torch")
    rng = np.random.default_rng(3)
    b, h, m, d, hn = 2, 4, 5, 8, 6
    xk = rng.normal(size=(b, h, d)).astype(np.float32)
    x0 = rng.normal(size=(b, m, d)).astype(np.float32)
    w = rng.normal(size=(hn, h, m)).astype(np.float32)
    txk, tx0, tw = map(torch.tensor, (xk, x0, w))
    # torch reference: einsum over the Hadamard tensor
    tz = txk[:, :, None, :] * tx0[:, None, :, :]
    tout = torch.einsum("bhmd,nhm->bnd", tz, tw)
    got = np.asarray(I.cin_layer(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w)))
    np.testing.assert_allclose(got, tout.numpy(), rtol=1e-4, atol=1e-4)


def test_fm_vs_torch():
    torch = pytest.importorskip("torch")
    rng = np.random.default_rng(4)
    e = rng.normal(size=(6, 26, 16)).astype(np.float32)
    te = torch.tensor(e)
    s = te.sum(1)
    tout = 0.5 * ((s * s).sum(1) - (te * te).sum(dim=(1, 2)))
    got = np.asarray(I.fm_pairwise(jnp.asarray(e)))
    np.testing.assert_allclose(got, tout.numpy(), rtol=1e-4, atol=1e-4)


def test_afm_pair_products_matches_triu_indexing():
    """the static-slice construction must equal the
    fancy-indexing form with np.triu pair order."""
    import numpy as np
    import jax.numpy as jnp
    from recmodels.ops import interactions as ops

    rng = np.random.default_rng(0)
    b, f, d = 8, 7, 5
    emb = jnp.asarray(rng.normal(size=(b, f, d)).astype(np.float32))
    fi, fj = np.triu_indices(f, k=1)
    want = np.asarray(emb)[:, fi, :] * np.asarray(emb)[:, fj, :]
    got = np.asarray(ops.afm_pair_products(emb))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------------
# Every op the models call, against a naive per-element numpy loop and
# through jax.test_util.check_grads (the gradient rule XLA differentiates).

B, F, D, H1, H2 = 3, 4, 5, 3, 2


def _naive_fm(e):
    out = np.zeros(e.shape[0])
    for b in range(e.shape[0]):
        for i in range(e.shape[1]):
            for j in range(i + 1, e.shape[1]):
                out[b] += np.dot(e[b, i], e[b, j])
    return out


def _naive_dcn(x0, w, b):
    out = np.zeros_like(x0)
    for n in range(x0.shape[0]):
        xl = x0[n].copy()
        for l in range(w.shape[0]):
            xl = x0[n] * np.dot(xl, w[l]) + b[l] + xl
        out[n] = xl
    return out


def _naive_inner(e):
    return np.array([[np.dot(e[b, i], e[b, j]) for i in range(e.shape[1])
                      for j in range(i + 1, e.shape[1])] for b in range(e.shape[0])])


def _naive_outer(e):
    out = np.zeros((e.shape[0], e.shape[2], e.shape[2]))
    for b in range(e.shape[0]):
        for i in range(e.shape[1]):
            for j in range(e.shape[1]):
                out[b] += np.outer(e[b, i], e[b, j])
    return out


def _naive_cin_layer(xk, x0, w):
    bsz, hk, d = xk.shape
    out = np.zeros((bsz, w.shape[0], d))
    for b in range(bsz):
        for n in range(w.shape[0]):
            for h in range(hk):
                for i in range(x0.shape[1]):
                    out[b, n] += w[n, h, i] * xk[b, h] * x0[b, i]
    return out


def _naive_cin_stack_dm_flat(x0_dm, w2s):
    x0 = np.swapaxes(x0_dm, 1, 2)
    m, xk, pools = x0.shape[1], x0, []
    for w2 in w2s:
        hk, hn = w2.shape[0], w2.shape[1] // m
        w = np.zeros((hn, hk, m))
        for h in range(hk):
            for i in range(m):
                for n in range(hn):
                    w[n, h, i] = w2[h, i * hn + n]
        xk = _naive_cin_layer(xk, x0, w)
        pools.append(xk.sum(axis=2))
    return np.concatenate(pools, axis=1)


def _naive_split(full):
    x_dm = np.zeros((full.shape[0], D, full.shape[1]))
    for b in range(full.shape[0]):
        for s in range(full.shape[1]):
            x_dm[b, :, s] = full[b, s, :D]
    return x_dm, full[:, :, D].sum(axis=1)


def _case(name, rng):
    """(jnp fn, args, naive numpy fn) for one op."""
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    if name == "fm_pairwise":
        return I.fm_pairwise, (r(B, F, D),), _naive_fm
    if name == "dcn_cross_stack":
        return I.dcn_cross_stack, (r(B, D), r(3, D) * 0.3, r(3, D)), _naive_dcn
    if name == "pnn_inner_products":
        return I.pnn_inner_products, (r(B, F, D),), _naive_inner
    if name == "pnn_outer_product":
        return I.pnn_outer_product, (r(B, F, D),), _naive_outer
    if name == "cin_layer":
        return I.cin_layer, (r(B, H1, D), r(B, F, D), r(H2, H1, F)), _naive_cin_layer
    if name == "cin_stack_dm_flat":
        fn = lambda x, wa, wb: I.cin_stack_dm_flat(x, [wa, wb])
        naive = lambda x, wa, wb: _naive_cin_stack_dm_flat(x, [wa, wb])
        return fn, (r(B, D, F), r(F, F * H1), r(H1, F * H2)), naive
    if name == "split_fused_rows":
        fn = lambda full: I.split_fused_rows(full, D)
        return fn, (r(B, F, D + 1),), _naive_split
    raise KeyError(name)


OPS = ["fm_pairwise", "dcn_cross_stack", "pnn_inner_products", "pnn_outer_product",
       "cin_layer", "cin_stack_dm_flat", "split_fused_rows"]


@pytest.mark.parametrize("name", OPS)
def test_reference_matches_naive_loop(name):
    fn, args, naive = _case(name, np.random.default_rng(11))
    got = jax.tree.leaves(fn(*map(jnp.asarray, args)))
    want = jax.tree.leaves(naive(*[a.astype(np.float64) for a in args]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", OPS)
def test_reference_gradients(name):
    from jax.test_util import check_grads

    fn, args, _ = _case(name, np.random.default_rng(12))
    scalar = lambda *a: sum(jnp.sum(jnp.sin(x)) for x in jax.tree.leaves(fn(*a)))
    check_grads(scalar, tuple(map(jnp.asarray, args)), order=1, modes=("rev",))
