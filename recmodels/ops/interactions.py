"""Feature-interaction ops — jnp reference implementations.

These are the model zoo's interaction layers (SURVEY.md §2b): the FM
second-order term, DCN explicit cross layers, PNN inner/outer product layers
and xDeepFM's CIN. The models call them directly, and they are the ground
truth any future hand-written kernel is tested against (SURVEY.md §4
item 1).

All ops take embeddings as ``[B, F, D]`` (batch, field/slot, embed dim).
Per-slot-dim schemas are zero-padded to the max dim upstream — zero padding
is exact for every op here (sums/dots of zero rows contribute nothing),
which is the documented resolution of SURVEY.md §7 hard part 4.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def fm_pairwise(emb: jnp.ndarray) -> jnp.ndarray:
    """FM second-order term via the sum-square identity (Rendle 2010).

    ``0.5 * sum_d [(sum_f e_fd)^2 - sum_f e_fd^2]`` — O(F*D), not O(F^2*D).
    emb: [B, F, D] -> [B].
    """
    s = jnp.sum(emb, axis=1)  # [B, D]
    sq = jnp.sum(emb * emb, axis=(1, 2))  # [B]
    return 0.5 * (jnp.sum(s * s, axis=1) - sq)


def dcn_cross_layer(x0: jnp.ndarray, xl: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """One DCN cross layer (arXiv:1708.05123): x_{l+1} = x0 * (xl . w) + b + xl.

    x0, xl: [B, d]; w, b: [d]. The rank-1 structure means the whole layer is
    one dot + one broadcast multiply — an elementwise-dominated (VPU) op.
    """
    xw = jnp.einsum("bd,d->b", xl, w)  # [B]
    return x0 * xw[:, None] + b[None, :] + xl


def triu_pair_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Static upper-triangle (i<j) index pair arrays for F fields."""
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def pnn_inner_products(emb: jnp.ndarray) -> jnp.ndarray:
    """IPNN product signal (arXiv:1611.00144): p_ij = <e_i, e_j> for i<j.

    emb: [B, F, D] -> [B, F*(F-1)/2]. Computed as the full Gram matrix
    ``G = emb @ emb^T`` (a [F, D] x [D, F] batched matmul)
    then gathering the static upper triangle.
    """
    gram = jnp.einsum("bfd,bgd->bfg", emb, emb)  # [B, F, F]
    fi, fj = triu_pair_indices(emb.shape[1])
    return gram[:, fi, fj]


def pnn_outer_product(emb: jnp.ndarray) -> jnp.ndarray:
    """OPNN superposition trick (arXiv:1611.00144 §3.2): p = f_Σ f_Σ^T.

    emb: [B, F, D] -> [B, D, D] where f_Σ = Σ_f e_f. Collapses the O(F²D²)
    pairwise outer products to one rank-1 outer per example.
    """
    s = jnp.sum(emb, axis=1)  # [B, D]
    return s[:, :, None] * s[:, None, :]


def cin_layer(xk: jnp.ndarray, x0: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """One CIN layer (arXiv:1803.05170 eq. 6).

    xk: [B, H_k, D] (previous layer), x0: [B, m, D] (field matrix),
    w: [H_next, H_k, m] -> [B, H_next, D]:

        X^{k+1}_{n,d} = Σ_{h,i} w_{n,h,i} * xk_{h,d} * x0_{i,d}

    The jnp reference contracts without materializing the [B, H_k, m, D]
    Hadamard tensor: for each d, (w reshaped [H_next, H_k*m]) @ vec(outer of
    column d). XLA maps this einsum onto batched matmuls (SURVEY.md §7
    hard part 5).
    """
    # [B, D, H_k, m] outer products per depth slice, contracted immediately.
    # f32 accumulation regardless of input dtype.
    out = jnp.einsum("bhd,bid,nhi->bnd", xk, x0, w, preferred_element_type=jnp.float32)
    return out.astype(xk.dtype)


def cin_sum_pool(xk: jnp.ndarray) -> jnp.ndarray:
    """Per-feature-map sum pooling over D: [B, H, D] -> [B, H]."""
    return jnp.sum(xk, axis=2)


def cin_stack(x0: jnp.ndarray, ws) -> jnp.ndarray:
    """Full CIN: x0 [B, m, D], ws = [w_k: [H_k, H_{k-1}, m]] -> pooled
    concat [B, sum_k H_k] (each layer sum-pooled over D)."""
    xk = x0
    pools = []
    for w in ws:
        xk = cin_layer(xk, x0, w)
        pools.append(cin_sum_pool(xk))
    return jnp.concatenate(pools, axis=1)


def cin_stack_dm(x0_dm: jnp.ndarray, ws) -> jnp.ndarray:
    """CIN from a D-major field matrix: x0_dm [B, D, m] -> pooled concat.
    Same math as ``cin_stack`` (reference), different input orientation."""
    return cin_stack(jnp.swapaxes(x0_dm, 1, 2), ws)


# ------------------------------------------------------------- flat weights
# xDeepFM stores each CIN weight FLAT 2-D [H_k, m*H_next] with column
# (i*H_next + n) = w[n, h, i] (the layout docs/KERNELS.md's algebra uses).


def flatten_cin_w(w: jnp.ndarray) -> jnp.ndarray:
    """[H_next, H_k, m] -> flat [H_k, m*H_next]."""
    hn, hk, m = w.shape
    return jnp.transpose(w, (1, 2, 0)).reshape(hk, m * hn)


def unflatten_cin_w(w2: jnp.ndarray, m: int) -> jnp.ndarray:
    """Inverse of ``flatten_cin_w``: [H_k, m*H_next] -> [H_next, H_k, m]."""
    hk = w2.shape[0]
    hn = w2.shape[1] // m
    return jnp.transpose(w2.reshape(hk, m, hn), (2, 0, 1))


def cin_stack_flat(x0: jnp.ndarray, w2s) -> jnp.ndarray:
    """``cin_stack`` with flat weights [H_k, m*H_next]."""
    m = x0.shape[1]
    return cin_stack(x0, [unflatten_cin_w(w2, m) for w2 in w2s])


def cin_stack_dm_flat(x0_dm: jnp.ndarray, w2s) -> jnp.ndarray:
    """``cin_stack_dm`` with flat weights."""
    return cin_stack_flat(jnp.swapaxes(x0_dm, 1, 2), w2s)


def split_fused_rows(full: jnp.ndarray, emb_dim: int):
    """Fanout for wide-fused rows [B, m, D+1] -> (x_dm [B, D, m],
    wide_sum [B] f32): the embedding vectors transposed to D-major plus the
    summed first-order column."""
    x_dm = jnp.swapaxes(full[..., :emb_dim], 1, 2)
    ws = jnp.sum(full[..., emb_dim].astype(jnp.float32), axis=1)
    return x_dm, ws


def fm_bi_interaction(emb: jnp.ndarray) -> jnp.ndarray:
    """NFM bi-interaction pooling (arXiv:1708.05027 eq. 4): the FM pairwise
    term BEFORE the final sum over dims — ``0.5[(Σ_f e)² − Σ_f e²]`` per dim.
    emb: [B, F, D] -> [B, D]. (``fm_pairwise == sum(fm_bi_interaction, -1)``.)"""
    s = jnp.sum(emb, axis=1)
    return 0.5 * (s * s - jnp.sum(emb * emb, axis=1))


def afm_pair_products(emb: jnp.ndarray) -> jnp.ndarray:
    """AFM pairwise element-wise products (arXiv:1708.04617 §3):
    p_ij = e_i ∘ e_j for i<j. emb: [B, F, D] -> [B, F(F-1)/2, D].

    Built from STATIC slices (row i of the triangle is e_i ∘ e_{i+1:}), not
    ``emb[:, fi, :]`` fancy indexing — the latter lowers to two [B, P, D]
    XLA gathers over the slot axis (the slice/concat form is gather-free
    and fuses; pair order is np.triu_indices row-major either way, pinned
    by tests)."""
    f = emb.shape[1]
    rows = [emb[:, i : i + 1, :] * emb[:, i + 1 :, :] for i in range(f - 1)]
    return jnp.concatenate(rows, axis=1)


def dcn_cross_stack(x0: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All L cross layers: x0 [B, d], w [L, d], b [L, d] -> x_L [B, d]."""
    xl = x0
    for l in range(w.shape[0]):
        xl = dcn_cross_layer(x0, xl, w[l], b[l])
    return xl
