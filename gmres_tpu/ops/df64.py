"""Double-float (two-fp32) vector math — the ``df64`` INNER precision tier.

This module represents an fp64-quality vector as an (hi, lo) fp32 pair
(``hi + lo`` with ``|lo| <= ulp(hi)/2``, unit roundoff ~2^-48) and
implements the GMRES inner loop's vector algebra on pairs with error-free
transformations — pure jnp, so it fuses under XLA on any backend and
inside shard_map.

This powers ``PrecisionSpec(df64_inner=True)`` (mode ``"df64"``): a
beyond-reference 5th precision configuration giving fp64-class
convergence from fp32 arithmetic.  The scalar O(m^2) machinery (H,
Givens, trsv) stays true fp64 — it is tiny.  Operators stay plain fp64:
``spmv_df64_pair`` merges the pair, multiplies in fp64 and splits again.

Reductions use a pairwise halving tree of df64 additions (error growth
O(log n) * 2^-48); distributed reductions all_gather the per-shard PAIR
partials and tree-sum them in df64 — a plain psum of hi parts would
collapse the tier to fp32 accuracy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1: Veltkamp split constant for fp32


def split_f64(x) -> tuple[jax.Array, jax.Array]:
    """fp64 array -> (hi, lo) fp32 pair with x == hi + lo exactly
    (up to double rounding of the tail)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def merge_f64(hi, lo):
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    # requires |a| >= |b|
    s = a + b
    err = b - (s - a)
    return s, err


def _two_prod(a, b):
    p = a * b
    ca = _SPLIT * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = _SPLIT * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def df_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return _quick_two_sum(p, e)


def df_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    e = e + al + bl
    return _quick_two_sum(s, e)


def promote_f32(x: jax.Array):
    """Exact f32 -> df64 pair."""
    return x, jnp.zeros_like(x)


def df_sub(ah, al, bh, bl):
    return df_add(ah, al, -bh, -bl)


def df_scale(h, l, sh, sl):
    """Pair * scalar-pair (broadcast)."""
    return df_mul(h, l, jnp.broadcast_to(sh, h.shape),
                  jnp.broadcast_to(sl, h.shape))


def df_sum(h, l, axis: int = -1):
    """Sum along ``axis`` via a pairwise halving tree of df64 adds
    (static shapes; log2(n) fused vector passes)."""
    h = jnp.moveaxis(h, axis, -1)
    l = jnp.moveaxis(l, axis, -1)
    n = h.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad = [(0, 0)] * (h.ndim - 1) + [(0, p - n)]
        h = jnp.pad(h, pad)
        l = jnp.pad(l, pad)
    while h.shape[-1] > 1:
        half = h.shape[-1] // 2
        h, l = df_add(h[..., :half], l[..., :half],
                      h[..., half:], l[..., half:])
    return h[..., 0], l[..., 0]


def _psum_pairs(sh, sl, axis_name):
    """Cross-shard reduction of df64 partials: all_gather the (hi, lo)
    pairs and tree-sum in df64 (psum of hi parts alone would round each
    cross-shard add to fp32)."""
    stacked = jax.lax.all_gather(jnp.stack([sh, sl]), axis_name)  # (P, 2, ...)
    return df_sum(stacked[:, 0], stacked[:, 1], axis=0)


def df_dot(ah, al, bh, bl, axis_name=None):
    """<a, b> over the last axis in df64; returns an fp64 scalar (exact
    merge of the pair — the consumer scalar algebra is fp64)."""
    ph, pl = df_mul(ah, al, bh, bl)
    sh, sl = df_sum(ph, pl, axis=-1)
    if axis_name is not None:
        sh, sl = _psum_pairs(sh, sl, axis_name)
    return merge_f64(sh, sl)


def df_norm(h, l, axis_name=None):
    return jnp.sqrt(df_dot(h, l, h, l, axis_name))


def df_gram(Vh, Vl, wh, wl, axis_name=None):
    """u[j] = <V_j, w> for every basis row, in df64.  Returns an fp64
    vector of length m+1 (the Hessenberg column consumer is fp64)."""
    ph, pl = df_mul(Vh, Vl, wh[None, :], wl[None, :])
    sh, sl = df_sum(ph, pl, axis=-1)
    if axis_name is not None:
        sh, sl = _psum_pairs(sh, sl, axis_name)
    return merge_f64(sh, sl)


def df_basis_comb(Vh, Vl, y64):
    """sum_j y_j V_j in df64 (y is fp64, split per coefficient)."""
    yh, yl = split_f64(y64)
    ph, pl = df_mul(Vh, Vl, yh[:, None], yl[:, None])
    return df_sum(ph, pl, axis=0)


def df_update(wh, wl, Vh, Vl, u64):
    """w - sum_j u_j V_j in df64 (the CGS/MGS elimination update)."""
    ch, cl = df_basis_comb(Vh, Vl, u64)
    return df_sub(wh, wl, ch, cl)


def spmv_df64_pair(A, xh, xl, axis_name=None):
    """y = A @ x on an (hi, lo) operand pair, returning a pair: exact
    merge, fp64 SpMV, exact split."""
    from gmres_tpu.ops.spmv import spmv

    y = spmv(A, merge_f64(xh, xl), axis_name)
    return split_f64(y.astype(jnp.float64))


def df_cgs(Vh, Vl, wh, wl, axis_name=None):
    """One classical Gram-Schmidt pass in df64 (zero-tail invariant: rows
    beyond k of V are zero, so no masking is needed — the Arnoldi loop's
    contract, ops/orth.py)."""
    u = df_gram(Vh, Vl, wh, wl, axis_name)
    wh, wl = df_update(wh, wl, Vh, Vl, u)
    return u, wh, wl


def df_mgs(Vh, Vl, k, wh, wl, axis_name=None):
    """Modified Gram-Schmidt in df64: k+1 sequential pair-dot/axpy steps
    (operation-sequence parity with ``Orthogonalization.hpp:91-107``)."""
    m1 = Vh.shape[0]
    h = jnp.zeros((m1,), jnp.float64)

    def body(j, carry):
        h, wh, wl = carry
        vjh = jax.lax.dynamic_index_in_dim(Vh, j, axis=0, keepdims=False)
        vjl = jax.lax.dynamic_index_in_dim(Vl, j, axis=0, keepdims=False)
        hj = df_dot(wh, wl, vjh, vjl, axis_name)
        ph, pl = df_scale(vjh, vjl, *split_f64(hj))
        wh, wl = df_sub(wh, wl, ph, pl)
        return h.at[j].set(hj), wh, wl

    h, wh, wl = jax.lax.fori_loop(0, k + 1, body, (h, wh, wl))
    return h, wh, wl


def df_mgs_lowsync_step(Vh, Vl, k, wh, wl, L, axis_name):
    """One-reduce ICWY MGS step on (hi, lo) pairs — the df64 analog of
    ``ops/orth.py:mgs_lowsync_step`` (Świrydowicz et al., NLAA 2020).

    Both grams of the step (V^T w for the projection, V^T v_k for row k
    of the coupling matrix L) are computed locally in df64 and reduced in
    ONE batched pair-psum; the unit-lower-triangular correction solve
    runs in plain fp64 (the scalar machinery's dtype).  Returns
    ``(h_f64, (wh, wl), (ssh, ssl), L')`` with the sum of squares of the
    projected vector as a LOCAL df64 pair — callers psum it for the norm
    (the step's only other reduction).
    """
    m1 = Vh.shape[0]
    vkh = jax.lax.dynamic_index_in_dim(Vh, k, axis=0, keepdims=False)
    vkl = jax.lax.dynamic_index_in_dim(Vl, k, axis=0, keepdims=False)
    # local pair-grams, batched into one reduction payload (2, m+1)
    pwh, pwl = df_mul(Vh, Vl, wh[None, :], wl[None, :])
    swh, swl = df_sum(pwh, pwl, axis=-1)
    pvh, pvl = df_mul(Vh, Vl, vkh[None, :], vkl[None, :])
    svh, svl = df_sum(pvh, pvl, axis=-1)
    Sh = jnp.stack([swh, svh])
    Sl = jnp.stack([swl, svl])
    if axis_name is not None:
        Sh, Sl = _psum_pairs(Sh, Sl, axis_name)
    P = merge_f64(Sh, Sl)                                   # (2, m+1) f64
    u = P[0]                          # V^T w; rows > k are zero already
    ell = jnp.where(jnp.arange(m1) < k, P[1], 0.0)
    L = jax.lax.dynamic_update_slice(
        L, ell[None, :], (jnp.asarray(k, jnp.int32), jnp.int32(0)))
    h = jax.scipy.linalg.solve_triangular(
        L, u, lower=True, unit_diagonal=True  # diagonal never read
    )
    wh, wl = df_update(wh, wl, Vh, Vl, h)   # exact: w' = w - sum h_j v_j
    sh, sl = df_sum(*df_mul(wh, wl, wh, wl), axis=-1)
    return h, (wh, wl), (sh, sl), L


def df_orthonormalize_step(kind: str, Vh, Vl, k, wh, wl, axis_name=None,
                           orth_steps: int = 2):
    """Orthogonalize + norm in df64: ``(h_col_f64, (wh, wl), h_next_f64)``
    — the df64 analog of ``ops/orth.py:orthonormalize_step``."""
    if kind == "mgs":
        h, wh, wl = df_mgs(Vh, Vl, k, wh, wl, axis_name)
    elif kind == "cgs":
        h, wh, wl = df_cgs(Vh, Vl, wh, wl, axis_name)
    elif kind == "cgsr":
        h, wh, wl = df_cgs(Vh, Vl, wh, wl, axis_name)
        for _ in range(orth_steps - 1):
            u, wh, wl = df_cgs(Vh, Vl, wh, wl, axis_name)
            h = h + u
    else:
        raise ValueError(f"unknown orthogonalization {kind!r}")
    h_next = df_norm(wh, wl, axis_name)
    return h, (wh, wl), h_next


def typesafe_apply_df64(M, wh, wl, axis_name=None):
    """Preconditioner application on a df64 pair with the reference's
    typesafe round-trip semantics (``gmres.cpp:12-22``): fp32
    preconditioners see the correctly-rounded fp32 value (the hi part of
    a normalized pair) and their result promotes exactly; other dtypes
    round-trip through true fp64."""
    from gmres_tpu.precond.apply import apply_preconditioner, typesafe_apply
    from gmres_tpu.precond.build import IdentityPrec

    if isinstance(M, IdentityPrec):
        return wh, wl
    m_dtype = M.inv_diag.dtype
    if m_dtype == jnp.float32:
        return promote_f32(
            apply_preconditioner(M, wh, axis_name)
        )
    w = merge_f64(wh, wl)
    return split_f64(typesafe_apply(M, w, axis_name))
