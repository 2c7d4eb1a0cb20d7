"""Orthogonalization kernels: CGS, MGS, CGSR.

Operation-sequence parity with ``Orthogonalization.hpp:76-136`` (see
SURVEY.md §2.4), recast for a row-stored Krylov basis ``V`` of static shape
``(m+1, n_local)`` inside a jitted loop:

- the growing column range ``V[:, 0:k+1]`` of the reference becomes a
  masked full-width product (static shapes; the O(m/k) overcompute trades
  FLOPs for an XLA-friendly dataflow);
- CGS is two basis matvecs and **one** allreduce per Arnoldi step; MGS is
  k+1 sequential dot/axpy pairs (k+1 allreduces) — the reason CGS/CGSR are
  the defaults at scale, consistent with the paper's GPU findings.
  Distributed MGS defaults to the one-reduce ICWY reformulation
  (``mgs_lowsync_step``; cfg.low_sync_mgs) so its allreduce count matches
  CGS without giving up MGS-grade orthogonality;
- CGSR re-runs the CGS pass ``orth_steps-1`` more times, accumulating the
  correction weights into h (``Orthogonalization.hpp:129-134``).

Accumulation happens in (at least) float32 regardless of the storage dtype:
bfloat16 bases are upcast around the product/reduction — accumulating a
length-n reduction in bf16 would destroy orthogonality.  Every float32
product states ``precision=HIGHEST``: without it the GPU may run it in
TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gmres_tpu.ops.blas import dot

_HI = jax.lax.Precision.HIGHEST


def _acc(x: jax.Array) -> jax.Array:
    """Upcast sub-fp32 storage to fp32 for accumulation (fp32/fp64 pass
    through — jnp reductions already accumulate exactly in those dtypes)."""
    return x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x


def _masked_gram(V: jax.Array, w: jax.Array, k, axis_name, mask=True):
    """u[j] = <v_j, w> for j <= k, 0 elsewhere.  One psum when sharded.

    Formulated as an elementwise product + row reduction rather than a
    matmul: XLA fuses it into one pass over V, and the elementwise form
    keeps true fp32/fp64 accumulation semantics (no TF32 path exists).

    ``mask=False`` skips the explicit j<=k masking — valid whenever the
    basis rows beyond k are still zero (true inside the Arnoldi loop, where
    row k+1 is written only after orthogonalization).  The orth-loss
    recurrence reads V *after* the row write and must keep the mask.
    """
    u = jnp.sum(_acc(V) * _acc(w)[None, :], axis=1).astype(w.dtype)
    if mask:
        u = jnp.where(jnp.arange(V.shape[0]) <= k, u, 0)
    if axis_name is not None:
        u = jax.lax.psum(u, axis_name)
    return u


def cgs(V, k, w, axis_name=None, assume_zero_tail=False):
    """Classical Gram-Schmidt (``Orthogonalization.hpp:76-89``).

    ``assume_zero_tail=True`` skips the j<=k masking; only valid when rows
    k+1..m of V are zero (the Arnoldi-loop invariant).
    """
    u = _masked_gram(V, w, k, axis_name, mask=not assume_zero_tail)
    w = (_acc(w) - jnp.sum(_acc(u)[:, None] * _acc(V), axis=0)).astype(w.dtype)
    return u, w


def mgs(V, k, w, axis_name=None, assume_zero_tail=False):
    """Modified Gram-Schmidt (``Orthogonalization.hpp:91-107``): sequential
    dot+naxpy pairs, one per basis vector.

    Distributed MGS rides the one-reduce ICWY path by default
    (``mgs_lowsync_step``); with ``cfg.low_sync_mgs=False`` this rolled
    form applies, where each h_j needs its own psum before the update
    (k+1 allreduces per step).  ``assume_zero_tail`` is accepted for a
    uniform signature; the loop runs only over rows 0..k anyway."""
    m1 = V.shape[0]
    h = jnp.zeros((m1,), dtype=w.dtype)

    def body(j, carry):
        h, w = carry
        vj = V[j]
        if jnp.bfloat16 in (V.dtype, w.dtype):
            hj_f = jnp.sum(_acc(w) * _acc(vj))
            if axis_name is not None:
                hj_f = jax.lax.psum(hj_f, axis_name)
            hj = hj_f.astype(w.dtype)
        else:
            hj = dot(w, vj, axis_name)
        w = (_acc(w) - _acc(hj) * _acc(vj)).astype(w.dtype)
        return h.at[j].set(hj), w

    h, w = jax.lax.fori_loop(0, k + 1, body, (h, w))
    return h, w


def mgs_lowsync_step(V, k, w, L, axis_name):
    """One low-synchronization MGS Arnoldi step (ICWY / one-reduce MGS).

    Classic MGS needs k+1 *sequential* allreduces per Arnoldi step (each
    h_j is a global dot on the already-updated w) — the latency term that
    makes distributed MGS the slow orthogonalization at scale
    (``Orthogonalization.hpp:91-107`` is inherently sequential).  The
    inverse-compact-WY reformulation (Świrydowicz, Langou, Ananthan,
    Yamazaki, Thomas, *Low-synchronization orthogonalization schemes for
    s-step and pipelined Krylov solvers*, NLAA 2020) observes that the MGS
    projection is, to first order in the orthogonality loss,

        h = (I + L_k)^{-1} V_k^T w,   L_k = strict lower tri of V_k^T V_k,

    and L can be maintained one row per step from the SAME reduction that
    computes V^T w: one batched psum of the (m+1, 2) matrix V @ [w, v_k]
    replaces the k+1 scalar psums.  The correction solve is a unit lower
    triangular (m+1)x(m+1) system — tiny, local, and the orthogonality
    loss stays O(eps * kappa) like true MGS (ibid., Thm 3.1/experiments).

    Args: ``V`` (m+1, n_local) with rows > k zero (Arnoldi invariant),
    ``w`` the vector to project, ``L`` the running (m+1, m+1) strict
    lower-triangular coupling matrix in the accumulation dtype, ``k`` the
    current step.  Returns ``(h, w', ss_local, L')``: projection
    coefficients (w.dtype, zero beyond k), the projected vector, the
    LOCAL sum of squares of w' (callers psum it for the norm — the only
    other reduction of the step), and L with row k filled in.
    """
    at = L.dtype  # accumulation dtype (f32 for bf16/f32 bases, f64 for f64)
    m1 = V.shape[0]

    Vf = _acc(V).astype(at)
    v_k = jax.lax.dynamic_index_in_dim(Vf, k, axis=0, keepdims=False)
    ops = jnp.stack([_acc(w).astype(at), v_k], axis=0)          # (2, n)
    if at == jnp.float64:
        # fp64 keeps the elementwise product + row reduction of
        # _masked_gram; whether the einsum form is faster on the GPU is
        # not measured yet
        P = jnp.sum(Vf[:, None, :] * ops[None, :, :], axis=2)   # (m+1, 2)
    else:
        P = jnp.einsum("jn,cn->jc", Vf, ops, precision=_HI)      # (m+1, 2)
    if axis_name is not None:
        P = jax.lax.psum(P, axis_name)
    u = P[:, 0]                       # V^T w; rows > k are zero already
    ell = jnp.where(jnp.arange(m1) < k, P[:, 1], 0)  # strict row k of V^T V
    L = jax.lax.dynamic_update_slice(
        L, ell[None, :], (jnp.asarray(k, jnp.int32), jnp.int32(0)))
    # rows > k of L are still zero and u is zero there, so solving the full
    # static-shape unit-lower-triangular system leaves h[j>k] = 0;
    # unit_diagonal means the solver never reads L's (zero) diagonal
    h = jax.scipy.linalg.solve_triangular(
        L, u, lower=True, unit_diagonal=True
    )
    if at == jnp.float64:  # same form as the gram above
        wf = ops[0] - jnp.sum(h[:, None] * Vf, axis=0)
    else:
        wf = ops[0] - jnp.einsum("j,jn->n", h, Vf, precision=_HI)
    ss_local = jnp.sum(wf * wf)
    return h.astype(w.dtype), wf.astype(w.dtype), ss_local, L


def cgsr(V, k, w, axis_name=None, orth_steps: int = 2, assume_zero_tail=False):
    """CGS with re-orthogonalization (``Orthogonalization.hpp:109-136``)."""
    h, w = cgs(V, k, w, axis_name, assume_zero_tail)
    for _ in range(orth_steps - 1):
        u, w = cgs(V, k, w, axis_name, assume_zero_tail)
        h = h + u
    return h, w


def orthogonalize(kind: str, V, k, w, axis_name=None, orth_steps: int = 2,
                  assume_zero_tail=False):
    if kind == "cgs":
        return cgs(V, k, w, axis_name, assume_zero_tail)
    if kind == "mgs":
        return mgs(V, k, w, axis_name, assume_zero_tail)
    if kind == "cgsr":
        return cgsr(V, k, w, axis_name, orth_steps, assume_zero_tail)
    raise ValueError(f"unknown orthogonalization {kind!r}")


def orthonormalize_step(kind: str, V, k, w, axis_name=None,
                        orth_steps: int = 2, assume_zero_tail=False):
    """Orthogonalize + the norm of the result: ``(h_col, w_orth, h_next)``
    (the Arnoldi loop always needs ``||w_orth||`` right after the
    orthogonalization, ``Orthogonalization.hpp:51-60``)."""
    h, w = orthogonalize(kind, V, k, w, axis_name, orth_steps,
                         assume_zero_tail)
    from gmres_tpu.ops.blas import nrm2

    if w.dtype == jnp.bfloat16:
        wf = _acc(w)
        ss = jnp.sum(wf * wf)
        if axis_name is not None:
            ss = jax.lax.psum(ss, axis_name)
        return h, w, jnp.sqrt(ss).astype(w.dtype)
    return h, w, nrm2(w, axis_name)
