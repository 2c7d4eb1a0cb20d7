"""Givens rotation machinery (BLAS rotg/rot semantics).

The reference uses cblas_?rotg / cublas?rotg and explicitly zeroes the
eliminated entry afterwards (``kernels_mkl.cpp:217-218``,
``kernels_cuda.cpp:404``); ``rot`` is the standard plane rotation
(``x' = c x + s y; y' = c y - s x``).  These run on O(m) data and stay as
jnp scalar ops inside the jitted cycle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rotg(a: jax.Array, b: jax.Array):
    """BLAS ?rotg: returns (r, c, s) with [c s; -s c] @ [a; b] = [r; 0].

    Matches the reference BLAS convention: r carries the sign of the larger-
    magnitude input; (c, s) = (1, 0) when both inputs are zero.
    """
    dt = a.dtype
    abs_a, abs_b = jnp.abs(a), jnp.abs(b)
    roe = jnp.where(abs_a > abs_b, a, b)
    scale = abs_a + abs_b
    safe_scale = jnp.where(scale == 0, dt.type(1), scale)
    r = safe_scale * jnp.sqrt((a / safe_scale) ** 2 + (b / safe_scale) ** 2)
    r = jnp.where(scale == 0, dt.type(0), jnp.sign(roe) * r)
    safe_r = jnp.where(r == 0, dt.type(1), r)
    c = jnp.where(scale == 0, dt.type(1), a / safe_r)
    s = jnp.where(scale == 0, dt.type(0), b / safe_r)
    return r, c, s


def accumulate_rotation(Q: jax.Array, k, c, s) -> jax.Array:
    """Q <- G(k, k+1; c, s) @ Q — fold a new plane rotation into the
    accumulated orthogonal transform.

    The solver carries ``Q = G_{k-1} ... G_0`` instead of (cs, sn, s)
    because applying k stored rotations sequentially is O(k) *dependent
    scalar updates*, each a tiny op with a fixed launch cost, and the
    reference's per-iteration ``rot`` sweep (``gmres.cpp:108``) is such a
    chain.  With Q the sweep becomes one (m+1, m+1) matvec and this
    two-row update, and the Givens right-hand side is free:
    ``s = beta * Q[:, 0]`` (since s = Q @ (beta e1)).
    """
    qk = jax.lax.dynamic_index_in_dim(Q, k, axis=0, keepdims=False)
    qk1 = jax.lax.dynamic_index_in_dim(Q, k + 1, axis=0, keepdims=False)
    Q = jax.lax.dynamic_update_index_in_dim(Q, c * qk + s * qk1, k, axis=0)
    return jax.lax.dynamic_update_index_in_dim(Q, c * qk1 - s * qk, k + 1, axis=0)


def apply_rotations(h: jax.Array, cs: jax.Array, sn: jax.Array, k) -> jax.Array:
    """Apply the k stored rotations (j = 0..k-1) to the new Hessenberg
    column prefix — the reference's vector-``rot`` call (``gmres.cpp:108``;
    the intended semantics per SURVEY.md §2.2, not the mixed-path
    subview off-by-one accident)."""

    def body(j, hcol):
        c, s = cs[j], sn[j]
        hj = hcol[j]
        hj1 = hcol[j + 1]
        hcol = hcol.at[j].set(c * hj + s * hj1)
        return hcol.at[j + 1].set(c * hj1 - s * hj)

    return jax.lax.fori_loop(0, k, body, h)
