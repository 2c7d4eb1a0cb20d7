"""Small dense triangular solve with dynamic active size k.

The reference calls cblas_?trsv / cublas?trsv on the leading k-by-k block of
the Hessenberg matrix (``gmres.cpp:288,300``).  Under jit, k is a traced
scalar, so we solve the full static m-by-m system with inactive rows/columns
replaced by the identity and a zero rhs — algebraically identical to the
k-by-k solve, with y[j] = 0 for j >= k.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp



def trsv_upper_padded(H: jax.Array, s: jax.Array, k) -> jax.Array:
    """Solve the leading k-by-k upper-triangular system H[:k,:k] y = s[:k].

    H: (m, m) (rows/cols beyond k may hold stale data — masked out here).
    s: (m,).  Returns y (m,) with zeros beyond k.

    Back-substitution UNROLLED over the static m (column sweep): the same
    arithmetic as the reference's cblas/cublas trsv, but as m static fused
    vector ops instead of a LAPACK-style while loop of m dependent steps.
    (A log2(m)-matmul Neumann-product form loses enough fp32 accuracy on
    ill-conditioned R to change convergence histories — rejected.)
    """
    m = H.shape[0]
    i = jnp.arange(m)[:, None]
    j = jnp.arange(m)[None, :]
    active = (i < k) & (j < k)
    Hp = jnp.where(active, H, 0) + jnp.where((i == j) & (i >= k), 1, 0).astype(H.dtype)
    rhs = jnp.where(jnp.arange(m) < k, s, 0)

    # unguarded reciprocal: a zero pivot must surface as inf/NaN exactly
    # like the reference's trsv division (divergence detection relies on it)
    dinv = (1.0 / jnp.diagonal(Hp)).astype(H.dtype)

    y = rhs
    for col in range(m - 1, -1, -1):
        y_col = y[col] * dinv[col]
        # eliminate column `col` from all rows above (static slice)
        y = jnp.concatenate(
            [y[:col] - y_col * Hp[:col, col], y_col[None], y[col + 1:]]
        ) if col else jnp.concatenate([y_col[None], y[1:]])
    return y
