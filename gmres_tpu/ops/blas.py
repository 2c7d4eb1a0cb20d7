"""BLAS-1 style reductions, distribution-aware.

The reference routes these through CBLAS/cuBLAS (``kernels_mkl.cpp:71-321``,
``kernels_cuda.cpp:109-572``); here they are jnp expressions that XLA fuses
into surrounding computation.  Every reduction takes an optional mesh
``axis_name``: inside ``shard_map`` the local partial is combined with a
single ``psum`` — the distributed design's one collective per reduction
(SURVEY.md §5.8).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _maybe_psum(val, axis_name: str | None):
    if axis_name is None:
        return val
    return jax.lax.psum(val, axis_name)


def dot(x: jax.Array, y: jax.Array, axis_name: str | None = None) -> jax.Array:
    """<x, y> in the dtype of x (matches BLAS sdot/ddot accumulate dtype)."""
    return _maybe_psum(jnp.dot(x, y, precision=_HI), axis_name)


def nrm2_squared(x: jax.Array, axis_name: str | None = None) -> jax.Array:
    return _maybe_psum(jnp.dot(x, x, precision=_HI), axis_name)


def nrm2(x: jax.Array, axis_name: str | None = None) -> jax.Array:
    """Euclidean norm.  Computed as sqrt(sum(x^2)) — the BLAS *nrm2 scaled
    algorithm guards overflow for ||x|| > ~1e19 (fp32), which is outside the
    operating range of these solvers."""
    return jnp.sqrt(nrm2_squared(x, axis_name))
