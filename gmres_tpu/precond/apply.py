"""Preconditioner application (on device, inside the jitted cycle).

``typesafe_apply`` parity: when the preconditioner dtype differs from the
vector dtype, the reference round-trips through a cast (``gmres.cpp:12-17``).

The ILU-Jacobi apply implements the *portable* kernel semantics
(``kernels.hpp:223-248``):

    L-phase (unit diagonal):  x_{t+1} = b  - L_strict x_t,        x_0 = b
    U-phase:                  x_{t+1} = x_t + D^{-1}(b' - U x_t),  x_0 = b' = L-phase result

which is the correct Jacobi iteration used by the reference's CUDA runs.
(The reference's MKL float specialization drops b in the U-phase —
``kernels_mkl.cpp:402-414`` honors beta=0 where the portable kernel
hardcodes beta=1 — a defect we do not replicate.)
"""

from __future__ import annotations

import jax

from gmres_tpu.ops.spmv import spmv
from gmres_tpu.precond.build import IdentityPrec, ILUJacobiPrec, JacobiPrec
from gmres_tpu.precond.level_ilu import LevelILUPrec, level_ilu_apply


def _ilu_jacobi_apply(M: ILUJacobiPrec, w: jax.Array, axis_name: str | None):
    if M.block_local:
        # block-Jacobi ILU factors are diagonal blocks: every sweep is
        # shard-local, no collectives (precond/bilu.py)
        axis_name = None
    b = w

    def l_sweep(_, x):
        return b - spmv(M.lower, x, axis_name)

    x = jax.lax.fori_loop(0, M.steps, l_sweep, b)

    b2 = x

    def u_sweep(_, x):
        return x + M.inv_diag * (b2 - spmv(M.upper, x, axis_name))

    return jax.lax.fori_loop(0, M.steps, u_sweep, b2)


def apply_preconditioner(M, w: jax.Array,
                         axis_name: str | None = None) -> jax.Array:
    """M^{-1} w in M's dtype (casting handled by the caller's typesafe
    wrapper)."""
    if isinstance(M, IdentityPrec):
        return w
    if isinstance(M, JacobiPrec):
        return M.inv_diag * w
    if isinstance(M, ILUJacobiPrec):
        return _ilu_jacobi_apply(M, w, axis_name)
    if isinstance(M, LevelILUPrec):
        if axis_name is not None:
            raise TypeError(
                "level-scheduled exact-ILU solves are single-device; use "
                "precond='ilu_jacobi' when distributed"
            )
        return level_ilu_apply(M, w)
    raise TypeError(f"unknown preconditioner {type(M)}")


def typesafe_apply(M, w: jax.Array, axis_name: str | None = None) -> jax.Array:
    """Apply M in its own dtype, round-tripping w if needed
    (``gmres.cpp:12-22``)."""
    if isinstance(M, IdentityPrec):
        return w
    m_dtype = (
        M.inv_diag.dtype if not isinstance(M, IdentityPrec) else w.dtype
    )
    if w.dtype == m_dtype:
        return apply_preconditioner(M, w, axis_name)
    return apply_preconditioner(M, w.astype(m_dtype), axis_name).astype(w.dtype)
