"""Preconditioner construction (host, setup-time) -> device pytrees.

Mirrors the reference's dispatch in ``DoBaselineProblem``
(``gmres_perf_test.cpp:68-92``): ILU / ILU-Jacobi factor with ``ilu0`` on
the fp64 matrix and downcast; Jacobi extracts a safeguarded inverse
diagonal; identity is a no-op.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np

from gmres_tpu.config import GmresConfig, Precond
from gmres_tpu.precond.ilu0 import (
    diag_positions,
    ilu0_factorize,
    triangular_level_counts,
)
from gmres_tpu.sparse import CSRMatrix, csr_from_arrays


@partial(jax.tree_util.register_dataclass, data_fields=(), meta_fields=())
@dataclasses.dataclass(frozen=True)
class IdentityPrec:
    pass


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("inv_diag",),
    meta_fields=(),
)
@dataclasses.dataclass(frozen=True)
class JacobiPrec:
    """Inverse main diagonal with the reference's pivot safeguard
    ``alpha = eps(float32) * max_i ||row_i||_1`` (``types.hpp:397-431``;
    note the reference uses float eps regardless of build dtype)."""

    inv_diag: jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lower", "upper", "inv_diag"),
    meta_fields=("steps", "block_local"),
)
@dataclasses.dataclass(frozen=True)
class ILUJacobiPrec:
    """ILU(0) factors applied via Jacobi-iteration triangular solves
    (``types.hpp:251-372``, ``kernels.hpp:172-248``): each sweep is a
    strict-triangular SpMV + elementwise, with no sequential dependency.

    ``lower``: strictly-lower part of the factor (unit diagonal implied).
    ``upper``: upper part *including* the diagonal.
    ``steps``: Jacobi sweeps per triangle; for the exact-ILU variant this is
    the pattern's dependency-level count, at which the (nilpotent) iteration
    reproduces the exact triangular solve.
    ``block_local``: the factors are shard-local diagonal blocks
    (block-Jacobi ILU, ``precond/bilu.py``) — sweeps then run WITHOUT the
    mesh axis (no collectives inside the apply).
    """

    lower: CSRMatrix
    upper: CSRMatrix
    inv_diag: jax.Array
    steps: int
    block_local: bool = False


def _split_triangles(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    fvals: np.ndarray,
    diag: np.ndarray,
    dtype,
) -> tuple[CSRMatrix, CSRMatrix, np.ndarray]:
    n = row_ptr.shape[0] - 1
    rp = row_ptr.astype(np.int64)
    nnz = rp[-1]
    ci = col_idx[:nnz].astype(np.int64)
    pos = np.arange(nnz, dtype=np.int64)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))

    diag_of_row = diag[row_ids]
    lower_mask = pos < diag_of_row
    upper_mask = pos >= diag_of_row  # includes the diagonal

    def build(mask):
        r = row_ids[mask]
        counts = np.bincount(r, minlength=n).astype(np.int64)
        rptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=rptr[1:])
        return csr_from_arrays(
            rptr.astype(np.int32),
            ci[mask].astype(np.int32),
            fvals[mask].astype(dtype),
            n_cols=n,
        )

    inv_diag = (1.0 / fvals[diag]).astype(dtype)
    return build(lower_mask), build(upper_mask), inv_diag


def build_jacobi(A: CSRMatrix, dtype) -> JacobiPrec:
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = rp[-1]
    ci = np.asarray(A.col_idx)[:nnz].astype(np.int64)
    # The reference builds Jacobi<PrecType> from a PrecType *copy* of A
    # (cross-dtype SparseMatrix conversion), so the row norms and diagonal
    # come from downcast values.
    v = np.asarray(A.vals)[:nnz].astype(dtype).astype(np.float64)
    n = A.n_rows

    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    row_abs = np.zeros(n)
    np.add.at(row_abs, row_ids, np.abs(v))
    alpha = float(np.finfo(np.float32).eps) * float(row_abs.max(initial=0.0))

    diag = diag_positions(rp, ci)
    dv = v[diag]
    clamped = np.where(dv >= 0, np.maximum(dv, alpha), np.minimum(dv, -alpha))
    return JacobiPrec(inv_diag=(1.0 / clamped).astype(dtype))


def build_jacobi_rowblock(A_blk, dtype, exchange) -> JacobiPrec:
    """``build_jacobi`` from a per-host ``RowBlockCSR`` (pod-scale input,
    SURVEY.md §5.8): each process computes row sums / diagonal values for
    its own rows only; the safeguard's GLOBAL ``alpha`` (f32 eps x max
    row 1-norm, ``types.hpp:397-431``) and the assembled global inv_diag
    come from two ``exchange`` rounds (``multihost.exchange_host_array``).
    The result is bit-identical to ``build_jacobi`` on the full matrix.

    The O(n) global inv_diag vector is deliberately replicated per host —
    vectors are cheap relative to the O(nnz) matrix this mode avoids."""
    lo, hi = A_blk.row_lo, A_blk.row_hi
    n = A_blk.n_rows
    rp = np.asarray(A_blk.row_ptr).astype(np.int64)
    ci, v_raw = A_blk.entries(lo, hi)
    ci = np.asarray(ci).astype(np.int64)
    v = np.asarray(v_raw).astype(dtype).astype(np.float64)

    nb = hi - lo
    row_ids = np.repeat(np.arange(nb, dtype=np.int64), np.diff(rp[lo:hi + 1]))
    row_abs = np.zeros(nb)
    np.add.at(row_abs, row_ids, np.abs(v))
    # round 1: the global max row 1-norm behind alpha
    gmax = float(
        exchange(np.array([row_abs.max(initial=0.0)])).max()
    )
    alpha = float(np.finfo(np.float32).eps) * gmax

    diag_mask = ci == (row_ids + lo)
    if int(diag_mask.sum()) != nb:
        raise ValueError(
            "row block lacks an explicit diagonal entry in some row; "
            "load it with io.loader.load_matrix_rows (the reference "
            "contract forces a diagonal)"
        )
    dv = v[diag_mask]
    clamped = np.where(dv >= 0, np.maximum(dv, alpha), np.minimum(dv, -alpha))
    inv_local = (1.0 / clamped).astype(dtype)

    # round 2: assemble the global inv_diag from every process's block
    # (fixed-shape payload: [row_lo, row_hi, padded piece])
    max_rows = int(exchange(np.array([nb])).max())
    payload = np.zeros(2 + max_rows, dtype=np.float64)
    payload[0], payload[1] = lo, hi
    payload[2 : 2 + nb] = inv_local.astype(np.float64)
    gathered = exchange(payload)
    inv_diag = np.ones(n, dtype=np.float64)  # rows no process owns: 1.0
    for row in np.asarray(gathered):
        a, b = int(row[0]), int(row[1])
        inv_diag[a:b] = row[2 : 2 + (b - a)]
    # host numpy like build_jacobi (callers pad/slice it before upload)
    return JacobiPrec(inv_diag=inv_diag.astype(dtype))


def build_ilu_jacobi(A: CSRMatrix, dtype, steps: int) -> ILUJacobiPrec:
    rp = np.asarray(A.row_ptr)
    nnz = int(rp[-1])
    ci = np.asarray(A.col_idx)[:nnz]
    v = np.asarray(A.vals)[:nnz].astype(np.float64)
    fvals, diag = ilu0_factorize(rp, ci, v, factor_dtype=np.dtype(dtype))
    fvals = np.asarray(fvals, dtype=np.float64).astype(dtype).astype(np.float64)
    lower, upper, inv_diag = _split_triangles(rp, ci, fvals, diag, dtype)
    return ILUJacobiPrec(lower=lower, upper=upper, inv_diag=inv_diag, steps=steps)


# Per-apply element-op ceiling for exact solves expressed as sweeps
# (full-sweep ILUJacobiPrec or level-scheduled chunks); past this the
# build refuses rather than hand the solver a multi-second preconditioner.
_SWEEP_WORK_BUDGET = 2_000_000_000


def build_ilu_exact(A: CSRMatrix, dtype):
    """Exact ILU(0) triangular solves, expressed as level-count Jacobi
    sweeps (the strict triangles are nilpotent of exactly that index, so
    the sweep recursion terminates at the exact substitution result).

    Returns ``ILUJacobiPrec`` with ``steps`` = the dependency-level count
    while ``levels * nnz`` stays within ``_SWEEP_WORK_BUDGET``; else the
    level-scheduled ``LevelILUPrec`` (``precond/level_ilu.py``, the
    cuSPARSE ``csrsv2`` analog) when its chunked work fits the budget;
    else a ValueError naming the ILU-Jacobi alternative.
    """
    rp = np.asarray(A.row_ptr)
    nnz = int(rp[-1])
    ci = np.asarray(A.col_idx)[:nnz]
    v = np.asarray(A.vals)[:nnz].astype(np.float64)
    fvals, diag = ilu0_factorize(rp, ci, v, factor_dtype=np.dtype(dtype))
    fvals = np.asarray(fvals, dtype=np.float64).astype(dtype).astype(np.float64)
    nlev_l, nlev_u = triangular_level_counts(rp.astype(np.int64), ci, diag)
    lower, upper, inv_diag = _split_triangles(rp, ci, fvals, diag, dtype)

    steps = max(nlev_l, nlev_u)
    if steps * max(nnz, 1) <= _SWEEP_WORK_BUDGET:
        return ILUJacobiPrec(lower=lower, upper=upper, inv_diag=inv_diag,
                             steps=steps)
    # Full-sweep exactness is prohibitively slow, but a LEVEL-SCHEDULED
    # apply only pays sum_c sweeps_c * nnz_c — try it before refusing.
    from gmres_tpu.precond.level_ilu import build_level_ilu, triangular_levels

    lev_l, lev_u = triangular_levels(
        rp.astype(np.int64), ci.astype(np.int64), diag
    )
    prec, work = build_level_ilu(lower, upper, inv_diag, lev_l, lev_u)
    if work <= _SWEEP_WORK_BUDGET:
        return prec
    raise ValueError(
        f"exact-ILU triangular solves need {steps} dependency-level "
        f"sweeps over {nnz} nonzeros per application, and the "
        f"level-scheduled form needs {work} element operations — both "
        f"exceed the budget of {_SWEEP_WORK_BUDGET}. Use "
        "precond='ilu_jacobi' (Jacobi-iteration triangular solves) "
        "or a smaller problem."
    )


def optimize_precond_format(M):
    """Re-pack ILU factors into DIA form when banded (single-device fast
    path; the Jacobi sweeps are then pure shifted elementwise FMAs)."""
    if isinstance(M, ILUJacobiPrec) and isinstance(M.lower, CSRMatrix):
        from gmres_tpu.ops.dia import from_csr

        lo = from_csr(M.lower)
        up = from_csr(M.upper)
        if lo is not None and up is not None:
            return dataclasses.replace(M, lower=lo, upper=up)
    return M


def build_jacobi_from_dia(A, dtype) -> JacobiPrec:
    """Jacobi from a DIA operator: the diagonal is the offset-0 band and
    the row 1-norms sum |data| down the diagonals (same safeguard math as
    ``build_jacobi``)."""
    data = np.asarray(A.data, dtype=np.float64)
    data = data.astype(dtype).astype(np.float64)  # reference's dtype-copy
    row_abs = np.abs(data).sum(axis=0)
    alpha = float(np.finfo(np.float32).eps) * float(row_abs.max(initial=0.0))
    try:
        d0 = A.offsets.index(0)
    except ValueError:
        raise ValueError("Jacobi preconditioner: DIA operator has no main diagonal")
    dv = data[d0]
    clamped = np.where(dv >= 0, np.maximum(dv, alpha), np.minimum(dv, -alpha))
    return JacobiPrec(inv_diag=(1.0 / clamped).astype(dtype))


def build_preconditioner(A: CSRMatrix, cfg: GmresConfig):
    """Build the preconditioner in the configured dtype from the (fp64)
    assembled matrix, as the reference does (``gmres_perf_test.cpp:68-92``:
    ``ilu0<PrecType>(A_double)``, ``Jacobi<PrecType>(A)``)."""
    dtype = cfg.precision.precond_dtype
    if cfg.precond == Precond.BILU_JACOBI:
        raise ValueError(
            "precond='bilu_jacobi' is the distributed block-Jacobi ILU "
            "(each shard factors its diagonal block — precond/bilu.py); "
            "use solve_distributed, or precond='ilu_jacobi' for "
            "single-device solves"
        )
    if cfg.precond == Precond.IDENTITY:
        return IdentityPrec()
    if not isinstance(A, CSRMatrix):
        # DIA (or other pre-staged) operator
        if cfg.precond == Precond.JACOBI and hasattr(A, "offsets"):
            return build_jacobi_from_dia(A, dtype)
        raise TypeError(
            f"{cfg.precond.value} preconditioner needs the CSR matrix; pass "
            "the CSR form to solve() (it auto-converts the operator to DIA "
            "internally) or prebuild M with build_preconditioner(csr, cfg)."
        )
    if cfg.precond == Precond.JACOBI:
        return build_jacobi(A, dtype)
    if cfg.precond == Precond.ILU_JACOBI:
        return build_ilu_jacobi(A, dtype, cfg.jacobi_steps)
    if cfg.precond == Precond.ILU:
        return build_ilu_exact(A, dtype)
    raise ValueError(f"unknown preconditioner {cfg.precond}")
