"""ILU(0) factorization (host, setup-time).

The reference factors on host/GPU at preconditioner-build time and times it
separately from the solve (``gmres_perf_test.cpp:65-93``).  We keep the same
split: factorization is a one-time host cost; only the *application* runs
on the device.

Algorithm parity with ``ilu0_impl`` (``kernels_mkl.cpp:416-496``):

- sequential IKJ ILU(0) on the CSR pattern (which the loader guarantees has
  a full diagonal);
- diagonal boost: pivots with magnitude below
  ``alpha = eps(factor_dtype) * max_i ||row_i(A)||_1`` are clamped to
  ``±alpha`` (``kernels_mkl.cpp:422-436,477-485``);
- factors are computed in fp64 and downcast to the preconditioner dtype at
  the end (``kernels_mkl.cpp:488-493``).

Fixed reference defect (SURVEY.md §2.5.1): the reference never populates
``diag_inds`` on the MKL path (``kernels_mkl.cpp:448``), silently using
index 0 as every row's pivot.  We compute diagonal positions correctly —
matching the (correct) cuSPARSE ``csrilu02`` path the paper's GPU numbers
used.

A native C++ fast path (``csrc/``) is used when built; the numpy/Python
fallback is exact but slower on multi-million-row matrices.
"""

from __future__ import annotations

import numpy as np


def _diag_positions(row_ptr: np.ndarray, col_idx: np.ndarray) -> np.ndarray:
    """Position of the first entry with col >= row in each row (the
    reference's diagonal scan, ``types.hpp:300-308``).  With the loader's
    guaranteed diagonal this is the diagonal entry itself."""
    n = row_ptr.shape[0] - 1
    diag = np.empty(n, dtype=np.int64)
    for i in range(n):
        lo, hi = row_ptr[i], row_ptr[i + 1]
        # rows are sorted by column: binary search
        pos = lo + np.searchsorted(col_idx[lo:hi], i)
        diag[i] = pos
    return diag


def diag_positions(row_ptr: np.ndarray, col_idx: np.ndarray) -> np.ndarray:
    """Vectorized diagonal-position scan."""
    n = row_ptr.shape[0] - 1
    rp = row_ptr.astype(np.int64)
    # For each row, count entries with col < row: since rows are sorted,
    # vectorize with a global searchsorted per row using offsets.
    # Fall back to the loop only for tiny n (overhead irrelevant).
    counts = np.empty(n, dtype=np.int64)
    # searchsorted per-row over the concatenated array: do it with one pass
    # over rows using np.searchsorted on each row slice is O(n) python; use
    # instead: position = rp[i] + (# cols in row i that are < i).
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    below = (col_idx[: rp[-1]].astype(np.int64) < row_ids).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(below)])
    counts = cum[rp[1:]] - cum[rp[:-1]]
    return rp[:-1] + counts


def ilu0_factorize_numpy(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    vals: np.ndarray,
    factor_dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray]:
    """Pure-numpy sequential ILU(0).  Returns (factor_vals, diag_positions):
    the combined L\\U factor on A's sparsity pattern (unit-diagonal L stored
    without its ones, like the reference)."""
    n = row_ptr.shape[0] - 1
    rp = row_ptr.astype(np.int64)
    ci = col_idx.astype(np.int64)
    v = vals.astype(np.float64).copy()

    # boost threshold: eps(factor dtype) * max row 1-norm (of A)
    nnz = rp[-1]
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    row_abs = np.zeros(n)
    np.add.at(row_abs, row_ids, np.abs(v[:nnz]))
    alpha = float(np.finfo(factor_dtype).eps) * float(row_abs.max(initial=0.0))

    diag = diag_positions(rp, ci)

    # boost row 0's pivot too?  The reference loop starts at row 1 and never
    # boosts row 0 (kernels_mkl.cpp:450); replicate exactly.
    for i in range(1, n):
        row_start, row_end = rp[i], rp[i + 1]
        k_ind = row_start
        while ci[k_ind] < i:
            k = ci[k_ind]
            pivot = v[diag[k]]
            factor = v[k_ind] / pivot
            v[k_ind] = factor

            prev_ind = diag[k] + 1
            prev_end = rp[k + 1]
            j_ind = k_ind + 1
            while j_ind < row_end and prev_ind < prev_end:
                cj, cp = ci[j_ind], ci[prev_ind]
                if cp < cj:
                    prev_ind += 1
                elif cp > cj:
                    j_ind += 1
                else:
                    v[j_ind] -= factor * v[prev_ind]
                    prev_ind += 1
                    j_ind += 1
            k_ind += 1

        dv = v[diag[i]]
        if dv >= 0:
            if dv < alpha:
                v[diag[i]] = alpha
        else:
            if dv > -alpha:
                v[diag[i]] = -alpha

    return v.astype(factor_dtype), diag


def ilu0_factorize(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    vals: np.ndarray,
    factor_dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray]:
    """ILU(0) with the native C++ fast path when available."""
    try:
        from gmres_tpu.native import ilu0_native

        return ilu0_native(row_ptr, col_idx, vals, factor_dtype)
    except (ImportError, OSError):
        return ilu0_factorize_numpy(row_ptr, col_idx, vals, factor_dtype)


def triangular_level_counts(
    row_ptr: np.ndarray, col_idx: np.ndarray, diag: np.ndarray
) -> tuple[int, int]:
    """Dependency-level counts (nilpotency indices) of the strict-lower and
    strict-upper parts of the factor pattern.

    An exact unit-lower triangular solve equals ``nlev_L`` Jacobi sweeps
    (the strict part is nilpotent of that index), which is how the exact-ILU
    preconditioner is applied (see ``precond/build.py:build_ilu_exact``).
    """
    try:
        from gmres_tpu.native import levels_native

        return levels_native(row_ptr, col_idx, diag)
    except (ImportError, OSError):
        pass
    n = row_ptr.shape[0] - 1
    rp = row_ptr.astype(np.int64)
    ci = col_idx.astype(np.int64)
    lev_l = np.zeros(n, dtype=np.int64)
    for i in range(n):
        lo = rp[i]
        hi = diag[i]
        if hi > lo:
            lev_l[i] = 1 + lev_l[ci[lo:hi]].max()
    lev_u = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        lo = diag[i] + 1
        hi = rp[i + 1]
        if hi > lo:
            lev_u[i] = 1 + lev_u[ci[lo:hi]].max()
    return int(lev_l.max(initial=0)) + 1, int(lev_u.max(initial=0)) + 1
