"""Bandwidth-reducing row/column reordering.

The gather-free SpMV paths (DIA, halo windows) need the matrix's nonzeros
near the diagonal.  Reverse Cuthill-McKee reordering makes most irregular
PDE/SuiteSparse matrices banded enough to qualify, and lets a partitioned
operator exchange halos instead of all-gathering the operand.

``solve(..., reorder="rcm")`` permutes A symmetrically at setup, solves
the permuted system, and un-permutes the solution; convergence behavior is
that of the permuted system (documented divergence: ILU(0) factors depend
on ordering, as they do in the reference under any external reordering).
"""

from __future__ import annotations

import numpy as np

from gmres_tpu.sparse import CSRMatrix, csr_from_coo


def rcm_permutation(A: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (on the symmetrized pattern)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = A.to_scipy()
    perm = reverse_cuthill_mckee(S, symmetric_mode=False)
    return np.asarray(perm, dtype=np.int64)


def permute_symmetric(A: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """B = P A P^T with B[i, j] = A[perm[i], perm[j]]."""
    n = A.n_rows
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    ci = np.asarray(A.col_idx)[:nnz].astype(np.int64)
    v = np.asarray(A.vals)[:nnz]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))

    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    return csr_from_coo(inv[rows], inv[ci], v, n_rows=n, n_cols=A.n_cols,
                        sum_duplicates=False)


def bandwidth(A: CSRMatrix) -> int:
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    ci = np.asarray(A.col_idx)[:nnz].astype(np.int64)
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp))
    if nnz == 0:
        return 0
    return int(np.abs(ci - rows).max())
