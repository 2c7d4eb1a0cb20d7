"""Sparse matrix containers as JAX pytrees.

The reference wraps CSR in per-backend classes holding MKL/cuSPARSE handles
(``types_mkl.hpp:17-107``, ``types_cuda.hpp:47-152``).  Here there are no
library handles: a matrix is a pytree of flat arrays that jits straight into
XLA programs, and dtype conversion (the mixed scheme's ``A_single``
construction, ``gmres.cpp:139``) is a value cast at setup.

Beyond the plain CSR triplet we precompute ``row_ids`` (the COO row index of
each stored entry, sorted): the CSR SpMV is a gather + segment-sum over this
layout (see ``ops/spmv.py``), so the ``row_ptr`` expansion happens once on
the host.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np

# Pad nnz to this multiple so matrices of similar size share array shapes
# (and so compiled programs).
_NNZ_PAD = 1024


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("row_ptr", "col_idx", "row_ids", "vals"),
    meta_fields=("n_rows", "n_cols", "nnz"),
)
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """CSR matrix with precomputed segment ids.

    ``col_idx``/``row_ids``/``vals`` are padded to a multiple of 1024 with
    zero-valued entries assigned to the last row (keeps ``row_ids`` sorted
    and contributes 0 to every SpMV).
    """

    row_ptr: jax.Array  # (n_rows+1,) int32
    col_idx: jax.Array  # (nnz_padded,) int32
    row_ids: jax.Array  # (nnz_padded,) int32, non-decreasing
    vals: jax.Array     # (nnz_padded,) dtype
    n_rows: int
    n_cols: int
    nnz: int            # true (unpadded) stored-entry count

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.vals.dtype

    def astype(self, dtype) -> "CSRMatrix":
        """Dtype-staged copy (the reference's cross-dtype SparseMatrix copy
        constructor, ``types_cuda.hpp:116-130``)."""
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    def to_dense(self) -> np.ndarray:
        """Host-side densification (tests only)."""
        out = np.zeros(self.shape, dtype=np.result_type(np.asarray(self.vals).dtype))
        rp = np.asarray(self.row_ptr)
        ci = np.asarray(self.col_idx)
        v = np.asarray(self.vals)
        for i in range(self.n_rows):
            for k in range(rp[i], rp[i + 1]):
                out[i, ci[k]] += v[k]
        return out

    def to_scipy(self):
        """Convert to scipy.sparse.csr_matrix (host-side utilities/tests)."""
        import scipy.sparse as sp

        return sp.csr_matrix(
            (
                np.asarray(self.vals[: self.nnz]),
                np.asarray(self.col_idx[: self.nnz]),
                np.asarray(self.row_ptr),
            ),
            shape=self.shape,
        )

    def device_put(self, sharding=None) -> "CSRMatrix":
        put = partial(jax.device_put, device=sharding) if sharding else jax.device_put
        return jax.tree.map(put, self)


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    out = np.full((size,), fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def csr_from_arrays(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    vals: np.ndarray,
    n_cols: int | None = None,
    pad_multiple: int = _NNZ_PAD,
) -> CSRMatrix:
    """Build a CSRMatrix from raw CSR arrays (host numpy)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int32)
    col_idx = np.asarray(col_idx, dtype=np.int32)
    n_rows = row_ptr.shape[0] - 1
    n_cols = int(n_cols) if n_cols is not None else n_rows
    nnz = int(row_ptr[-1])
    assert col_idx.shape[0] >= nnz and vals.shape[0] >= nnz
    col_idx = col_idx[:nnz]
    vals = np.asarray(vals)[:nnz]

    row_ids = np.repeat(
        np.arange(n_rows, dtype=np.int32), np.diff(row_ptr).astype(np.int64)
    )

    padded = max(pad_multiple, -(-nnz // pad_multiple) * pad_multiple)
    return CSRMatrix(
        row_ptr=row_ptr,
        col_idx=_pad_to(col_idx, padded, 0),
        row_ids=_pad_to(row_ids, padded, max(n_rows - 1, 0)),
        vals=_pad_to(vals, padded, vals.dtype.type(0)),
        n_rows=n_rows,
        n_cols=n_cols,
        nnz=nnz,
    )


def csr_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int | None = None,
    sum_duplicates: bool = True,
) -> CSRMatrix:
    """COO -> CSR with rows sorted by (row, col).

    Unlike the reference loader this is a general-purpose constructor: no
    symmetry expansion or diagonal insertion (those are the .mtx loader's
    contract; see ``io/loader.py``).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    n_cols = int(n_cols) if n_cols is not None else int(n_rows)

    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]

    if sum_duplicates and rows.size:
        key_same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if key_same.any():
            # group-reduce duplicates
            group_start = np.concatenate([[True], ~key_same])
            group_id = np.cumsum(group_start) - 1
            n_groups = group_id[-1] + 1
            new_vals = np.zeros(n_groups, dtype=vals.dtype)
            np.add.at(new_vals, group_id, vals)
            keep = np.flatnonzero(group_start)
            rows, cols, vals = rows[keep], cols[keep], new_vals

    counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
    row_ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return csr_from_arrays(row_ptr, cols.astype(np.int32), vals, n_cols=n_cols)


def csr_from_dense(a: np.ndarray, keep_zeros: bool = False) -> CSRMatrix:
    """Dense -> CSR (tests / tiny problems)."""
    a = np.asarray(a)
    if keep_zeros:
        rows, cols = np.indices(a.shape)
        rows, cols = rows.ravel(), cols.ravel()
        vals = a.ravel()
    else:
        rows, cols = np.nonzero(a)
        vals = a[rows, cols]
    return csr_from_coo(rows, cols, vals, n_rows=a.shape[0], n_cols=a.shape[1])


@dataclasses.dataclass(frozen=True)
class RowBlockCSR:
    """Host container for rows ``[row_lo, row_hi)`` of a global CSR.

    The pod-scale input form (SURVEY.md §5.8): a process loads only its own
    row block from disk (``io/loader.py:load_matrix_rows``), so no process
    ever materializes the O(global nnz) entry arrays — only the O(n) global
    ``row_ptr`` (needed for shard nnz offsets; vectors are already cheap
    relative to the matrix) plus its local entries.

    Column indices are GLOBAL.  Not a pytree — this is a host-side staging
    container consumed by the partitioners (``parallel/partition.py``),
    never shipped to devices.
    """

    row_ptr: np.ndarray   # (n_rows+1,) int64 GLOBAL assembled row pointer
    col_idx: np.ndarray   # local entries, global columns (int32)
    vals: np.ndarray      # local entries
    row_lo: int
    row_hi: int
    n_rows: int           # global
    n_cols: int           # global

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def local_nnz(self) -> int:
        return int(self.row_ptr[self.row_hi] - self.row_ptr[self.row_lo])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def entries(self, lo: int, hi: int):
        """(col_idx, vals) views for global rows ``[lo, hi)``; the range
        must sit inside the owned block."""
        if not (self.row_lo <= lo and hi <= self.row_hi and lo <= hi):
            raise IndexError(
                f"rows [{lo}, {hi}) outside owned block "
                f"[{self.row_lo}, {self.row_hi})"
            )
        base = int(self.row_ptr[self.row_lo])
        a = int(self.row_ptr[lo]) - base
        b = int(self.row_ptr[hi]) - base
        return self.col_idx[a:b], self.vals[a:b]

    def astype(self, dtype) -> "RowBlockCSR":
        dt = np.dtype(dtype)
        if dt == self.vals.dtype:
            return self
        return dataclasses.replace(self, vals=self.vals.astype(dt))

    def local_block(self) -> CSRMatrix:
        """The owned rows as a standalone CSRMatrix (local row indexing,
        global columns) — for oracle checks and local preconditioners."""
        rp = (self.row_ptr[self.row_lo : self.row_hi + 1]
              - self.row_ptr[self.row_lo]).astype(np.int32)
        return csr_from_arrays(rp, self.col_idx, self.vals,
                               n_cols=self.n_cols)
