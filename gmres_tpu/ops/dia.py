"""DIA (diagonal) sparse format — the fast path for banded matrices.

For matrices whose nonzeros live on a bounded set of diagonals (stencil
Laplacians, convection-diffusion, and most reordered PDE matrices — the
bulk of the paper's SuiteSparse suite), SpMV restructures into pure vector
code:

    y = sum_d  data[d] * shift(x, offset_d)

— one elementwise pass over the diagonal data, no indexed memory access
and no column-index bytes.  Offsets are static metadata, so XLA unrolls
the sum into shifted fused multiply-adds in any dtype.

``from_csr`` decides profitability: DIA stores D*n values vs CSR's nnz, so
it is used when the fill ratio stays below a threshold.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.sparse import CSRMatrix


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("data",),
    meta_fields=("offsets", "n_rows", "n_cols", "nnz"),
)
@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Diagonal-format sparse matrix.

    ``data[d, i] = A[i, i + offsets[d]]`` (0 where out of range or not
    stored).  ``offsets`` is a static tuple so shifts compile to static
    slices.
    """

    data: jax.Array          # (n_diags, n_rows)
    offsets: tuple[int, ...]
    n_rows: int
    n_cols: int
    nnz: int                 # true stored-entry count of the source matrix

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def vals(self) -> jax.Array:
        """Values array view (Frobenius-norm compatible: padding is 0)."""
        return self.data.reshape(-1)

    def astype(self, dtype) -> "DIAMatrix":
        return dataclasses.replace(self, data=self.data.astype(dtype))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.asarray(self.data).dtype)
        data = np.asarray(self.data)
        for d, off in enumerate(self.offsets):
            for i in range(max(0, -off), min(self.n_rows, self.n_cols - off)):
                out[i, i + off] = data[d, i]
        return out


def from_csr(A: CSRMatrix, max_fill: float = 3.0, max_diags: int = 256) -> DIAMatrix | None:
    """Convert CSR -> DIA when profitable, else None.

    Profitable: the number of distinct diagonals D satisfies
    ``D * n <= max_fill * nnz`` and ``D <= max_diags`` (bounds both memory
    blow-up and compiled-loop length).
    """
    n = A.n_rows
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    if nnz == 0:
        return None
    ci = np.asarray(A.col_idx)[:nnz].astype(np.int64)
    v = np.asarray(A.vals)[:nnz]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))

    offs = ci - rows
    # bounded-range unique via a presence bitmap: O(nnz + n), no sort
    # (np.unique's sort over nnz int64 was the setup bottleneck)
    off_min = int(offs.min())
    off_max = int(offs.max())
    span = off_max - off_min + 1
    present = np.zeros(span, dtype=bool)
    present[offs - off_min] = True
    uniq = np.flatnonzero(present) + off_min
    D = uniq.shape[0]
    if D > max_diags or D * n > max_fill * max(nnz, 1):
        return None

    lookup = np.zeros(span, dtype=np.int64)
    lookup[uniq - off_min] = np.arange(D)
    d_idx = lookup[offs - off_min]
    # duplicates on the same (row, col) sum, matching SpMV semantics of
    # duplicate CSR entries (bincount ~10x faster than np.add.at here)
    data = np.bincount(d_idx * n + rows, weights=v, minlength=D * n).reshape(
        D, n
    ).astype(v.dtype)
    return DIAMatrix(
        data=data,
        offsets=tuple(int(o) for o in uniq),
        n_rows=n,
        n_cols=A.n_cols,
        nnz=nnz,
    )


def dia_transpose(A: DIAMatrix) -> DIAMatrix:
    """A^T in DIA form: offsets negate, each band's data shifts by its own
    offset (B_data[-o][p] = A_data[o][p + o], zero outside).  Host-side
    (numpy) — used at setup by condest's Golub-Kahan recurrence, which
    needs A^T @ u (``condest.cpp`` uses the cusparse transpose flag)."""
    data = np.asarray(A.data)
    n = A.n_rows
    out = np.zeros((len(A.offsets), n), dtype=data.dtype)
    new_offsets = tuple(-o for o in A.offsets)
    # B_data[d][p] = A_data[d][p - off_d] (band d moves to offset -off_d):
    # B[p, p - off] = A[p - off, p] = A_data[off][p - off]
    for d, off in enumerate(A.offsets):
        src = data[d]
        if off >= 0:
            out[d, off:] = src[: n - off] if off else src
        else:
            out[d, : n + off] = src[-off:]
    # sort bands by new offset to keep the canonical ascending order
    order = np.argsort(new_offsets)
    return DIAMatrix(
        data=out[order],
        offsets=tuple(new_offsets[i] for i in order),
        n_rows=A.n_cols,
        n_cols=A.n_rows,
        nnz=A.nnz,
    )


def shift_read(x: jax.Array, off: int, n: int) -> jax.Array:
    """z[i] = x[i + off] for i in [0, n), zero outside x's range."""
    m = x.shape[0]
    if off == 0 and m == n:
        return x
    z = jnp.zeros((n,), dtype=x.dtype)
    src_lo = max(0, off)
    src_hi = min(m, n + off)
    if src_hi <= src_lo:
        return z
    dst_lo = src_lo - off
    return jax.lax.dynamic_update_slice(
        z, jax.lax.slice(x, (src_lo,), (src_hi,)), (dst_lo,)
    )


def dia_spmv(A: DIAMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x as shifted elementwise products, one per diagonal."""
    x = x.astype(A.data.dtype)
    n = A.n_rows
    y = jnp.zeros((n,), dtype=A.data.dtype)
    for d, off in enumerate(A.offsets):
        y = y + A.data[d] * shift_read(x, off, n)
    return y
