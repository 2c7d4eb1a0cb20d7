"""Sparse matrix-vector products.

The reference dispatches SpMV to ``mkl_sparse_?_mv`` / ``cusparse?csrmv``
(``kernels_mkl.cpp:326-352``, ``kernels_cuda.cpp:576-614``).  Here the
XLA formulation is a gather + sorted segment-sum over the pre-expanded
COO row ids (host-computed once in ``sparse.py``):

    y[i] = sum_{k : row_ids[k] == i} vals[k] * x[col_idx[k]]

Padding entries carry ``vals == 0`` and point at row ``n_rows-1``, so they
contribute nothing while keeping shapes static.

In distributed mode each shard holds a row block of A with *global* column
indices; the dense operand is all-gathered over the mesh axis before the
local gather (the allgather-then-SpMV baseline of SURVEY.md §7; the
halo-exchange overlap optimization lives in ``parallel/halo.py``).
"""

from __future__ import annotations

import jax

from gmres_tpu.sparse import CSRMatrix


def gather_operand(x_local: jax.Array, axis_name: str | None) -> jax.Array:
    """Materialize the full operand vector from row shards."""
    if axis_name is None:
        return x_local
    return jax.lax.all_gather(x_local, axis_name, tiled=True)


def spmv(
    A,
    x: jax.Array,
    axis_name: str | None = None,
    x_is_global: bool = False,
) -> jax.Array:
    """y = A @ x in A's dtype.  Dispatches on the operator format:
    halo-partitioned (distributed), DIA (shifted elementwise), SELL (its
    XLA executor) or CSR (gather + sorted segment-sum).

    ``x`` may be in a different dtype; it is cast to A's dtype first (the
    reference's SpMV is always dtype-uniform — casts happen at staging
    boundaries, ``gmres.cpp:173-175``).
    """
    from gmres_tpu.ops.dia import DIAMatrix, dia_spmv

    if hasattr(A, "halo_left"):  # HaloDIA / HaloCSR (distributed fast path)
        from gmres_tpu.parallel.halo import halo_spmv

        return halo_spmv(A, x, axis_name)

    xg = x if x_is_global else gather_operand(x, axis_name)
    if isinstance(A, DIAMatrix):
        return dia_spmv(A, xg)
    from gmres_tpu.ops.sell import SELLMatrix, sell_spmv

    if isinstance(A, SELLMatrix):
        return sell_spmv(A, xg)
    return csr_spmv(A, xg)


def csr_spmv(A: CSRMatrix, xg: jax.Array) -> jax.Array:
    """Gather + sorted segment-sum over the pre-expanded row ids."""
    xg = xg.astype(A.vals.dtype)
    prod = A.vals * xg[A.col_idx]
    return jax.ops.segment_sum(
        prod,
        A.row_ids,
        num_segments=A.n_rows,
        indices_are_sorted=True,
    )


def spmv_accum(
    A: CSRMatrix,
    x: jax.Array,
    alpha,
    beta,
    y: jax.Array,
    axis_name: str | None = None,
) -> jax.Array:
    """y <- alpha*A@x + beta*y (the reference's full spmv signature)."""
    return alpha * spmv(A, x, axis_name) + beta * y
