"""Block-Jacobi ILU(0) — the pod-scale ILU preconditioner (distributed).

New scope vs the single-device reference (SURVEY.md §2.6/§5.8): the
reference's ILU(0) (``kernels_mkl.cpp:416-506`` / csrilu02) is a GLOBAL
sequential factorization, which no process can run when the matrix itself
is loaded per-host (``RowBlockCSR``) — and whose factors couple shards, so
even its *application* needs cross-shard communication every Jacobi sweep.
The standard distributed remedy is block-Jacobi ILU: each shard factors
ONLY its diagonal block ``A[s*r:(s+1)*r, s*r:(s+1)*r]`` and applies
Jacobi-iteration triangular sweeps locally.

Properties that make this the right shape for many devices:

- **Application is communication-free** — the preconditioner is
  block-diagonal by construction, so every sweep is shard-local (DIA
  shifted-FMA or local gather), with no halo/allgather inside the
  ``typesafe_apply`` of the sharded cycle.
- **Factorization cost and memory divide by P** — a process factors only
  the blocks its devices own; the only cross-process traffic is one
  fixed-shape metadata allgather (format vote + padding widths).
- **Numerics legitimately differ from global ILU(0)**: off-block
  couplings are dropped from M (not from A).  For P=1 it coincides
  exactly with ``precond='ilu_jacobi'``.  This is standard domain
  decomposition (block-Jacobi/additive-Schwarz with zero overlap), not a
  reference behavior — the reference has no distributed mode at all.

Factor storage mirrors the operator partitioners: a shared-offsets
block-DIA form when every block's factor pattern is (collectively) banded
enough — Jacobi sweeps are then pure shifted elementwise FMAs per shard —
else per-shard padded CSR stacks.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np

from gmres_tpu.precond.build import _split_triangles
from gmres_tpu.precond.ilu0 import ilu0_factorize

_MAXD = 256  # same diagonal-count gate as ops/dia.from_csr


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lower", "upper", "inv_diag"),
    meta_fields=("offsets_l", "offsets_u", "steps"),
)
@dataclasses.dataclass(frozen=True)
class BlockILUDia:
    """Per-shard block-ILU(0) factors in shared-offsets DIA form.

    ``lower``: (P, D_l, r) strictly-lower factor bands per shard (unit
    diagonal implied); ``upper``: (P, D_u, r) upper factor incl. diagonal;
    ``inv_diag``: (P, r).  Offsets are global (unioned across shards), so
    every shard's sweep compiles to the same static shifted-FMA loop."""

    lower: jax.Array
    upper: jax.Array
    inv_diag: jax.Array
    offsets_l: tuple[int, ...]
    offsets_u: tuple[int, ...]
    steps: int


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("l_ptr", "l_col", "l_rid", "l_val",
                 "u_ptr", "u_col", "u_rid", "u_val", "inv_diag"),
    meta_fields=("steps", "rows_per"),
)
@dataclasses.dataclass(frozen=True)
class BlockILUCSR:
    """Per-shard block-ILU(0) factors as padded CSR stacks with
    shard-LOCAL column indices (cols live inside the diagonal block)."""

    l_ptr: jax.Array   # (P, r+1)
    l_col: jax.Array   # (P, K_l) local columns
    l_rid: jax.Array   # (P, K_l)
    l_val: jax.Array   # (P, K_l)
    u_ptr: jax.Array
    u_col: jax.Array
    u_rid: jax.Array
    u_val: jax.Array
    inv_diag: jax.Array  # (P, r)
    steps: int
    rows_per: int


def _tri_offsets(tri) -> set[int]:
    """Unique (col - row) offsets of a local-column triangle CSR."""
    rp = np.asarray(tri.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    if nnz == 0:
        return set()
    ci = np.asarray(tri.col_idx)[:nnz].astype(np.int64)
    rows = np.repeat(np.arange(rp.shape[0] - 1, dtype=np.int64), np.diff(rp))
    offs = ci - rows
    off_min = int(offs.min())
    present = np.zeros(int(offs.max()) - off_min + 1, dtype=bool)
    present[offs - off_min] = True
    return {int(o) for o in (np.flatnonzero(present) + off_min)}


def _dia_pack(tri, offsets: tuple[int, ...], r: int, dtype) -> np.ndarray:
    """Local-column triangle CSR -> (D, r) band data on shared offsets."""
    D = len(offsets)
    rp = np.asarray(tri.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    out = np.zeros((D, r), dtype=dtype)
    if nnz == 0:
        return out
    ci = np.asarray(tri.col_idx)[:nnz].astype(np.int64)
    v = np.asarray(tri.vals)[:nnz].astype(np.float64)
    rows = np.repeat(np.arange(rp.shape[0] - 1, dtype=np.int64), np.diff(rp))
    off_arr = np.array(offsets, dtype=np.int64)
    lookup = np.zeros(int(off_arr.max()) - int(off_arr.min()) + 1, np.int64)
    lookup[off_arr - off_arr.min()] = np.arange(D)
    d_idx = lookup[(ci - rows) - int(off_arr.min())]
    out_flat = np.bincount(d_idx * r + rows, weights=v, minlength=D * r)
    return out_flat.reshape(D, r).astype(dtype)


def _csr_pad(tri, r: int, K: int, dtype):
    """Local-column triangle CSR -> fixed-shape (r+1)/(K,) padded arrays
    (padding: val 0, col 0, rid r-1 — the partition_rows convention)."""
    rp = np.asarray(tri.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    nb = rp.shape[0] - 1
    ptr = np.zeros(r + 1, np.int32)
    ptr[1 : nb + 1] = rp[1:]
    ptr[nb + 1 :] = rp[-1]
    col = np.zeros(K, np.int32)
    rid = np.full(K, r - 1, np.int32)
    val = np.zeros(K, dtype)
    col[:nnz] = np.asarray(tri.col_idx)[:nnz]
    rid[:nnz] = np.repeat(np.arange(nb, dtype=np.int32), np.diff(rp))
    val[:nnz] = np.asarray(tri.vals)[:nnz]
    return ptr, col, rid, val


def build_bilu_jacobi(A, n_shards: int, rows_per: int, dtype, steps: int,
                      owned=None, exchange=None):
    """Factor each owned shard's diagonal block with ILU(0) and return the
    stacked device form (``BlockILUDia`` when the unioned factor pattern
    passes the DIA gates, else ``BlockILUCSR``).

    ``A``: the assembled fp64 operator — ``CSRMatrix`` or per-host
    ``RowBlockCSR`` (only owned rows' entries needed).  ``owned``: shard
    ids to materialize (``ShardStack`` leaves); None stacks all shards.
    ``exchange``: combines the per-process metadata partials (offset
    unions, padding widths, the DIA fill vote) — REQUIRED whenever the
    processes' owned sets do not each cover all shards; every process
    calls it exactly once (lockstep).  Factors are computed in fp64 and
    downcast to ``dtype`` like ``build_ilu_jacobi`` (csrilu02 contract,
    ``precond/build.py``)."""
    from gmres_tpu.parallel.partition import ShardStack
    from gmres_tpu.sparse import RowBlockCSR

    dtype = np.dtype(dtype)
    n = A.n_rows
    is_block = isinstance(A, RowBlockCSR)
    fill = sorted(owned) if owned is not None else list(range(n_shards))
    rp = np.asarray(A.row_ptr).astype(np.int64)
    if not is_block:
        nnz_g = int(rp[-1])
        ci_g = np.asarray(A.col_idx)[:nnz_g]
        v_g = np.asarray(A.vals)[:nnz_g]

    facs = {}  # shard -> (lower, upper, inv_diag, nb) local triangles
    offs_l: set[int] = set()
    offs_u: set[int] = set()
    nnz_l = nnz_u = 0
    max_kl = max_ku = 0
    for s in fill:
        lo, hi = s * rows_per, min((s + 1) * rows_per, n)
        nb = max(0, hi - lo)
        if nb == 0:
            facs[s] = None
            continue
        if is_block:
            ci_s, v_s = A.entries(lo, hi)
        else:
            a, b = int(rp[lo]), int(rp[hi])
            ci_s, v_s = ci_g[a:b], v_g[a:b]
        rows_s = np.repeat(np.arange(nb, dtype=np.int64),
                           np.diff(rp[lo : hi + 1]))
        ci64 = np.asarray(ci_s).astype(np.int64)
        keep = (ci64 >= lo) & (ci64 < hi)
        rows_k = rows_s[keep]
        cols_k = (ci64[keep] - lo).astype(np.int32)
        sub_rp = np.zeros(nb + 1, np.int64)
        np.cumsum(np.bincount(rows_k, minlength=nb), out=sub_rp[1:])
        if int((cols_k == rows_k).sum()) != nb:
            raise ValueError(
                f"block rows [{lo}, {hi}) lack an explicit diagonal entry "
                "in some row; load through io.loader (the reference "
                "contract forces a diagonal, LoadMatrix.hpp:97-101)"
            )
        fvals, diag = ilu0_factorize(
            sub_rp, cols_k, np.asarray(v_s)[keep].astype(np.float64),
            factor_dtype=dtype,
        )
        fvals = np.asarray(fvals, np.float64).astype(dtype).astype(np.float64)
        lower, upper, inv_d = _split_triangles(sub_rp, cols_k, fvals, diag,
                                               dtype)
        facs[s] = (lower, upper, inv_d, nb)
        offs_l |= _tri_offsets(lower)
        offs_u |= _tri_offsets(upper)
        nnz_l += lower.nnz
        nnz_u += upper.nnz
        max_kl = max(max_kl, lower.nnz)
        max_ku = max(max_ku, upper.nnz)

    # --- metadata vote (one fixed-shape lockstep allgather): offset
    # unions, global factor nnz, per-shard padding maxima ---
    if exchange is not None:
        from gmres_tpu.parallel.multihost import pack_offsets, union_offsets

        payload = np.concatenate([
            pack_offsets(offs_l, _MAXD), pack_offsets(offs_u, _MAXD),
            np.array([nnz_l, nnz_u, max_kl, max_ku], np.int64),
        ])
        g = np.asarray(exchange(payload))
        u_l = union_offsets(g[:, : _MAXD + 1], _MAXD)
        u_u = union_offsets(g[:, _MAXD + 1 : 2 * (_MAXD + 1)], _MAXD)
        tail = g[:, 2 * (_MAXD + 1) :]
        nnz_l = int(tail[:, 0].sum())
        nnz_u = int(tail[:, 1].sum())
        max_kl = int(tail[:, 2].max())
        max_ku = int(tail[:, 3].max())
    else:
        u_l = offs_l if len(offs_l) <= _MAXD else None
        u_u = offs_u if len(offs_u) <= _MAXD else None

    use_dia = (
        u_l is not None
        and u_u is not None
        and (len(u_l) + len(u_u)) * rows_per * n_shards
        <= 3.0 * max(nnz_l + nnz_u, 1)
    )

    def stack(pieces: dict, shape_tail, dt):
        if owned is not None:
            return ShardStack((n_shards, *shape_tail), np.dtype(dt), pieces)
        return np.stack([pieces[s] for s in range(n_shards)])

    inv_pieces = {}
    for s in fill:
        piece = np.ones(rows_per, dtype=dtype)
        if facs[s] is not None:
            piece[: facs[s][3]] = facs[s][2]
        inv_pieces[s] = piece
    inv_stack = stack(inv_pieces, (rows_per,), dtype)

    if use_dia:
        # strictly-lower may be globally empty (diagonal blocks): keep one
        # zero band so the shifted-FMA loop has static structure
        offsets_l = tuple(sorted(u_l)) or (-1,)
        offsets_u = tuple(sorted(u_u)) or (0,)
        lo_pieces, up_pieces = {}, {}
        for s in fill:
            if facs[s] is None:
                lo_pieces[s] = np.zeros((len(offsets_l), rows_per), dtype)
                up_pieces[s] = np.zeros((len(offsets_u), rows_per), dtype)
            else:
                lo_pieces[s] = _dia_pack(facs[s][0], offsets_l, rows_per, dtype)
                up_pieces[s] = _dia_pack(facs[s][1], offsets_u, rows_per, dtype)
        return BlockILUDia(
            lower=stack(lo_pieces, (len(offsets_l), rows_per), dtype),
            upper=stack(up_pieces, (len(offsets_u), rows_per), dtype),
            inv_diag=inv_stack,
            offsets_l=offsets_l,
            offsets_u=offsets_u,
            steps=steps,
        )

    K_l = max(128, -(-max_kl // 128) * 128)
    K_u = max(128, -(-max_ku // 128) * 128)
    parts = {k: {} for k in ("lp", "lc", "lr", "lv", "up", "uc", "ur", "uv")}
    empty_l = _csr_pad(
        _EmptyTri(rows_per), rows_per, K_l, dtype
    )
    empty_u = _csr_pad(_EmptyTri(rows_per), rows_per, K_u, dtype)
    for s in fill:
        if facs[s] is None:
            lp, lc, lr, lv = empty_l
            up_, uc, ur, uv = empty_u
        else:
            lp, lc, lr, lv = _csr_pad(facs[s][0], rows_per, K_l, dtype)
            up_, uc, ur, uv = _csr_pad(facs[s][1], rows_per, K_u, dtype)
        for k, a in zip(("lp", "lc", "lr", "lv", "up", "uc", "ur", "uv"),
                        (lp, lc, lr, lv, up_, uc, ur, uv)):
            parts[k][s] = a
    return BlockILUCSR(
        l_ptr=stack(parts["lp"], (rows_per + 1,), np.int32),
        l_col=stack(parts["lc"], (K_l,), np.int32),
        l_rid=stack(parts["lr"], (K_l,), np.int32),
        l_val=stack(parts["lv"], (K_l,), dtype),
        u_ptr=stack(parts["up"], (rows_per + 1,), np.int32),
        u_col=stack(parts["uc"], (K_u,), np.int32),
        u_rid=stack(parts["ur"], (K_u,), np.int32),
        u_val=stack(parts["uv"], (K_u,), dtype),
        inv_diag=inv_stack,
        steps=steps,
        rows_per=rows_per,
    )


class _EmptyTri:
    """Zero-entry triangle stand-in for shards past the matrix end."""

    def __init__(self, nb: int):
        self.row_ptr = np.zeros(nb + 1, np.int64)
        self.col_idx = np.zeros(0, np.int32)
        self.vals = np.zeros(0, np.float64)
        self.nnz = 0


def localize_bilu(M):
    """Inside shard_map: rebuild the shard-local ``ILUJacobiPrec`` (with
    ``block_local=True`` so its Jacobi sweeps run without collectives)."""
    from gmres_tpu.ops.dia import DIAMatrix
    from gmres_tpu.precond.build import ILUJacobiPrec
    from gmres_tpu.sparse import CSRMatrix

    if isinstance(M, BlockILUDia):
        r = M.lower.shape[-1]
        return ILUJacobiPrec(
            lower=DIAMatrix(data=M.lower[0], offsets=M.offsets_l,
                            n_rows=r, n_cols=r, nnz=len(M.offsets_l) * r),
            upper=DIAMatrix(data=M.upper[0], offsets=M.offsets_u,
                            n_rows=r, n_cols=r, nnz=len(M.offsets_u) * r),
            inv_diag=M.inv_diag[0],
            steps=M.steps,
            block_local=True,
        )
    if isinstance(M, BlockILUCSR):
        r = M.rows_per

        def mk(ptr, col, rid, val):
            return CSRMatrix(row_ptr=ptr[0], col_idx=col[0], row_ids=rid[0],
                             vals=val[0], n_rows=r, n_cols=r,
                             nnz=int(col.shape[-1]))

        return ILUJacobiPrec(
            lower=mk(M.l_ptr, M.l_col, M.l_rid, M.l_val),
            upper=mk(M.u_ptr, M.u_col, M.u_rid, M.u_val),
            inv_diag=M.inv_diag[0],
            steps=M.steps,
            block_local=True,
        )
    raise TypeError(f"not a block-ILU preconditioner: {type(M)}")
