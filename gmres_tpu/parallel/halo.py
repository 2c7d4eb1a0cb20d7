"""Halo-exchange distributed SpMV.

The allgather baseline (``ops/spmv.py``) moves (P-1)/P of the operand
vector to every chip per SpMV.  For row-partitioned banded matrices each
shard only needs two small *edge windows* of x from its neighbors, so the
exchange becomes two ``ppermute`` sends of ``halo`` elements — O(bandwidth)
instead of O(n) — to the neighbouring devices (SURVEY.md §5.8, the
"context-parallel of Krylov solvers").

Composition with DIA: a row block of a DIA matrix is a column slice of the
diagonal data with unchanged (static) offsets, so the local SpMV stays a
fused shifted-FMA pass over ``[left_halo | local | right_halo]``.  A
rebased-CSR variant covers banded-but-irregular patterns.

Restriction (checked at partition time): the halo must fit within the
immediate neighbors (halo <= rows_per_shard).  Wider-than-one-shard
couplings fall back to the allgather path.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.ops.dia import DIAMatrix, from_csr, shift_read
from gmres_tpu.parallel.partition import PartitionedCSR, padded_size, partition_rows
from gmres_tpu.sparse import CSRMatrix


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("data",),
    meta_fields=("offsets", "n_shards", "rows_per_shard", "halo_left",
                 "halo_right", "nnz"),
)
@dataclasses.dataclass(frozen=True)
class HaloDIA:
    """Row-partitioned DIA with neighbor-halo exchange."""

    data: jax.Array            # (P, D, rows_per)
    offsets: tuple[int, ...]   # global diagonal offsets
    n_shards: int
    rows_per_shard: int
    halo_left: int
    halo_right: int
    nnz: int

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def vals(self) -> jax.Array:
        return self.data.reshape(-1)

    def astype(self, dtype) -> "HaloDIA":
        return dataclasses.replace(self, data=self.data.astype(dtype))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("row_ptr", "col_idx", "row_ids", "vals"),
    meta_fields=("n_shards", "rows_per_shard", "halo_left", "halo_right", "nnz"),
)
@dataclasses.dataclass(frozen=True)
class HaloCSR:
    """Row-partitioned CSR with columns rebased into the haloed window
    ``[s*r - halo_left, (s+1)*r + halo_right)``."""

    row_ptr: jax.Array  # (P, rows_per+1)
    col_idx: jax.Array  # (P, K) — window-local indices
    row_ids: jax.Array  # (P, K)
    vals: jax.Array     # (P, K)
    n_shards: int
    rows_per_shard: int
    halo_left: int
    halo_right: int
    nnz: int

    @property
    def dtype(self):
        return self.vals.dtype

    def astype(self, dtype) -> "HaloCSR":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))


def _round_up(v: int, mult: int = 128) -> int:
    return max(mult, -(-v // mult) * mult)


def partition_halo(A: CSRMatrix, n_shards: int, owned=None, exchange=None):
    """Partition A for halo exchange.  Returns HaloDIA (banded), HaloCSR
    (irregular but neighbor-local), or None (fall back to allgather).

    ``owned`` (iterable of shard ids): per-host mode — materialize data
    only for those shards (``ShardStack`` leaves).  Partitioning metadata
    (diagonal offsets, halo widths, acceptance gates) is computed from
    range-at-a-time structure scans whose transient footprint is
    O(global/P), so every process derives identical metadata from the
    shared CSR structure with no communication.

    ``A`` may be a ``RowBlockCSR`` (per-host INPUT: only the owned rows'
    entries exist on this process).  The structure scans then cover only
    the local block and the per-process metadata partials are combined
    through ``exchange`` (``multihost.exchange_host_array``: a fixed-shape
    ``np.ndarray -> (P, ...) stack`` allgather).  ``exchange=None`` treats
    the local partials as global (single-process blocks)."""
    from gmres_tpu.sparse import RowBlockCSR

    n = A.n_rows
    n_pad = padded_size(n, n_shards)
    r = n_pad // n_shards

    if owned is not None or isinstance(A, RowBlockCSR):
        if owned is None:
            owned = range(n_shards)
        return _partition_halo_owned(A, n_shards, owned, n_pad, r, exchange)

    dia = from_csr(A)
    if dia is not None:
        hl = max(0, -min(dia.offsets))
        hr = max(0, max(dia.offsets))
        if hl <= r and hr <= r:
            data = np.asarray(dia.data)
            if n_pad != n:
                data = np.concatenate(
                    [data, np.zeros((data.shape[0], n_pad - n), data.dtype)], axis=1
                )
            D = data.shape[0]
            stacked = data.reshape(D, n_shards, r).transpose(1, 0, 2).copy()
            return HaloDIA(
                data=stacked,
                offsets=dia.offsets,
                n_shards=n_shards,
                rows_per_shard=r,
                halo_left=min(_round_up(hl), r) if hl else 0,
                halo_right=min(_round_up(hr), r) if hr else 0,
                nnz=A.nnz,
            )

    # irregular pattern: rebased CSR if all columns stay within one
    # neighbor's range
    part = partition_rows(A, n_shards)
    cols = np.asarray(part.col_idx)
    vals = np.asarray(part.vals)
    base = np.arange(n_shards, dtype=np.int64)[:, None] * r
    rel = cols.astype(np.int64) - base  # column relative to shard start
    active = vals != 0
    if not active.any():
        return None
    hl = int(np.maximum(0, -(rel[active].min())))
    hr = int(np.maximum(0, rel[active].max() - (r - 1)))
    if hl > r or hr > r:
        return None
    hl = min(_round_up(hl), r) if hl else 0
    hr = min(_round_up(hr), r) if hr else 0
    rebased = (rel + hl).astype(np.int32)
    rebased[~active] = 0  # padding entries point anywhere in-window
    return HaloCSR(
        row_ptr=part.row_ptr,
        col_idx=rebased,
        row_ids=part.row_ids,
        vals=part.vals,
        n_shards=n_shards,
        rows_per_shard=r,
        halo_left=hl,
        halo_right=hr,
        nnz=A.nnz,
    )


_MAX_DIAGS = 256  # from_csr's diagonal-count gate


def _partition_halo_owned(A, n_shards: int, owned, n_pad: int,
                          r: int, exchange=None):
    """Per-host ``partition_halo``: same acceptance gates and results as
    the global path (``ops/dia.py:from_csr`` fill/diag-count gates, halo
    width bounds), but value arrays are built only for ``owned`` shards
    and every metadata pass scans one shard's row range at a time.

    With a ``RowBlockCSR`` input only the block's ranges are scannable;
    the metadata partials (unique diagonal offsets — clipped at the
    ``_MAX_DIAGS`` gate — and halo width bounds) are tiny fixed-shape
    arrays combined across processes via ``exchange``."""
    from gmres_tpu.parallel.partition import ShardStack, partition_rows
    from gmres_tpu.sparse import RowBlockCSR

    owned = sorted(set(owned))
    n = A.n_rows
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    if nnz == 0:
        return None
    is_block = isinstance(A, RowBlockCSR)
    if is_block:
        vdtype = A.vals.dtype
    else:
        ci = np.asarray(A.col_idx)
        v = np.asarray(A.vals)
        vdtype = v.dtype

    def ranges(scan_owned: bool):
        shards = owned if scan_owned else range(n_shards)
        for s in shards:
            lo, hi = s * r, min((s + 1) * r, n)
            if hi <= lo:
                continue
            a, b = int(rp[lo]), int(rp[hi])
            if b <= a:
                continue
            yield s, lo, hi, a, b

    def entries(lo, hi, a, b):
        if is_block:
            return A.entries(lo, hi)
        return ci[a:b], v[a:b]

    # --- pass 1+2: unique diagonal offsets (same uniquing as from_csr),
    # scanned range at a time; per-process partials union'd via exchange.
    # Local uniques above the _MAX_DIAGS gate are clipped — the global
    # count can only be larger, so the gate outcome is unaffected. ---
    local_offs = set()
    overflow = False
    for s, lo, hi, a, b in ranges(scan_owned=is_block):
        rows_s = np.repeat(np.arange(lo, hi, dtype=np.int64),
                           np.diff(rp[lo:hi + 1]))
        ci_s, _ = entries(lo, hi, a, b)
        offs_s = np.unique(ci_s.astype(np.int64) - rows_s)
        local_offs.update(int(o) for o in offs_s)
        if len(local_offs) > _MAX_DIAGS:
            overflow = True
            break
    if is_block and exchange is not None:
        from gmres_tpu.parallel.multihost import pack_offsets, union_offsets

        payload = pack_offsets(
            range(_MAX_DIAGS + 1) if overflow else local_offs, _MAX_DIAGS
        )  # an over-long iterable encodes local overflow (-1 sentinel)
        union = union_offsets(np.asarray(exchange(payload)), _MAX_DIAGS)
        overflow = union is None
        if not overflow:
            local_offs = union
    uniq = np.array(sorted(local_offs), dtype=np.int64)
    D = uniq.shape[0] if not overflow else _MAX_DIAGS + 1

    # from_csr's profitability gate (max_fill=3.0, max_diags=256)
    if D == 0:
        # an empty owned block with no exchange: global structure is
        # unknowable here; with exchange this implies nnz == 0 (handled
        # above), so every process agrees on the fallback
        return None
    if D <= _MAX_DIAGS and D * n <= 3.0 * max(nnz, 1):
        off_min = int(uniq.min())
        span = int(uniq.max()) - off_min + 1
        hl = max(0, -int(uniq.min()))
        hr = max(0, int(uniq.max()))
        if hl <= r and hr <= r:
            lookup = np.zeros(span, dtype=np.int64)
            lookup[uniq - off_min] = np.arange(D)
            pieces = {}
            by_shard = {s: (lo, hi, a, b)
                        for s, lo, hi, a, b in ranges(scan_owned=is_block)}
            for s in owned:
                if s not in by_shard:
                    pieces[s] = np.zeros((D, r), dtype=vdtype)
                    continue
                lo, hi, a, b = by_shard[s]
                rows_s = np.repeat(np.arange(lo, hi, dtype=np.int64),
                                   np.diff(rp[lo:hi + 1]))
                ci_s, v_s = entries(lo, hi, a, b)
                d_idx = lookup[ci_s.astype(np.int64) - rows_s - off_min]
                pieces[s] = np.bincount(
                    d_idx * r + (rows_s - lo), weights=v_s,
                    minlength=D * r,
                ).reshape(D, r).astype(vdtype)
            return HaloDIA(
                data=ShardStack((n_shards, D, r), np.dtype(vdtype), pieces),
                offsets=tuple(int(o) for o in uniq),
                n_shards=n_shards,
                rows_per_shard=r,
                halo_left=min(_round_up(hl), r) if hl else 0,
                halo_right=min(_round_up(hr), r) if hr else 0,
                nnz=nnz,
            )

    # --- irregular: rebased CSR if all columns stay neighbor-local ---
    hl = hr = 0
    any_active = False
    for s, lo, hi, a, b in ranges(scan_owned=is_block):
        ci_s, v_s = entries(lo, hi, a, b)
        active = v_s != 0
        if not active.any():
            continue
        any_active = True
        rel = ci_s.astype(np.int64)[active] - s * r
        hl = max(hl, int(np.maximum(0, -rel.min())))
        hr = max(hr, int(np.maximum(0, rel.max() - (r - 1))))
    if is_block and exchange is not None:
        gathered = np.asarray(
            exchange(np.array([hl, hr, int(any_active)], dtype=np.int64))
        )
        hl = int(gathered[:, 0].max())
        hr = int(gathered[:, 1].max())
        any_active = bool(gathered[:, 2].any())
    if not any_active or hl > r or hr > r:
        return None
    hl = min(_round_up(hl), r) if hl else 0
    hr = min(_round_up(hr), r) if hr else 0

    part = partition_rows(A, n_shards, owned=owned)
    col_pieces = {}
    for s in owned:
        cols_s = part.col_idx.pieces[s].astype(np.int64)
        rebased = (cols_s - s * r + hl).astype(np.int32)
        rebased[part.vals.pieces[s] == 0] = 0
        col_pieces[s] = rebased
    return HaloCSR(
        row_ptr=part.row_ptr,
        col_idx=ShardStack(part.col_idx.shape, np.dtype(np.int32), col_pieces),
        row_ids=part.row_ids,
        vals=part.vals,
        n_shards=n_shards,
        rows_per_shard=r,
        halo_left=hl,
        halo_right=hr,
        nnz=nnz,
    )


def _exchange_halos(x_local: jax.Array, hl: int, hr: int, P: int,
                    axis_name: str):
    """Build [left_halo | x_local | right_halo] via neighbor ppermutes.
    Boundary shards receive zeros (ppermute zero-fills missing sources),
    matching out-of-range matrix entries which are structurally zero."""
    parts = []
    if hl:
        # shard s receives the tail of shard s-1
        left = jax.lax.ppermute(
            x_local[-hl:], axis_name, [(s, s + 1) for s in range(P - 1)]
        )
        parts.append(left)
    parts.append(x_local)
    if hr:
        # shard s receives the head of shard s+1
        right = jax.lax.ppermute(
            x_local[:hr], axis_name, [(s + 1, s) for s in range(P - 1)]
        )
        parts.append(right)
    if len(parts) == 1:
        return x_local
    return jnp.concatenate(parts)


def halo_spmv(A, x_local: jax.Array, axis: str) -> jax.Array:
    """Local y = A_block @ x using neighbor halo exchange.  Called inside
    shard_map; ``A`` leaves have a leading length-1 shard dim."""
    P = A.n_shards
    hl, hr = A.halo_left, A.halo_right
    if isinstance(A, HaloDIA):
        x_local = x_local.astype(A.data.dtype)
        xx = _exchange_halos(x_local, hl, hr, P, axis)
        data = A.data[0]  # (D, r)
        r = A.rows_per_shard
        y = jnp.zeros((r,), dtype=data.dtype)
        for d, off in enumerate(A.offsets):
            y = y + data[d] * shift_read(xx, off + hl, r)
        return y
    if isinstance(A, HaloCSR):
        x_local = x_local.astype(A.vals.dtype)
        xx = _exchange_halos(x_local, hl, hr, P, axis)
        prod = A.vals[0] * xx[A.col_idx[0]]
        return jax.ops.segment_sum(
            prod, A.row_ids[0], num_segments=A.rows_per_shard,
            indices_are_sorted=True,
        )
    raise TypeError(f"not a halo operator: {type(A)}")
