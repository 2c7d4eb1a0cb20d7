"""Row-partitioned SELL operators for distributed unstructured SpMV.

The reference is single-device (SURVEY.md §2.6).  This module carries the
SELL layout (``ops/sell.py``) under ``shard_map``; solve_distributed uses
it only when asked (``force_sell=True``) — unstructured patterns otherwise
take the halo or allgather CSR partitions:

- SELL chunks are grouped by output block (``ops/sell.py:_plan_parts``),
  which IS a contiguous row partition — each shard packs its own row
  block (``rows_per_shard`` = a multiple of ``ROWS_PER_BLOCK``) with the
  SAME globally-autotuned (W, K), so per-shard SpMVs share one compiled
  program;
- per-shard chunk lists are split at shared static part boundaries
  (cross-shard per-block maxima, <= MAX_CHUNKS_PER_CALL per part) and
  padded per part with inert dummy chunks (zero values, existing output
  block), giving every leaf a uniform ``(P, ...)`` stacked shape that
  shards over the mesh axis;
- inside ``shard_map`` the local ``SELLMatrix`` is rebuilt from the
  leading-dim-1 slices and ``ops/sell.sell_spmv`` runs unchanged on the
  all-gathered operand (``ops/spmv.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import numpy as np

import os

from gmres_tpu.ops.sell import (
    C,
    G_BATCH,
    ROWS_PER_BLOCK,
    SLABS_PER_BLOCK,
    SELLMatrix,
    autotune_wk,
    block_layer_counts,
    sell_from_csr,
)
from gmres_tpu.sparse import CSRMatrix


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("packed", "packed_lo", "bucket", "slab",
                 "dense_data", "dense_lo", "dense_bucket", "dense_slab",
                 "dense_vidx"),
    meta_fields=("n_shards", "rows_per_shard", "n_rows", "n_cols", "nnz",
                 "W", "K", "n_buckets", "n_chunks", "n_dense_chunks",
                 "n_dense_blocks", "df64", "val_dtype", "parts", "G"),
)
@dataclasses.dataclass(frozen=True)
class PartitionedSELL:
    """Per-shard SELL packs stacked over a leading shard axis.

    Static metadata is identical across shards by construction (shared
    (W, K); chunk/dense counts padded per PART to the cross-shard
    per-block maxima), so the shard_map'd SpMV traces once.
    ``n_dense_chunks == 0`` means no shard crossed the dense-fill
    threshold and the dense side is a single shared zero block per shard.

    ``parts`` is the STATIC part plan shared by every shard: each entry
    ``(n_chunks_p, first_block, n_blocks_p)`` owns a disjoint contiguous
    local output-block range and at most ``MAX_CHUNKS_PER_CALL`` chunks.
    Chunk arrays are the per-part lists concatenated;
    ``n_chunks = sum(n_chunks_p)``.
    """

    # only the merged view is stored; the per-slot value/column
    # views (``data``/``cols``) derive from it — see ops/sell.SELLMatrix
    packed: jax.Array      # (P, n_chunks, 2K, C) f32
    packed_lo: jax.Array   # (P, n_chunks, K, C) f32 (0-length when no lo)
    bucket: jax.Array      # (P, n_chunks) int32
    slab: jax.Array        # (P, n_chunks) int32, non-decreasing per shard
    dense_data: jax.Array  # (P, n_dense_blocks, W, C); block 0 = zeros
    dense_lo: jax.Array    # same shape (zeros when not df64)
    dense_bucket: jax.Array  # (P, n_dense_chunks) int32
    dense_slab: jax.Array    # (P, n_dense_chunks) int32
    dense_vidx: jax.Array    # (P, n_dense_chunks) int32
    n_shards: int
    rows_per_shard: int    # multiple of ROWS_PER_BLOCK
    n_rows: int            # true global row count
    n_cols: int            # global PADDED operand length (= P * rows_per)
    nnz: int               # true global stored-entry count
    W: int
    K: int
    n_buckets: int
    n_chunks: int          # per shard TOTAL over parts, multiple of G
    n_dense_chunks: int    # per shard (0 = no dense side anywhere)
    n_dense_blocks: int    # per shard, incl. the shared zero block
    df64: bool             # lo sidecars present (fp64 values)
    val_dtype: str = "float32"
    # static per-shard part plan ((n_chunks_p, first_block, n_blocks_p), ...)
    # — default of () means one part spanning all blocks (legacy packs)
    parts: tuple = ()
    # chunk-count granule shared by every shard (resolved by the
    # cross-shard auto-G pick in partition_sell; default = the
    # process-wide pin)
    G: int = G_BATCH

    @property
    def dtype(self):
        return np.dtype(self.val_dtype)

    @property
    def data(self):
        """Derived (P, n_chunks, K, C) slot values in ``dtype`` (hi + lo
        for fp64 packs).  Plain-array stacks only — per-host ShardStack
        callers read ``packed`` directly."""
        hi = self.packed[:, :, : self.K, :]
        if self.dtype == np.float32:
            return hi
        v = hi.astype(self.val_dtype)
        if self.df64:
            v = v + self.packed_lo.astype(self.val_dtype)
        return v

    @property
    def cols(self):
        from gmres_tpu.ops.sell import _bitcast_i32

        return _bitcast_i32(self.packed[:, :, self.K:, :])

    def astype(self, dtype) -> "PartitionedSELL":
        # storage is dtype-invariant; only the logical value dtype moves
        return dataclasses.replace(self, val_dtype=np.dtype(dtype).name)

    def local_sell(self) -> SELLMatrix:
        """Rebuild the shard-local SELLMatrix inside shard_map (leaves
        there have leading dim 1).  Multi-part packs slice the
        concatenated chunk arrays at the static part offsets, as in the
        single-device path."""
        n_blocks = self.rows_per_shard // ROWS_PER_BLOCK
        has_dense = self.n_dense_chunks > 0
        parts = self.parts or ((self.n_chunks, 0, n_blocks),)
        pk, plo, bk, sl = [], [], [], []
        off = 0
        for (nc, _blo, _nb) in parts:
            pk.append(self.packed[0, off:off + nc])
            if self.df64:
                plo.append(self.packed_lo[0, off:off + nc])
            bk.append(self.bucket[0, off:off + nc])
            sl.append(self.slab[0, off:off + nc])
            off += nc
        return SELLMatrix(
            packed=tuple(pk),
            packed_lo=tuple(plo),
            bucket=tuple(bk),
            slab=tuple(sl),
            dense_data=(self.dense_data[0],),
            dense_lo=(self.dense_lo[0],) if self.df64 else (),
            dense_bucket=(self.dense_bucket[0],) if has_dense else (),
            dense_slab=(self.dense_slab[0],) if has_dense else (),
            dense_vidx=(self.dense_vidx[0],) if has_dense else (),
            n_rows=self.rows_per_shard,
            n_cols=self.n_cols,
            nnz=self.nnz,
            W=self.W,
            K=self.K,
            parts=tuple(parts),
            dense_parts=(
                ((self.n_dense_chunks, 0, n_blocks),) if has_dense else ()
            ),
            n_rows_pad=self.rows_per_shard,
            n_buckets=self.n_buckets,
            val_dtype=self.val_dtype,
            G=self.G,
        )


def _csr_rows(rp, ci, v, lo, hi, n_rows_out, n_cols):
    """Rows [lo, hi) of a host CSR as a lightweight namespace accepted by
    ``sell_from_csr`` (trailing rows beyond hi-lo are empty)."""
    s, e = int(rp[lo]), int(rp[hi])
    rp_loc = (rp[lo:hi + 1] - s).astype(np.int64)
    if n_rows_out > hi - lo:
        rp_loc = np.concatenate(
            [rp_loc, np.full(n_rows_out - (hi - lo), rp_loc[-1], np.int64)]
        )
    return SimpleNamespace(
        row_ptr=rp_loc, col_idx=ci[s:e], vals=v[s:e],
        n_rows=n_rows_out, n_cols=n_cols,
    )


def _empty_pack(n_blocks, W, K, dtype, G):
    """Pack of an all-zero row block: G coverage chunks per output
    block."""
    nc = n_blocks * G
    return SimpleNamespace(
        packed=(np.zeros((nc, 2 * K, C), dtype=np.float32),),
        packed_lo=(np.zeros((nc, K, C), dtype=np.float32),),
        bucket=(np.zeros((nc,), dtype=np.int32),),
        slab=(np.repeat(
            np.arange(n_blocks, dtype=np.int32) * SLABS_PER_BLOCK, G),),
        dense_data=(np.zeros((1, W, C), dtype=np.float32),),
        dense_lo=(np.zeros((1, W, C), dtype=np.float32),),
        dense_bucket=(), dense_slab=(), dense_vidx=(),
        parts=((nc, 0, n_blocks),), dense_parts=(),
    )


def _pad_chunks(arrs, n_pad, last_slab=None):
    """Append inert chunks: zeros, or repeats of ``last_slab`` for the
    slab array (keeps the non-decreasing block order)."""
    a = arrs[0]
    cur = a.shape[0]
    if cur == n_pad:
        return np.asarray(a)
    if last_slab is not None:
        pad = np.full((n_pad - cur,) + a.shape[1:], last_slab, a.dtype)
    else:
        pad = np.zeros((n_pad - cur,) + a.shape[1:], a.dtype)
    return np.concatenate([np.asarray(a), pad])


def _plan_shard_parts(mx):
    """Static per-shard part plan from the cross-shard per-block chunk
    maxima ``mx``: greedy cut at output-block boundaries so every part
    holds at most MAX_CHUNKS_PER_CALL chunks.  A single block over the
    budget gets its own part, mirroring ``ops/sell._plan_parts``.  Returns
    ``((cap, first_block, n_blocks), ...)`` — identical for every shard,
    which is what lets the shard_map'd SpMV trace once."""
    from gmres_tpu.ops.sell import MAX_CHUNKS_PER_CALL

    parts = []
    blo, cap = 0, 0
    for b in range(mx.shape[0]):
        c = int(mx[b])
        if cap and cap + c > MAX_CHUNKS_PER_CALL:
            parts.append((cap, blo, b - blo))
            blo, cap = b, 0
        cap += c
    parts.append((cap, blo, mx.shape[0] - blo))
    return tuple(parts)


def _pad_shard_to_plan(p, part_plan, G):
    """Rewrite one shard snapshot's chunk arrays to the shared part plan:
    per part, slice the shard's chunks for that block range (the list is
    slab-sorted, so it is contiguous) and pad to the part capacity with
    inert repeats of the part's last chunk (zero values, existing block;
    lands in complete G-groups since both counts are multiples of the
    shared G)."""
    pref = np.zeros(p.cnt.shape[0] + 1, dtype=np.int64)
    np.cumsum(p.cnt, out=pref[1:])
    pk, plo, bk, sl = [], [], [], []
    for (cap, blo, nb) in part_plan:
        a, b = int(pref[blo]), int(pref[blo + nb])
        pad = cap - (b - a)
        assert pad >= 0 and pad % G == 0, (cap, b - a)
        pk.append(_pad_chunks((p.packed[a:b],), cap))
        if p.packed_lo.shape[0]:
            plo.append(_pad_chunks((p.packed_lo[a:b],), cap))
        bk.append(_pad_chunks((p.bucket[a:b],), cap))
        sl.append(_pad_chunks((p.slab[a:b],), cap,
                              last_slab=int(p.slab[b - 1])))
    p.packed = np.concatenate(pk) if len(pk) > 1 else pk[0]
    if plo:
        p.packed_lo = np.concatenate(plo) if len(plo) > 1 else plo[0]
    p.bucket = np.concatenate(bk) if len(bk) > 1 else bk[0]
    p.slab = np.concatenate(sl) if len(sl) > 1 else sl[0]
    return p


def sell_rows_per(n: int, n_shards: int) -> int:
    """The SELL partition's shard height: rows per shard rounded up to a
    multiple of ROWS_PER_BLOCK (larger than the plain ceil(n/P) blocks —
    per-host loaders must use THIS grid for SELL-routed solves)."""
    return -(-n // (n_shards * ROWS_PER_BLOCK)) * ROWS_PER_BLOCK


def partition_sell(
    A: CSRMatrix,
    n_shards: int,
    df64: bool = False,
    dtype=np.float32,
    W: int | None = None,
    K: int | None = None,
    max_bytes_per_nnz: float = 256.0,
    owned=None,
    exchange=None,
) -> PartitionedSELL | None:
    """Partition A into per-shard SELL packs with shared (W, K).

    Returns None when the global cost model refuses the pattern (same
    gate as ``sell_from_csr``) or any shard's chunk list would need
    multiple parts (> MAX_CHUNKS_PER_CALL chunks — larger than any
    realistic per-shard slice).

    ``owned`` (iterable of shard ids): per-host mode — only those shards'
    pack arrays are RETAINED (``parallel/partition.ShardStack`` leaves).
    Non-owned shards are still packed one at a time to derive the shared
    padding metadata (chunk/dense-block maxima must agree across
    processes), but each transient pack is dropped immediately, so peak
    host memory stays ~(owned + 1)/P of the global pack instead of P/P.
    The (W, K) autotune likewise scans one shard's structure at a time.

    ``A`` may be a ``RowBlockCSR`` (per-host INPUT: only the owned rows'
    entries exist here — the block must cover the owned shards on the
    ``sell_rows_per`` grid).  Unowned shards are then never packed; the
    shared metadata (autotune chunk counts, padding maxima) is combined
    across processes through ``exchange``
    (``multihost.exchange_host_array``)."""
    from gmres_tpu.sparse import RowBlockCSR

    n = A.n_rows
    rows_per = sell_rows_per(n, n_shards)
    n_pad = rows_per * n_shards
    n_blocks = rows_per // ROWS_PER_BLOCK

    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    if nnz == 0:
        return None
    is_block = isinstance(A, RowBlockCSR)
    if is_block and owned is None:
        owned = range(n_shards)

    _csr_cache = {}  # owned path: memoized per-shard sorted CSRs (below)
    if owned is None:
        ci = np.asarray(A.col_idx)[:nnz].astype(np.int64)
        v = np.asarray(A.vals)[:nnz]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        # the group machinery requires (row, col) order (see sell_from_csr)
        rc_key = rows * np.int64(n_pad) + ci
        if not np.all(rc_key[1:] >= rc_key[:-1]):
            order = np.argsort(rc_key, kind="stable")
            rows, ci, v = rows[order], ci[order], v[order]
            rp = np.concatenate(
                [[0], np.cumsum(np.bincount(rows, minlength=n))]
            ).astype(np.int64)
        del rc_key

        if W is None or K is None:
            tuned = autotune_wk(rows, ci, n_pad, nnz, W, K, max_bytes_per_nnz)
            if tuned is None:
                return None
            W, K = tuned

        def local_csr(s):
            lo = s * rows_per
            hi = min((s + 1) * rows_per, n)
            if hi <= lo or rp[hi] == rp[lo]:
                return None
            return _csr_rows(rp, ci, v, lo, hi, rows_per, n_pad)
    else:
        owned = sorted(set(owned))
        if not is_block:
            ci_raw = np.asarray(A.col_idx)
            v_raw = np.asarray(A.vals)

        # Memoize per shard (_csr_cache): the (W, K) autotune below scans
        # every shard once per W candidate and the pack loop once more —
        # without the cache each scan repeats the entry slice + stable
        # sort (~5x the partition wall on the single-core host).  The pack
        # loop pops entries as it consumes them, so the peak is one extra
        # copy of this process's shards (is_block: ~global/P), held only
        # between autotune and pack.
        def local_csr(s):
            """Shard s's rows as a sorted local CSR (O(global/P) transient;
            per-range sorting replaces the global path's one-shot sort)."""
            if s in _csr_cache:
                return _csr_cache[s]
            lo = s * rows_per
            hi = min((s + 1) * rows_per, n)
            if hi <= lo or rp[hi] == rp[lo]:
                return None
            if is_block:
                ci_l, v_l = A.entries(lo, hi)
                ci_l = np.asarray(ci_l).astype(np.int64)
                v_l = np.asarray(v_l)
            else:
                a, b = int(rp[lo]), int(rp[hi])
                ci_l = ci_raw[a:b].astype(np.int64)
                v_l = v_raw[a:b]
            rows_l = np.repeat(
                np.arange(hi - lo, dtype=np.int64), np.diff(rp[lo:hi + 1])
            )
            key = rows_l * np.int64(n_pad) + ci_l
            if not np.all(key[1:] >= key[:-1]):
                order = np.argsort(key, kind="stable")
                rows_l, ci_l, v_l = rows_l[order], ci_l[order], v_l[order]
            rp_l = np.concatenate(
                [[0], np.cumsum(np.bincount(rows_l, minlength=rows_per))]
            ).astype(np.int64)
            loc = SimpleNamespace(
                row_ptr=rp_l, col_idx=ci_l, vals=v_l,
                n_rows=rows_per, n_cols=n_pad, _rows=rows_l,
            )
            _csr_cache[s] = loc
            return loc

        if W is None or K is None:
            from gmres_tpu.ops.sell import _chunk_sb_max

            scan_shards = owned if is_block else range(n_shards)

            def sb_counter(Wc):
                for s in scan_shards:
                    loc = local_csr(s)
                    if loc is None:
                        continue
                    yield _chunk_sb_max(loc._rows, loc.col_idx, n_pad, Wc)

            counts_exchange = None
            if is_block and exchange is not None:
                counts_exchange = (
                    lambda c: exchange(np.array([c], np.int64)).sum()
                )
            tuned = autotune_wk(None, None, n_pad, nnz, W, K,
                                max_bytes_per_nnz, sbmax_counter=sb_counter,
                                counts_exchange=counts_exchange)
            if tuned is None:
                return None
            W, K = tuned

    # --- resolve the shared G (chunk-count granule) ---
    # The env override wins (G_BATCH reads GMRES_TPU_SELL_G); otherwise
    # pick the largest of {16, 8, 4} whose exact dummy padding over the
    # REAL cross-shard per-(shard, block) chunk counts stays within 2% —
    # the same rule as the single-device auto-pick (ops/sell._auto_g).
    if os.environ.get("GMRES_TPU_SELL_G"):
        G_part = G_BATCH
    else:
        def _pad_stats(counts):
            return (int(counts.sum()),
                    {g: int(np.where(counts == 0, g, (-counts) % g).sum())
                     for g in (16, 8)})

        if owned is None:
            # shards are contiguous ROWS_PER_BLOCK-aligned row ranges, so
            # the global per-block count vector IS the per-shard vectors
            # concatenated
            g_total, g_pads = _pad_stats(block_layer_counts(
                rows, ci, n_pad, W, K, n_shards * n_blocks))
        else:
            g_total, g_pads = 0, {16: 0, 8: 0}
            for s in (owned if is_block else range(n_shards)):
                loc = local_csr(s)
                if loc is None:
                    # empty shard: counts are all zero -> each block pads
                    # a full coverage group of g
                    for g in g_pads:
                        g_pads[g] += g * n_blocks
                    continue
                t, p = _pad_stats(block_layer_counts(
                    loc._rows, loc.col_idx, n_pad, W, K, n_blocks))
                g_total += t
                for g in g_pads:
                    g_pads[g] += p[g]
            if is_block and exchange is not None:
                partial_ = np.array(
                    [g_total, g_pads[16], g_pads[8]], np.int64)
                summed = np.asarray(exchange(partial_)).sum(axis=0)
                g_total = int(summed[0])
                g_pads = {16: int(summed[1]), 8: int(summed[2])}
        G_part = 4
        for g in (16, 8):
            if g_pads[g] * 50 <= g_total:
                G_part = g
                break

    def _cat(arrs):
        arrs = [np.asarray(a) for a in arrs]
        return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)

    metas = []   # per shard: (per-block chunk counts, n_dense, ndb)
    packs = {}   # shard -> retained snapshot (all shards when owned=None)
    retain = set(range(n_shards)) if owned is None else set(owned)
    # per-host INPUT: unowned shards cannot be packed (their entries are
    # on other processes) — the padding maxima come from an exchange below
    # A pack failure (cost-gate refusal, dense multi-part) is PROCESS-LOCAL
    # under per-host input, but the padding-metadata exchange below is a
    # collective every process must reach — an early return here would
    # deadlock the others in the allgather.  Record the failure, fall
    # through to the exchange, and let every process agree to bail.
    pack_failed = False
    scan = sorted(retain) if is_block else range(n_shards)
    for s in scan:
        local = local_csr(s)
        _csr_cache.pop(s, None)  # pack is the last consumer of this shard
        if local is None:
            if s in retain:
                sell = _empty_pack(n_blocks, W, K, np.dtype(dtype), G_part)
            else:
                metas.append(SimpleNamespace(
                    cnt=np.full(n_blocks, G_part, np.int64),
                    n_dense=0, ndb=1))
                continue
        else:
            # G pinned to the partition-wide G_part: every shard of a
            # PartitionedSELL (including _empty_pack's coverage chunks)
            # must share one chunk layout.  A shard whose chunk list
            # exceeds MAX_CHUNKS_PER_CALL is fine: the part plan below
            # splits every shard at the same static block boundaries.
            sell = sell_from_csr(local, W=W, K=K, df64=df64, dtype=dtype,
                                 host_arrays=True, G=G_part)
            bad = (sell is None
                   or (sell.dense_parts and len(sell.dense_parts) != 1))
            if bad:
                if is_block and exchange is not None:
                    pack_failed = True
                    break
                return None
        # per-shard snapshot with parts concatenated back into one
        # slab-sorted chunk list (``_plan_parts`` splits are contiguous
        # slices, so concatenation restores the full list exactly)
        slab_full = _cat(sell.slab).astype(np.int32)
        cnt = np.bincount(slab_full // SLABS_PER_BLOCK,
                          minlength=n_blocks).astype(np.int64)
        nd = sell.dense_parts[0][0] if sell.dense_parts else 0
        metas.append(SimpleNamespace(
            cnt=cnt, n_dense=nd,
            ndb=np.asarray(sell.dense_data[0]).shape[0]))
        if s in retain:
            # mutable per-shard snapshot (SELLMatrix is frozen)
            packs[s] = SimpleNamespace(
                packed=_cat(sell.packed),
                packed_lo=(_cat(sell.packed_lo) if sell.packed_lo
                           else np.zeros((0, K, C), np.float32)),
                bucket=_cat(sell.bucket),
                slab=slab_full,
                dense_data=np.asarray(sell.dense_data[0], np.float32),
                dense_lo=(np.asarray(sell.dense_lo[0], np.float32)
                          if sell.dense_lo else None),
                dense_bucket=(np.asarray(sell.dense_bucket[0])
                              if sell.dense_parts else None),
                dense_slab=(np.asarray(sell.dense_slab[0])
                            if sell.dense_parts else None),
                dense_vidx=(np.asarray(sell.dense_vidx[0])
                            if sell.dense_parts else None),
                cnt=cnt,
                n_dense=nd,
            )
        del sell

    # --- pad chunk lists per PART to the cross-shard per-block maxima ---
    mx_local = np.zeros(n_blocks, dtype=np.int64)
    for m in metas:
        np.maximum(mx_local, m.cnt, out=mx_local)
    if is_block and exchange is not None:
        # combine the padding metadata across processes (each saw only its
        # owned shards): [any dense, max dense chunks, any shard WITHOUT a
        # dense side, max dense blocks, pack failed] + per-block chunk max
        payload = np.concatenate([np.array([
            int(any(m.n_dense for m in metas)),
            max((m.n_dense for m in metas), default=0),
            int(any(m.n_dense == 0 for m in metas)),
            max((m.ndb for m in metas), default=1),
            int(pack_failed),
        ], dtype=np.int64), mx_local])
        g = np.asarray(exchange(payload))
        if g[:, 4].any():
            return None  # some process's shard refused to pack: all bail
        has_dense = bool(g[:, 0].any())
        g_max_nd = int(g[:, 1].max())
        g_any_zero_nd = bool(g[:, 2].any())
        g_max_ndb = int(g[:, 3].max())
        mx = g[:, 5:].max(axis=0)
        if has_dense:
            max_ndc = max(g_max_nd, n_blocks if g_any_zero_nd else 0)
            max_ndb = g_max_ndb
        else:
            max_ndc, max_ndb = 0, 1
    else:
        mx = mx_local
        has_dense = any(m.n_dense for m in metas)
        if has_dense:
            max_ndc = max(m.n_dense if m.n_dense else n_blocks
                          for m in metas)
            max_ndb = max(m.ndb for m in metas)
        else:
            max_ndc, max_ndb = 0, 1

    if has_dense:
        # shards without a dense side need per-block coverage chunks
        # (every output block of the dense call must be visited once so
        # the revisited block is zero-initialized)
        cov_slab = np.arange(n_blocks, dtype=np.int32) * SLABS_PER_BLOCK
        for p in packs.values():
            if not p.n_dense:
                p.dense_bucket = np.zeros((n_blocks,), np.int32)
                p.dense_slab = cov_slab
                p.dense_vidx = np.zeros((n_blocks,), np.int32)
                p.n_dense = n_blocks

    part_plan = _plan_shard_parts(mx)
    for p in packs.values():
        _pad_shard_to_plan(p, part_plan, G_part)
    return _assemble_partitioned_sell(
        packs, owned, n_shards, rows_per, n, n_pad, nnz, W, K,
        n_blocks, part_plan, has_dense, max_ndc, max_ndb, df64, dtype,
        G_part,
    )


def _assemble_partitioned_sell(packs, owned, n_shards, rows_per, n, n_pad,
                               nnz, W, K, n_blocks, part_plan, has_dense,
                               max_ndc, max_ndb, df64, dtype, G_part=G_BATCH):
    """Stack the retained per-shard packs (chunk arrays already padded to
    the shared part plan by ``_pad_shard_to_plan``) into a
    PartitionedSELL — the tail shared by the single-host, per-host
    (owned) and per-host-input (RowBlockCSR + exchange) paths."""
    max_nc = sum(p[0] for p in part_plan)

    def finish(pieces, empty_trailing_shape, empty_dtype):
        """Stack (single-host) or wrap as ShardStack (per-host)."""
        if owned is None:
            return np.stack([pieces[s] for s in range(n_shards)])
        from gmres_tpu.parallel.partition import ShardStack

        if pieces:
            a0 = next(iter(pieces.values()))
            return ShardStack((n_shards,) + a0.shape, a0.dtype, pieces)
        return ShardStack((n_shards,) + empty_trailing_shape,
                          np.dtype(empty_dtype), pieces)

    def stack(field, n_pad_chunks, slab_src=None, trailing=(), tdtype=np.float32):
        pieces = {}
        for s, p in packs.items():
            a = getattr(p, field)
            last = (int(getattr(p, slab_src)[-1])
                    if slab_src is not None else None)
            pieces[s] = _pad_chunks((a,), n_pad_chunks, last_slab=last)
        return finish(pieces, (n_pad_chunks,) + trailing, tdtype)

    # lo sidecars exist whenever the pack values are fp64 (the derived
    # ``data`` view reconstructs hi + lo) or the caller asked for them
    has_lo = df64 or np.dtype(dtype) == np.dtype(np.float64)
    packed = stack("packed", max_nc, trailing=(2 * K, C))
    packed_lo = (stack("packed_lo", max_nc, trailing=(K, C)) if has_lo
                 else np.zeros((n_shards, 0, K, C), np.float32))
    bucket = stack("bucket", max_nc, tdtype=np.int32)
    slab = stack("slab", max_nc, slab_src="slab", tdtype=np.int32)

    if has_dense:
        dense_bucket = stack("dense_bucket", max_ndc, tdtype=np.int32)
        dense_slab = stack("dense_slab", max_ndc, slab_src="dense_slab",
                           tdtype=np.int32)
        dense_vidx = stack("dense_vidx", max_ndc, tdtype=np.int32)
    else:
        dense_bucket = np.zeros((n_shards, 0), np.int32)
        dense_slab = np.zeros((n_shards, 0), np.int32)
        dense_vidx = np.zeros((n_shards, 0), np.int32)

    def pad_blocks(a, target):
        if a.shape[0] >= target:
            return a
        return np.concatenate(
            [a, np.zeros((target - a.shape[0],) + a.shape[1:], a.dtype)]
        )

    dense_data = finish(
        {s: pad_blocks(p.dense_data, max_ndb) for s, p in packs.items()},
        (max_ndb, W, C), np.float32,
    )
    if has_lo:
        dense_lo = finish(
            {
                s: pad_blocks(
                    p.dense_lo if p.dense_lo is not None
                    else np.zeros((1, W, C), np.float32),
                    max_ndb,
                )
                for s, p in packs.items()
            },
            (max_ndb, W, C), np.float32,
        )
    else:
        # placeholder leaf, never read when no lo sidecar exists
        dense_lo = np.zeros((n_shards, 1, 1, 1), np.float32)

    return PartitionedSELL(
        packed=packed,
        packed_lo=packed_lo,
        bucket=bucket,
        slab=slab,
        dense_data=dense_data,
        dense_lo=dense_lo,
        dense_bucket=dense_bucket,
        dense_slab=dense_slab,
        dense_vidx=dense_vidx,
        n_shards=n_shards,
        rows_per_shard=rows_per,
        n_rows=n,
        n_cols=n_pad,
        nnz=nnz,
        W=W,
        K=K,
        n_buckets=max(1, -(-n_pad // W)),
        n_chunks=max_nc,
        n_dense_chunks=max_ndc,
        n_dense_blocks=max_ndb,
        df64=has_lo,
        val_dtype=np.dtype(dtype).name,
        parts=tuple(part_plan),
        G=G_part,
    )
