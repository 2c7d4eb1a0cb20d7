"""SELL (sliced-ELL) format for *unstructured* sparsity.

The reference runs arbitrary-CSR SpMV through ``mkl_sparse_d_mv`` /
``cusparseDcsrmv`` (``kernels_mkl.cpp:326-352``,
``kernels_cuda.cpp:576-614``); the default path here is the CSR gather +
segment sum of ``ops/spmv.py``.  SELL is an alternative layout, reached
only when a caller asks for it (``sell_from_csr``, ``force_sell`` in
``solve_distributed``), that replaces the per-nonzero row ids of CSR with
bucketed, fixed-width slots:

- rows are grouped into **slabs of C=128**;
- columns are cut into **static buckets of width W** — bucket ``b`` covers
  ``[b*W, (b+1)*W)``, so the operand window for a chunk is the *contiguous*
  slice ``x[b*W : (b+1)*W]``;
- each (slab, bucket) pair packs its entries into **K-wide ELL layers**:
  chunk ``(slab, bucket, layer)`` holds slot ``k`` of every row's entries
  ``[layer*K, layer*K + K)`` that fall in the bucket;
- dense (slab, bucket) pairs are stored as explicit (W, C) blocks.

The chunk list is pre-split at pack time into parts of at most
``MAX_CHUNKS_PER_CALL`` chunks, cut at output-block boundaries (static
metadata — the SpMV itself stays fully traceable).  ``sell_spmv`` executes
the layout with XLA gathers.

``sell_from_csr`` auto-tunes (W, K) to the fewest stored bytes and refuses
(returns None) when the padded layout would store too many bytes per true
nonzero — exactly like ``dia.from_csr`` refuses unprofitable bandings.

Matrices with *scattered* rows pack badly here (every nonzero in its own
bucket); a bandwidth-reducing reordering (``solve(reorder="rcm")``) is the
standard unlock.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.sparse import CSRMatrix

C = 128              # rows per slab (one lane-tile)
SLABS_PER_BLOCK = 8  # output block = (8 slabs, 128 lanes) = 1024 rows
ROWS_PER_BLOCK = C * SLABS_PER_BLOCK

# The chunk list is pre-split into parts no longer than this, cut at
# output-block boundaries (a pack-layout property shared by the single-
# device and per-shard packs).
MAX_CHUNKS_PER_CALL = int(
    os.environ.get("GMRES_TPU_SELL_MAX_CHUNKS", "32768"))

# Chunk-count granule: chunk counts are padded to a multiple of G within
# every output block, making G a PACK-layout property — it is picked per
# matrix by ``pick_g`` and carried on ``SELLMatrix.G``.
# ``G_BATCH`` remains the process-wide value the DISTRIBUTED pack pins
# (every shard of a PartitionedSELL must share one chunk layout, including
# the all-zero shard's coverage pack), and the env var forces it
# everywhere for hardware A/B sweeps:
#   GMRES_TPU_SELL_G=8 python -m gmres_tpu.cli.bench_kernels ...
G_BATCH = int(os.environ.get("GMRES_TPU_SELL_G", "4"))

# Operand-size gate of ``pick_g``: at or below this many padded operand
# bytes G is auto-picked from the exact per-block chunk counts, above it
# G is pinned to 4.
XRES_MAX_BYTES = int(
    os.environ.get("GMRES_TPU_SELL_XRES_BYTES", str(8 * 1024 * 1024)))
NO_XRES = bool(os.environ.get("GMRES_TPU_SELL_NO_XRES"))


def pick_g(n_cols: int, W: int) -> int | None:
    """Chunk-count granule for a single-device pack.  ``None`` = let the
    pack engine auto-pick from the EXACT per-block chunk counts (largest
    of {16, 8, 4} within 2% dummy padding — ``_auto_g``) when the padded
    operand is at most ``XRES_MAX_BYTES``; 4 otherwise.  The env override
    (GMRES_TPU_SELL_G) wins."""
    env = os.environ.get("GMRES_TPU_SELL_G")
    if env:
        return max(1, int(env))
    n_buckets = max(1, -(-n_cols // W))
    xres = (not NO_XRES) and n_buckets * W * 4 <= XRES_MAX_BYTES
    return None if xres else 4


def _auto_g(covered: np.ndarray) -> int:
    """Largest G in {16, 8, 4} whose exact dummy padding over the real
    per-block chunk counts stays within 2% (numpy-engine twin of the
    native plan pass's auto-pick)."""
    total = int(covered.sum())
    for g in (16, 8):
        pad = int(np.where(covered == 0, g, (-covered) % g).sum())
        if pad * 50 <= total:
            return g
    return 4


def _bitcast_i32(a):
    """f32 -> int32 bitcast for numpy (host packs) and jax (traced) arrays."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a).view(np.int32)
    return jax.lax.bitcast_convert_type(a, jnp.int32)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("packed", "packed_lo", "bucket", "slab",
                 "dense_data", "dense_lo", "dense_bucket", "dense_slab",
                 "dense_vidx"),
    meta_fields=("n_rows", "n_cols", "nnz", "W", "K", "parts",
                 "dense_parts", "n_rows_pad", "n_buckets", "val_dtype",
                 "frob64", "frob32", "G"),
)
@dataclasses.dataclass(frozen=True)
class SELLMatrix:
    """Sliced-ELL matrix, chunked and pre-split into parts.

    Per part ``p``: ``data[p][c, k, r]``/``cols[p][c, k, r]`` (derived
    views of ``packed``, see below) hold the value / *bucket-relative*
    column of slot ``k`` of row ``slab[p][c]*C + r`` (0/0 for padding
    slots — they select ``x_window[0]`` with weight 0).
    The (K, C) slot layout keeps the minor dimension at C=128.
    Chunks are sorted by ``slab``; every output block of ``ROWS_PER_BLOCK``
    rows has at least one chunk (dummies inserted).  ``parts[p] = (n_chunks, first_block, n_blocks)``
    — each part owns a disjoint, contiguous output-block range.

    Only ``packed`` (+``packed_lo``, dense blocks) is device-resident:
    the slot values/columns are stored ONCE as one merged view and the
    ``data``/``cols`` views the executor reads are derived by
    slicing/bitcasting it.  fp64 values round-trip exactly through the
    (hi, lo) double-float split: packs with fp64 values always carry
    ``packed_lo``, and ``data`` reconstructs hi + lo.
    """

    # vals and bitcast cols merged into one (2K, C) f32 block per chunk
    packed: tuple  # tuple of (n_chunks_p, 2K, C) f32 arrays
    # double-float sidecar (empty for f32 packs): the low f32 halves of
    # fp64 values
    packed_lo: tuple   # tuple of (n_chunks_p, K, C) f32 arrays, or ()
    bucket: tuple  # tuple of (n_chunks_p,) int32 arrays — x window index
    slab: tuple    # tuple of (n_chunks_p,) int32 arrays, non-decreasing
    # hybrid dense side: (slab, bucket) pairs above the fill threshold
    # (default 12.5%) are stored as explicit (W, C) blocks — y_row +=
    # x_window @ block is one matvec.  dense_vidx maps dummy coverage
    # chunks to the shared all-zero block 0.
    dense_data: tuple    # tuple of (n_dense_blocks, W, C) arrays (idx 0 = zeros)
    dense_lo: tuple      # df64 sidecar dense blocks, or ()
    dense_bucket: tuple  # tuple of (n_dense_p,) int32
    dense_slab: tuple    # tuple of (n_dense_p,) int32, non-decreasing
    dense_vidx: tuple    # tuple of (n_dense_p,) int32 into dense_data
    n_rows: int
    n_cols: int
    nnz: int
    W: int                    # bucket width (lane window)
    K: int                    # ELL slots per (row, chunk)
    parts: tuple              # ((n_chunks, first_block, n_blocks), ...)
    dense_parts: tuple        # same scheme for the dense chunk list
    n_rows_pad: int           # rows padded to ROWS_PER_BLOCK multiple
    n_buckets: int
    val_dtype: str = "float32"  # logical value dtype (data/cols derive it)
    # pack-time Frobenius norms of the TRUE nonzeros (fp64-accumulated over
    # the fp64 / f32-cast values): carried as metadata so the solver never
    # materializes the padded slot array to take one norm
    frob64: float = 0.0
    frob32: float = 0.0
    # chunk-count granule: the chunk padding within every output block is
    # a multiple of this (resolved per matrix by ``pick_g``)
    G: int = 4

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return np.dtype(self.val_dtype)

    @property
    def frob_norm(self) -> float:
        """||A||_F of the true nonzeros in the current value dtype.
        frob64 is reserved for fp64 packs; every <=32-bit float tier
        (f32, bf16 casts) reports the f32-cast norm — the norm of the
        values the executor actually streams."""
        return self.frob64 if self.dtype == np.float64 else self.frob32

    @property
    def n_chunks(self) -> int:
        return sum(p[0] for p in self.parts)

    @property
    def n_dense_chunks(self) -> int:
        return sum(p[0] for p in self.dense_parts)

    @property
    def data(self) -> tuple:
        """Per-part (n_chunks_p, K, C) slot values in ``dtype``, derived
        from the merged view (hi + lo for fp64 packs)."""
        out = []
        for p, pk in enumerate(self.packed):
            hi = pk[:, : self.K, :]
            if self.dtype == np.float32:
                out.append(hi)
            else:
                v = hi.astype(self.val_dtype)
                if self.packed_lo:
                    v = v + self.packed_lo[p].astype(self.val_dtype)
                out.append(v)
        return tuple(out)

    @property
    def cols(self) -> tuple:
        """Per-part (n_chunks_p, K, C) int32 bucket-relative columns."""
        return tuple(_bitcast_i32(pk[:, self.K:, :]) for pk in self.packed)

    @property
    def vals(self) -> jax.Array:
        """Values view over all slots (padding slots are 0).  EXPENSIVE —
        materializes the padded slot array; prefer ``frob_norm`` for
        norms.  Kept for format-conversion/debug consumers."""
        flats = [d.reshape(-1) for d in self.data]
        blocks = self.dense_data[0].astype(self.val_dtype)
        if self.dense_lo and self.dtype != np.float32:
            blocks = blocks + self.dense_lo[0].astype(self.val_dtype)
        flats += [blocks.reshape(-1)]
        return flats[0] if len(flats) == 1 else jnp.concatenate(flats)

    def astype(self, dtype) -> "SELLMatrix":
        # storage is dtype-invariant (merged f32 hi/lo views); only the
        # logical value dtype changes
        return dataclasses.replace(self, val_dtype=np.dtype(dtype).name)


def _rb_groups(rows, bucket, n_buckets):
    """Per-(row, bucket) groups WITHOUT an nnz-scale sort: entries are
    CSR-ordered (row asc, col asc within row), so ``row * nb + bucket`` is
    non-decreasing and group boundaries are a diff away.  Returns
    (rb_starts, rb_counts, rb_of_nnz)."""
    rb_key = rows * n_buckets + bucket
    start_mask = np.empty(rb_key.shape[0], dtype=bool)
    start_mask[0] = True
    np.not_equal(rb_key[1:], rb_key[:-1], out=start_mask[1:])
    rb_starts = np.flatnonzero(start_mask)
    rb_counts = np.diff(np.append(rb_starts, rb_key.shape[0]))
    rb_of_nnz = np.cumsum(start_mask) - 1
    return rb_starts, rb_counts, rb_of_nnz


def _sb_groups(rb_slab, rb_bucket, rb_counts, n_buckets):
    """Group (row, bucket) groups by (slab, bucket): an R-scale sort (R =
    number of rb groups, typically 3-10x smaller than nnz).  Returns
    (sb_uniq sorted, sb_cnt, sb_max_rb, sb_rank_of_rb)."""
    rb_sb = rb_slab * n_buckets + rb_bucket
    order = np.argsort(rb_sb, kind="stable")
    sb_sorted = rb_sb[order]
    start_mask = np.empty(sb_sorted.shape[0], dtype=bool)
    start_mask[0] = True
    np.not_equal(sb_sorted[1:], sb_sorted[:-1], out=start_mask[1:])
    starts = np.flatnonzero(start_mask)
    sb_uniq = sb_sorted[starts]
    cnt_sorted = rb_counts[order]
    sb_cnt = np.add.reduceat(cnt_sorted, starts)
    sb_max = np.maximum.reduceat(cnt_sorted, starts)
    sb_rank_of_rb = np.empty(rb_sb.shape[0], dtype=np.int64)
    sb_rank_of_rb[order] = np.cumsum(start_mask) - 1
    return sb_uniq, sb_cnt, sb_max, sb_rank_of_rb


def _chunk_sb_max(rows, cols, n_cols, W):
    """Per-(slab, bucket) max row-group count for candidate W — the
    K-INDEPENDENT part of the chunk count, so one scan per W serves every
    K candidate (the autotune's 12 full-structure scans were 40% of the
    pack wall at 10M nnz)."""
    nb = np.int64(max(1, -(-n_cols // W)))
    bucket = cols // W
    rb_starts, rb_counts, _ = _rb_groups(rows, bucket, nb)
    rb_slab = rows[rb_starts] // C
    rb_bucket = bucket[rb_starts]
    _, _, sb_max, _ = _sb_groups(rb_slab, rb_bucket, rb_counts, nb)
    return sb_max


def block_layer_counts(rows, ci, n_cols, W, K, n_blocks):
    """Real (pre-padding) ELL chunk count per output block for a fixed
    (W, K): each (slab, bucket) pair contributes ceil(max_rb/K) layer
    chunks to its block.  Ignores the dense-block classification (an
    upper bound — dense pairs only remove chunks), which is fine for its
    consumer: the distributed partitioner's cross-shard auto-G pick
    (``parallel/sell_dist.partition_sell``)."""
    nb = np.int64(max(1, -(-n_cols // W)))
    bucket = ci // W
    rb_starts, rb_counts, _ = _rb_groups(rows, bucket, nb)
    rb_slab = rows[rb_starts] // C
    rb_bucket = bucket[rb_starts]
    sb_uniq, _, sb_max, _ = _sb_groups(rb_slab, rb_bucket, rb_counts, nb)
    layers = -(-sb_max // K)
    blk = (sb_uniq // nb) // SLABS_PER_BLOCK
    out = np.zeros(n_blocks, np.int64)
    np.add.at(out, blk, layers)
    return out


def _chunk_stats(rows, cols, n_cols, W, K):
    """Number of chunks for candidate (W, K): a (slab, bucket) pair needs
    ``ceil(max_count_over_rows / K)`` layers, and every layer is a chunk."""
    sb_max = _chunk_sb_max(rows, cols, n_cols, W)
    return int((-(-sb_max // K)).sum())


def _plan_parts(chunk_blocks: np.ndarray, n_blocks_total: int):
    """Split chunk indices into parts of <= MAX_CHUNKS_PER_CALL chunks,
    cut at output-block boundaries.  Returns [(lo, hi, blk_lo, blk_hi)]."""
    n_chunks = chunk_blocks.shape[0]
    splits = []
    lo = 0
    while lo < n_chunks:
        hi = min(lo + MAX_CHUNKS_PER_CALL, n_chunks)
        if hi < n_chunks:
            b = chunk_blocks[hi]
            while hi > lo and chunk_blocks[hi - 1] == b:
                hi -= 1
            if hi == lo:  # a single block larger than the budget
                hi = lo + 1
                while hi < n_chunks and chunk_blocks[hi] == chunk_blocks[lo]:
                    hi += 1
        blk_lo = int(chunk_blocks[lo])
        blk_hi = int(chunk_blocks[hi - 1]) + 1
        splits.append((lo, hi, blk_lo, blk_hi))
        lo = hi
    assert splits[0][2] == 0 and splits[-1][3] == n_blocks_total
    return splits


def autotune_wk(rows, ci, n_cols, nnz, W=None, K=None,
                max_bytes_per_nnz: float = 256.0, sbmax_counter=None,
                counts_exchange=None):
    """Pick (W, K) storing the fewest bytes; ``None`` when the padded
    layout stores more than ``max_bytes_per_nnz`` per true nonzero (the
    CSR gather path is then the better layout).  A caller-supplied W or K
    is held fixed; entries must already be (row, col)-sorted.

    The byte count per chunk is its (2K, C) f32 slot block (values and
    columns) plus its W-wide f32 operand window.

    ``sbmax_counter(W) -> iterable of sb_max arrays`` overrides the default
    global ``_chunk_sb_max`` scan — the per-host distributed partitioner
    passes a range-at-a-time counter so no O(global nnz) index array is
    ever materialized (``rows``/``ci`` may then be None).  The scan is
    K-independent, so each W candidate is scanned exactly once.  Shared by
    ``sell_from_csr`` (single device) and ``parallel/sell_dist.partition_sell``
    (same (W, K) across all shards).
    """
    if sbmax_counter is None:
        sbmax_counter = lambda Wc: (_chunk_sb_max(rows, ci, n_cols, Wc),)
    W_cands = (W,) if W is not None else (128, 256, 512, 1024)
    K_cands = (K,) if K is not None else (4, 8, 16)
    best = None
    for Wc in W_cands:
        bases = tuple(sbmax_counter(Wc))
        for Kc in K_cands:
            n_chunks = sum(int((-(-b // Kc)).sum()) for b in bases)
            if counts_exchange is not None:
                # per-host input: this process only scanned its own row
                # block — sum the per-candidate chunk-count partials
                # across processes (same candidate order everywhere)
                n_chunks = int(counts_exchange(n_chunks))
            nbytes = n_chunks * (2 * Kc * C * 4 + Wc * 4)
            if best is None or nbytes < best[0]:
                best = (nbytes, Wc, Kc)
    nbytes, Wb, Kb = best
    if nbytes / nnz > max_bytes_per_nnz:
        return None
    return Wb, Kb


def sell_from_csr(
    A: CSRMatrix,
    W: int | None = None,
    K: int | None = None,
    max_bytes_per_nnz: float = 256.0,
    dtype=None,
    dense_fill_min: float = 0.125,
    max_dense_bytes: int = 2 << 30,
    df64: bool = False,
    host_arrays: bool = False,
    G: int | None = None,
) -> SELLMatrix | None:
    """Pack CSR into SELL, auto-tuning (W, K); None when unprofitable.

    ``G`` (chunks per grid step, a pack-layout property) defaults to
    ``pick_g`` once W is known; the distributed partitioner pins it to
    the process-wide ``G_BATCH`` so every shard shares one layout.

    Packing is refused when the padded layout stores more than
    ``max_bytes_per_nnz`` bytes per true nonzero (``autotune_wk``).

    ``host_arrays=True`` keeps every array as host numpy (no device
    upload) — for callers that post-process the pack (e.g. the
    distributed partitioner stacking per-shard packs before a sharded
    device_put, ``parallel/sell_dist.py``).

    Two interchangeable pack engines produce bit-identical arrays
    (tests/test_sell_native.py): the native two-pass streamer
    (``csrc/gmres_native.cpp:sell_pack_plan/fill`` — the default; the
    numpy path pays ~15 nnz-scale array passes) and the pure-numpy path
    (fallback when the library, the value dtype, or GMRES_TPU_SELL_NUMPY=1
    rule the native one out).
    """
    import os

    conv = (lambda a: a) if host_arrays else jnp.asarray
    n = A.n_rows
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    if nnz == 0:
        return None
    ci = np.asarray(A.col_idx)[:nnz]
    v = np.asarray(A.vals)[:nnz]
    out_dtype = v.dtype if dtype is None else dtype
    # fp64 packs always carry the lo sidecar: the exact complement that
    # lets the derived ``data`` view reconstruct fp64 values from the f32
    # hi halves
    need_lo = df64 or np.dtype(out_dtype) == np.dtype(np.float64)
    # pack-time Frobenius norms of the true nonzeros
    v64 = v.astype(np.float64, copy=False)
    frob64 = float(np.sqrt(np.dot(v64, v64)))
    v32 = v64.astype(np.float32).astype(np.float64)
    frob32 = float(np.sqrt(np.dot(v32, v32)))
    del v64, v32
    n_rows_pad = -(-n // ROWS_PER_BLOCK) * ROWS_PER_BLOCK
    n_blocks = n_rows_pad // ROWS_PER_BLOCK

    packed_arrays = None
    use_native = (
        not os.environ.get("GMRES_TPU_SELL_NUMPY")
        and np.dtype(out_dtype) in (np.dtype(np.float64), np.dtype(np.float32))
        and A.n_cols < np.iinfo(np.int32).max
        # the native ABI takes int32 row_ptr values: a >=2^31-nnz matrix
        # would silently wrap and corrupt the pack
        and nnz < np.iinfo(np.int32).max
    )
    if use_native:
        try:
            packed_arrays, W, K, G = _pack_entries_native(
                A, rp, ci, v, W, K, max_bytes_per_nnz, dense_fill_min,
                max_dense_bytes, need_lo, out_dtype, G,
            )
        except ImportError:
            packed_arrays = None
        else:
            if packed_arrays is None:
                return None  # the autotune gate refused

    if packed_arrays is None:
        ci = ci.astype(np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))

        # The sort-free group machinery below requires entries ordered by
        # (row, col): valid CSR does not guarantee sorted columns (and
        # csr_from_arrays doesn't sort), and unsorted rows would split a
        # (row, bucket) pair into multiple groups whose slot sequences
        # restart at 0 — distinct nonzeros would then collide on the same
        # (chunk, slot, row) cell and be silently dropped.  Detect (O(nnz)
        # compare) and stable-sort only when needed.
        rc_key = rows * np.int64(A.n_cols) + ci
        if not np.all(rc_key[1:] >= rc_key[:-1]):
            order = np.argsort(rc_key, kind="stable")
            rows, ci, v = rows[order], ci[order], v[order]
        del rc_key

        if W is None or K is None:
            tuned = autotune_wk(rows, ci, A.n_cols, nnz, W, K,
                                max_bytes_per_nnz)
            if tuned is None:
                return None
            W, K = tuned
        if G is None:
            G = pick_g(A.n_cols, W)  # int (env/windowed pin) or None (auto)
        packed_arrays, G = _pack_entries_numpy(
            rows, ci, v, A.n_cols, W, K, n_blocks, dense_fill_min,
            max_dense_bytes, need_lo, out_dtype, G,
        )

    n_buckets = max(1, -(-A.n_cols // W))
    # drop the separate vals/cols arrays the native engine also returns —
    # only the merged view (+ lo sidecar) is retained/uploaded
    (merged, merged_lo, dense_blocks, dense_lo_blocks,
     chunk_slab, chunk_bucket, dense_slab_arr, dense_bucket_arr) = \
        packed_arrays[-8:]
    n_chunks = chunk_slab.shape[0]
    n_dense_real = dense_slab_arr.shape[0]
    dense_vidx_arr = np.arange(1, n_dense_real + 1, dtype=np.int64)

    # dense coverage dummies (share the zero block via vidx 0)
    covered_d = np.zeros(n_blocks, dtype=bool)
    covered_d[dense_slab_arr // SLABS_PER_BLOCK] = True
    missing_d = np.flatnonzero(~covered_d)
    if n_dense_real and missing_d.shape[0]:
        dense_slab_arr = np.concatenate(
            [dense_slab_arr, missing_d.astype(np.int64) * SLABS_PER_BLOCK])
        dense_bucket_arr = np.concatenate(
            [dense_bucket_arr, np.zeros(missing_d.shape[0], np.int32)])
        dense_vidx_arr = np.concatenate(
            [dense_vidx_arr, np.zeros(missing_d.shape[0], np.int64)])
        order = np.argsort(dense_slab_arr, kind="stable")
        dense_slab_arr = dense_slab_arr[order]
        dense_bucket_arr = dense_bucket_arr[order]
        dense_vidx_arr = dense_vidx_arr[order]

    splits = _plan_parts(chunk_slab // SLABS_PER_BLOCK, n_blocks)
    packed_p, plo_p, bucket_p, slab_p, parts = ([], [], [], [], [])
    for (lo, hi, blk_lo, blk_hi) in splits:
        packed_p.append(conv(merged[lo:hi]))
        if need_lo:
            plo_p.append(conv(merged_lo[lo:hi]))
        bucket_p.append(conv(chunk_bucket[lo:hi]))
        slab_p.append(conv(chunk_slab[lo:hi].astype(np.int32)))
        parts.append((hi - lo, blk_lo, blk_hi - blk_lo))

    dbucket_p, dslab_p, dvidx_p, dense_parts = [], [], [], []
    if n_dense_real:
        dsplits = _plan_parts(dense_slab_arr // SLABS_PER_BLOCK, n_blocks)
        for (lo, hi, blk_lo, blk_hi) in dsplits:
            dbucket_p.append(conv(dense_bucket_arr[lo:hi]))
            dslab_p.append(conv(dense_slab_arr[lo:hi].astype(np.int32)))
            dvidx_p.append(conv(dense_vidx_arr[lo:hi].astype(np.int32)))
            dense_parts.append((hi - lo, blk_lo, blk_hi - blk_lo))

    return SELLMatrix(
        packed=tuple(packed_p),
        packed_lo=tuple(plo_p),
        bucket=tuple(bucket_p),
        slab=tuple(slab_p),
        dense_data=(conv(dense_blocks),),
        dense_lo=((conv(dense_lo_blocks),) if need_lo else ()),
        dense_bucket=tuple(dbucket_p),
        dense_slab=tuple(dslab_p),
        dense_vidx=tuple(dvidx_p),
        n_rows=n,
        n_cols=A.n_cols,
        nnz=nnz,
        W=W,
        K=K,
        parts=tuple(parts),
        dense_parts=tuple(dense_parts),
        n_rows_pad=n_rows_pad,
        n_buckets=n_buckets,
        val_dtype=np.dtype(out_dtype).name,
        frob64=frob64,
        frob32=frob32,
        G=G,
    )


def _pack_entries_native(A, rp, ci, v, W, K, max_bytes_per_nnz,
                         dense_fill_min, max_dense_bytes, df64, out_dtype,
                         G=None):
    """Autotune + pack through the native two-pass streamer.  Returns
    ``(arrays, W, K, G)`` with ``arrays`` matching ``_pack_entries_numpy``,
    or ``(None, W, K, G)`` when the autotune gate refuses; raises
    ImportError when the native library is unavailable."""
    from gmres_tpu.native import sell_pack_native, sell_sbmax_native

    nnz = int(rp[-1])
    sorted_ci, sorted_v = ci, v

    def _sort():
        nonlocal sorted_ci, sorted_v
        rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp))
        rc_key = rows * np.int64(A.n_cols) + sorted_ci.astype(np.int64)
        order = np.argsort(rc_key, kind="stable")
        # intra-row sort: row_ptr stays valid, only ci/v permute
        sorted_ci, sorted_v = sorted_ci[order], sorted_v[order]

    if W is None or K is None:
        def counter(Wc):
            yield sell_sbmax_native(rp, sorted_ci, A.n_cols, Wc)

        try:
            tuned = autotune_wk(None, None, A.n_cols, nnz, W, K,
                                max_bytes_per_nnz, sbmax_counter=counter)
        except ValueError:
            _sort()
            tuned = autotune_wk(None, None, A.n_cols, nnz, W, K,
                                max_bytes_per_nnz, sbmax_counter=counter)
        if tuned is None:
            return None, W, K, G  # gate refused; caller returns None
        W, K = tuned
    if G is None:
        G = pick_g(A.n_cols, W)  # int (env/windowed pin) or None (auto)

    dense_min_cnt = max(int(dense_fill_min * W * C), 2 * K)
    # no max(1, .): a budget below one block means ZERO dense blocks,
    # exactly like the numpy packer's empty keep list
    max_dense_blocks = max_dense_bytes // (W * C * 4)
    try:
        arrays, G = sell_pack_native(rp, sorted_ci, sorted_v, A.n_cols, W,
                                     K, dense_min_cnt, max_dense_blocks,
                                     df64, out_dtype, G=G)
    except ValueError:
        _sort()
        arrays, G = sell_pack_native(rp, sorted_ci, sorted_v, A.n_cols, W,
                                     K, dense_min_cnt, max_dense_blocks,
                                     df64, out_dtype, G=G)
    return arrays, W, K, G


def _pack_entries_numpy(rows, ci, v, n_cols, W, K, n_blocks,
                        dense_fill_min, max_dense_bytes, need_lo, out_dtype,
                        G=None):
    """Pure-numpy pack of (row, col)-sorted entries.  Returns
    ``(merged, merged_lo, dense_blocks, dense_lo_blocks, chunk_slab,
    chunk_bucket, dense_slab_arr, dense_bucket_arr)`` — dense lists
    WITHOUT coverage dummies (added by the shared assembly tail in
    ``sell_from_csr``).  Only the merged view is built: the
    separate vals/cols slot arrays would be 12 bytes/slot of host and
    device waste."""
    nnz = rows.shape[0]
    n_buckets = max(1, -(-n_cols // W))

    slab = rows // C
    bucket = ci // W
    col_rel = (ci - bucket * W).astype(np.int32)
    row_local = (rows - slab * C).astype(np.int64)

    # --- hybrid classification: per-(slab, bucket) nonzero counts ---
    # (sort-free group machinery: rb groups are CSR-ordered; only the
    # rb -> sb grouping pays an R-scale sort)
    rb_starts, rb_counts, rb_of_nnz = _rb_groups(rows, bucket, n_buckets)
    rb_slab = rows[rb_starts] // C
    rb_bucket = bucket[rb_starts]
    sb_uniq, sb_cnt, sb_max_rb, sb_rank_of_rb = _sb_groups(
        rb_slab, rb_bucket, rb_counts, n_buckets
    )
    sb_inv = sb_rank_of_rb[rb_of_nnz]          # nnz -> sb index
    # position of each entry within its (row, bucket) group
    seq_all = np.arange(nnz, dtype=np.int64) - rb_starts[rb_of_nnz]
    dense_min = int(dense_fill_min * W * C)
    pair_dense = sb_cnt >= max(dense_min, 2 * K)
    # cap total dense storage
    n_dense_real = int(pair_dense.sum())
    if n_dense_real * W * C * 4 > max_dense_bytes:
        keep = np.argsort(sb_cnt)[::-1][: max_dense_bytes // (W * C * 4)]
        mask = np.zeros_like(pair_dense)
        mask[keep] = True
        pair_dense &= mask
        n_dense_real = int(pair_dense.sum())
    is_dense_nnz = pair_dense[sb_inv]

    # --- dense side: explicit (W, C) blocks, one per dense pair ---
    dense_pairs = sb_uniq[pair_dense]              # ascending == slab-sorted
    dense_slab_arr = (dense_pairs // n_buckets).astype(np.int64)
    dense_bucket_arr = (dense_pairs % n_buckets).astype(np.int32)
    pair_rank = np.full(sb_uniq.shape[0], -1, dtype=np.int64)
    pair_rank[pair_dense] = np.arange(n_dense_real)
    # Dense blocks are stored f32: the values are pre-split per NONZERO
    # into (hi, lo) f32 halves and scattered separately, instead of
    # allocating and converting (n_dense, W, C) float64 arrays.  Duplicate
    # entries sum per half; hi+lo still equals the true fp64 sum to
    # ~2^-48.
    dense_blocks = np.zeros((n_dense_real + 1, W, C), dtype=np.float32)
    # np.zeros is lazy (calloc) — np.zeros_like memsets eagerly
    dense_lo_blocks = (
        np.zeros((n_dense_real + 1, W, C), dtype=np.float32)
        if need_lo else None
    )
    if n_dense_real:
        dn = is_dense_nnz
        didx = pair_rank[sb_inv[dn]] + 1           # 0 is the shared zero block
        flat_d = (didx * W + col_rel[dn].astype(np.int64)) * C + row_local[dn]
        v_d = v[dn]
        v_hi = v_d.astype(np.float32)
        np.add.at(dense_blocks.reshape(-1), flat_d, v_hi)
        if need_lo:
            v_lo = (v_d - v_hi.astype(np.float64)).astype(np.float32)
            np.add.at(dense_lo_blocks.reshape(-1), flat_d, v_lo)
    # --- ELL side on the remaining entries ---
    # chunk ids WITHOUT an nnz-scale sort: per ELL (slab,bucket) pair the
    # layer count is ceil(max_rb_count / K); chunk index = the pair's
    # exclusive layer-count prefix + the entry's layer.  Pairs ascend in
    # sb_uniq order, so chunks come out sorted by (slab, bucket, layer).
    e = ~is_dense_nnz
    col_rel_e, row_local_e, v_e = col_rel[e], row_local[e], v[e]
    seq = seq_all[e]
    layer = seq // K
    slot = (seq - layer * K).astype(np.int64)

    ell_pair = ~pair_dense
    pair_layers = np.where(ell_pair, -(-sb_max_rb // K), 0)
    chunk_base = np.zeros(sb_uniq.shape[0] + 1, dtype=np.int64)
    np.cumsum(pair_layers, out=chunk_base[1:])
    n_chunks = int(chunk_base[-1])
    inv = chunk_base[sb_inv[e]] + layer

    ell_sb = sb_uniq[ell_pair]
    chunk_slab = np.repeat(ell_sb // n_buckets, pair_layers[ell_pair])
    chunk_bucket = np.repeat(
        (ell_sb % n_buckets).astype(np.int32), pair_layers[ell_pair]
    )

    # ensure every output block has a chunk (zero-init coverage), then pad
    # every block's chunk count to a multiple of G; G=None auto-picks from
    # the exact per-block counts (must mirror the native plan pass —
    # parity tested)
    covered = np.zeros(n_blocks, dtype=np.int64)
    if n_chunks:
        np.add.at(covered, chunk_slab // SLABS_PER_BLOCK, 1)
    if G is None:
        G = _auto_g(covered)
    need = np.where(covered == 0, G, (-covered) % G)
    n_dummy = int(need.sum())
    if n_dummy:
        dummy_blocks = np.repeat(np.arange(n_blocks, dtype=np.int64), need)
        dummy_slab = dummy_blocks * SLABS_PER_BLOCK
        chunk_slab = np.concatenate([chunk_slab, dummy_slab])
        chunk_bucket = np.concatenate(
            [chunk_bucket, np.zeros(n_dummy, np.int32)]
        )
        order = np.argsort(chunk_slab, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.shape[0])
        inv = rank[inv]  # old chunk c is now at position rank[c]
        chunk_slab = chunk_slab[order]
        chunk_bucket = chunk_bucket[order]
        n_chunks += n_dummy

    # scatter straight into the merged (2K, C) view: value halves
    # land in sublanes [0, K), bitcast int32 columns in [K, 2K)
    merged = np.zeros((n_chunks, 2 * K, C), dtype=np.float32)
    mflat = merged.reshape(-1)
    flat_v = (inv * (2 * K) + slot) * C + row_local_e
    v_hi_e = v_e.astype(np.float32)
    mflat[flat_v] = v_hi_e
    mflat[flat_v + K * C] = col_rel_e.astype(np.int32).view(np.float32)
    merged_lo = None
    if need_lo:
        merged_lo = np.zeros((n_chunks, K, C), dtype=np.float32)
        flat = (inv * K + slot) * C + row_local_e
        merged_lo.reshape(-1)[flat] = (
            v_e - v_hi_e.astype(np.float64)
        ).astype(np.float32)
    return (merged, merged_lo, dense_blocks, dense_lo_blocks, chunk_slab,
            chunk_bucket, dense_slab_arr, dense_bucket_arr), G


def _pad_x(A: "SELLMatrix", x: jax.Array) -> jax.Array:
    total = A.n_buckets * A.W
    if x.shape[0] < total:
        return jnp.pad(x, (0, total - x.shape[0]))
    return x[:total]


def sell_spmv(A: SELLMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x over the SELL layout: per-slot operand gathers summed per
    chunk and scatter-added into the chunk's slab, plus one batched matvec
    for the dense blocks."""
    x = x.astype(A.dtype)
    xp = _pad_x(A, x)
    y = jnp.zeros((A.n_rows_pad // C, C), dtype=A.dtype)
    for p in range(len(A.parts)):
        gcols = A.cols[p] + A.bucket[p][:, None, None].astype(jnp.int32) * A.W
        prod = A.data[p] * xp[gcols]             # (n_chunks_p, K, C)
        contrib = prod.sum(axis=1)               # (n_chunks_p, C)
        y = y.at[A.slab[p]].add(contrib)
    xp2 = xp.reshape(A.n_buckets, A.W)
    blocks = A.dense_data[0].astype(A.dtype)
    # the lo sidecar only contributes at fp64 compute (for f32 the hi
    # halves ARE the values, matching the ELL side's derived ``data``)
    lo = (A.dense_lo[0].astype(A.dtype)
          if A.dense_lo and A.dtype != np.float32 else None)
    for p in range(len(A.dense_parts)):
        win = xp2[A.dense_bucket[p]]             # (n_dense_p, W)
        blk = blocks[A.dense_vidx[p]]            # (n_dense_p, W, C)
        if lo is not None:
            blk = blk + lo[A.dense_vidx[p]]
        contrib = jnp.einsum("pw,pwc->pc", win, blk,
                             precision=jax.lax.Precision.HIGHEST)
        y = y.at[A.dense_slab[p]].add(contrib)
    return y.reshape(-1)[: A.n_rows]
