"""ctypes bindings for the native host kernels (``csrc/gmres_native.cpp``).

The shared library is built on first use from the committed source with
the host's C++ compiler (a one-time ~2 s cost), without ``-march=native``,
and its file name carries a hash of the source, the compiler flags and the
host's machine type and processor: a library built for other source or
another host is never loaded.  It lives in ``build/`` of the checkout (or
the per-user cache when that is not writable).  All entry points raise
ImportError when the library is unavailable — callers (``precond/ilu0.py``,
``io/loader.py``) fall back to numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "gmres_native.cpp"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_lib_failed = False


def _lib_name() -> str:
    """``libgmres_native-<hash>.so``, keyed on what the build depends on."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(f"{platform.machine()}|{platform.processor()}".encode())
    return f"libgmres_native-{h.hexdigest()[:16]}.so"


def _find_or_build() -> pathlib.Path:
    if not _SRC.exists():
        raise ImportError("native source not found")
    name = _lib_name()
    build = _SRC.parent.parent / "build"
    cache = pathlib.Path(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    ) / "gmres_tpu"
    for d in (build, cache):
        if (d / name).exists():
            return d / name
    try:
        build.mkdir(exist_ok=True)
        target_dir = build if os.access(build, os.W_OK) else None
    except OSError:
        target_dir = None
    if target_dir is None:
        cache.mkdir(parents=True, exist_ok=True)
        target_dir = cache
    target = target_dir / name
    # build into a private temporary file and rename it into place, so
    # concurrent processes never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target_dir)
    os.close(fd)
    cmd = ["g++", *_FLAGS, "-o", tmp, str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        raise ImportError(f"native build failed: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _get_lib():
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        raise ImportError("native library unavailable")
    try:
        path = _find_or_build()
        lib = ctypes.CDLL(str(path))
    except (ImportError, OSError) as e:
        _lib_failed = True
        raise ImportError(str(e)) from e

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.ilu0_factorize.restype = ctypes.c_int
    lib.ilu0_factorize.argtypes = [
        ctypes.c_int64, i32p, i32p, f64p, i64p, ctypes.c_double,
    ]
    lib.tri_level_counts.restype = None
    lib.tri_level_counts.argtypes = [
        ctypes.c_int64, i32p, i32p, i64p, i64p, i64p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ilu_trisolve.restype = None
    lib.ilu_trisolve.argtypes = [
        ctypes.c_int64, i32p, i32p, f64p, i64p, f64p,
    ]
    lib.parse_coord.restype = ctypes.c_int64
    lib.parse_coord.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, f64p,
        ctypes.c_int,
    ]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    vp = ctypes.c_void_p
    lib.sell_pack_plan.restype = ctypes.c_int64
    lib.sell_pack_plan.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        i32p, i64p, i64p, i32p, i64p, i64p,
    ]
    lib.sell_pack_fill.restype = ctypes.c_int
    lib.sell_pack_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p, i32p, f64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        i32p, i64p, i64p, i32p, i64p,
        ctypes.c_int, ctypes.c_int,
        vp, i32p, f32p, vp, f32p, vp,
        i64p, i32p, i64p, i32p,
    ]
    _lib = lib
    return lib


def ilu0_native(row_ptr, col_idx, vals, factor_dtype=np.float64):
    """Native ILU(0) with the same contract as ilu0_factorize_numpy."""
    lib = _get_lib()
    rp = np.ascontiguousarray(row_ptr, dtype=np.int32)
    n = rp.shape[0] - 1
    nnz = int(rp[-1])
    ci = np.ascontiguousarray(col_idx[:nnz], dtype=np.int32)
    v = np.ascontiguousarray(vals[:nnz], dtype=np.float64).copy()

    row_abs = np.zeros(n)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp.astype(np.int64)))
    np.add.at(row_abs, row_ids, np.abs(v))
    alpha = float(np.finfo(factor_dtype).eps) * float(row_abs.max(initial=0.0))

    diag = np.zeros(n, dtype=np.int64)
    rc = lib.ilu0_factorize(n, rp, ci, v, diag, alpha)
    if rc != 0:
        raise ValueError(f"row {-rc - 1} has no diagonal-or-later entry")
    return v.astype(factor_dtype), diag


def levels_native(row_ptr, col_idx, diag):
    lib = _get_lib()
    rp = np.ascontiguousarray(row_ptr, dtype=np.int32)
    n = rp.shape[0] - 1
    nnz = int(rp[-1])
    ci = np.ascontiguousarray(col_idx[:nnz], dtype=np.int32)
    d = np.ascontiguousarray(diag, dtype=np.int64)
    lev_l = np.zeros(n, dtype=np.int64)
    lev_u = np.zeros(n, dtype=np.int64)
    out_l = ctypes.c_int64(0)
    out_u = ctypes.c_int64(0)
    lib.tri_level_counts(n, rp, ci, d, lev_l, lev_u,
                         ctypes.byref(out_l), ctypes.byref(out_u))
    return int(out_l.value), int(out_u.value)


def tri_levels_native(row_ptr, col_idx, diag):
    """Per-row dependency levels of both triangles (same C pass as
    ``levels_native``; the count outputs are the array maxima + 1)."""
    lib = _get_lib()
    rp = np.ascontiguousarray(row_ptr, dtype=np.int32)
    n = rp.shape[0] - 1
    nnz = int(rp[-1])
    ci = np.ascontiguousarray(col_idx[:nnz], dtype=np.int32)
    d = np.ascontiguousarray(diag, dtype=np.int64)
    lev_l = np.zeros(n, dtype=np.int64)
    lev_u = np.zeros(n, dtype=np.int64)
    out_l = ctypes.c_int64(0)
    out_u = ctypes.c_int64(0)
    lib.tri_level_counts(n, rp, ci, d, lev_l, lev_u,
                         ctypes.byref(out_l), ctypes.byref(out_u))
    return lev_l, lev_u


def trisolve_native(row_ptr, col_idx, vals, diag, b):
    """Exact sequential L/U substitution on the combined factor (host
    oracle; the reference's ilusv)."""
    lib = _get_lib()
    rp = np.ascontiguousarray(row_ptr, dtype=np.int32)
    n = rp.shape[0] - 1
    nnz = int(rp[-1])
    ci = np.ascontiguousarray(col_idx[:nnz], dtype=np.int32)
    v = np.ascontiguousarray(vals[:nnz], dtype=np.float64)
    d = np.ascontiguousarray(diag, dtype=np.int64)
    x = np.ascontiguousarray(b, dtype=np.float64).copy()
    lib.ilu_trisolve(n, rp, ci, v, d, x)
    return x


def sell_pack_native(rp, ci, v, n_cols, W, K, dense_min_cnt, max_dense_blocks,
                     df64: bool, out_dtype, G: int | None = None):
    """Native SELL pack (the hot loops of ``ops/sell.py:sell_from_csr``).

    Inputs: int32 CSR (``rp`` length n+1, ``ci``/``v`` length >= nnz with
    sorted columns per row), the tuned (W, K), the classification
    thresholds, and the chunk-padding batch ``G`` (``None`` = the plan
    pass auto-picks the largest of {16, 8, 4} whose exact dummy padding
    over the per-block chunk counts stays within 2%).  Returns
    ``(arrays, G)`` with ``arrays`` the pre-assembled tuple in the exact
    layout the numpy packer produces (bit-identical;
    tests/test_sell_native.py): ``(vals_arr, cols_arr, merged, merged_lo,
    dense_hi, dense_lo, chunk_slab, chunk_bucket, dense_slab,
    dense_bucket)`` and ``G`` the resolved batch.

    Raises ``ValueError`` when a row's columns are unsorted (caller sorts
    and retries) and ``ImportError``/``TypeError`` when the native path is
    unavailable for the library/dtype — callers fall back to numpy.
    """
    out_dtype = np.dtype(out_dtype)
    if out_dtype not in (np.dtype(np.float64), np.dtype(np.float32)):
        raise TypeError(f"native pack supports f64/f32 data, not {out_dtype}")
    if int(np.asarray(rp)[-1]) >= np.iinfo(np.int32).max:
        # the int32 ABI would silently wrap row_ptr for >=2^31-nnz input
        raise TypeError("native pack takes int32 row_ptr; nnz >= 2^31 "
                        "must use the numpy packer")
    lib = _get_lib()
    rp = np.ascontiguousarray(rp, dtype=np.int32)
    n = rp.shape[0] - 1
    nnz = int(rp[-1])
    ci = np.ascontiguousarray(ci[:nnz], dtype=np.int32)
    v = np.ascontiguousarray(v[:nnz], dtype=np.float64)

    # worst-case (np.empty: untouched pages never materialize)
    rb_sbrank = np.empty(nnz, dtype=np.int32)
    sb_pair = np.empty(nnz, dtype=np.int64)
    chunk_base = np.empty(nnz + 1, dtype=np.int64)
    pair_rank = np.empty(nnz, dtype=np.int32)
    sb_max = np.empty(nnz, dtype=np.int64)
    counts = np.zeros(5, dtype=np.int64)
    # G=0 asks the plan pass to auto-pick from the exact per-block chunk
    # counts (largest of {16, 8, 4} within 2% padding); the resolved G
    # comes back in counts[4] and MUST feed the fill pass
    R = lib.sell_pack_plan(
        n, int(n_cols), nnz, rp, ci, W, K, 0 if G is None else int(G),
        int(dense_min_cnt), int(max_dense_blocks),
        rb_sbrank, sb_pair, chunk_base, pair_rank, sb_max, counts,
    )
    if R == -1:
        raise ValueError("unsorted columns within a row")
    if R < 0:
        raise ImportError("native pack allocation failure")
    n_sb, n_chunks, n_dense, _ = (int(c) for c in counts[:4])
    G = int(counts[4])

    C_ = 128
    vals_arr = np.zeros((n_chunks, K, C_), dtype=out_dtype)
    cols_arr = np.zeros((n_chunks, K, C_), dtype=np.int32)
    merged = np.zeros((n_chunks, 2 * K, C_), dtype=np.float32)
    merged_lo = (np.zeros((n_chunks, K, C_), dtype=np.float32)
                 if df64 else np.zeros((0, K, C_), dtype=np.float32))
    dense_hi = np.zeros((n_dense + 1, W, C_), dtype=np.float32)
    dense_lo = (np.zeros((n_dense + 1, W, C_), dtype=np.float32)
                if df64 else np.zeros((1, W, C_), dtype=np.float32))
    chunk_slab = np.zeros(n_chunks, dtype=np.int64)
    chunk_bucket = np.zeros(n_chunks, dtype=np.int32)
    dense_slab = np.zeros(n_dense, dtype=np.int64)
    dense_bucket = np.zeros(n_dense, dtype=np.int32)
    R = lib.sell_pack_fill(
        n, int(n_cols), nnz, rp, ci, v, W, K, int(G), n_sb,
        rb_sbrank, sb_pair, chunk_base, pair_rank, sb_max,
        int(out_dtype == np.dtype(np.float32)), int(df64),
        vals_arr.ctypes.data_as(ctypes.c_void_p), cols_arr, merged,
        merged_lo.ctypes.data_as(ctypes.c_void_p), dense_hi,
        dense_lo.ctypes.data_as(ctypes.c_void_p),
        chunk_slab, chunk_bucket, dense_slab, dense_bucket,
    )
    if R < 0:
        # an early return would otherwise leave all outputs zeroed and
        # the solver consuming a silently-zero operator
        raise ImportError("native pack fill allocation failure")
    return (vals_arr, cols_arr, merged,
            merged_lo if df64 else None,
            dense_hi, dense_lo if df64 else None,
            chunk_slab, chunk_bucket, dense_slab, dense_bucket), G


def sell_sbmax_native(rp, ci, n_cols, W):
    """Per-(slab, bucket) max row-group count (the autotune structure scan,
    ``ops/sell.py:_chunk_sb_max``) via the native plan pass.  Returns the
    sb_max array, or raises for unsorted rows / unavailable library."""
    lib = _get_lib()
    rp = np.ascontiguousarray(rp, dtype=np.int32)
    n = rp.shape[0] - 1
    nnz = int(rp[-1])
    ci = np.ascontiguousarray(ci[:nnz], dtype=np.int32)
    rb_sbrank = np.empty(nnz, dtype=np.int32)
    sb_pair = np.empty(nnz, dtype=np.int64)
    chunk_base = np.empty(nnz + 1, dtype=np.int64)
    pair_rank = np.empty(nnz, dtype=np.int32)
    sb_max = np.empty(nnz, dtype=np.int64)
    # 5 slots: csrc sell_pack_plan writes out_counts[4] (the resolved G)
    # unconditionally; a 4-slot buffer is an 8-byte heap overwrite.
    counts = np.zeros(5, dtype=np.int64)
    # K=4, G=4 are placeholders: sb_max is (K, G)-independent
    R = lib.sell_pack_plan(
        n, int(n_cols), nnz, rp, ci, W, 4, 4, np.iinfo(np.int64).max,
        np.iinfo(np.int64).max,
        rb_sbrank, sb_pair, chunk_base, pair_rank, sb_max, counts,
    )
    if R == -1:
        raise ValueError("unsorted columns within a row")
    if R < 0:
        raise ImportError("native scan allocation failure")
    return sb_max[: int(counts[0])]


def parse_coord_native(text: bytes, nnz: int, pattern: bool = False):
    """Parse nnz coordinate lines; returns (rows, cols, vals) 0-based."""
    lib = _get_lib()
    I = np.empty(nnz, dtype=np.int32)
    J = np.empty(nnz, dtype=np.int32)
    V = np.empty(nnz, dtype=np.float64)
    got = lib.parse_coord(text, len(text), nnz, I, J, V, int(pattern))
    if got != nnz:
        raise ValueError(f"parsed {got} of {nnz} entries")
    return I.astype(np.int64), J.astype(np.int64), V
