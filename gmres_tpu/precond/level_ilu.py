"""Level-scheduled exact ILU(0) triangular solves for unstructured patterns.

The reference's cuSPARSE ``csrsv2`` path (``kernels_cuda.cpp:617-695``)
level-schedules the substitution: an analysis pass groups rows by
dependency depth, then each apply does O(nnz) work regardless of how many
levels there are.  The analog here:

  * host analysis: per-row dependency levels of the strict-lower and
    upper factor triangles (the same levels whose max is the full-sweep
    form's sweep count), rows permuted into ascending-level
    order and grouped into CHUNKS at level-aligned boundaries;
  * device apply: one ``lax.scan`` over the chunks.  Chunk ``c`` covers
    levels ``[a..b]``; rows at level ``a`` depend only on earlier chunks,
    so ``b - a + 1`` Jacobi sweeps over the chunk's rows alone make every
    row in the chunk exact.  Total gather work is
    ``sum_c sweeps_c * nnz_c`` — with level-aligned chunking this is
    ~``nnz * (1 + levels/n_chunks)``, versus the full-sweep fallback's
    ``levels * nnz`` (the bound that forced ``build_ilu_exact`` to refuse
    large unstructured factors).

The sweeps inside a chunk are plain gather + segment-sum in the original
row index space (x is never permuted; only the *processing order* is),
so any sparsity pattern is supported.  This is the capability analog of
csrsv2; ``build_ilu_exact`` prefers plain full sweeps when
``levels * nnz`` is small.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.sparse import CSRMatrix


def triangular_levels(
    row_ptr: np.ndarray, col_idx: np.ndarray, diag: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row dependency levels (lev_l, lev_u) of the strict triangles.

    Level 0 rows have no in-triangle dependencies; level ``k`` rows
    depend on at least one level ``k-1`` row and nothing deeper.  Native
    when the C helper is built, vectorized-python otherwise.
    """
    n = row_ptr.shape[0] - 1
    try:
        from gmres_tpu.native import tri_levels_native

        return tri_levels_native(row_ptr, col_idx, diag)
    except (ImportError, OSError):
        pass
    rp = row_ptr.astype(np.int64)
    ci = col_idx.astype(np.int64)
    lev_l = np.zeros(n, dtype=np.int64)
    for i in range(n):
        lo, hi = rp[i], diag[i]
        if hi > lo:
            lev_l[i] = 1 + lev_l[ci[lo:hi]].max()
    lev_u = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        lo, hi = diag[i] + 1, rp[i + 1]
        if hi > lo:
            lev_u[i] = 1 + lev_u[ci[lo:hi]].max()
    return lev_l, lev_u


def _level_chunks(lev: np.ndarray, rows_target: int) -> list[np.ndarray]:
    """Group row indices into processing chunks: ascending level order,
    whole levels accumulated until ~rows_target, oversized levels split
    (a split level costs nothing — same-level rows are independent)."""
    order = np.argsort(lev, kind="stable")
    lev_sorted = lev[order]
    # boundaries between distinct levels in the sorted order
    bnd = np.flatnonzero(np.diff(lev_sorted)) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [lev.shape[0]]])
    chunks: list[np.ndarray] = []
    cur: list[np.ndarray] = []
    cur_rows = 0
    for s, e in zip(starts, ends):
        size = e - s
        if size >= rows_target:
            if cur:
                chunks.append(np.concatenate(cur))
                cur, cur_rows = [], 0
            for p in range(s, e, rows_target):
                chunks.append(order[p : min(p + rows_target, e)])
            continue
        if cur_rows + size > rows_target and cur:
            chunks.append(np.concatenate(cur))
            cur, cur_rows = [], 0
        cur.append(order[s:e])
        cur_rows += size
    if cur:
        chunks.append(np.concatenate(cur))
    return chunks


def _pack_phase(tri: CSRMatrix, lev: np.ndarray, rows_target: int, n: int):
    """Stack a triangle's rows into uniform [C, ...] chunk arrays.

    Returns (cols, vals, segs, rows, sweeps, rows_max, work) where
    ``rows[c, k] == n`` marks a padding row (scattered to x's pad slot)
    and ``cols`` padding points at the pad slot with ``vals == 0``.
    """
    rp = np.asarray(tri.row_ptr).astype(np.int64)
    ci = np.asarray(tri.col_idx)[: rp[-1]].astype(np.int32)
    v = np.asarray(tri.vals)[: rp[-1]]
    chunks = _level_chunks(lev, rows_target)
    rows_max = max(c.shape[0] for c in chunks)
    counts = np.diff(rp)
    nnz_max = max(int(counts[c].sum()) for c in chunks)
    nnz_max = max(nnz_max, 1)
    C = len(chunks)
    cols = np.full((C, nnz_max), n, dtype=np.int32)
    vals = np.zeros((C, nnz_max), dtype=v.dtype)
    segs = np.full((C, nnz_max), rows_max - 1, dtype=np.int32)
    rows = np.full((C, rows_max), n, dtype=np.int32)
    sweeps = np.zeros((C,), dtype=np.int32)
    work = 0
    for c, rsel in enumerate(chunks):
        nr = rsel.shape[0]
        rows[c, :nr] = rsel
        cnt = counts[rsel]
        tot = int(cnt.sum())
        if tot:
            idx = _ranges(rp, rsel)
            cols[c, :tot] = ci[idx]
            vals[c, :tot] = v[idx]
            segs[c, :tot] = np.repeat(np.arange(nr, dtype=np.int32), cnt)
        lv = lev[rsel]
        sweeps[c] = int(lv.max() - lv.min()) + 1
        work += int(sweeps[c]) * nnz_max
    return cols, vals, segs, rows, sweeps, rows_max, work


def _ranges(rp: np.ndarray, rsel: np.ndarray) -> np.ndarray:
    """Concatenated arange(rp[r], rp[r+1]) over rsel without a python
    loop (chunks can hold 100k+ rows): delta encoding + cumsum."""
    cnt = (rp[rsel + 1] - rp[rsel]).astype(np.int64)
    tot = int(cnt.sum())
    if tot == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(tot, dtype=np.int64)
    starts_out = np.cumsum(cnt) - cnt  # output position of each row start
    nz = np.flatnonzero(cnt)
    first = rp[rsel[nz]].astype(np.int64)
    out[starts_out[nz[0]]] = first[0]
    if nz.size > 1:
        prev_last = first[:-1] + cnt[nz[:-1]] - 1
        out[starts_out[nz[1:]]] = first[1:] - prev_last
    return np.cumsum(out)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "l_cols", "l_vals", "l_segs", "l_rows", "l_sweeps",
        "u_cols", "u_vals", "u_segs", "u_rows", "u_sweeps",
        "u_invd", "inv_diag",
    ),
    meta_fields=("l_rows_max", "u_rows_max", "n"),
)
@dataclasses.dataclass(frozen=True)
class LevelILUPrec:
    """Exact ILU(0) solves applied by level-scheduled chunk sweeps (the
    csrsv2 analog for factors too deep for full sweeps).

    Cites ``kernels_cuda.cpp:617-695`` (reference csrsv2 level-scheduled
    ilusv) for the capability contract.
    """

    l_cols: jax.Array   # [C_l, NNZ_l] int32, pad -> x pad slot
    l_vals: jax.Array   # [C_l, NNZ_l] factor dtype, pad 0
    l_segs: jax.Array   # [C_l, NNZ_l] int32 local row rank
    l_rows: jax.Array   # [C_l, R_l] int32 original row ids, pad n
    l_sweeps: jax.Array  # [C_l] int32 intra-chunk level span
    u_cols: jax.Array
    u_vals: jax.Array
    u_segs: jax.Array
    u_rows: jax.Array
    u_sweeps: jax.Array
    u_invd: jax.Array   # [C_u, R_u] inv diag gathered per chunk (pad 1)
    inv_diag: jax.Array  # [n] (typesafe_apply dtype introspection)
    l_rows_max: int
    u_rows_max: int
    n: int


def build_level_ilu(
    lower: CSRMatrix,
    upper: CSRMatrix,
    inv_diag: np.ndarray,
    lev_l: np.ndarray,
    lev_u: np.ndarray,
    rows_target: int = 65536,
) -> tuple["LevelILUPrec", int]:
    """Pack the split factor triangles (``_split_triangles`` output:
    strict lower / diag-inclusive upper) into a LevelILUPrec.  Returns
    (prec, work) where work bounds the per-apply gather count so the
    caller can gate."""
    n = lower.n_rows
    lc, lv, ls, lr, lsw, lrm, wl = _pack_phase(lower, lev_l, rows_target, n)
    uc, uv, us, ur, usw, urm, wu = _pack_phase(upper, lev_u, rows_target, n)
    invd = np.asarray(inv_diag)
    u_invd = np.ones((ur.shape[0], urm), dtype=invd.dtype)
    valid = ur != n
    u_invd[valid] = invd[ur[valid]]
    prec = LevelILUPrec(
        l_cols=jnp.asarray(lc), l_vals=jnp.asarray(lv),
        l_segs=jnp.asarray(ls), l_rows=jnp.asarray(lr),
        l_sweeps=jnp.asarray(lsw),
        u_cols=jnp.asarray(uc), u_vals=jnp.asarray(uv),
        u_segs=jnp.asarray(us), u_rows=jnp.asarray(ur),
        u_sweeps=jnp.asarray(usw), u_invd=jnp.asarray(u_invd),
        inv_diag=jnp.asarray(invd),
        l_rows_max=lrm, u_rows_max=urm, n=n,
    )
    return prec, wl + wu


def level_ilu_apply(M: LevelILUPrec, w: jax.Array) -> jax.Array:
    """(LU)^{-1} w by level-scheduled chunk sweeps.

    L-phase (unit diag):  chunk rows  x_r <- b_r - (L_strict x)_r
    U-phase:              chunk rows  x_r <- x_r + D_r^{-1} (b'_r - (U x)_r)

    identical recurrences to the full-sweep ``_ilu_jacobi_apply`` but
    restricted to one chunk at a time; the chunk's level span bounds the
    sweeps needed for exactness (strict triangles are nilpotent within
    the chunk once earlier chunks are final).
    """
    n_w = w.shape[0]
    if n_w < M.n:
        w = jnp.pad(w, (0, M.n - n_w))
    elif n_w > M.n:
        w = w[: M.n]
    x = jnp.pad(w, (0, 1))  # final slot = pad target (stays garbage-free 0)
    b = x

    def l_chunk(x, chunk):
        cols, vals, segs, rows, sweeps = chunk
        b_rows = b[rows]

        def sweep(_, x):
            contrib = jax.ops.segment_sum(
                vals * x[cols], segs, num_segments=M.l_rows_max
            )
            return x.at[rows].set(b_rows - contrib)

        return jax.lax.fori_loop(0, sweeps, sweep, x), None

    x, _ = jax.lax.scan(
        l_chunk, x, (M.l_cols, M.l_vals, M.l_segs, M.l_rows, M.l_sweeps)
    )
    # the pad slot may hold a padding row's scatter; re-zero before U reads
    x = x.at[M.n].set(0)
    b2 = x

    def u_chunk(x, chunk):
        cols, vals, segs, rows, sweeps, invd = chunk
        b_rows = b2[rows]

        def sweep(_, x):
            contrib = jax.ops.segment_sum(
                vals * x[cols], segs, num_segments=M.u_rows_max
            )
            return x.at[rows].set(x[rows] + invd * (b_rows - contrib))

        return jax.lax.fori_loop(0, sweeps, sweep, x), None

    x, _ = jax.lax.scan(
        u_chunk,
        x,
        (M.u_cols, M.u_vals, M.u_segs, M.u_rows, M.u_sweeps, M.u_invd),
    )
    out = x[: M.n]
    return out[:n_w] if n_w <= M.n else jnp.pad(out, (0, n_w - M.n))
