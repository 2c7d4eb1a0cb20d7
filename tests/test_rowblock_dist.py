"""Per-host RowBlockCSR input (pod scale, SURVEY.md §5.8): partitioners fed
only a process's row block — with metadata partials combined through a
simulated exchange — must produce exactly the global partition, and
solve_distributed on a RowBlockCSR must match the full-matrix solve."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gmres_tpu import GmresConfig, PrecisionSpec
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d, random_sparse
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.parallel.dist_gmres import process_row_range, solve_distributed
from gmres_tpu.parallel.halo import partition_halo
from gmres_tpu.parallel.partition import padded_size, partition_rows
from gmres_tpu.sparse import RowBlockCSR


def _to_block(A, lo, hi):
    """Rows [lo, hi) of a CSRMatrix as a RowBlockCSR."""
    rp = np.asarray(A.row_ptr).astype(np.int64)
    a, b = int(rp[lo]), int(rp[hi])
    return RowBlockCSR(
        row_ptr=rp,
        col_idx=np.asarray(A.col_idx)[a:b],
        vals=np.asarray(A.vals)[a:b],
        row_lo=lo,
        row_hi=hi,
        n_rows=A.n_rows,
        n_cols=A.n_cols,
    )


def _split_blocks(A, n_procs, n_shards):
    """Contiguous per-process row blocks matching the shard grid."""
    r = padded_size(A.n_rows, n_shards) // n_shards
    per = n_shards // n_procs
    blocks, shard_sets = [], []
    for p in range(n_procs):
        lo = min(p * per * r, A.n_rows)
        hi = min((p + 1) * per * r, A.n_rows)
        blocks.append(_to_block(A, lo, hi))
        shard_sets.append(list(range(p * per, (p + 1) * per)))
    return blocks, shard_sets


class FakeExchange:
    """Simulates multihost.exchange_host_array across n 'processes' by
    running the partitioner once per process and rendezvousing payloads —
    the partitioners call exchange in the same order on every process, so
    a simple round counter lines the payloads up."""

    def __init__(self):
        self.rounds = []       # round -> list of payloads
        self.proc_calls = {}   # proc -> next round index

    def for_proc(self, p, payload_log):
        def exchange(arr):
            r = self.proc_calls.get(p, 0)
            self.proc_calls[p] = r + 1
            payload_log.append(np.asarray(arr))
            while len(self.rounds) <= r:
                self.rounds.append({})
            self.rounds[r][p] = np.asarray(arr)
            return np.stack([self.rounds[r][q]
                             for q in sorted(self.rounds[r])])
        return exchange


def _run_per_proc(A, n_procs, n_shards, fn):
    """fn(block, owned, exchange) per simulated process, two passes: the
    first records payloads per round, the second serves the full gather."""
    blocks, shard_sets = _split_blocks(A, n_procs, n_shards)
    # pass 1: collect every process's payload per round
    ex = FakeExchange()
    logs = [[] for _ in range(n_procs)]
    for p in range(n_procs):
        try:
            fn(blocks[p], shard_sets[p], ex.for_proc(p, logs[p]))
        except Exception:
            pass  # pass 1 may fail on incomplete gathers; only logs matter
    rounds = [dict(r) for r in ex.rounds]

    # pass 2: every exchange returns the complete gather
    outs = []
    for p in range(n_procs):
        calls = {"i": 0}

        def exchange(arr, p=p, calls=calls):
            r = calls["i"]
            calls["i"] += 1
            full = dict(rounds[r])
            full[p] = np.asarray(arr)
            return np.stack([full[q] for q in sorted(full)])

        outs.append(fn(blocks[p], shard_sets[p], exchange))
    return outs


def _assert_stack_equal(global_arr, stacks, shard_sets):
    """Per-process ShardStack pieces must equal the global stacked array."""
    g = np.asarray(global_arr)
    for pieces, shards in zip(stacks, shard_sets):
        for s in shards:
            np.testing.assert_array_equal(pieces.pieces[s], g[s])


def test_partition_rows_block_matches_global():
    A = random_sparse(300, row_nnz=6, seed=1)
    full = partition_rows(A, 4)
    blocks, shard_sets = _split_blocks(A, 2, 4)
    for blk, shards in zip(blocks, shard_sets):
        part = partition_rows(blk, 4, owned=shards)
        assert part.rows_per_shard == full.rows_per_shard
        for s in shards:
            np.testing.assert_array_equal(part.col_idx.pieces[s],
                                          np.asarray(full.col_idx)[s])
            np.testing.assert_array_equal(part.vals.pieces[s],
                                          np.asarray(full.vals)[s])
            np.testing.assert_array_equal(part.row_ptr.pieces[s],
                                          np.asarray(full.row_ptr)[s])


def test_partition_halo_dia_block_matches_global():
    A = convection_diffusion_2d(24)  # banded: HaloDIA path
    full = partition_halo(A, 4)
    assert type(full).__name__ == "HaloDIA"

    outs = _run_per_proc(
        A, 2, 4,
        lambda blk, shards, ex: partition_halo(blk, 4, owned=shards,
                                               exchange=ex),
    )
    for H, shards in zip(outs, [[0, 1], [2, 3]]):
        assert type(H).__name__ == "HaloDIA"
        assert H.offsets == full.offsets
        assert (H.halo_left, H.halo_right) == (full.halo_left, full.halo_right)
        _assert_stack_equal(full.data, [H.data], [shards])


def test_partition_halo_csr_block_matches_global():
    # neighbor-local but many distinct offsets: rebased HaloCSR path
    rng = np.random.default_rng(4)
    n = 256
    rows = np.repeat(np.arange(n), 5)
    cols = np.clip(rows + rng.integers(-40, 41, size=rows.shape[0]), 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    from gmres_tpu.sparse import csr_from_coo

    A = csr_from_coo(rows, cols, vals, n_rows=n)
    full = partition_halo(A, 4)
    outs = _run_per_proc(
        A, 2, 4,
        lambda blk, shards, ex: partition_halo(blk, 4, owned=shards,
                                               exchange=ex),
    )
    for H, shards in zip(outs, [[0, 1], [2, 3]]):
        assert type(H).__name__ == type(full).__name__
        assert (H.halo_left, H.halo_right) == (full.halo_left, full.halo_right)
        if type(full).__name__ == "HaloCSR":
            _assert_stack_equal(full.vals, [H.vals], [shards])
            _assert_stack_equal(full.col_idx, [H.col_idx], [shards])


def test_jacobi_rowblock_matches_global():
    from gmres_tpu.precond.build import build_jacobi_rowblock, build_preconditioner

    A = random_sparse(200, row_nnz=5, seed=7)
    cfg = GmresConfig(precond="jacobi")
    M_full = build_preconditioner(A, cfg)
    outs = _run_per_proc(
        A, 2, 4,
        lambda blk, shards, ex: build_jacobi_rowblock(blk, np.float64, ex),
    )
    for M in outs:
        np.testing.assert_array_equal(np.asarray(M.inv_diag),
                                      np.asarray(M_full.inv_diag))


@pytest.mark.parametrize("precond", ["identity", "jacobi"])
def test_solve_rowblock_matches_full(precond):
    """Single-process whole-range block: identical history to the full
    CSR solve_distributed (the mesh covers all 8 virtual devices)."""
    A = convection_diffusion_2d(16, beta=1.0)
    blk = _to_block(A, 0, A.n_rows)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr", precond=precond,
        restart_length=12, tol=1e-9, max_restarts=60,
    )
    r_full = solve_distributed(A, b, cfg, record_history=True)
    r_blk = solve_distributed(blk, b, cfg, record_history=True)
    assert r_blk.converged and r_full.converged
    assert r_blk.restarts == r_full.restarts
    assert r_blk.total_iters == r_full.total_iters
    np.testing.assert_allclose(np.asarray(r_blk.x), np.asarray(r_full.x),
                               rtol=0, atol=0)
    err = np.linalg.norm(np.asarray(r_blk.x) - x_true)
    assert err < 1e-5, err


def test_solve_rowblock_rejects_ilu():
    A = convection_diffusion_2d(8)
    blk = _to_block(A, 0, A.n_rows)
    b = np.ones(A.n_rows)
    with pytest.raises(ValueError, match="per-host RowBlockCSR"):
        solve_distributed(blk, b, GmresConfig(precond="ilu_jacobi"))


def test_process_row_range_contiguous():
    mesh = jax.make_mesh((8,), ("rows",))
    lo, hi = process_row_range(mesh, 100, owned=[2, 3])
    r = padded_size(100, 8) // 8
    assert (lo, hi) == (2 * r, min(100, 4 * r))
    with pytest.raises(ValueError, match="contiguous"):
        process_row_range(mesh, 100, owned=[0, 2])


@pytest.mark.parametrize("max_chunks", [None, 32])
def test_partition_sell_block_matches_global(max_chunks, monkeypatch):
    """Per-host-input packs must equal the global pack byte-for-byte —
    including under a multi-part plan (max_chunks=32 forces the round-5
    static part split; the padding-metadata exchange then carries the
    per-block chunk-count vector)."""
    import gmres_tpu.ops.sell as sm
    from gmres_tpu.io.synth import unstructured_mesh
    from gmres_tpu.parallel.sell_dist import partition_sell, sell_rows_per

    if max_chunks is not None:
        monkeypatch.setattr(sm, "MAX_CHUNKS_PER_CALL", max_chunks)
    # multi-part needs >1 output block per shard (parts cut at block
    # boundaries): 16384 rows / 4 shards = 4 blocks each
    A = unstructured_mesh(16384 if max_chunks else 4096, run=3, seed=2)
    full = partition_sell(A, 4)
    assert full is not None
    if max_chunks is not None:
        assert len(full.parts) > 1

    # per-process blocks on the SELL shard grid
    r = sell_rows_per(A.n_rows, 4)
    rp = np.asarray(A.row_ptr).astype(np.int64)

    def blocks_fn(n_procs):
        per = 4 // n_procs
        out = []
        for p in range(n_procs):
            lo = min(p * per * r, A.n_rows)
            hi = min((p + 1) * per * r, A.n_rows)
            out.append((_to_block(A, lo, hi),
                        list(range(p * per, (p + 1) * per))))
        return out

    ex = FakeExchange()
    logs = [[] for _ in range(2)]
    bl = blocks_fn(2)
    for p, (blk, shards) in enumerate(bl):
        try:
            partition_sell(blk, 4, owned=shards,
                           exchange=ex.for_proc(p, logs[p]))
        except Exception:
            pass
    rounds = [dict(rr) for rr in ex.rounds]
    for p, (blk, shards) in enumerate(bl):
        calls = {"i": 0}

        def exchange(arr, p=p, calls=calls):
            rr = calls["i"]
            calls["i"] += 1
            fullr = dict(rounds[rr])
            fullr[p] = np.asarray(arr)
            return np.stack([fullr[q] for q in sorted(fullr)])

        part = partition_sell(blk, 4, owned=shards, exchange=exchange)
        assert part is not None
        assert (part.W, part.K) == (full.W, full.K)
        assert part.n_chunks == full.n_chunks
        assert part.parts == full.parts
        assert part.n_dense_chunks == full.n_dense_chunks
        for s in shards:
            np.testing.assert_array_equal(part.packed.pieces[s],
                                          np.asarray(full.packed)[s])
            np.testing.assert_array_equal(part.slab.pieces[s],
                                          np.asarray(full.slab)[s])
            np.testing.assert_array_equal(part.bucket.pieces[s],
                                          np.asarray(full.bucket)[s])


def test_solve_rowblock_force_sell_matches_full():
    from gmres_tpu.io.synth import unstructured_mesh

    A = unstructured_mesh(2048, run=3, seed=6)
    blk = _to_block(A, 0, A.n_rows)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr", precond="jacobi",
        restart_length=15, tol=1e-9, max_restarts=80,
    )
    r_full = solve_distributed(A, b, cfg, force_sell=True)
    r_blk = solve_distributed(blk, b, cfg, force_sell=True)
    assert r_blk.converged and r_full.converged
    assert (r_blk.restarts, r_blk.total_iters) == (
        r_full.restarts, r_full.total_iters)
    np.testing.assert_allclose(np.asarray(r_blk.x), np.asarray(r_full.x),
                               rtol=0, atol=0)


def test_solve_rowblock_auto_routes_sell():
    """Unstructured per-host input WITHOUT force_sell: no automatic route
    picks SELL.  The operator takes the halo (rebased CSR) or allgather
    CSR partition and matches the full-matrix solve exactly."""
    from gmres_tpu.io.synth import unstructured_mesh
    from gmres_tpu.parallel import dist_gmres

    A = unstructured_mesh(2048, run=3, seed=6)
    blk = _to_block(A, 0, A.n_rows)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr", precond="jacobi",
        restart_length=15, tol=1e-9, max_restarts=80,
    )
    r_blk = solve_distributed(blk, b, cfg)
    assert r_blk.converged
    entry = dist_gmres._DIST_STAGE_CACHE[id(blk)][1]
    staged_types = {type(v[1]).__name__ for v in entry.values()
                    if isinstance(v, tuple)}
    assert "PartitionedSELL" not in staged_types, staged_types
    assert staged_types & {"HaloCSR", "PartitionedCSR"}, staged_types
    # identical route => identical history vs the full-matrix solve
    r_full = solve_distributed(A, b, cfg)
    assert (r_blk.restarts, r_blk.total_iters) == (
        r_full.restarts, r_full.total_iters)
    np.testing.assert_allclose(np.asarray(r_blk.x), np.asarray(r_full.x),
                               rtol=0, atol=0)


def test_solve_rowblock_auto_keeps_dia():
    """Banded per-host input takes the HaloDIA route."""
    from gmres_tpu.parallel import dist_gmres

    A = convection_diffusion_2d(16, beta=1.0)
    blk = _to_block(A, 0, A.n_rows)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr", precond="jacobi",
        restart_length=12, tol=1e-9, max_restarts=60,
    )
    r_blk = solve_distributed(blk, b, cfg)
    assert r_blk.converged
    entry = dist_gmres._DIST_STAGE_CACHE[id(blk)][1]
    staged_types = {type(v[1]).__name__ for v in entry.values()
                    if isinstance(v, tuple)}
    assert "HaloDIA" in staged_types, staged_types
