"""Distributed SELL: per-shard packs under shard_map (``force_sell``).
Runs on the 8-virtual-device CPU mesh (conftest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu.config import GmresConfig, PrecisionSpec
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import unstructured_mesh
from gmres_tpu.ops.sell import sell_spmv
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.parallel.sell_dist import PartitionedSELL, partition_sell


def test_partition_sell_local_spmv_matches_csr():
    A = unstructured_mesh(5000, jitter=8, seed=3)
    P = 8
    # df64=True so the (always-f32) dense blocks carry their lo sidecar —
    # hi+lo makes the XLA-path comparison exact at fp64
    psell = partition_sell(A, P, df64=True, dtype=np.float64)
    assert psell is not None
    assert psell.n_shards == P
    assert psell.rows_per_shard * P == psell.n_cols
    assert psell.n_chunks % 4 == 0  # G_BATCH multiple

    rng = np.random.default_rng(0)
    x = rng.standard_normal(psell.n_cols)
    x[A.n_rows:] = 0.0
    y_ref = np.asarray(spmv(A, jnp.asarray(x[: A.n_rows])))

    r = psell.rows_per_shard
    for s in range(P):
        shard = jax.tree.map(lambda a: a[s : s + 1], psell)
        ls = shard.local_sell()
        y_s = np.asarray(sell_spmv(ls, jnp.asarray(x)))
        lo, hi = s * r, (s + 1) * r
        want = np.zeros(r)
        want[: max(0, min(hi, A.n_rows) - lo)] = y_ref[lo : min(hi, A.n_rows)]
        np.testing.assert_allclose(y_s, want, rtol=1e-10, atol=1e-12)


def test_partition_sell_df64_halves():
    A = unstructured_mesh(3000, jitter=6, seed=5)
    psell = partition_sell(A, 2, df64=True)
    assert psell is not None and psell.df64
    # hi + lo recombines to the exact fp64 values: compare one shard's
    # total against the CSR values sum
    tot = 0.0
    for s in range(2):
        tot += float(np.sum(np.asarray(psell.data[s], np.float64)))
        tot += float(np.sum(np.asarray(psell.packed_lo[s], np.float64)))
        tot += float(np.sum(np.asarray(psell.dense_data[s], np.float64)))
        tot += float(np.sum(np.asarray(psell.dense_lo[s], np.float64)))
    want = float(np.sum(np.asarray(A.vals, np.float64)))
    np.testing.assert_allclose(tot, want, rtol=1e-13)


@pytest.mark.parametrize("mode", ["mixed", "single"])
def test_solve_distributed_sell(mode):
    """End-to-end sharded solve routed through per-shard SELL operators:
    the staging cache must hold a PartitionedSELL inner operator and the
    solve must converge to the fp64-accurate solution."""
    from gmres_tpu.parallel import dist_gmres

    A = unstructured_mesh(6000, jitter=8, seed=11)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode(mode),
        orth="cgsr",
        precond="identity",
        restart_length=25,
        tol=1e-7,
        max_restarts=300,
    )
    res = dist_gmres.solve_distributed(A, b, cfg, force_sell=True)
    assert res.converged
    x = np.asarray(res.x, dtype=np.float64)
    r = b - np.asarray(spmv(A, jnp.asarray(x)))
    rel = np.linalg.norm(r) / np.linalg.norm(b)
    assert rel <= 1e-6

    # the unstructured route was actually taken
    entry = dist_gmres._DIST_STAGE_CACHE.get(id(A))
    assert entry is not None
    staged = list(entry[1].values())
    assert any(isinstance(t[1], PartitionedSELL) for t in staged), \
        "inner operator was not SELL-partitioned"
    if mode == "mixed":
        from gmres_tpu.parallel.partition import PartitionedCSR

        assert any(isinstance(t[0], PartitionedCSR) for t in staged), \
            "fp64 outer residual did not keep the CSR row partition"


def test_partition_sell_multipart_over_chunk_budget(monkeypatch):
    """A shard whose chunk list exceeds MAX_CHUNKS_PER_CALL must split
    into multiple static parts (shared across shards) instead of refusing
    — the round-4 retention bench silently fell back to the 18x-slower
    CSR gather path here (VERDICT round-4 item 1)."""
    import gmres_tpu.ops.sell as sm

    A = unstructured_mesh(5000, jitter=8, seed=3)
    P = 2
    monkeypatch.setattr(sm, "MAX_CHUNKS_PER_CALL", 64)
    psell = partition_sell(A, P, df64=True, dtype=np.float64)
    assert psell is not None, "multi-part pack refused"
    assert len(psell.parts) > 1
    assert psell.n_chunks == sum(p[0] for p in psell.parts)
    # parts tile the local block range contiguously and disjointly
    n_blocks = psell.rows_per_shard // 1024
    assert psell.parts[0][1] == 0
    for (pa, pb) in zip(psell.parts[:-1], psell.parts[1:]):
        assert pa[1] + pa[2] == pb[1]
    assert psell.parts[-1][1] + psell.parts[-1][2] == n_blocks

    rng = np.random.default_rng(0)
    x = rng.standard_normal(psell.n_cols)
    x[A.n_rows:] = 0.0
    y_ref = np.asarray(spmv(A, jnp.asarray(x[: A.n_rows])))
    r = psell.rows_per_shard
    for s in range(P):
        shard = jax.tree.map(lambda a: a[s : s + 1], psell)
        ls = shard.local_sell()
        assert len(ls.parts) == len(psell.parts)
        y_s = np.asarray(sell_spmv(ls, jnp.asarray(x)))
        lo, hi = s * r, (s + 1) * r
        want = np.zeros(r)
        want[: max(0, min(hi, A.n_rows) - lo)] = y_ref[lo : min(hi, A.n_rows)]
        np.testing.assert_allclose(y_s, want, rtol=1e-10, atol=1e-12)


def test_solve_distributed_sell_multipart(monkeypatch):
    """End-to-end sharded solve with a forced multi-part SELL plan: the
    shard_map'd SELL executor must converge like the single-part case."""
    import gmres_tpu.ops.sell as sm
    from gmres_tpu.parallel import dist_gmres

    # big enough that each shard spans >1 output block (parts cut at
    # block boundaries; a single over-budget block cannot split)
    A = unstructured_mesh(20000, jitter=6, seed=7)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr",
        precond="identity",
        restart_length=20,
        tol=1e-7,
        max_restarts=300,
    )
    monkeypatch.setattr(sm, "MAX_CHUNKS_PER_CALL", 64)
    res = dist_gmres.solve_distributed(A, b, cfg, force_sell=True)
    assert res.converged
    x = np.asarray(res.x, dtype=np.float64)
    rel = np.linalg.norm(b - np.asarray(spmv(A, jnp.asarray(x))))
    rel /= np.linalg.norm(b)
    assert rel <= 1e-6
    entry = dist_gmres._DIST_STAGE_CACHE.get(id(A))
    staged = list(entry[1].values())
    ps = next(t[1] for t in staged if isinstance(t[1], PartitionedSELL))
    assert len(ps.parts) > 1, "multi-part plan was not exercised"


def test_solve_distributed_sell_matches_single_device():
    """Iteration counts of the sharded SELL solve match the single-device
    solve of the same config (reduction-order differences only)."""
    from gmres_tpu.parallel.dist_gmres import solve_distributed
    from gmres_tpu.solver.gmres import solve

    A = unstructured_mesh(4000, jitter=6, seed=7)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr",
        precond="jacobi",
        restart_length=20,
        tol=1e-8,
        max_restarts=300,
    )
    res_d = solve_distributed(A, b, cfg, force_sell=True,
                              record_history=True)
    res_s = solve(A, b, cfg, record_history=True)
    assert res_d.converged and res_s.converged
    assert abs(res_d.restarts - res_s.restarts) <= 1


def test_plan_shard_parts_edges(monkeypatch):
    """Part planner edges: budget cuts at block boundaries, a single
    over-budget block gets its own part, totals always preserved."""
    import numpy as np

    import gmres_tpu.ops.sell as sm
    from gmres_tpu.parallel.sell_dist import _plan_shard_parts

    monkeypatch.setattr(sm, "MAX_CHUNKS_PER_CALL", 100)
    # uniform: 10 blocks x 40 chunks -> parts of 2 blocks (80 <= 100)
    plan = _plan_shard_parts(np.full(10, 40, np.int64))
    assert sum(p[0] for p in plan) == 400
    assert all(p[0] <= 100 for p in plan)
    assert plan[0][1] == 0 and plan[-1][1] + plan[-1][2] == 10
    for a, b in zip(plan[:-1], plan[1:]):
        assert a[1] + a[2] == b[1]
    # one block alone exceeds the budget: it still gets exactly one part
    mx = np.array([40, 250, 40], np.int64)
    plan = _plan_shard_parts(mx)
    assert sum(p[0] for p in plan) == 330
    assert any(p[0] == 250 and p[2] == 1 for p in plan)
    # all-zero (fully empty partition): one part covering everything
    plan = _plan_shard_parts(np.zeros(4, np.int64))
    assert plan == ((0, 0, 4),)
