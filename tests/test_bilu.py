"""Block-Jacobi ILU(0) (``precond/bilu.py``) — the pod-scale ILU: each
shard factors its diagonal block, application is communication-free.  New
scope vs the single-device reference (SURVEY.md §2.6/§5.8)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gmres_tpu import GmresConfig, PrecisionSpec
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d, unstructured_mesh
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.parallel.dist_gmres import solve_distributed
from gmres_tpu.precond.bilu import BlockILUCSR, BlockILUDia, build_bilu_jacobi
from gmres_tpu.precond.ilu0 import ilu0_factorize

from test_rowblock_dist import _run_per_proc, _to_block


def _mixed_cfg(**kw):
    base = dict(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr", precond="bilu_jacobi", jacobi_steps=3,
        restart_length=12, tol=1e-9, max_restarts=100,
    )
    base.update(kw)
    return GmresConfig(**base)


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    return x_true, b


def _diag_block(A, lo, hi):
    """(sub_rp, sub_ci, sub_v) of A[lo:hi, lo:hi] with local columns."""
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    ci = np.asarray(A.col_idx)[:nnz].astype(np.int64)
    v = np.asarray(A.vals)[:nnz]
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp))
    keep = (rows >= lo) & (rows < hi) & (ci >= lo) & (ci < hi)
    rows_k = rows[keep] - lo
    sub_rp = np.zeros(hi - lo + 1, np.int64)
    np.cumsum(np.bincount(rows_k, minlength=hi - lo), out=sub_rp[1:])
    return sub_rp, (ci[keep] - lo).astype(np.int32), v[keep]


def test_p1_coincides_with_global_ilu_jacobi():
    """One shard = one block = the whole matrix: bilu == ilu_jacobi."""
    A = convection_diffusion_2d(16, beta=1.0)
    x_true, b = _problem(A)
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("rows",))
    r1 = solve_distributed(A, b, _mixed_cfg(), mesh=mesh1)
    r2 = solve_distributed(A, b, _mixed_cfg(precond="ilu_jacobi"), mesh=mesh1)
    assert r1.converged and r2.converged
    assert (r1.restarts, r1.total_iters) == (r2.restarts, r2.total_iters)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))


@pytest.mark.parametrize("make,name", [
    (lambda: convection_diffusion_2d(16, beta=1.0), "banded"),
    (lambda: unstructured_mesh(2048, run=3, seed=6), "unstructured"),
])
def test_bilu_solve_converges_8_shards(make, name):
    A = make()
    x_true, b = _problem(A)
    r = solve_distributed(A, b, _mixed_cfg(restart_length=15))
    assert r.converged, name
    err = np.linalg.norm(np.asarray(r.x) - x_true)
    assert err < 1e-5, (name, err)


def test_factor_form_routing():
    """Banded blocks -> shared-offsets DIA; scattered blocks -> CSR."""
    A = convection_diffusion_2d(16, beta=1.0)
    r = -(-A.n_rows // 8)
    assert isinstance(build_bilu_jacobi(A, 8, r, np.float32, 3), BlockILUDia)
    U = unstructured_mesh(2048, run=3, seed=6)
    r = -(-U.n_rows // 8)
    assert isinstance(build_bilu_jacobi(U, 8, r, np.float32, 3), BlockILUCSR)


def test_block_factors_match_direct_ilu0():
    """Each shard's factors equal ILU(0) run directly on its extracted
    diagonal block (via the DIA form's band values)."""
    A = convection_diffusion_2d(12, beta=1.0)
    n_shards = 4
    r = -(-A.n_rows // n_shards)
    M = build_bilu_jacobi(A, n_shards, r, np.float64, 3)
    assert isinstance(M, BlockILUDia)
    lower = np.asarray(M.lower)
    upper = np.asarray(M.upper)
    for s in range(n_shards):
        lo, hi = s * r, min((s + 1) * r, A.n_rows)
        sub_rp, sub_ci, sub_v = _diag_block(A, lo, hi)
        fvals, diag = ilu0_factorize(sub_rp, sub_ci,
                                     sub_v.astype(np.float64))
        fvals = np.asarray(fvals)
        rows = np.repeat(np.arange(hi - lo, dtype=np.int64),
                         np.diff(sub_rp))
        offs = sub_ci.astype(np.int64) - rows
        for e in range(fvals.shape[0]):
            i, o = int(rows[e]), int(offs[e])
            if o < 0:
                d = M.offsets_l.index(o)
                np.testing.assert_allclose(lower[s, d, i], fvals[e],
                                           rtol=1e-14)
            else:
                d = M.offsets_u.index(o)
                np.testing.assert_allclose(upper[s, d, i], fvals[e],
                                           rtol=1e-14)
        inv = np.asarray(M.inv_diag)[s, : hi - lo]
        np.testing.assert_allclose(inv, 1.0 / fvals[diag], rtol=1e-14)


def test_rowblock_bilu_matches_full():
    """Whole-range RowBlockCSR input: identical solve to the full CSR."""
    A = convection_diffusion_2d(16, beta=1.0)
    x_true, b = _problem(A)
    blk = _to_block(A, 0, A.n_rows)
    r_full = solve_distributed(A, b, _mixed_cfg())
    r_blk = solve_distributed(blk, b, _mixed_cfg())
    assert r_blk.converged and r_full.converged
    assert (r_blk.restarts, r_blk.total_iters) == (
        r_full.restarts, r_full.total_iters)
    np.testing.assert_array_equal(np.asarray(r_blk.x), np.asarray(r_full.x))


@pytest.mark.parametrize("make", [
    lambda: convection_diffusion_2d(16, beta=1.0),   # DIA form
    lambda: unstructured_mesh(1024, run=3, seed=3),  # CSR form
])
def test_build_per_process_matches_global(make):
    """Per-process owned builds (metadata through a simulated exchange)
    must produce exactly the single-process global factors."""
    A = make()
    n_shards = 4
    r = -(-A.n_rows // n_shards)
    full = build_bilu_jacobi(A, n_shards, r, np.float32, 3)
    outs = _run_per_proc(
        A, 2, n_shards,
        lambda blk, shards, ex: build_bilu_jacobi(
            A=blk, n_shards=n_shards, rows_per=r, dtype=np.float32,
            steps=3, owned=shards, exchange=ex),
    )
    for M, shards in zip(outs, [[0, 1], [2, 3]]):
        assert type(M).__name__ == type(full).__name__
        if isinstance(full, BlockILUDia):
            assert M.offsets_l == full.offsets_l
            assert M.offsets_u == full.offsets_u
            for s in shards:
                np.testing.assert_array_equal(M.lower.pieces[s],
                                              np.asarray(full.lower)[s])
                np.testing.assert_array_equal(M.upper.pieces[s],
                                              np.asarray(full.upper)[s])
                np.testing.assert_array_equal(M.inv_diag.pieces[s],
                                              np.asarray(full.inv_diag)[s])
        else:
            for s in shards:
                for fld in ("l_ptr", "l_col", "l_val", "u_ptr", "u_col",
                            "u_val", "inv_diag"):
                    np.testing.assert_array_equal(
                        getattr(M, fld).pieces[s],
                        np.asarray(getattr(full, fld))[s], err_msg=fld)


def test_single_device_build_raises():
    from gmres_tpu.precond.build import build_preconditioner

    A = convection_diffusion_2d(8)
    with pytest.raises(ValueError, match="solve_distributed"):
        build_preconditioner(A, GmresConfig(precond="bilu_jacobi"))


def test_distributed_checkpoint_resume(tmp_path):
    """Sharded checkpoint/resume (SURVEY.md §5.4 at pod scale): abort a
    budget-limited distributed solve mid-way, resume, and match the
    uninterrupted run."""
    from gmres_tpu.utils.checkpoint import CheckpointSpec

    A = convection_diffusion_2d(16, beta=1.0)
    x_true, b = _problem(A)
    cfg = _mixed_cfg(precond="jacobi", restart_length=8, tol=1e-10,
                     max_restarts=200)
    full = solve_distributed(A, b, cfg, record_history=True)
    assert full.converged and full.restarts >= 3

    ck = CheckpointSpec(path=str(tmp_path / "d.ckpt"), every=1)
    part = solve_distributed(A, b, cfg.with_(max_restarts=2), checkpoint=ck)
    assert part.aborted

    res = solve_distributed(A, b, cfg, checkpoint=ck)
    assert res.converged
    assert res.restarts == full.restarts
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(full.x),
                               rtol=1e-10)


def test_ckpt_consensus_adopts_minimum_header():
    """A mid-save preemption leaves per-process checkpoint files one
    interval apart; the consensus hook must reconcile (all adopt the
    minimum restart header) instead of failing the resume."""
    import warnings

    from gmres_tpu.parallel.dist_gmres import _dist_ckpt_hooks
    from gmres_tpu.solver.policies import initial_policy_state
    from gmres_tpu.utils.checkpoint import CheckpointSpec
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax.make_mesh((4,), ("rows",))
    shard0 = NamedSharding(mesh, P("rows"))
    spec = CheckpointSpec(path="/tmp/unused.ckpt", every=1)
    _, _, _, consensus = _dist_ckpt_hooks(
        spec, mesh, shard0, 8, None,
        exchange=lambda arr: np.stack([
            np.asarray(arr),                       # this "process": i=10
            np.array([8, 80, 0, 12, 1e-3]),        # a process behind: i=8
        ]),
    )
    ps = initial_policy_state()
    x_blk = np.arange(32.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = consensus((x_blk, 10, 100, ps))
    assert out is not None
    x2, i, iters, ps2 = out
    np.testing.assert_array_equal(x2, x_blk)       # keeps its OWN block
    assert (i, iters) == (8, 80)                   # adopts the minimum
    assert int(ps2.second_restart_length) == 12
    assert float(ps2.restart_tol) == 1e-3
    assert any("disagree" in str(x.message) for x in w)

    # a process with no file: everyone starts fresh
    _, _, _, consensus2 = _dist_ckpt_hooks(
        spec, mesh, shard0, 8, None,
        exchange=lambda arr: np.stack([
            np.asarray(arr), np.array([-1.0, 0, 0, 0, 0])]),
    )
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert consensus2((x_blk, 10, 100, ps)) is None

    # non-contiguous owned shards are rejected up front
    with pytest.raises(ValueError, match="contiguous"):
        _dist_ckpt_hooks(spec, mesh, shard0, 8, [0, 2])
