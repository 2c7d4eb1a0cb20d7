"""Batched multi-RHS solve (solver/batched.py): per-lane equivalence with
the single-RHS solver, lockstep masking, policies, failure lanes."""

import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu import GmresConfig, PrecisionSpec, solve, solve_batched
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d, poisson_2d
from gmres_tpu.ops.spmv import spmv


def _rhs_batch(A, seeds):
    xs = [rand_vect(A.n_rows, s) for s in seeds]
    B = np.stack([np.asarray(spmv(A, jnp.asarray(x))) for x in xs])
    return xs, B


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_batched_matches_single(mode):
    """Each lane reproduces solve() exactly (same cycle, vectorized):
    identical restart counts, iteration totals and solutions."""
    A = convection_diffusion_2d(12)
    xs, B = _rhs_batch(A, [1, 2, 3, 4])
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode(mode), orth="cgsr",
        precond="jacobi", restart_length=15, tol=1e-8, max_restarts=200,
    )
    results = solve_batched(A, B, cfg, record_history=True)
    assert len(results) == 4
    for lane, (x_true, r) in enumerate(zip(xs, results)):
        r_s = solve(A, B[lane], cfg,
                    record_history=True)
        assert r.converged and r_s.converged
        assert (r.restarts, r.total_iters) == (r_s.restarts, r_s.total_iters)
        np.testing.assert_allclose(np.asarray(r.x), np.asarray(r_s.x),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(r.rel_prec_res, r_s.rel_prec_res,
                                   rtol=1e-6)
        assert np.linalg.norm(np.asarray(r.x) - x_true) < 1e-4
        # per-cycle history mirrors the single-RHS driver row for row
        assert [(h["i"], h["k"]) for h in r.history] == \
            [(h["i"], h["k"]) for h in r_s.history]
        np.testing.assert_allclose(
            [h["rel_initial"] for h in r.history],
            [h["rel_initial"] for h in r_s.history], rtol=1e-6)


def test_batched_uneven_convergence():
    """Lanes that converge early are frozen while harder lanes keep
    iterating — per-lane counts still match the single-RHS solver."""
    A = poisson_2d(12)
    n = A.n_rows
    x1 = rand_vect(n, 7)
    b_easy = np.asarray(spmv(A, jnp.asarray(x1))) * 1e-3
    # x0=0 already nearly solves a tiny-norm RHS at loose tol quickly;
    # pair it with a full-scale RHS at tight tol
    x2 = rand_vect(n, 8)
    b_hard = np.asarray(spmv(A, jnp.asarray(x2)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"), orth="cgs",
        precond="jacobi", restart_length=10, tol=1e-8, max_restarts=300,
    )
    res = solve_batched(A, np.stack([b_easy, b_hard]), cfg)
    for lane, b in enumerate((b_easy, b_hard)):
        r_s = solve(A, b, cfg)
        assert res[lane].converged == r_s.converged
        assert (res[lane].restarts, res[lane].total_iters) == (
            r_s.restarts, r_s.total_iters)
    assert res[0].restarts != res[1].restarts  # genuinely uneven


def test_batched_policy_relres():
    """Non-FIXED policies batch: per-lane PolicyState (restart_tol,
    second_restart_length) is threaded through the masked chunk loop."""
    A = convection_diffusion_2d(10)
    xs, B = _rhs_batch(A, [11, 12, 13])
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"), orth="cgsr",
        precond="jacobi", policy="relres", restart_improvement=0.5,
        restart_length=15, tol=1e-8, max_restarts=300,
    )
    results = solve_batched(A, B, cfg)
    for lane in range(3):
        r_s = solve(A, B[lane], cfg)
        assert results[lane].converged and r_s.converged
        assert (results[lane].restarts, results[lane].total_iters) == (
            r_s.restarts, r_s.total_iters)


def test_batched_max_restarts_abort():
    A = poisson_2d(12)
    _, B = _rhs_batch(A, [1, 2])
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"), orth="cgs",
        precond="identity", restart_length=5, tol=1e-12, max_restarts=2,
    )
    results = solve_batched(A, B, cfg)
    for r in results:
        assert not r.converged and r.aborted
        assert r.restarts == 2


def test_batched_default_config_exact_ilu():
    """The DEFAULT GmresConfig (precond='ilu') must work batched: the
    exact-ILU apply is rebuilt in its XLA-sweep form (identical factors
    and level counts; the fused Pallas trisolve cannot batch)."""
    A = convection_diffusion_2d(10)
    xs, B = _rhs_batch(A, [21, 22])
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"),
                      restart_length=15, tol=1e-8, max_restarts=200)
    results = solve_batched(A, B, cfg)
    for x_true, r in zip(xs, results):
        assert r.converged
        assert np.linalg.norm(np.asarray(r.x) - x_true) < 1e-4


def test_batched_input_validation():
    A = poisson_2d(8)
    _, B = _rhs_batch(A, [1])
    with pytest.raises(ValueError, match="single-device"):
        solve_batched(A, B, GmresConfig(axis_name="rows"))
    with pytest.raises(ValueError, match="df64"):
        solve_batched(A, B, GmresConfig(
            precision=PrecisionSpec.from_mode("df64")))
    with pytest.raises(ValueError, match="batch, n"):
        solve_batched(A, np.zeros((A.n_rows,)), GmresConfig())


def test_batched_compressed_basis():
    """Tier composition: the CB (bf16 basis) tier under the batched
    (vmapped) cycle — mixed-dtype orth paths must batch too."""
    import dataclasses

    A = convection_diffusion_2d(10)
    xs, B = _rhs_batch(A, [31, 32])
    prec = dataclasses.replace(PrecisionSpec.from_mode("mixed"),
                               basis="bfloat16")
    cfg = GmresConfig(precision=prec, orth="cgsr", precond="jacobi",
                      restart_length=15, tol=1e-8, max_restarts=300)
    results = solve_batched(A, B, cfg)
    for lane, (x_true, r) in enumerate(zip(xs, results)):
        r_s = solve(A, B[lane], cfg)
        assert r.converged and r_s.converged
        assert (r.restarts, r.total_iters) == (r_s.restarts, r_s.total_iters)
        assert np.linalg.norm(np.asarray(r.x) - x_true) < 1e-3


def test_batched_list_input():
    A = poisson_2d(10)
    xs, B = _rhs_batch(A, [5, 6])
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("baseline"),
                      orth="mgs", precond="jacobi", restart_length=12,
                      tol=1e-10, max_restarts=300)
    results = solve_batched(A, [B[0], B[1]], cfg)
    for x_true, r in zip(xs, results):
        assert r.converged
        assert np.linalg.norm(np.asarray(r.x) - x_true) < 1e-6
