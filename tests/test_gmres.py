"""End-to-end GMRES tests: the manufactured-solution harness (the
reference's de-facto integration test, gmres_perf_test.cpp:39-51,104-115)
across modes, orthogonalizations, preconditioners and policies."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu import GmresConfig, PrecisionSpec, solve
from gmres_tpu.config import Orth, Precond, RestartPolicy
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d, poisson_2d, random_sparse
from gmres_tpu.ops.spmv import spmv


def manufactured(A, seed=42):
    x_true = rand_vect(A.n_rows, seed)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    return x_true, b


def backward_error(A, x, b):
    r = b - np.asarray(spmv(A, jnp.asarray(np.asarray(x, dtype=np.float64))))
    a_norm = np.linalg.norm(np.asarray(A.vals))
    return np.linalg.norm(r) / (
        np.linalg.norm(b) + a_norm * np.linalg.norm(np.asarray(x))
    )


@pytest.mark.parametrize("mode", ["baseline", "mixed", "single-prec", "single"])
def test_modes_converge_poisson(mode):
    A = poisson_2d(16)
    x_true, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode(mode),
        orth=Orth.MGS,
        precond=Precond.IDENTITY,
        restart_length=30,
        tol=1e-6,
        max_restarts=1000,
    )
    res = solve(A, b, cfg)
    assert res.converged and not res.aborted
    assert backward_error(A, res.x, b) <= 1e-6
    # iteration counts are multiples of restart structure; all 4 modes land
    # in the same ballpark on this well-conditioned problem
    assert res.total_iters > 0


@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgsr"])
def test_orthogonalizations_agree(orth):
    A = convection_diffusion_2d(12)
    x_true, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        orth=orth,
        precond=Precond.IDENTITY,
        restart_length=25,
        tol=1e-8,
        max_restarts=1000,
    )
    res = solve(A, b, cfg)
    assert res.converged
    assert backward_error(A, res.x, b) <= 1e-8


@pytest.mark.parametrize("prec", ["identity", "jacobi", "ilu_jacobi", "ilu"])
def test_preconditioners(prec):
    A = convection_diffusion_2d(10, beta=30.0)
    x_true, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        orth=Orth.MGS,
        precond=prec,
        jacobi_steps=3,
        restart_length=20,
        tol=1e-7,
        max_restarts=500,
    )
    res = solve(A, b, cfg)
    assert res.converged, f"{prec} did not converge"
    assert backward_error(A, res.x, b) <= 1e-7


def test_ilu_precond_accelerates():
    A = convection_diffusion_2d(14, beta=40.0)
    _, b = manufactured(A)
    base = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        orth=Orth.MGS,
        precond=Precond.IDENTITY,
        restart_length=20,
        tol=1e-7,
        max_restarts=2000,
    )
    res_id = solve(A, b, base)
    res_ilu = solve(A, b, base.with_(precond=Precond.ILU))
    assert res_ilu.converged
    assert res_ilu.total_iters < res_id.total_iters


def test_mixed_matches_baseline_iterations():
    """Cross-configuration consistency: mixed precision converges in a
    comparable iteration count on identical (matrix, b, seed) inputs — the
    reference's validation methodology (SURVEY.md §4.3)."""
    A = poisson_2d(16)
    _, b = manufactured(A)
    kw = dict(orth=Orth.MGS, precond=Precond.IDENTITY, restart_length=30,
              tol=1e-6, max_restarts=1000)
    res_b = solve(A, b, GmresConfig(precision=PrecisionSpec.from_mode("baseline"), **kw))
    res_m = solve(A, b, GmresConfig(precision=PrecisionSpec.from_mode("mixed"), **kw))
    assert res_b.converged and res_m.converged
    assert res_m.total_iters <= 2 * res_b.total_iters


def test_bf16_inner_converges():
    """The generalized dtype staging beyond the reference's four modes."""
    A = poisson_2d(12)
    _, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec("float64", "bfloat16", "bfloat16"),
        orth=Orth.CGSR,
        precond=Precond.IDENTITY,
        restart_length=20,
        tol=1e-6,
        max_restarts=5000,
    )
    res = solve(A, b, cfg)
    assert res.converged
    assert backward_error(A, res.x, b) <= 1e-6


def test_abort_at_max_restarts():
    A = poisson_2d(16)
    _, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        orth=Orth.MGS,
        precond=Precond.IDENTITY,
        restart_length=5,
        tol=1e-14,  # unreachably tight with m=5
        max_restarts=3,
    )
    res = solve(A, b, cfg)
    assert res.aborted and not res.converged
    # max_restarts bounds check_initial calls: 3 cycles ran
    assert res.restarts == 3
    assert res.total_iters == 15


def test_fixed_restart_iteration_structure():
    A = poisson_2d(16)
    _, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        orth=Orth.MGS,
        precond=Precond.IDENTITY,
        restart_length=13,
        tol=1e-6,
        max_restarts=1000,
    )
    res = solve(A, b, cfg, record_history=True)
    assert res.converged
    # fixed policy: every completed cycle runs exactly m inner iterations
    for h in res.history[:-1]:
        assert h["k"] == 13
    assert res.total_iters == 13 * (len(res.history) - 1)


def test_relres_policy_restarts_early():
    A = convection_diffusion_2d(12)
    _, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        orth=Orth.MGS,
        precond=Precond.IDENTITY,
        policy=RestartPolicy.REL_PREC_RES,
        restart_improvement=0.5,  # restart after halving the prec residual
        restart_length=50,
        tol=1e-8,
        max_restarts=5000,
    )
    res = solve(A, b, cfg, record_history=True)
    assert res.converged
    # at least one cycle must have restarted before the max length
    assert any(h["k"] < 50 for h in res.history if h["k"] > 0)


def test_repeat_iteration_policy():
    A = convection_diffusion_2d(12)
    _, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        orth=Orth.MGS,
        precond=Precond.IDENTITY,
        policy=RestartPolicy.REPEAT_ITERATION,
        restart_improvement=0.5,
        restart_length=50,
        tol=1e-8,
        max_restarts=5000,
    )
    res = solve(A, b, cfg, record_history=True)
    assert res.converged
    ks = [h["k"] for h in res.history if h["k"] > 0]
    # after the first cycle picks a length, later full cycles repeat it
    if len(ks) > 2:
        assert all(k == ks[0] for k in ks[1:-1])


def test_orthloss_policy():
    A = convection_diffusion_2d(12)
    _, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("single"),
        orth=Orth.MGS,
        precond=Precond.IDENTITY,
        policy=RestartPolicy.LOST_ORTHOGONALITY,
        restart_improvement=1e-4,
        restart_length=60,
        tol=1e-5,
        max_restarts=5000,
    )
    res = solve(A, b, cfg)
    assert res.converged


def test_x0_and_immediate_convergence():
    A = poisson_2d(8)
    x_true, b = manufactured(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("baseline"),
        precond=Precond.IDENTITY,
        restart_length=10,
        tol=1e-6,
    )
    res = solve(A, b, cfg, x0=x_true)
    assert res.converged
    assert res.restarts == 0 and res.total_iters == 0 and res.final_k == 0


def test_random_diag_dominant():
    A = random_sparse(400, row_nnz=10, seed=3)
    x_true, b = manufactured(A, seed=7)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth=Orth.CGS,
        precond=Precond.JACOBI,
        restart_length=30,
        tol=1e-8,
        max_restarts=1000,
    )
    res = solve(A, b, cfg)
    assert res.converged
    assert backward_error(A, res.x, b) <= 1e-8


@contextlib.contextmanager
def _unrolled():
    """Run with ``backend.unroll_inner()`` answering True.  The jit caches
    are cleared on entry and exit: the answer is read at trace time, and a
    program traced under the other answer must not be reused.

    Callers compare against the rolled loop under ``jax.disable_jit()``:
    both then execute the same operations one by one, so any difference
    in the histories comes from the control flow under test (post-hoc
    trigger selection versus early exit) and not from how a compiler
    fused the two programs."""
    from gmres_tpu import backend

    real = backend.unroll_inner
    backend.unroll_inner = lambda: True
    jax.clear_caches()
    try:
        yield
    finally:
        backend.unroll_inner = real
        jax.clear_caches()


@pytest.mark.parametrize("policy_kw", [
    dict(rtol=1e-2),                      # REL_PREC_RES
    dict(rtol=1e-2, repeat_iter=True),    # REPEAT_ITERATION
    dict(rtol=1e-2, orthloss=True),       # LOST_ORTHOGONALITY
])
def test_policy_unrolled_matches_rolled(policy_kw):
    """The unrolled post-hoc-trigger path (``backend.unroll_inner``) must
    reproduce the rolled while_loop's convergence history exactly."""

    A = convection_diffusion_2d(12, beta=1.5)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig.from_flags(
        mode="mixed", orth="cgsr", prec="identity",
        rlen=15, tol=1e-9, max_restarts=200, **policy_kw,
    )
    assert cfg.policy != RestartPolicy.FIXED

    with jax.disable_jit():
        res_rolled = solve(A, b, cfg, record_history=True)
        with _unrolled():
            res_unrolled = solve(A, b, cfg, record_history=True)

    assert res_unrolled.converged == res_rolled.converged
    assert res_unrolled.restarts == res_rolled.restarts
    assert res_unrolled.total_iters == res_rolled.total_iters
    ks_r = [h["k"] for h in res_rolled.history]
    ks_u = [h["k"] for h in res_unrolled.history]
    assert ks_r == ks_u
    for hr, hu in zip(res_rolled.history, res_unrolled.history):
        if "arnoldi_final" in hr:
            np.testing.assert_allclose(hu["arnoldi_final"],
                                       hr["arnoldi_final"], rtol=1e-10)


def test_repeat_policy_divergence_is_config_inherent():
    """The diverging ``repeat(1e-2)`` bench row (BASELINE.md round-2 policy
    table) must be a property of the CONFIG, not an artifact of the
    unrolled post-hoc-trigger path: the rolled while_loop and the forced
    unrolled path must abort identically.

    conv-diff nx=128 reproduces the bench operator's behavior: the first
    cycle's rtol=1e-2 trigger locks the repeat policy's restart length to a
    small k and GMRES(k) stagnates (IterUtil.hpp:84-137 semantics)."""

    A = convection_diffusion_2d(128, beta=2.0)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig.from_flags(
        mode="mixed", orth="cgsr", prec="identity",
        rlen=30, tol=1e-8, max_restarts=80, rtol=1e-2, repeat_iter=True,
    )
    res_rolled = solve(A, b, cfg, record_history=True)
    with _unrolled():
        res_unrolled = solve(A, b, cfg, record_history=True)
    # both paths diverge (abort at max_restarts), with identical histories
    assert res_rolled.aborted and not res_rolled.converged
    assert res_unrolled.aborted and not res_unrolled.converged
    assert res_unrolled.restarts == res_rolled.restarts == 80
    assert res_unrolled.total_iters == res_rolled.total_iters
    assert [h["k"] for h in res_unrolled.history] == \
        [h["k"] for h in res_rolled.history]


def test_fixed_unrolled_matches_rolled():
    """The FIXED policy's unrolled fori path (``backend.unroll_inner``)
    must match the rolled loop exactly."""

    A = convection_diffusion_2d(12, beta=1.5)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig.from_flags(
        mode="mixed", orth="cgsr", prec="identity",
        rlen=15, tol=1e-9, max_restarts=100,
    )
    assert cfg.policy == RestartPolicy.FIXED
    with jax.disable_jit():
        res_rolled = solve(A, b, cfg, record_history=True)
        with _unrolled():
            res_unrolled = solve(A, b, cfg, record_history=True)
    assert res_unrolled.restarts == res_rolled.restarts
    assert res_unrolled.total_iters == res_rolled.total_iters
    for hr, hu in zip(res_rolled.history, res_unrolled.history):
        np.testing.assert_allclose(hu["rel_initial"], hr["rel_initial"],
                                   rtol=1e-12)
