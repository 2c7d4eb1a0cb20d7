"""The df64 inner-precision tier (mode "df64", ``ops/df64.py``): an
fp64-quality inner loop carried as two-fp32 pairs — the beyond-reference
5th precision configuration.  Its contract: converge like the all-fp64
baseline (same restart/iteration counts, fp64-class solution error) in
regimes where the fp32-inner mixed scheme needs extra refinement."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gmres_tpu import GmresConfig, PrecisionSpec, solve
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d, unstructured_mesh
from gmres_tpu.ops.spmv import spmv


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    return x_true, b


def test_df64_math_accuracy():
    from gmres_tpu.ops.df64 import (
        df_dot, df_gram, df_norm, df_update, merge_f64, split_f64,
    )

    rng = np.random.default_rng(0)
    n = 65536
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    ah, al = split_f64(jnp.asarray(a))
    bh, bl = split_f64(jnp.asarray(b))
    assert abs(float(df_dot(ah, al, bh, bl)) - np.dot(a, b)) <= (
        1e-13 * abs(np.dot(a, b)) + 1e-13 * np.linalg.norm(a) * np.linalg.norm(b)
    )
    assert abs(float(df_norm(ah, al)) - np.linalg.norm(a)) <= (
        1e-13 * np.linalg.norm(a)
    )
    V = rng.standard_normal((17, n))
    Vh, Vl = split_f64(jnp.asarray(V))
    np.testing.assert_allclose(np.asarray(df_gram(Vh, Vl, ah, al)), V @ a,
                               rtol=0, atol=1e-11 * np.abs(V @ a).max())
    u = rng.standard_normal(17)
    wh, wl = df_update(ah, al, Vh, Vl, jnp.asarray(u))
    np.testing.assert_allclose(np.asarray(merge_f64(wh, wl)), a - u @ V,
                               rtol=0, atol=1e-12 * np.abs(a - u @ V).max())


@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgsr"])
def test_df64_matches_baseline_counts(orth):
    A = convection_diffusion_2d(24, beta=1.0)
    x_true, b = _problem(A)
    res = {}
    for mode in ("baseline", "df64"):
        cfg = GmresConfig(
            precision=PrecisionSpec.from_mode(mode), orth=orth,
            precond="jacobi", restart_length=20, tol=1e-12, max_restarts=200,
        )
        A2 = convection_diffusion_2d(24, beta=1.0)  # dodge stage cache
        res[mode] = solve(A2, b, cfg)
    base, df = res["baseline"], res["df64"]
    assert base.converged and df.converged
    assert (df.restarts, df.total_iters) == (base.restarts, base.total_iters)
    err_b = np.linalg.norm(np.asarray(base.x, np.float64) - x_true)
    err_d = np.linalg.norm(np.asarray(df.x, np.float64) - x_true)
    assert err_d <= 10 * err_b + 1e-12, (err_b, err_d)


def test_df64_beats_mixed_in_f32_floor_regime():
    """The language-class regime (tests/test_golden_histories.py): at a
    tolerance one fp32 inner cycle cannot deliver, mixed needs a second
    refinement restart; df64 must converge in ONE like the baseline."""
    A = convection_diffusion_2d(24, beta=1.0)
    x_true, b = _problem(A)

    def run(mode):
        return solve(
            convection_diffusion_2d(24, beta=1.0), b,
            GmresConfig(precision=PrecisionSpec.from_mode(mode), orth="cgsr",
                        precond="identity", restart_length=150, tol=3e-9,
                        max_restarts=100),
        )

    base, mixed, df = run("baseline"), run("mixed"), run("df64")
    assert base.restarts == 1 and mixed.restarts == 2
    assert df.restarts == 1 and df.total_iters == base.total_iters
    err = np.linalg.norm(np.asarray(df.x, np.float64) - x_true)
    assert err < 1e-10, err


def test_df64_with_ilu_jacobi_and_unstructured():
    A = unstructured_mesh(2048, run=3, seed=6)
    x_true, b = _problem(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("df64"), orth="cgsr",
        precond="ilu_jacobi", jacobi_steps=3, auto_reorder=False,
        restart_length=15, tol=1e-11, max_restarts=100,
    )
    r = solve(A, b, cfg)
    assert r.converged
    err = np.linalg.norm(np.asarray(r.x, np.float64) - x_true)
    assert err < 1e-7, err


def test_df64_policies():
    """Non-FIXED restart policies run on the df64 cycle too (shared
    Givens/policy tail)."""
    A = convection_diffusion_2d(16, beta=1.0)
    x_true, b = _problem(A)
    for kw in (dict(policy="relres", restart_improvement=1e-2),
               dict(policy="orthloss", restart_improvement=1e-4)):
        cfg = GmresConfig(
            precision=PrecisionSpec.from_mode("df64"), orth="cgsr",
            precond="jacobi", restart_length=25, tol=1e-10,
            max_restarts=200, **kw,
        )
        r = solve(convection_diffusion_2d(16, beta=1.0), b, cfg)
        assert r.converged, kw
        assert np.linalg.norm(np.asarray(r.x, np.float64) - x_true) < 1e-6


def test_df64_distributed():
    from gmres_tpu.parallel.dist_gmres import solve_distributed

    A = convection_diffusion_2d(16, beta=1.0)
    x_true, b = _problem(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("df64"), orth="cgsr",
        precond="jacobi", restart_length=12, tol=1e-11, max_restarts=100,
    )
    r = solve_distributed(A, b, cfg)
    base = solve_distributed(
        A, b, cfg.with_(precision=PrecisionSpec.from_mode("baseline")))
    assert r.converged and base.converged
    assert (r.restarts, r.total_iters) == (base.restarts, base.total_iters)
    assert np.linalg.norm(np.asarray(r.x, np.float64) - x_true) < 1e-6


@pytest.mark.parametrize("low_sync", [True, False])
def test_df64_distributed_mgs(low_sync):
    """Distributed df64 MGS: the one-reduce ICWY pair path
    (ops/df64.py:df_mgs_lowsync_step) and the sequential pair recurrence
    both converge to fp64 quality like the baseline."""
    from gmres_tpu.parallel.dist_gmres import solve_distributed

    A = convection_diffusion_2d(16, beta=1.0)
    x_true, b = _problem(A)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("df64"), orth="mgs",
        precond="jacobi", restart_length=12, tol=1e-11, max_restarts=100,
        low_sync_mgs=low_sync,
    )
    r = solve_distributed(A, b, cfg)
    base = solve_distributed(
        A, b, cfg.with_(precision=PrecisionSpec.from_mode("baseline")))
    assert r.converged and base.converged
    assert abs(r.total_iters - base.total_iters) <= cfg.restart_length
    assert np.linalg.norm(np.asarray(r.x, np.float64) - x_true) < 1e-6


def test_df64_spec_validation():
    with pytest.raises(ValueError, match="df64_inner"):
        PrecisionSpec("float64", "float32", "float32", df64_inner=True)
