"""Compressed-basis tier (CB-GMRES, PrecisionSpec.basis): the Krylov basis
is STORED narrower than the arithmetic (arXiv:2009.12101) — solver
convergence, mixed-dtype orthogonalization paths, config validation."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu import GmresConfig, PrecisionSpec, solve
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d
from gmres_tpu.ops.spmv import spmv


def _cb(mode, basis):
    return dataclasses.replace(PrecisionSpec.from_mode(mode), basis=basis)


def _problem(nx=16, seed=42):
    A = convection_diffusion_2d(nx)
    x_true = rand_vect(A.n_rows, seed)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    return A, x_true, b


@pytest.mark.parametrize("orth", ["cgs", "mgs", "cgsr"])
def test_cb_bf16_basis_converges(orth):
    """bf16 basis under an f32 inner loop: converges to the same outer
    tolerance with at most a mild iteration increase (the paper's
    observed regime — H and all reductions stay f32)."""
    A, x_true, b = _problem()
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"),
                      orth=orth, precond="jacobi", restart_length=20,
                      tol=1e-9, max_restarts=300)
    r_plain = solve(A, b, cfg)
    r_cb = solve(A, b, cfg.with_(precision=_cb("mixed", "bfloat16")))
    assert r_plain.converged and r_cb.converged
    assert r_cb.total_iters <= 2 * r_plain.total_iters
    err = np.linalg.norm(np.asarray(r_cb.x) - x_true)
    assert err < 1e-5  # outer fp64 residual governs final accuracy


def test_cb_f32_basis_under_f64():
    """f32 basis under the fp64 baseline: iteration-neutral on a
    well-conditioned problem (the paper's headline configuration)."""
    A, x_true, b = _problem()
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("baseline"),
                      orth="cgsr", precond="jacobi", restart_length=20,
                      tol=1e-9, max_restarts=300)
    r_plain = solve(A, b, cfg)
    r_cb = solve(A, b, cfg.with_(precision=_cb("baseline", "float32")))
    assert r_plain.converged and r_cb.converged
    assert r_cb.restarts <= r_plain.restarts + 1
    assert np.linalg.norm(np.asarray(r_cb.x) - x_true) < 1e-5


def test_cb_distributed():
    """Compressed basis under shard_map (both the batched-gram CGSR path
    and the one-reduce ICWY MGS carry a bf16 V against an f32 w)."""
    import jax
    from jax.sharding import Mesh

    from gmres_tpu.parallel.dist_gmres import AXIS, solve_distributed

    A, x_true, b = _problem(12)
    mesh = Mesh(np.array(jax.devices()[:4]), (AXIS,))
    for orth in ("cgsr", "mgs"):
        cfg = GmresConfig(precision=_cb("mixed", "bfloat16"), orth=orth,
                          precond="jacobi", restart_length=15, tol=1e-8,
                          max_restarts=300)
        r = solve_distributed(A, b, cfg, mesh=mesh)
        assert r.converged, orth
        assert np.linalg.norm(np.asarray(r.x) - x_true) < 1e-4


def test_cb_validation():
    with pytest.raises(ValueError, match="wider than inner"):
        PrecisionSpec("float64", "float32", "float32", basis="float64")
    with pytest.raises(ValueError, match="exclusive"):
        dataclasses.replace(PrecisionSpec.from_mode("df64"), basis="float32")
    with pytest.raises(ValueError, match="unsupported basis"):
        PrecisionSpec("float64", "float32", "float32", basis="int8")
    # equal-width basis is legal (a no-op)
    assert PrecisionSpec("float64", "float32", "float32",
                         basis="float32").basis_dtype == jnp.float32


def test_orth_mixed_dtype_outputs():
    """XLA orthogonalization paths with V bf16 / w f32: coefficients and
    the work vector come back in the WORK dtype (f32), not the storage
    dtype — compressing V must not compress H."""
    from gmres_tpu.ops.orth import cgs, mgs, orthonormalize_step

    rng = np.random.default_rng(0)
    m1, n, k = 8, 512, 4
    Q, _ = np.linalg.qr(rng.standard_normal((n, m1)))
    V = Q.T.copy()
    V[k + 1:] = 0
    Vb = jnp.asarray(V, jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal(n), jnp.float32)

    for fn in (cgs, mgs):
        h, w2 = fn(Vb, k, w)
        assert h.dtype == jnp.float32 and w2.dtype == jnp.float32
    h, w2, hn = orthonormalize_step("cgsr", Vb, k, w, assume_zero_tail=True)
    assert h.dtype == jnp.float32 and hn.dtype == jnp.float32
    # coefficients match the f64 reference within bf16-input tolerance
    want = V[: k + 1].astype(np.float64) @ np.asarray(w, np.float64)
    got = np.asarray(h, np.float64)[: k + 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
