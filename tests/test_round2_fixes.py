"""Regression tests for earlier correctness fixes:

- the nan_fallback fp64 rescue works with a preconditioner;
- happy breakdown yields no NaN;
- bf16 orthogonalization accumulates in fp32.
"""

import jax.numpy as jnp
import numpy as np

from gmres_tpu import GmresConfig, PrecisionSpec, solve
from gmres_tpu.io.synth import poisson_2d
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.sparse import csr_from_coo


def test_nan_fallback_with_preconditioner():
    """The fp64 rescue path must work with a non-identity preconditioner."""
    n = 32
    big = 3e38
    rows = np.arange(n)
    A = csr_from_coo(rows, rows, np.full(n, big), n_rows=n)
    b = np.full(n, 1.0)
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        precond="jacobi",
        restart_length=5,
        tol=1e-10,
        max_restarts=50,
        nan_fallback=True,
        auto_format=False,
    )
    res = solve(A, b, cfg)
    assert res.fellback_to_fp64
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), 1.0 / big, rtol=1e-7)


def test_happy_breakdown_no_nan():
    """Exact convergence mid-cycle (A = I, b = e1: the Krylov space is
    A-invariant after one step, h(1,0) == 0 exactly) must not NaN the
    triangular solve — the reference divides by zero here
    (Orthogonalization.hpp:59), a documented divergence (SURVEY.md §2.2)."""
    n = 32
    rows = np.arange(n)
    A = csr_from_coo(rows, rows, np.ones(n), n_rows=n)
    b = np.zeros(n)
    b[0] = 1.0
    for mode in ("baseline", "mixed"):
        cfg = GmresConfig(
            precision=PrecisionSpec.from_mode(mode),
            precond="identity",
            restart_length=5,
            tol=1e-12,
            max_restarts=5,
            auto_format=False,
        )
        res = solve(A, b, cfg)
        assert res.converged and not res.diverged, mode
        np.testing.assert_allclose(np.asarray(res.x), b, atol=1e-12)


def test_nan_fallback_with_ilu_jacobi():
    """Divergence triggered by fp32 overflow of ||b|| (norm of 1e20-scaled
    rhs overflows fp32) on a well-scaled operator; the fp64 rescue rebuilds
    the ILU-Jacobi factors in fp64 and converges."""
    A = poisson_2d(8)
    scale = 1e20
    x_true = scale * np.ones(A.n_rows)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        precond="ilu_jacobi",
        jacobi_steps=2,
        restart_length=10,
        tol=1e-12,
        max_restarts=200,
        nan_fallback=True,
        auto_format=False,
    )
    res = solve(A, b, cfg)
    assert res.fellback_to_fp64 and res.converged
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6)


def test_bf16_gram_accumulates_in_fp32():
    """A length-n reduction accumulated in bf16 loses ~all precision by
    n=4096; the gram/update path must upcast (ADVICE.md low #3)."""
    from gmres_tpu.ops.orth import _masked_gram, cgs

    n = 8192
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n).astype(np.float32)
    vhat = v / np.linalg.norm(v)  # Gram-Schmidt expects a normalized basis
    V = jnp.asarray(vhat[None, :], dtype=jnp.bfloat16)
    w = jnp.asarray(v, dtype=jnp.bfloat16)

    u = np.asarray(_masked_gram(V, w, 0, None), dtype=np.float64)
    want = float(np.asarray(V[0], np.float64) @ np.asarray(w, np.float64))
    # bf16 storage of the result allows ~1% error; bf16 ACCUMULATION over
    # 8192 terms would be off by orders of magnitude
    assert abs(u[0] - want) / abs(want) < 0.01

    # the CGS update must leave w essentially orthogonal to V[0]
    _, w2 = cgs(V, 0, w, assume_zero_tail=False)
    res = float(np.asarray(V[0], np.float64) @ np.asarray(w2, np.float64))
    assert abs(res) / abs(want) < 0.02
