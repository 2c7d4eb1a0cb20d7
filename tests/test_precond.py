"""Preconditioner tests: ILU(0) factorization vs a dense reference,
safeguarded Jacobi, ILU-Jacobi sweep semantics, exact-ILU nilpotent solve."""

import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu.config import GmresConfig, Precond, PrecisionSpec
from gmres_tpu.io.synth import convection_diffusion_2d, poisson_2d, random_sparse
from gmres_tpu.precond.apply import apply_preconditioner, typesafe_apply
from gmres_tpu.precond.build import (
    build_ilu_exact,
    build_ilu_jacobi,
    build_jacobi,
    build_preconditioner,
)
from gmres_tpu.precond.ilu0 import (
    diag_positions,
    ilu0_factorize_numpy,
    triangular_level_counts,
)


def dense_ilu0(A: np.ndarray) -> np.ndarray:
    """Dense IKJ ILU(0) restricted to A's nonzero pattern (textbook)."""
    n = A.shape[0]
    pattern = A != 0
    LU = A.astype(np.float64).copy()
    for i in range(1, n):
        for k in range(i):
            if pattern[i, k] and LU[k, k] != 0:
                factor = LU[i, k] / LU[k, k]
                LU[i, k] = factor
                for j in range(k + 1, n):
                    if pattern[i, j]:
                        LU[i, j] -= factor * LU[k, j]
    return LU


def test_diag_positions():
    A = poisson_2d(5)
    rp = np.asarray(A.row_ptr).astype(np.int64)
    ci = np.asarray(A.col_idx)
    d = diag_positions(rp, ci)
    for i in range(A.n_rows):
        assert ci[d[i]] == i


def test_ilu0_matches_dense_reference():
    A = convection_diffusion_2d(6)  # nonsymmetric, has a full diagonal
    rp = np.asarray(A.row_ptr)
    nnz = int(rp[-1])
    ci = np.asarray(A.col_idx)[:nnz]
    v = np.asarray(A.vals)[:nnz]
    fvals, diag = ilu0_factorize_numpy(rp, ci, v)

    dense = A.to_dense()
    LU_ref = dense_ilu0(dense)
    LU_got = np.zeros_like(dense)
    row_ids = np.repeat(np.arange(A.n_rows), np.diff(rp))
    LU_got[row_ids, ci] = fvals
    # compare on the pattern
    np.testing.assert_allclose(LU_got, LU_ref * (dense != 0), rtol=1e-12, atol=1e-14)


def test_ilu0_diag_boost():
    # a matrix with an exactly-zero pivot after elimination gets boosted
    A = np.array(
        [[2.0, 4.0, 0.0],
         [1.0, 2.0, 1.0],   # pivot (1,1): 2 - (1/2)*4 = 0 -> boosted
         [0.0, 1.0, 3.0]]
    )
    from gmres_tpu.sparse import csr_from_dense

    Ac = csr_from_dense(A)
    rp = np.asarray(Ac.row_ptr)
    ci = np.asarray(Ac.col_idx)[: rp[-1]]
    v = np.asarray(Ac.vals)[: rp[-1]]
    fvals, diag = ilu0_factorize_numpy(rp, ci, v)
    alpha = np.finfo(np.float64).eps * 6.0  # max row 1-norm = |2|+|4| = 6
    assert fvals[diag[1]] == alpha


def test_jacobi_safeguard():
    A = np.diag([4.0, -1e-30, 1e-30, -5.0])
    A[0, 3] = 6.0  # max row 1-norm = 10
    from gmres_tpu.sparse import csr_from_dense

    Ac = csr_from_dense(A, keep_zeros=False)
    M = build_jacobi(Ac, jnp.float64)
    alpha = np.finfo(np.float32).eps * 10.0
    want = 1.0 / np.array([4.0, -alpha, alpha, -5.0])
    np.testing.assert_allclose(np.asarray(M.inv_diag), want, rtol=1e-12)


def test_ilu_jacobi_sweep_semantics():
    """One L sweep then one U sweep, vs the explicit portable-kernel math."""
    A = convection_diffusion_2d(4)
    M = build_ilu_jacobi(A, jnp.float64, steps=1)
    n = A.n_rows
    rng = np.random.default_rng(7)
    w = rng.standard_normal(n)

    Ls = M.lower.to_scipy().toarray()
    Uf = M.upper.to_scipy().toarray()
    Dinv = np.asarray(M.inv_diag)

    # L-phase: x0 = b; x1 = b - Ls x0
    x = w - Ls @ w
    # U-phase: b2 = x; x1 = b2 + Dinv (b2 - U b2)
    b2 = x
    want = b2 + Dinv * (b2 - Uf @ b2)

    got = np.asarray(apply_preconditioner(M, jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("steps_factor", [1])
def test_ilu_exact_is_exact_trisolve(steps_factor):
    """The nilpotent sweep count reproduces the exact L/U substitution."""
    A = convection_diffusion_2d(5)
    M = build_ilu_exact(A, jnp.float64)
    n = A.n_rows
    rng = np.random.default_rng(8)
    w = rng.standard_normal(n)

    Ls = M.lower.to_scipy().toarray()
    Uf = M.upper.to_scipy().toarray()
    L = np.eye(n) + Ls
    want = np.linalg.solve(Uf, np.linalg.solve(L, w))

    got = np.asarray(apply_preconditioner(M, jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_level_counts_tridiagonal():
    # tridiagonal: every row depends on the previous -> n levels
    from gmres_tpu.sparse import csr_from_dense

    n = 6
    T = np.eye(n) * 2 + np.eye(n, k=1) * -1 + np.eye(n, k=-1) * -1
    Ac = csr_from_dense(T)
    rp = np.asarray(Ac.row_ptr).astype(np.int64)
    ci = np.asarray(Ac.col_idx)[: rp[-1]]
    d = diag_positions(rp, ci)
    nl, nu = triangular_level_counts(rp, ci, d)
    assert nl == n and nu == n


def test_typesafe_apply_round_trip():
    A = poisson_2d(4)
    cfg = GmresConfig(
        precision=PrecisionSpec("float64", "float64", "float32"),
        precond=Precond.JACOBI,
    )
    M = build_preconditioner(A, cfg)
    assert M.inv_diag.dtype == jnp.float32
    w = jnp.asarray(np.random.default_rng(9).standard_normal(16))
    out = typesafe_apply(M, w)
    assert out.dtype == jnp.float64
    want = (np.asarray(w).astype(np.float32) * np.asarray(M.inv_diag)).astype(np.float64)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-7)


def test_identity():
    cfg = GmresConfig(precond=Precond.IDENTITY)
    M = build_preconditioner(poisson_2d(3), cfg)
    w = jnp.arange(9.0)
    assert (np.asarray(typesafe_apply(M, w)) == np.arange(9.0)).all()


def test_ilu_exact_shallow_levels_use_plain_sweeps():
    """A red-black ordered 5-point operator has exactly 2 dependency levels
    per triangle; build_ilu_exact must return the plain 2-sweep
    ILUJacobiPrec (exact by nilpotency)."""
    from gmres_tpu.ops.reorder import permute_symmetric
    from gmres_tpu.precond.build import ILUJacobiPrec

    nx = 16
    A = convection_diffusion_2d(nx)
    n = A.n_rows
    ii, jj = np.divmod(np.arange(n, dtype=np.int64), nx)
    color = (ii + jj) & 1
    perm = np.concatenate(
        [np.flatnonzero(color == 0), np.flatnonzero(color == 1)])
    Arb = permute_symmetric(A, perm)

    M = build_ilu_exact(Arb, jnp.float32)
    assert isinstance(M, ILUJacobiPrec)
    assert M.steps == 2

    import scipy.sparse as sp

    L = np.eye(n) + M.lower.to_scipy().toarray().astype(np.float64)
    U = M.upper.to_scipy().toarray().astype(np.float64)
    rng = np.random.default_rng(33)
    w = rng.standard_normal(n).astype(np.float32)
    want = np.linalg.solve(U, np.linalg.solve(L, w.astype(np.float64)))
    got = np.asarray(apply_preconditioner(M, jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_ilu_exact_refuses_unfused_large():
    """Exact ILU with huge level counts routes to the level-scheduled
    csrsv2-analog form; when even THAT exceeds the work budget it raises
    with guidance instead of hanging (the honest gate)."""
    from gmres_tpu.precond import build as build_mod
    from gmres_tpu.precond import level_ilu as level_mod
    from gmres_tpu.precond.build import ILUJacobiPrec
    from gmres_tpu.precond.level_ilu import LevelILUPrec

    A = convection_diffusion_2d(40)  # n=1600
    # small problem: the full-sweep form takes it
    M = build_ilu_exact(A, jnp.float32)
    assert isinstance(M, ILUJacobiPrec)
    # simulate bench scale: full-sweep gate refuses, level path takes it
    import gmres_tpu.precond.ilu0 as ilu0_mod

    real_counts = ilu0_mod.triangular_level_counts

    def fake_counts(rp, ci, diag):
        return 300_000, 300_000

    build_mod.triangular_level_counts = fake_counts
    try:
        M2 = build_ilu_exact(A, jnp.float32)
        assert isinstance(M2, LevelILUPrec)
        # ...and when the level-scheduled work is also over budget,
        # the build refuses
        real_build = level_mod.build_level_ilu

        def fat_build(*a, **k):
            prec, _ = real_build(*a, **k)
            return prec, build_mod._SWEEP_WORK_BUDGET + 1

        level_mod.build_level_ilu = fat_build
        try:
            with pytest.raises(ValueError, match="ilu_jacobi"):
                build_ilu_exact(A, jnp.float32)
        finally:
            level_mod.build_level_ilu = real_build
    finally:
        build_mod.triangular_level_counts = real_counts
