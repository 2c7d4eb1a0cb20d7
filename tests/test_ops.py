"""Kernel unit tests vs numpy/scipy references (the unit-test layer the
reference lacks — SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from gmres_tpu.io.synth import poisson_2d, random_sparse
from gmres_tpu.ops.blas import dot, nrm2
from gmres_tpu.ops.givens import apply_rotations, rotg
from gmres_tpu.ops.orth import cgs, cgsr, mgs
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.ops.tri import trsv_upper_padded


def test_spmv_matches_scipy():
    A = random_sparse(200, row_nnz=6, seed=1)
    x = np.random.default_rng(0).standard_normal(200)
    want = A.to_scipy() @ x
    got = np.asarray(spmv(A, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_spmv_poisson_dtypes():
    A = poisson_2d(10)
    x = np.random.default_rng(1).standard_normal(A.n_rows)
    want = A.to_scipy() @ x
    scale = np.abs(want).max()
    for dt in (jnp.float64, jnp.float32):
        got = np.asarray(spmv(A.astype(dt), jnp.asarray(x, dtype=dt)))
        rtol = 1e-11 if dt == jnp.float64 else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
        assert got.dtype == np.dtype(dt)


def test_spmv_casts_operand():
    A = poisson_2d(4).astype(jnp.float32)
    x = jnp.ones(16, dtype=jnp.float64)
    y = spmv(A, x)
    assert y.dtype == jnp.float32


def test_dot_nrm2():
    x = np.random.default_rng(2).standard_normal(1000)
    y = np.random.default_rng(3).standard_normal(1000)
    np.testing.assert_allclose(float(dot(jnp.asarray(x), jnp.asarray(y))), x @ y)
    np.testing.assert_allclose(float(nrm2(jnp.asarray(x))), np.linalg.norm(x))


@pytest.mark.parametrize(
    "a,b",
    [(3.0, 4.0), (-3.0, 4.0), (4.0, -3.0), (0.0, 0.0), (1e-30, 1e-30),
     (5.0, 0.0), (0.0, 5.0), (-2.0, -7.0)],
)
def test_rotg_matches_blas(a, b):
    r, c, s = rotg(jnp.float64(a), jnp.float64(b))
    # scipy exposes the reference BLAS drotg
    c_ref, s_ref = scipy.linalg.blas.drotg(a, b)
    np.testing.assert_allclose(float(c), c_ref, atol=1e-14)
    np.testing.assert_allclose(float(s), s_ref, atol=1e-14)
    # rotation property: [c s; -s c] [a b]^T = [r 0]^T
    np.testing.assert_allclose(float(c * a + s * b), float(r), atol=1e-14)
    np.testing.assert_allclose(float(c * b - s * a), 0.0, atol=1e-14)


def test_apply_rotations_sequence():
    m = 8
    rng = np.random.default_rng(4)
    h = rng.standard_normal(m + 1)
    theta = rng.standard_normal(m)
    cs, sn = np.cos(theta), np.sin(theta)
    k = 5
    want = h.copy()
    for j in range(k):
        hj, hj1 = want[j], want[j + 1]
        want[j] = cs[j] * hj + sn[j] * hj1
        want[j + 1] = cs[j] * hj1 - sn[j] * hj
    got = np.asarray(
        jax.jit(apply_rotations)(jnp.asarray(h), jnp.asarray(cs), jnp.asarray(sn), k)
    )
    np.testing.assert_allclose(got, want, rtol=1e-14)


def _np_orth_reference(V, k, w, kind, steps=2):
    """Reference Gram-Schmidt on numpy (V row-stored)."""
    h = np.zeros(V.shape[0])
    w = w.copy()
    if kind == "mgs":
        for j in range(k + 1):
            hj = w @ V[j]
            h[j] = hj
            w = w - hj * V[j]
    else:
        u = V[: k + 1] @ w
        h[: k + 1] = u
        w = w - u @ V[: k + 1]
        if kind == "cgsr":
            for _ in range(steps - 1):
                u = V[: k + 1] @ w
                w = w - u @ V[: k + 1]
                h[: k + 1] += u
    return h, w


@pytest.mark.parametrize("kind", ["cgs", "mgs", "cgsr"])
def test_orthogonalization_matches_reference(kind):
    rng = np.random.default_rng(5)
    m, n = 10, 300
    Q, _ = np.linalg.qr(rng.standard_normal((n, m + 1)))
    V = Q.T.copy()  # orthonormal rows
    w = rng.standard_normal(n)
    k = 6
    fn = {"cgs": cgs, "mgs": mgs, "cgsr": cgsr}[kind]
    h, w2 = fn(jnp.asarray(V), k, jnp.asarray(w))
    h_ref, w_ref = _np_orth_reference(V, k, w, kind)
    np.testing.assert_allclose(np.asarray(h), h_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(w2), w_ref, atol=1e-12)
    # result is orthogonal to the active basis
    np.testing.assert_allclose(V[: k + 1] @ np.asarray(w2), 0, atol=1e-10)
    # masked region untouched
    np.testing.assert_allclose(np.asarray(h)[k + 1 :], 0, atol=0)


def test_mgs_lowsync_step_matches_mgs():
    """ICWY one-reduce MGS (ops/orth.py:mgs_lowsync_step): coefficients
    agree with classic MGS to second order in the orthogonality loss, the
    projected vector is orthogonal to the basis, and the projection
    identity w' = w - h @ V holds exactly (the Arnoldi relation GMRES
    relies on)."""
    from gmres_tpu.ops.orth import mgs_lowsync_step

    rng = np.random.default_rng(11)
    m, n, k = 10, 300, 6
    Q, _ = np.linalg.qr(rng.standard_normal((n, m + 1)))
    V = Q.T.copy()
    # slightly non-orthogonal basis (loss ~1e-6): the regime where ICWY's
    # (I+L)^{-1} correction differs from CGS and must track MGS
    V[: k + 1] += 1e-6 * rng.standard_normal((k + 1, n))
    V[k + 1 :] = 0.0  # Arnoldi invariant: rows beyond k are zero
    w = rng.standard_normal(n)

    # build L the way the Arnoldi loop does: one row per completed step
    L = np.tril(V @ V.T, k=-1)
    L[k + 1 :] = 0.0
    L[k] = 0.0  # row k is filled inside the step itself
    h, w2, ss, L2 = mgs_lowsync_step(
        jnp.asarray(V), k, jnp.asarray(w), jnp.asarray(L), None
    )
    h, w2 = np.asarray(h), np.asarray(w2)

    h_ref, w_ref = _np_orth_reference(V, k, w, "mgs")
    np.testing.assert_allclose(h[: k + 1], h_ref[: k + 1], atol=1e-9)
    np.testing.assert_allclose(h[k + 1 :], 0, atol=0)
    np.testing.assert_allclose(w2, w_ref, atol=1e-8)
    # a single (M)GS pass leaves FIRST-order non-orthogonality (later
    # projections reintroduce earlier components — that is MGS's own
    # behavior, not an ICWY artifact); assert we are no worse than MGS
    assert (np.abs(V[: k + 1] @ w2).max()
            <= np.abs(V[: k + 1] @ w_ref).max() + 1e-9)
    # the projection identity is exact (not just first-order): w2 is
    # literally w - h @ V with the returned h
    np.testing.assert_allclose(w2, w - h @ V, atol=1e-13)
    np.testing.assert_allclose(float(ss), float(w2 @ w2), rtol=1e-12)
    # L gained exactly row k (strict lower part of V Vt)
    np.testing.assert_allclose(
        np.asarray(L2)[k, :k], (V @ V.T)[k, :k], atol=1e-12
    )


def test_trsv_padded():
    rng = np.random.default_rng(6)
    m, k = 12, 7
    H = np.triu(rng.standard_normal((m, m))) + np.eye(m) * 3
    s = rng.standard_normal(m)
    y = np.asarray(trsv_upper_padded(jnp.asarray(H), jnp.asarray(s), k))
    want = np.linalg.solve(np.triu(H[:k, :k]), s[:k])
    np.testing.assert_allclose(y[:k], want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(y[k:], 0, atol=0)


def test_trsv_padded_ignores_stale_garbage():
    m, k = 6, 3
    H = np.full((m, m), np.inf)  # garbage everywhere
    H[:k, :k] = np.triu(np.arange(1, k * k + 1).reshape(k, k).astype(float))
    s = np.arange(1.0, m + 1)
    y = np.asarray(trsv_upper_padded(jnp.asarray(H), jnp.asarray(s), k))
    want = np.linalg.solve(np.triu(H[:k, :k]), s[:k])
    np.testing.assert_allclose(y[:k], want, rtol=1e-12, atol=1e-14)
