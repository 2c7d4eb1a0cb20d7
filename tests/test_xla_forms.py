"""The plain XLA forms the solver runs on every platform, each against a
float64 host reference: DIA, CSR and halo SpMV, the CGS/MGS/CGSR and
one-reduce MGS orthogonalization steps, and the exact-ILU applies against
the native sequential substitution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gmres_tpu.io.synth import (
    convection_diffusion_2d,
    poisson_2d,
    random_sparse,
    unstructured_mesh,
)
from gmres_tpu.ops.dia import DIAMatrix, dia_spmv
from gmres_tpu.ops.orth import mgs_lowsync_step, orthonormalize_step
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.sparse import csr_from_coo

# float64 forms: a handful of ulps of the row sums; float32 forms: the
# fp32 unit roundoff (6e-8) grown by short reductions and fp32 rounding of
# the operator values
TOL = {jnp.float64: 1e-13, jnp.float32: 2e-6}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ------------------------------------------------------------- DIA SpMV
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("n,offsets", [
    (64, (0,)),
    (100, (-1, 0, 1)),
    (257, (-16, -1, 0, 1, 16)),
    (1000, (-300, 0, 7)),
    (33, (-40, -2, 0, 40)),       # offsets past the matrix edge
])
def test_dia_spmv_matches_numpy(n, offsets, dtype):
    rng = np.random.default_rng(n)
    data = rng.standard_normal((len(offsets), n))
    dense = np.zeros((n, n))
    for d, off in enumerate(offsets):
        for i in range(max(0, -off), min(n, n - off)):
            dense[i, i + off] = data[d, i]
        # entries that fall outside the matrix are never read
    A = DIAMatrix(data=jnp.asarray(data), offsets=offsets, n_rows=n,
                  n_cols=n, nnz=int((dense != 0).sum()))
    x = rng.standard_normal(n)
    want = dense @ x
    got = dia_spmv(A.astype(dtype), jnp.asarray(x, dtype))
    assert got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype]


# ------------------------------------------------------------- CSR SpMV
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("n,row_nnz", [(50, 1), (777, 8), (2048, 30)])
def test_csr_spmv_matches_scipy(n, row_nnz, dtype):
    A = random_sparse(n, row_nnz=row_nnz, seed=n)
    x = np.random.default_rng(n + 1).standard_normal(n)
    want = A.to_scipy() @ x
    got = spmv(A.astype(dtype), jnp.asarray(x, dtype))
    assert got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype]


# ------------------------------------------------------------ halo SpMV
def _halo_spmv(A, x, n_shards):
    from gmres_tpu.parallel.dist_gmres import AXIS
    from gmres_tpu.parallel.halo import halo_spmv, partition_halo
    from gmres_tpu.parallel.partition import pad_vector

    H = partition_halo(A, n_shards)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), (AXIS,))
    sharded = P(AXIS)
    fn = jax.jit(jax.shard_map(lambda Hb, xl: halo_spmv(Hb, xl, AXIS),
                               mesh=mesh, in_specs=(sharded, sharded),
                               out_specs=sharded, check_vma=False))
    Hs = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, sharded)), H)
    xp = jnp.asarray(pad_vector(np.asarray(x), n_shards))
    return H, np.asarray(fn(Hs, xp))[: A.n_rows]


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("pattern", ["banded", "irregular"])
def test_halo_spmv_matches_scipy(pattern, n_shards):
    from gmres_tpu.parallel.halo import HaloCSR, HaloDIA

    if pattern == "banded":
        A, kind = convection_diffusion_2d(20, beta=3.0), HaloDIA
    else:
        # neighbor-local but with thousands of distinct diagonals
        A, kind = unstructured_mesh(4096, nx=64, jitter=8, seed=2), HaloCSR
    x = np.random.default_rng(9).standard_normal(A.n_rows)
    H, got = _halo_spmv(A, x, n_shards)
    assert isinstance(H, kind)
    assert _rel(got, A.to_scipy() @ x) <= TOL[jnp.float64]


# ------------------------------------------------------ orthogonalization
def _basis(n, m1, k, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, k + 1)))
    V = np.zeros((m1, n))
    V[: k + 1] = Q.T
    return V, rng.standard_normal(n)


def _reference_step(kind, V, k, w):
    Vk = V[: k + 1]
    if kind == "mgs":
        h = np.zeros(V.shape[0])
        for j in range(k + 1):
            h[j] = Vk[j] @ w
            w = w - h[j] * Vk[j]
        return h, w
    h = np.zeros(V.shape[0])
    for _ in range(2 if kind == "cgsr" else 1):
        u = Vk @ w
        w = w - Vk.T @ u
        h[: k + 1] += u
    return h, w


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("kind", ["cgs", "mgs", "cgsr"])
def test_orthonormalize_step_matches_numpy(kind, dtype):
    n, m1, k = 3000, 12, 6
    V, w = _basis(n, m1, k, seed=len(kind))
    h_ref, w_ref = _reference_step(kind, V, k, w)
    h, w2, hn = jax.jit(lambda V, w: orthonormalize_step(
        kind, V, k, w, assume_zero_tail=True))(
        jnp.asarray(V, dtype), jnp.asarray(w, dtype))
    assert h.dtype == w2.dtype == dtype
    assert _rel(h, h_ref) <= 10 * TOL[dtype]
    assert _rel(w2, w_ref) <= 10 * TOL[dtype]
    assert abs(float(hn) - np.linalg.norm(w_ref)) <= (
        10 * TOL[dtype] * np.linalg.norm(w_ref))


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_mgs_lowsync_step_matches_numpy(dtype):
    """The one-reduce ICWY step: h = (I + L)^-1 V^T w, the L row it adds
    is the strict lower row k of V V^T, and ss is ||w'||^2."""
    n, m1, k = 2048, 10, 4
    rng = np.random.default_rng(3)
    V = np.zeros((m1, n))
    V[: k + 1] = rng.standard_normal((k + 1, n)) / np.sqrt(n)
    w = rng.standard_normal(n)
    G = V @ V.T
    L = np.tril(G, -1)
    L[k:] = 0.0          # rows >= k are built by this and later steps
    L_want = L.copy()
    L_want[k, :k] = G[k, :k]
    u = V @ w
    h_ref = np.linalg.solve(np.eye(m1) + L_want, u)
    w_ref = w - V.T @ h_ref

    acc = jnp.float64 if dtype == jnp.float64 else jnp.float32
    h, w2, ss, L2 = jax.jit(lambda V, w, L: mgs_lowsync_step(V, k, w, L, None))(
        jnp.asarray(V, dtype), jnp.asarray(w, dtype), jnp.asarray(L, acc))
    tol = 10 * TOL[dtype]
    assert _rel(h, h_ref) <= tol
    assert _rel(w2, w_ref) <= tol
    assert _rel(L2, L_want) <= tol
    assert abs(float(ss) - w_ref @ w_ref) <= tol * (w_ref @ w_ref)


def test_single_device_lowsync_solve_matches_sequential():
    """orth=mgs with low_sync_mgs=True on a single device converges with
    the same history as the sequential recurrence (ICWY is MGS to first
    order; counts must agree on a well-conditioned problem)."""
    from gmres_tpu import GmresConfig, PrecisionSpec, solve
    from gmres_tpu.io.rng import rand_vect

    A = convection_diffusion_2d(24, beta=1.0)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    base = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"), orth="mgs",
        precond="identity", restart_length=30, tol=1e-9, max_restarts=60,
    )
    r_seq = solve(A, b, base)
    r_icwy = solve(A, b, base.with_(low_sync_mgs=True))
    assert r_seq.converged and r_icwy.converged
    assert abs(r_seq.restarts - r_icwy.restarts) <= 1
    assert abs(r_seq.total_iters - r_icwy.total_iters) <= 30


# --------------------------------------------------------- exact ILU apply
def _ilu_oracle(A, w):
    """Native sequential L/U substitution on the float32-rounded factors."""
    from gmres_tpu.native import trisolve_native
    from gmres_tpu.precond.ilu0 import ilu0_factorize

    rp = np.asarray(A.row_ptr)
    ci = np.asarray(A.col_idx)[: A.nnz]
    fv, diag = ilu0_factorize(rp, ci, np.asarray(A.vals)[: A.nnz],
                              factor_dtype=np.float32)
    return trisolve_native(rp, ci, np.asarray(fv, np.float64), diag, w)


ILU_MATRICES = {
    "convdiff12": lambda: convection_diffusion_2d(12, beta=2.0),
    "convdiff20": lambda: convection_diffusion_2d(20, beta=5.0),
    "poisson16": lambda: poisson_2d(16),
    "mesh": lambda: unstructured_mesh(600, run=3, seed=4),
}


@pytest.mark.parametrize("form", ["sweeps", "levels"])
@pytest.mark.parametrize("matrix", list(ILU_MATRICES))
def test_exact_ilu_apply_matches_native_substitution(monkeypatch, matrix, form):
    """Both XLA forms build_ilu_exact returns — dependency-level Jacobi
    sweeps and the level-scheduled substitution — reproduce the exact
    sequential substitution of the same float32 factors.  Tolerance: the
    float32 apply through up to ~2*nx dependency levels of diagonally
    dominant factors."""
    pytest.importorskip("gmres_tpu.native")
    from gmres_tpu.precond import build as build_mod
    from gmres_tpu.precond.apply import apply_preconditioner
    from gmres_tpu.precond.build import ILUJacobiPrec
    from gmres_tpu.precond.level_ilu import LevelILUPrec

    A = ILU_MATRICES[matrix]()
    if form == "levels":
        # report a level count whose full sweeps exceed the work budget
        monkeypatch.setattr(build_mod, "triangular_level_counts",
                            lambda rp, ci, d: (10**9, 10**9))
    M = build_mod.build_ilu_exact(A, np.float32)
    assert isinstance(M, ILUJacobiPrec if form == "sweeps" else LevelILUPrec)
    w = np.random.default_rng(5).standard_normal(A.n_rows)
    want = _ilu_oracle(A, w)
    got = jax.jit(apply_preconditioner)(M, jnp.asarray(w, jnp.float32))
    assert got.dtype == jnp.float32
    assert _rel(got, want) <= 1e-5


def test_exact_ilu_native_oracle_is_exact():
    """The oracle itself: (L U) z == w on the factor pattern's dense
    product, in float64."""
    pytest.importorskip("gmres_tpu.native")
    from gmres_tpu.precond.build import build_ilu_jacobi

    A = convection_diffusion_2d(9, beta=2.0)
    n = A.n_rows
    M = build_ilu_jacobi(A, np.float32, steps=1)
    L = np.eye(n) + M.lower.to_scipy().toarray().astype(np.float64)
    U = M.upper.to_scipy().toarray().astype(np.float64)
    w = np.random.default_rng(1).standard_normal(n)
    z = _ilu_oracle(A, w)
    np.testing.assert_allclose(L @ (U @ z), w, rtol=1e-12, atol=1e-12)


def test_csr_from_coo_reference_is_scipy():
    """The CSR container the SpMV tests build matches scipy's own CSR."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 40, 300)
    cols = rng.integers(0, 40, 300)
    vals = rng.standard_normal(300)
    A = csr_from_coo(rows, cols, vals, n_rows=40)
    want = sp.coo_matrix((vals, (rows, cols)), shape=(40, 40)).toarray()
    np.testing.assert_allclose(A.to_scipy().toarray(), want, rtol=1e-15)
