"""SELL format: packer correctness, the XLA executor and solver
integration."""

import numpy as np
import jax.numpy as jnp
import pytest

from gmres_tpu.ops.sell import SELLMatrix, sell_from_csr, sell_spmv
from gmres_tpu.sparse import csr_from_coo, csr_from_dense


def _random_local_csr(n=1000, avg_nnz=6, spread=900, seed=0):
    """Unstructured matrix with *bounded locality* (post-RCM-like): row i's
    columns are scattered within [i-spread/2, i+spread/2)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        k = rng.integers(1, 2 * avg_nnz)
        c = np.unique(
            np.clip(i + rng.integers(-spread // 2, spread // 2, size=k), 0, n - 1)
        )
        rows.extend([i] * len(c))
        cols.extend(c.tolist())
        if i not in c:
            rows.append(i)
            cols.append(i)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = rng.standard_normal(rows.shape[0])
    # make it diagonally dominant so GMRES converges fast in tests
    diag = rows == cols
    vals[diag] = 10.0 + np.abs(vals[diag])
    return csr_from_coo(rows, cols, vals, n_rows=n)


def test_pack_roundtrip_dense():
    rng = np.random.default_rng(1)
    a = np.zeros((70, 70))
    mask = rng.random((70, 70)) < 0.08
    a[mask] = rng.standard_normal(mask.sum())
    np.fill_diagonal(a, 3.0)
    A = csr_from_dense(a)
    S = sell_from_csr(A, W=128, K=4)
    assert S is not None
    x = rng.standard_normal(70)
    y = np.asarray(sell_spmv(S, jnp.asarray(x)))
    # dense blocks are stored as f32 (the kernels' native dtype)
    np.testing.assert_allclose(y, a @ x, rtol=1e-5, atol=1e-5)


def test_pack_matches_csr_spmv():
    A = _random_local_csr()
    S = sell_from_csr(A)
    assert S is not None
    assert S.nnz == A.nnz
    rng = np.random.default_rng(2)
    x = rng.standard_normal(A.n_rows)
    from gmres_tpu.ops.spmv import spmv

    want = np.asarray(spmv(A, jnp.asarray(x)))
    got = np.asarray(sell_spmv(S, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_pack_long_rows_split_into_layers():
    """Rows longer than K spill into extra layer chunks."""
    n = 300
    rng = np.random.default_rng(3)
    rows, cols = [], []
    for i in range(n):
        k = 40 if i == 57 else 3  # one pathological row
        c = np.unique(rng.integers(0, n, size=k))
        rows.extend([i] * len(c))
        cols.extend(c.tolist())
    vals = rng.standard_normal(len(rows))
    A = csr_from_coo(np.asarray(rows), np.asarray(cols), vals, n_rows=n)
    S = sell_from_csr(A, W=128, K=4)
    assert S is not None
    x = rng.standard_normal(n)
    want = A.to_scipy() @ x
    got = np.asarray(sell_spmv(S, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_pack_refuses_scattered():
    """A large, fully random (no locality) pattern packs ~one nonzero per
    chunk and must be refused by the cost gate.  (Small random matrices
    pack fine — a handful of buckets covers the whole operand.)"""
    n = 200_000
    rng = np.random.default_rng(4)
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, n, size=3 * n)
    vals = rng.standard_normal(3 * n)
    A = csr_from_coo(rows, cols, vals, n_rows=n)
    assert sell_from_csr(A) is None


def test_multi_part_split_matches_single_part():
    """Shrinking the chunk budget splits the pack into several parts; the
    executor's result must not change."""
    import gmres_tpu.ops.sell as sell_mod

    A = _random_local_csr(n=2500, spread=500, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal(A.n_rows)
    S1 = sell_from_csr(A)
    assert S1 is not None
    want = np.asarray(sell_spmv(S1, jnp.asarray(x)))
    old = sell_mod.MAX_CHUNKS_PER_CALL
    sell_mod.MAX_CHUNKS_PER_CALL = max(4, S1.n_chunks // 3)
    try:
        S = sell_from_csr(A)
        assert len(S.parts) >= 2
        got = np.asarray(sell_spmv(S, jnp.asarray(x)))
    finally:
        sell_mod.MAX_CHUNKS_PER_CALL = old
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, A.to_scipy() @ x, rtol=1e-10, atol=1e-12)


def test_solve_with_sell_operator():
    """End-to-end: GMRES on a SELL-staged operator matches the CSR solve."""
    from gmres_tpu import GmresConfig, solve

    A = _random_local_csr(n=800, spread=300, seed=9)
    rng = np.random.default_rng(10)
    x_true = rng.standard_normal(A.n_rows)
    b = A.to_scipy() @ x_true

    cfg = GmresConfig(restart_length=30, tol=1e-10, max_restarts=50,
                      orth="cgsr", precond="identity")
    res_csr = solve(A, b, cfg)
    S = sell_from_csr(A)
    assert S is not None
    res_sell = solve(S, b, cfg)
    assert res_sell.converged
    assert res_sell.total_iters == res_csr.total_iters
    np.testing.assert_allclose(
        np.asarray(res_sell.x), x_true, rtol=1e-6, atol=1e-8
    )


def test_hybrid_dense_chunks():
    """(slab, bucket) pairs above the fill threshold become dense blocks;
    the executor's result must match scipy."""
    n = 1500
    rng = np.random.default_rng(11)
    # rows 0..255 densely coupled to cols 0..127 (fill ~40% in that pair),
    # everything else sparse local
    rows, cols = [], []
    for i in range(256):
        c = np.unique(rng.integers(0, 128, size=50))
        rows.extend([i] * len(c))
        cols.extend(c.tolist())
    for i in range(n):
        c = np.unique(np.clip(i + rng.integers(-60, 60, size=3), 0, n - 1))
        rows.extend([i] * len(c))
        cols.extend(c.tolist())
        rows.append(i)
        cols.append(i)
    vals = rng.standard_normal(len(rows))
    A = csr_from_coo(np.asarray(rows), np.asarray(cols), vals, n_rows=n)
    S = sell_from_csr(A, W=128, K=4)
    assert S is not None
    assert S.n_dense_chunks > 0, "expected dense chunks"
    x = rng.standard_normal(n)
    want = A.to_scipy() @ x
    got_xla = np.asarray(sell_spmv(S, jnp.asarray(x)))
    # dense blocks are f32-native; ELL values keep the build dtype
    np.testing.assert_allclose(got_xla, want, rtol=2e-6, atol=2e-6)


def test_pack_unsorted_columns():
    """Valid CSR with unsorted columns within a row (csr_from_arrays
    neither sorts nor requires sorted columns) must pack correctly: the
    sort-free grouping needs (row, col) order and must sort when the
    input violates it (ADVICE round-2 high finding)."""
    from gmres_tpu.sparse import csr_from_arrays

    # the advisor's repro: one row with cols [200, 5, 250, 10] at W=128
    row_ptr = np.array([0, 4], dtype=np.int32)
    cols = np.array([200, 5, 250, 10], dtype=np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    A = csr_from_arrays(row_ptr, cols, vals, n_cols=512)
    S = sell_from_csr(A, W=128, K=4)
    assert S is not None
    x = np.ones(512)
    y = np.asarray(sell_spmv(S, jnp.asarray(x)))
    np.testing.assert_allclose(y[0], 10.0, rtol=1e-12)

    # a larger random shuffle-within-rows case, checked against scipy
    rng = np.random.default_rng(7)
    n = 2000
    rows, cols_l = [], []
    for i in range(n):
        c = np.unique(np.clip(i + rng.integers(-300, 300, size=8), 0, n - 1))
        rng.shuffle(c)  # deliberately unsorted within the row
        rows.extend([i] * len(c))
        cols_l.extend(c.tolist())
    nnz = len(rows)
    vals = rng.standard_normal(nnz)
    counts = np.bincount(np.asarray(rows), minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    A = csr_from_arrays(row_ptr, np.asarray(cols_l, np.int32), vals)
    S = sell_from_csr(A, W=128, K=4)
    assert S is not None and S.nnz == nnz
    x = rng.standard_normal(n)
    got = np.asarray(sell_spmv(S, jnp.asarray(x)))
    want = A.to_scipy() @ x
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


def test_autotune_single_param_held_fixed():
    """Passing exactly one of (W, K) autotunes only the other (ADVICE
    round-2 low finding)."""
    A = _random_local_csr(n=1500, seed=11)
    S_w = sell_from_csr(A, W=256)
    assert S_w is not None and S_w.W == 256
    S_k = sell_from_csr(A, K=8)
    assert S_k is not None and S_k.K == 8
