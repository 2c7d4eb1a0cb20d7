"""Native SELL packer parity: csrc sell_pack_plan/fill vs the pure-numpy
packer, bit-exact over every SELLMatrix field.

The native two-pass streamer (csrc/gmres_native.cpp) replaces ~15 nnz-scale
numpy array passes; sell_from_csr routes through it by default and the
GMRES_TPU_SELL_NUMPY=1 env knob forces the numpy engine — these tests pack
the same matrix through both engines and require identical arrays,
including the chunk layout (dummy padding positions), the hybrid
dense/ELL split, and the df64 (hi, lo) value splits.
"""

import os

import numpy as np
import pytest

from gmres_tpu.io.synth import random_sparse, unstructured_mesh
from gmres_tpu.ops.sell import sell_from_csr
from gmres_tpu.sparse import csr_from_arrays, csr_from_coo


def _native_available() -> bool:
    try:
        from gmres_tpu.native import _get_lib

        _get_lib()
        return True
    except ImportError:
        return False


pytestmark = pytest.mark.skipif(
    not _native_available(), reason="native library unavailable"
)


def _pack_both(A, **kw):
    old = os.environ.pop("GMRES_TPU_SELL_NUMPY", None)
    try:
        S_native = sell_from_csr(A, host_arrays=True, **kw)
        os.environ["GMRES_TPU_SELL_NUMPY"] = "1"
        S_numpy = sell_from_csr(A, host_arrays=True, **kw)
    finally:
        if old is None:
            os.environ.pop("GMRES_TPU_SELL_NUMPY", None)
        else:
            os.environ["GMRES_TPU_SELL_NUMPY"] = old
    return S_native, S_numpy


def _assert_identical(Sn, Sp):
    if Sp is None:
        assert Sn is None
        return
    assert Sn is not None
    assert (Sn.W, Sn.K, Sn.G) == (Sp.W, Sp.K, Sp.G)
    assert Sn.parts == Sp.parts
    assert Sn.dense_parts == Sp.dense_parts
    assert (Sn.n_rows, Sn.n_cols, Sn.nnz) == (Sp.n_rows, Sp.n_cols, Sp.nnz)
    assert (Sn.n_rows_pad, Sn.n_buckets) == (Sp.n_rows_pad, Sp.n_buckets)
    for field in ("data", "cols", "packed", "packed_lo", "bucket", "slab",
                  "dense_data", "dense_lo", "dense_bucket", "dense_slab",
                  "dense_vidx"):
        an, ap = getattr(Sn, field), getattr(Sp, field)
        assert len(an) == len(ap), field
        for i, (xn, xp) in enumerate(zip(an, ap)):
            xn, xp = np.asarray(xn), np.asarray(xp)
            assert xn.dtype == xp.dtype, (field, i)
            assert xn.shape == xp.shape, (field, i)
            # bit-exact (values were produced by identical arithmetic)
            np.testing.assert_array_equal(xn, xp, err_msg=f"{field}[{i}]")


@pytest.mark.parametrize("df64", [False, True])
def test_parity_mesh(df64):
    A = unstructured_mesh(4096, run=8, seed=3)
    _assert_identical(*_pack_both(A, df64=df64))


def test_parity_mesh_2d_autotune():
    # W/K resolved by the autotune inside each engine — must agree
    A = unstructured_mesh(3000, run=3, seed=11)
    _assert_identical(*_pack_both(A))


@pytest.mark.parametrize("seed", [0, 7])
def test_parity_random(seed):
    A = random_sparse(1500, row_nnz=9, seed=seed)
    _assert_identical(*_pack_both(A, W=128, K=4))


def test_parity_f32_data():
    A = unstructured_mesh(2048, run=8, seed=5)
    _assert_identical(*_pack_both(A, W=256, K=8, dtype=np.float32))


@pytest.mark.parametrize("G", [1, 4, 8])
def test_parity_explicit_g(G):
    # G is a pack-layout parameter on BOTH engines (round-4: the native
    # packer's padding was hardcoded at 4, forcing G sweeps onto the
    # ~20x-slower numpy path)
    A = unstructured_mesh(2600, run=5, seed=9)
    Sn, Sp = _pack_both(A, W=256, K=8, G=G)
    assert Sn.G == G
    _assert_identical(Sn, Sp)


def test_default_g_follows_xres_gate():
    # small operand -> x-resident kernel -> engines auto-pick G from the
    # exact per-block padding; a pack whose padded operand exceeds the
    # VMEM budget stays at the windowed optimum G=4
    from gmres_tpu.ops.sell import NO_XRES, pick_g

    if os.environ.get("GMRES_TPU_SELL_G") or NO_XRES:
        pytest.skip("SELL env overrides active")
    assert pick_g(4096, 512) is None  # auto (x-resident)
    assert pick_g(64 * 1024 * 1024, 512) == 4  # windowed pin
    A = unstructured_mesh(4096, run=8, seed=3)
    S = sell_from_csr(A, host_arrays=True)
    assert S.G in (4, 8, 16)
    for n_chunks, _, _ in S.parts:
        assert n_chunks % S.G == 0


def test_auto_g_exact_padding_rule():
    # the auto-pick takes the LARGEST candidate within 2% exact padding
    from gmres_tpu.ops.sell import _auto_g

    # all blocks at 48 chunks: 16 | 48 -> zero padding -> 16
    assert _auto_g(np.full(64, 48, np.int64)) == 16
    # blocks at 20: G=16 pads +12/20, G=8 pads +4/20, G=4 pads 0 -> 4
    assert _auto_g(np.full(64, 20, np.int64)) == 4
    # blocks at 24: G=16 pads +8/24, G=8 pads 0 -> 8
    assert _auto_g(np.full(64, 24, np.int64)) == 8
    # empty blocks get coverage dummies in the candidate's size
    assert _auto_g(np.zeros(4, np.int64)) == 4


def test_parity_with_dense_blocks():
    # a banded-ish matrix dense enough to cross the dense-pair threshold
    rng = np.random.default_rng(0)
    n = 1024
    rows, cols = [], []
    for i in range(n):
        # a dense cluster (high fill within bucket 0 of each slab) plus
        # scattered ELL entries
        for j in range(8):
            rows.append(i)
            cols.append((i // 128) * 0 + (i * 7 + j * 13) % 96)
        rows.append(i)
        cols.append(900 + (i % 17))
    rows = np.array(rows)
    cols = np.array(cols)
    vals = rng.standard_normal(rows.shape[0])
    A = csr_from_coo(rows, cols, vals, n_rows=n, n_cols=1024)
    Sn, Sp = _pack_both(A, W=128, K=4, dense_fill_min=0.012, df64=True)
    assert Sn.n_dense_chunks > 0  # the dense side is actually exercised
    _assert_identical(Sn, Sp)


def test_parity_unsorted_rows():
    # csr_from_arrays keeps caller order; feed shuffled columns per row so
    # both engines exercise their sort-recovery path
    rng = np.random.default_rng(2)
    n = 700
    cols = np.concatenate(
        [rng.choice(n, size=6, replace=False) for _ in range(n)]
    )  # unsorted within each row on purpose
    row_ptr = np.arange(0, 6 * n + 1, 6, dtype=np.int32)
    vals = rng.standard_normal(6 * n)
    A = csr_from_arrays(row_ptr, cols, vals, n_cols=n)
    _assert_identical(*_pack_both(A, W=128, K=4, df64=True))


def test_parity_zero_dense_cap():
    """A dense-block budget below one block demotes EVERY dense candidate
    to ELL in BOTH engines (regression: the native side forced a minimum
    of one dense block where numpy kept zero)."""
    rng = np.random.default_rng(4)
    n = 1024
    rows = np.repeat(np.arange(n), 8)
    cols = (rows * 7 + np.tile(np.arange(8) * 13, n)) % 96  # bucket-0 dense
    vals = rng.standard_normal(rows.shape[0])
    A = csr_from_coo(rows, cols, vals, n_rows=n, n_cols=1024)
    Sn, Sp = _pack_both(A, W=128, K=4, dense_fill_min=0.012,
                        max_dense_bytes=1)  # < one block: cap of zero
    assert Sp is not None and Sp.n_dense_chunks == 0
    _assert_identical(Sn, Sp)


@pytest.mark.parametrize("seed", range(8))
def test_parity_randomized_sweep(seed):
    """Randomized structural sweep over the packer pair: varying density,
    column spread, duplicate-heavy rows, tiny K, autotuned (W, K) — both
    engines must stay bit-identical across the space (the layout contract
    the distributed SELL partitioner and the kernels rely on)."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(300, 2500))
    row_nnz = int(rng.integers(2, 20))
    rows = np.repeat(np.arange(n), row_nnz)
    spread = int(rng.integers(8, max(9, n)))
    cols = np.clip(rows + rng.integers(-spread, spread + 1,
                                       size=rows.shape[0]), 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    A = csr_from_coo(rows, cols, vals, n_rows=n, n_cols=n)
    kw = {}
    if seed % 2:  # half the sweep exercises the autotune path
        kw = dict(W=int(rng.choice([128, 256])), K=int(rng.choice([2, 4, 8])))
    if seed % 3 == 0:
        kw["df64"] = True
    _assert_identical(*_pack_both(A, **kw))


def test_spmv_matches_dense_native_pack():
    # end-to-end: the native-packed operator multiplies correctly
    import jax.numpy as jnp

    from gmres_tpu.ops.sell import sell_spmv

    A = unstructured_mesh(2000, run=3, seed=9)
    S = sell_from_csr(A, W=128, K=4)
    assert S is not None
    x = np.linspace(-1.0, 1.0, 2000)
    y = np.asarray(sell_spmv(S, jnp.asarray(x)))
    y_ref = A.to_dense() @ x
    # the XLA SpMV accumulates in f32 regardless of the stored dtype
    np.testing.assert_allclose(y, y_ref, rtol=5e-5, atol=5e-5)
