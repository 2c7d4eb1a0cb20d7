"""Double-float (two-fp32) pair math of the df64 tier vs true fp64.

Guards the error-free transformations against compiler contraction /
reassociation: a regression shows up as relative error jumping from
~1e-14 toward fp32's ~1e-7.
"""

import jax.numpy as jnp
import numpy as np

from gmres_tpu.io.synth import convection_diffusion_2d
from gmres_tpu.ops.df64 import df_dot, merge_f64, split_f64, spmv_df64_pair
from gmres_tpu.ops.dia import dia_spmv, from_csr


def test_split_merge_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
    hi, lo = split_f64(jnp.asarray(x))
    back = np.asarray(merge_f64(hi, lo))
    np.testing.assert_allclose(back, x, rtol=4e-15)


def test_df64_spmv_accuracy():
    """The df64 tier's SpMV on an (hi, lo) operand pair (exact merge, fp64
    product, exact split) keeps fp64 accuracy, far beyond fp32's."""
    A = from_csr(convection_diffusion_2d(17, beta=3.0))  # n=289
    assert A is not None
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.n_rows)

    y64 = np.asarray(dia_spmv(A.astype(jnp.float64), jnp.asarray(x)),
                     dtype=np.float64)
    yh, yl = spmv_df64_pair(A.astype(jnp.float64), *split_f64(jnp.asarray(x)))
    ydf = np.asarray(merge_f64(yh, yl))
    y32 = np.asarray(
        dia_spmv(A.astype(jnp.float32), jnp.asarray(x, dtype=jnp.float32))
    ).astype(np.float64)

    scale = np.max(np.abs(y64))
    err_df = np.max(np.abs(ydf - y64)) / scale
    err_f32 = np.max(np.abs(y32 - y64)) / scale
    # double-float must be dramatically more accurate than fp32
    assert err_df < 1e-12, f"df64 error too large: {err_df}"
    assert err_df < err_f32 * 1e-4, (err_df, err_f32)


def test_df64_fast_dot_matches_fp64():
    """The df64 pair dot (ops/df64.df_dot, a pairwise tree of double-float
    additions) agrees with the IEEE fp64 dot to ~2^-48 relative, at
    lengths that are and are not powers of two."""
    rng = np.random.default_rng(7)
    for n in (1024, 65536, 70000):
        x = rng.standard_normal(n)
        y = rng.standard_normal(n) * 1e3
        want = float(np.dot(x, y))
        got = float(df_dot(*split_f64(jnp.asarray(x)),
                           *split_f64(jnp.asarray(y))))
        scale = float(np.abs(x) @ np.abs(y))
        assert abs(got - want) <= 2e-13 * scale, (n, got, want)
