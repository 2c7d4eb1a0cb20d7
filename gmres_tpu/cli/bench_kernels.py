"""Kernel microbenchmark — the reference's ``kernel_perf_test`` capability
(``kernel_perf_test.cpp``: times spmv, dot, dot+axpy "MGS proxy", gemv),
reporting nnz/s and GB/s per device.

Unlike the reference (which evicts caches between single-shot trials),
timing uses jitted repetition loops: each op is run in a device-side chain
long enough to amortize dispatch, which is how steady-state production
behavior looks under jit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial


def device_loop(fn, reps: int):
    """Chain fn reps times on device so host dispatch amortizes.  Returns a
    SCALAR checksum, fetched by the caller as the completion barrier."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnums=())
    def run(*args):
        def body(i, a):
            r = fn(*a)
            return r if isinstance(r, tuple) else (r,)

        out = jax.lax.fori_loop(0, reps, body, args)
        leaves = [x for x in jax.tree.leaves(out) if hasattr(x, "dtype")]
        return sum(
            jnp.sum(x.reshape(-1)[:1].astype(jnp.float32)) for x in leaves
        )

    return run


def device_loop_op(fn, reps: int):
    """Like device_loop, but the first argument is a stationary operand
    (a jit argument, carried nowhere: closing over it would bake the
    operator into the program as constants)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnums=())
    def run(op, *args):
        def body(i, a):
            r = fn(op, *a)
            return r if isinstance(r, tuple) else (r,)

        out = jax.lax.fori_loop(0, reps, body, args)
        leaves = [x for x in jax.tree.leaves(out) if hasattr(x, "dtype")]
        return sum(
            jnp.sum(x.reshape(-1)[:1].astype(jnp.float32)) for x in leaves
        )

    return run


def time_op(run, args, reps: int, warmup: int = 1) -> float:
    import numpy as np

    for _ in range(warmup):
        float(np.asarray(run(*args)))
    t0 = time.perf_counter()
    float(np.asarray(run(*args)))
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gmres-bench-kernels")
    ap.add_argument("--Apath", default=None)
    ap.add_argument("--synth", default="convdiff:1024")
    ap.add_argument("--vcols", type=int, default=31, help="basis width for gemv")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--rand", type=int, default=42)
    ap.add_argument("--device", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--reorder", choices=["rcm"], default=None,
                    help="apply a bandwidth-reducing RCM permutation before "
                         "format dispatch (solve(reorder='rcm') semantics "
                         "at the kernel level)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from gmres_tpu import backend

    backend.use_compile_cache()
    if args.device == "gpu":
        backend.require_gpu()

    import jax.numpy as jnp

    from gmres_tpu.cli.solve import make_synth
    from gmres_tpu.io.loader import load_matrix
    from gmres_tpu.io.rng import rand_vect
    from gmres_tpu.ops.blas import dot as blas_dot
    from gmres_tpu.ops.orth import orthonormalize_step
    from gmres_tpu.ops.spmv import spmv

    A64 = make_synth(args.synth) if args.synth and not args.Apath else load_matrix(args.Apath)
    if args.reorder == "rcm":
        from gmres_tpu.ops.reorder import permute_symmetric, rcm_permutation

        t0 = time.perf_counter()
        perm = rcm_permutation(A64)
        A64 = permute_symmetric(A64, perm)
        print(f"RCM reorder applied ({time.perf_counter()-t0:.1f}s)",
              file=sys.stderr)
    n, nnz = A64.n_rows, A64.nnz
    reps = args.trials
    print(f"matrix: n={n:,} nnz={nnz:,}; reps={reps}", file=sys.stderr)

    x = jnp.asarray(rand_vect(n, args.rand))
    results = {}

    from gmres_tpu.ops.dia import from_csr

    dia64 = from_csr(A64)
    formats = [("csr", A64)] + ([("dia", dia64)] if dia64 is not None else [])
    for fmt_name, A0 in formats:
        for dt_name, dt in (("f64", jnp.float64), ("f32", jnp.float32),
                            ("bf16", jnp.bfloat16)):
            A = jax.device_put(A0.astype(dt))
            xd = x.astype(dt)
            # The 0.125 scale keeps the chained values from overflowing
            # (rho(A)^reps) and fuses into the SpMV epilogue.
            step_fn = lambda a, v: spmv(a, v) * dt(0.125)
            t = time_op(device_loop_op(step_fn, reps), (A, xd), reps)
            itemsize = jnp.dtype(dt).itemsize
            bytes_per = nnz * (itemsize + 4) + n * 2 * itemsize  # vals+cols+x+y
            results[f"spmv_{fmt_name}_{dt_name}"] = dict(
                seconds=t, nnz_per_s=nnz / t, gb_per_s=bytes_per / t / 1e9
            )
            print(f"spmv {fmt_name} {dt_name}: {t*1e6:8.1f} us  {nnz/t:.3e} nnz/s "
                  f"{bytes_per/t/1e9:7.1f} GB/s", file=sys.stderr)

    for dt_name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        xd = jax.device_put(x.astype(dt))
        y = jax.device_put((x * 0.5).astype(dt))
        itemsize = jnp.dtype(dt).itemsize

        # stationary operands are closed over (jit constants), only the
        # evolving value is carried — a carried pytree copies per iteration.
        def dot_step(acc):
            return acc * 1e-9 + blas_dot(xd, y)

        t = time_op(device_loop(dot_step, reps), (jnp.zeros((), dt),), reps)
        results[f"dot_{dt_name}"] = dict(seconds=t, gb_per_s=2 * n * itemsize / t / 1e9)
        print(f"dot  {dt_name}: {t*1e6:8.1f} us  {2*n*itemsize/t/1e9:7.1f} GB/s",
              file=sys.stderr)

        # MGS proxy: dot + axpy (the sequential recurrence's inner step,
        # using the library dot like solver/gmres.py does)
        def mgs_step(w):
            h = blas_dot(w, y)
            return w - h * y

        t = time_op(device_loop(mgs_step, reps), (xd,), reps)
        results[f"dot_axpy_{dt_name}"] = dict(seconds=t)
        print(f"mgs  {dt_name}: {t*1e6:8.1f} us", file=sys.stderr)

        # CGS and CGSR steps of the solver (ops/orth.py) against an
        # m x n basis, and the compressed-basis (bf16 V) CGSR variant
        V = jax.device_put(jnp.tile(y[None, :], (args.vcols, 1)))
        k = args.vcols - 1
        variants = [("cgs", "cgs", V, 2), ("cgsr", "cgsr", V, 3)]
        if dt == jnp.float32:
            variants.append(("cgsr_cb_bf16V", "cgsr",
                             jax.device_put(V.astype(jnp.bfloat16)), 3))
        for name, kind, basis, sweeps in variants:
            def orth_step(w, basis=basis, kind=kind):
                _, w2, hn = orthonormalize_step(kind, basis, k, w,
                                                assume_zero_tail=True)
                return w2 / (hn + 1)

            t = time_op(device_loop(orth_step, reps), (xd,), reps)
            bytes_per = sweeps * args.vcols * n * basis.dtype.itemsize
            results[f"{name}_{dt_name}"] = dict(
                seconds=t, gb_per_s=bytes_per / t / 1e9)
            print(f"{name} {dt_name} (m={args.vcols}): {t*1e6:8.1f} us  "
                  f"{bytes_per/t/1e9:7.1f} GB/s", file=sys.stderr)

    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
