"""Solver CLI with flag and output parity to ``gmres_perf_test``
(``gmres_perf_test.cpp:309-455``).

The summary block format is a compatibility contract: the reference's sweep
runner scrapes it with a regex (``automated.py:33-38``), and ours accepts
the same format (while natively using structured results).  Numbers print
with C++ ``cout``-style %g formatting.

Additions: ``--device {gpu,cpu}`` (``--gpu`` is accepted as an alias);
``--dist`` solves row-partitioned over all devices; ``--json`` emits a
structured result line after the classic block.
"""

from __future__ import annotations

import argparse
import json
import sys


def fmt(x: float) -> str:
    """C++ ostream default float formatting (6 significant digits)."""
    return f"{float(x):g}"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmres-solve",
        description="Mixed-precision GMRES (reference-parity CLI)",
    )
    p.add_argument("--Apath", default=None)
    p.add_argument("--bpath", default=None)
    p.add_argument("--rlen", type=int, default=0)
    p.add_argument("--rtol", type=float, default=0.0)
    p.add_argument("--repeat-iter", action="store_true", dest="repeat_iter")
    p.add_argument("--orthloss", action="store_true")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-restarts", type=int, default=1_000_000, dest="max_restarts")
    p.add_argument("--rand", type=int, default=42)
    p.add_argument(
        "--mode",
        choices=["mixed", "baseline", "single-prec", "single", "df64"],
        default="mixed",
    )
    p.add_argument("--orth", type=str.lower, choices=["cgs", "mgs", "cgsr"], default="mgs")
    p.add_argument(
        "--prec", choices=["ilu", "ilu_jacobi", "jacobi", "identity"], default="ilu"
    )
    p.add_argument("--jacobi-steps", type=int, default=1, dest="jacobi_steps")
    # --gpu accepted for drop-in compatibility with the reference's CLI
    # (gmres_perf_test.cpp:402); the GPU is the default device anyway
    p.add_argument("--gpu", action="store_true",
                   help="reference-compat alias for --device gpu")
    p.add_argument("--device", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--dist", action="store_true", help="row-partition over all devices")
    p.add_argument("--inner-dtype", choices=["float32", "bfloat16"], default=None,
                   help="override the mixed mode's inner dtype")
    p.add_argument("--basis-dtype", choices=["float32", "bfloat16"], default=None,
                   help="compressed Krylov-basis storage (CB-GMRES, "
                        "arXiv:2009.12101): V stored narrower than the "
                        "arithmetic; w/H/Givens keep the inner dtype")
    p.add_argument("--json", action="store_true", help="emit a JSON result line too")
    # synthetic matrices for environments without .mtx files
    p.add_argument("--synth", default=None,
                   help="synthetic matrix instead of --Apath, e.g. poisson2d:512, "
                        "poisson3d:64, convdiff:512")
    return p


def make_synth(spec: str):
    from gmres_tpu.io import synth

    kind, _, size = spec.partition(":")
    n = int(size) if size else 64
    if kind == "poisson2d":
        return synth.poisson_2d(n)
    if kind == "poisson3d":
        return synth.poisson_3d(n)
    if kind == "convdiff":
        return synth.convection_diffusion_2d(n)
    if kind == "mesh":
        return synth.unstructured_mesh(n)
    if kind == "mesh3d":  # 3D-FEM/cage-class row density
        return synth.unstructured_mesh(n, run=8)
    raise SystemExit(f"unknown synthetic matrix {spec!r}")


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from gmres_tpu import backend
    from gmres_tpu.config import GmresConfig, PrecisionSpec

    backend.use_compile_cache()
    from gmres_tpu.io.loader import load_matrix, load_vector
    from gmres_tpu.io.rng import rand_vect
    from gmres_tpu.ops.blas import nrm2
    from gmres_tpu.ops.spmv import spmv
    from gmres_tpu.solver.gmres import solve

    if args.repeat_iter and args.orthloss:
        print("Repeated Iteration Restart cannot be used with OrthLoss restart")
        return 1
    if args.Apath is None and args.synth is None:
        # reference message, verbatim contract (gmres_perf_test.cpp:402)
        print("No value suplied for A")
        return 1

    A = make_synth(args.synth) if args.synth else load_matrix(args.Apath)
    n = A.n_rows

    if args.bpath is None:
        x_host = rand_vect(n, args.rand)
        b_host = np.asarray(spmv(A, jnp.asarray(x_host)))
    else:
        x_host = np.zeros(n)
        b_host = load_vector(args.bpath)

    precision = PrecisionSpec.from_mode(args.mode)
    if args.inner_dtype:
        import dataclasses

        precision = dataclasses.replace(
            precision, inner=args.inner_dtype, precond=args.inner_dtype
        )
    if args.basis_dtype:
        import dataclasses

        precision = dataclasses.replace(precision, basis=args.basis_dtype)

    cfg = GmresConfig.from_flags(
        mode=args.mode,
        orth=args.orth,
        prec=args.prec,
        rlen=args.rlen if args.rlen > 0 else 30,
        rtol=args.rtol,
        tol=args.tol,
        max_restarts=args.max_restarts,
        repeat_iter=args.repeat_iter,
        orthloss=args.orthloss,
        jacobi_steps=args.jacobi_steps,
    ).with_(precision=precision)

    print(f"||x|| = {fmt(np.linalg.norm(x_host))}")
    print(f"||b|| = {fmt(np.linalg.norm(b_host))}")
    print(f"||A|| = {fmt(np.linalg.norm(np.asarray(A.vals)))}")

    if args.mode == "mixed":
        print("Doing Mixed Precision test")
    else:
        print("Doing Baseline test")

    if args.dist:
        from gmres_tpu.parallel.dist_gmres import solve_distributed as _solve

        res = _solve(A, b_host, cfg)
    else:
        res = solve(A, b_host, cfg)

    if res.aborted:
        print(f"Aborting after {res.total_iters} iterations")
    else:
        print(
            f"Found solution with rel prec res norm = {fmt(res.rel_prec_res)} "
            f"when k = {res.final_k} and i = {res.restarts}"
        )
        print(f"  total iterations = {res.total_iters}")

    # true fp64 residual/error report (gmres_perf_test.cpp:104-115)
    x64 = np.asarray(res.x, dtype=np.float64)
    r = b_host - np.asarray(spmv(A, jnp.asarray(x64)))
    res_norm = np.linalg.norm(r)
    err_norm = np.linalg.norm(x64 - x_host)
    print(f"  ilu took {fmt(res.prec_seconds)}s; gmres took {fmt(res.solve_seconds)}s")
    print(f"  resNorm = {fmt(res_norm)}; errNorm = {fmt(err_norm)}")

    if args.json:
        print(json.dumps({
            "converged": res.converged,
            "aborted": res.aborted,
            "k": res.final_k,
            "i": res.restarts,
            "total_iters": res.total_iters,
            "rel_prec_res": res.rel_prec_res,
            "res_norm": float(res_norm),
            "err_norm": float(err_norm),
            "prec_seconds": res.prec_seconds,
            "solve_seconds": res.solve_seconds,
            "n": n,
            "nnz": A.nnz,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
