"""condest CLI (flag parity with ``condest.cpp:186-227``)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gmres-condest")
    p.add_argument("--Apath", default=None)
    p.add_argument("--rand", type=int, default=42)
    p.add_argument("--max-iters", type=int, default=100_000, dest="max_iters")
    p.add_argument("--gpu", action="store_true",
                   help="reference-compat alias for --device gpu")
    p.add_argument("--device", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--synth", default=None)
    args = p.parse_args(argv)

    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    if args.Apath is None and args.synth is None:
        print("No value suplied for A")
        return 1

    from gmres_tpu import backend
    from gmres_tpu.cli.solve import make_synth
    from gmres_tpu.io.loader import load_matrix
    from gmres_tpu.solver.condest import condest

    backend.use_compile_cache()

    A = make_synth(args.synth) if args.synth else load_matrix(args.Apath)
    condest(A, rand_seed=args.rand, max_iters=args.max_iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
