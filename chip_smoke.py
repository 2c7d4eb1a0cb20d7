#!/usr/bin/env python3
"""Smoke run of the solver's main path on one NVIDIA GPU.

    python chip_smoke.py                 # one card: device, layers, solve
    python chip_smoke.py --four-gpus     # only the 4-card solve_distributed phase
    python chip_smoke.py --cpu-rehearsal # every phase at tiny sizes on the CPU

Phases, each printing one JSON line to stdout (progress goes to stderr):

- ``device``: JAX must report a GPU, else the script exits with code 1
  before printing any result.  Reports the device kind, the device count
  and the card's name and power limit from ``nvidia-smi``.
- ``layers``: each XLA form the solver runs — DIA SpMV, CSR SpMV, CGS and
  CGSR orthogonalization, exact-ILU apply and the fp64 outer residual —
  at full width, compared with a float64 host reference (scipy/numpy, and
  the native C++ substitution for exact ILU), with the median wall time
  per call of back-to-back calls after a warm-up, its bytes/s and a large
  copy's bytes/s measured in the same process.
- ``solve``: ``solve``, ``stage`` and ``solve_batched`` on the benchmark's
  configurations; every run must converge with an fp64 backward error,
  computed on the host, of at most ``tol``.
- ``distributed`` (``--four-gpus``): ``solve_distributed`` over a 4-device
  mesh against a single-device ``solve`` of the same system.

Any failed check raises: the script then exits non-zero.  The last stdout
line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true", dest="four",
                    help="run only the 4-device solve_distributed phase")
    ap.add_argument("--cpu-rehearsal", action="store_true", dest="cpu",
                    help="run every phase at tiny sizes on the CPU")
    ap.add_argument("--seed", type=int, default=42)
    return ap.parse_args()


ARGS = _parse()
if ARGS.cpu:
    # before JAX starts: the CPU platform with 4 virtual devices
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gmres_tpu import (  # noqa: E402
    GmresConfig,
    PrecisionSpec,
    backend,
    rand_vect,
    solve,
    solve_batched,
    solve_distributed,
    stage,
)
from gmres_tpu.io.synth import convection_diffusion_2d, unstructured_mesh  # noqa: E402

# Sizes: (full, rehearsal).  Full sizes are the ones users solve; the
# rehearsal sizes only exercise the control flow.
FULL = not ARGS.cpu
NX_MAIN = 1024 if FULL else 32          # convdiff n = 1,048,576 (5.2M nnz)
NX_BIG = 4096 if FULL else 64           # n = 16,777,216: past the 50 MB L2
N_MESH = 1 << 20 if FULL else 2048      # unstructured_mesh, ~25 nnz/row
NX_ILU_MAX = 3048 if FULL else 48       # largest convdiff build_ilu_exact accepts
NX_BATCH = 512 if FULL else 24
NX_DIST = 2048 if FULL else 32
M_RESTART = 30
TOL = 1e-8
BYTES_COPY = (1 << 30) if FULL else (1 << 20)
CACHE_DIR = None


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed(fn, *args):
    """Median wall seconds per call of back-to-back calls, after a warm-up
    that also compiles; returns (seconds, last output)."""
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    one = time.perf_counter() - t0
    reps = max(1, min(50, int(0.05 / max(one, 1e-6))))
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / reps)
    return float(np.median(samples)), out


def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check(name: str, err: float, tol: float, why: str):
    if not err <= tol:
        raise AssertionError(f"{name}: relative error {err:.3e} > {tol:.1e} ({why})")


# --------------------------------------------------------------- device
def phase_device() -> dict:
    dev = backend.describe_devices()
    want = "cpu" if ARGS.cpu else "gpu"
    if dev["platform"] != want:
        print(f"no GPU: JAX runs on {dev['platform']!r}", file=sys.stderr)
        raise SystemExit(1)
    card = backend.card_line()
    print(card, flush=True)   # nvidia-smi's own line: name, power limit
    emit("device", **dev, card=card, compile_cache=CACHE_DIR)
    return dev


# --------------------------------------------------------------- layers
TOL_F64 = (1e-12, "float64 reduction over at most 2^24 terms")
TOL_F32 = (1e-4, "float32 unit roundoff 6e-8 grown by reductions over "
           "up to 2^24 terms and the fp32-rounded operator values")


def phase_layers(A_main, A_mesh, A_ilu) -> list:
    from gmres_tpu.ops.blas import nrm2
    from gmres_tpu.ops.dia import from_csr
    from gmres_tpu.ops.orth import orthonormalize_step
    from gmres_tpu.ops.spmv import spmv

    rows = []
    rng = np.random.default_rng(ARGS.seed)

    def record(layer, dtype, n, sec, nbytes, err, tol_why, **extra):
        tol, why = tol_why
        check(f"{layer} {dtype} n={n}", err, tol, why)
        row = dict(layer=layer, dtype=dtype, n=n, seconds=sec,
                   bytes=nbytes, bytes_per_s=nbytes / sec, rel_err=err,
                   tol=tol, **extra)
        log(json.dumps(row))
        rows.append(row)

    # large-copy bandwidth: read n, write n
    xc = jnp.ones((BYTES_COPY // 4,), jnp.float32)
    sec, _ = timed(jax.jit(lambda v: v * 2.0), xc)
    copy_bps = 2 * BYTES_COPY / sec
    rows.append(dict(layer="copy", dtype="float32", n=xc.shape[0],
                     seconds=sec, bytes=2 * BYTES_COPY, bytes_per_s=copy_bps))
    log(json.dumps(rows[-1]))
    del xc

    spmv_j = jax.jit(spmv)

    # DIA SpMV, 5 bands, at n = 1M and 16.7M (past the L2)
    for A in (A_main, convection_diffusion_2d(NX_BIG, beta=2.0)):
        dia = from_csr(A)
        x = rand_vect(A.n_rows, ARGS.seed)
        y_ref = A.to_scipy() @ x
        for dt, tol in ((jnp.float64, TOL_F64), (jnp.float32, TOL_F32)):
            Ad = jax.device_put(dia.astype(dt))
            sec, y = timed(spmv_j, Ad, jnp.asarray(x, dt))
            it = jnp.dtype(dt).itemsize
            record("dia_spmv", jnp.dtype(dt).name, A.n_rows, sec,
                   (len(dia.offsets) + 2) * A.n_rows * it, rel_err(y, y_ref),
                   tol, diagonals=len(dia.offsets))
            del Ad

    # CSR SpMV (gather + segment sum) on the unstructured mesh
    x = rand_vect(A_mesh.n_rows, ARGS.seed)
    y_ref = A_mesh.to_scipy() @ x
    for dt, tol in ((jnp.float64, TOL_F64), (jnp.float32, TOL_F32)):
        Ad = jax.device_put(A_mesh.astype(dt))
        sec, y = timed(spmv_j, Ad, jnp.asarray(x, dt))
        it = jnp.dtype(dt).itemsize
        nnz_p = Ad.vals.shape[0]
        record("csr_spmv", jnp.dtype(dt).name, A_mesh.n_rows, sec,
               nnz_p * (it + 8) + 2 * A_mesh.n_rows * it, rel_err(y, y_ref),
               tol, nnz=A_mesh.nnz)
        del Ad

    # CGS / CGSR step at m = 30: rows 0..m-1 of V orthonormal, row m zero
    n = A_main.n_rows
    Q, _ = np.linalg.qr(rng.standard_normal((n, M_RESTART)))
    V64 = np.zeros((M_RESTART + 1, n))
    V64[:M_RESTART] = Q.T
    w64 = rng.standard_normal(n)
    del Q
    h1 = V64 @ w64
    w1 = w64 - V64.T @ h1
    h2 = V64 @ w1
    w2 = w1 - V64.T @ h2
    refs = {"cgs": (h1, w1), "cgsr": (h1 + h2, w2)}
    for kind, passes in (("cgs", 2), ("cgsr", 4)):
        fn = jax.jit(lambda V, w, kind=kind: orthonormalize_step(
            kind, V, M_RESTART - 1, w, assume_zero_tail=True))
        for dt, tol in ((jnp.float64, TOL_F64), (jnp.float32, TOL_F32)):
            V = jnp.asarray(V64, dt)
            sec, (h, w, hn) = timed(fn, V, jnp.asarray(w64, dt))
            h_ref, w_ref = refs[kind]
            err = max(rel_err(h[:M_RESTART], h_ref[:M_RESTART]),
                      rel_err(w, w_ref),
                      abs(float(hn) - np.linalg.norm(w_ref))
                      / np.linalg.norm(w_ref))
            it = jnp.dtype(dt).itemsize
            record(f"orth_{kind}", jnp.dtype(dt).name, n, sec,
                   passes * (M_RESTART + 1) * n * it + 3 * n * it, err, tol,
                   m=M_RESTART, basis_reads=passes)
            del V
    del V64

    # exact-ILU apply (float32 factors) vs the native substitution
    from gmres_tpu.native import trisolve_native
    from gmres_tpu.precond.apply import apply_preconditioner
    from gmres_tpu.precond.build import build_ilu_exact
    from gmres_tpu.precond.ilu0 import ilu0_factorize

    apply_j = jax.jit(apply_preconditioner)
    for nx, A in ((NX_MAIN, A_main), (NX_ILU_MAX, A_ilu)):
        M = jax.device_put(build_ilu_exact(A, np.float32))
        rp = np.asarray(A.row_ptr)
        nnz = A.nnz
        ci = np.asarray(A.col_idx)[:nnz]
        fv, diag = ilu0_factorize(rp, ci, np.asarray(A.vals)[:nnz],
                                  factor_dtype=np.float32)
        w = rand_vect(A.n_rows, ARGS.seed)
        z_ref = trisolve_native(rp, ci, np.asarray(fv, np.float64), diag, w)
        sec, z = timed(apply_j, M, jnp.asarray(w, jnp.float32))
        record("ilu_apply", "float32", A.n_rows, sec,
               nnz * 8 + 3 * A.n_rows * 4, rel_err(z, z_ref),
               (1e-4, "float32 substitution through ~2*nx dependency levels "
                "of diagonally dominant factors"),
               form=type(M).__name__, nx=nx)
        del M

    # fp64 outer residual r = b - A x and its norms (the baseline's fp64
    # SpMV and dots; the mixed tier's once-per-restart work)
    dia = jax.device_put(from_csr(A_main))
    x = rand_vect(A_main.n_rows, ARGS.seed)
    b = rand_vect(A_main.n_rows, ARGS.seed + 1)
    r_ref = b - A_main.to_scipy() @ x

    @jax.jit
    def residual(A, b, x):
        r = b - spmv(A, x)
        return r, nrm2(r), nrm2(x)

    sec, (r, rn, xn) = timed(residual, dia, jnp.asarray(b), jnp.asarray(x))
    err = max(rel_err(r, r_ref),
              abs(float(rn) - np.linalg.norm(r_ref)) / np.linalg.norm(r_ref))
    record("fp64_residual", "float64", A_main.n_rows, sec,
           (len(dia.offsets) + 3) * A_main.n_rows * 8, err, TOL_F64)
    for row in rows:
        row["share_of_copy"] = row["bytes_per_s"] / copy_bps
    emit("layers", copy_bytes_per_s=copy_bps, results=rows)
    return rows


# ---------------------------------------------------------------- solve
def backward_error(S, b, x) -> float:
    """||b - A x|| / (||b|| + ||A||_F ||x||) in float64 on the host —
    the solver's own convergence criterion."""
    x = np.asarray(x, dtype=np.float64)
    r = b - S @ x
    a_norm = float(np.sqrt((S.data.astype(np.float64) ** 2).sum()))
    return float(np.linalg.norm(r)
                 / (np.linalg.norm(b) + a_norm * np.linalg.norm(x)))


def cfg_for(mode: str, prec: str = "identity", **kw) -> GmresConfig:
    return GmresConfig(precision=PrecisionSpec.from_mode(mode), orth="cgsr",
                       precond=prec, jacobi_steps=3, restart_length=M_RESTART,
                       tol=TOL, max_restarts=2000, **kw)


def problem(A, seed):
    x_true = rand_vect(A.n_rows, seed)
    return x_true, A.to_scipy() @ x_true


def check_run(tag: str, S, b, x_true, res) -> dict:
    be = backward_error(S, b, res.x)
    fe = rel_err(res.x, x_true)
    row = dict(run=tag, converged=bool(res.converged), iters=res.total_iters,
               restarts=res.restarts, backward_error=be, forward_error=fe)
    if not res.converged:
        raise AssertionError(f"{tag}: did not converge ({row})")
    if not be <= TOL:
        raise AssertionError(f"{tag}: backward error {be:.3e} > tol {TOL:.0e}")
    return row


def phase_solve(A_main, A_mesh, A_ilu) -> list:
    rows = []
    # (tag, matrix, config, through stage(), timed again once compiled)
    runs = [
        ("convdiff baseline", A_main, cfg_for("baseline"), False, True),
        ("convdiff mixed", A_main, cfg_for("mixed"), True, True),
        ("convdiff mixed jacobi", A_main, cfg_for("mixed", "jacobi"), False,
         True),
        ("convdiff mixed ilu_jacobi", A_main, cfg_for("mixed", "ilu_jacobi"),
         False, True),
        # exact ILU at the layer's largest grid: one run, its applies are
        # hundreds of milliseconds each
        ("convdiff mixed ilu", A_ilu, cfg_for("mixed", "ilu"), False, False),
        ("convdiff df64", A_main, cfg_for("df64"), False, True),
        ("mesh mixed", A_mesh, cfg_for("mixed"), False, True),
        ("mesh baseline", A_mesh, cfg_for("baseline"), False, True),
    ]
    staged = {}
    for tag, A, cfg, use_stage, again in runs:
        S = A.to_scipy()
        x_true, b = problem(A, ARGS.seed)
        op = A
        if use_stage:
            op = staged.setdefault(id(A), stage(A))
        walls = []
        for _ in range(2 if again else 1):
            t0 = time.perf_counter()
            res = solve(op, b, cfg, M=None if op is A else _prec(A, cfg))
            jax.block_until_ready(res.x)
            walls.append(time.perf_counter() - t0)
        row = check_run(tag, S, b, x_true, res)
        row.update(n=A.n_rows, nnz=A.nnz, first_wall_s=walls[0],
                   wall_s=walls[-1] if again else None, staged=use_stage)
        log(json.dumps(row))
        rows.append(row)

    # multi-RHS: B = 8 right-hand sides in one lockstep batch
    A = convection_diffusion_2d(NX_BATCH, beta=2.0)
    S = A.to_scipy()
    X_true = np.stack([rand_vect(A.n_rows, ARGS.seed + j) for j in range(8)])
    B = (S @ X_true.T).T
    cfg = cfg_for("mixed")
    t0 = time.perf_counter()
    res = solve_batched(A, B, cfg)
    jax.block_until_ready(res[0].x)
    wall = time.perf_counter() - t0
    for j, r in enumerate(res):
        row = check_run(f"batched lane {j}", S, B[j], X_true[j], r)
        row.update(n=A.n_rows, batch=8, wall_s_batch=wall)
        log(json.dumps(row))
        rows.append(row)
    emit("solve", tol=TOL, restart_length=M_RESTART, results=rows)
    return rows


def _prec(A, cfg):
    from gmres_tpu.precond.build import build_preconditioner

    return build_preconditioner(A, cfg)


# ---------------------------------------------------------- distributed
def phase_distributed() -> list:
    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-gpus needs 4 devices, JAX sees {len(devs)}")
    mesh = jax.make_mesh((4,), ("rows",), devices=devs[:4])
    rows = []
    for name, A in (("convdiff", convection_diffusion_2d(NX_DIST, beta=2.0)),
                    ("mesh", unstructured_mesh(N_MESH, run=8))):
        S = A.to_scipy()
        x_true, b = problem(A, ARGS.seed)
        for mode in ("mixed", "baseline"):
            cfg = cfg_for(mode, "jacobi")
            t0 = time.perf_counter()
            rd = solve_distributed(A, b, cfg, mesh=mesh)
            jax.block_until_ready(rd.x)
            wall_d = time.perf_counter() - t0
            n_dev = len(rd.x.sharding.device_set)
            if n_dev != 4:
                raise AssertionError(f"{name} {mode}: x spans {n_dev} devices")
            t0 = time.perf_counter()
            r1 = solve(A, b, cfg)
            jax.block_until_ready(r1.x)
            wall_1 = time.perf_counter() - t0
            row = check_run(f"{name} {mode} 4 devices", S, b, x_true, rd)
            row1 = check_run(f"{name} {mode} 1 device", S, b, x_true, r1)
            if rd.restarts != r1.restarts:
                raise AssertionError(
                    f"{name} {mode}: {rd.restarts} restarts on 4 devices, "
                    f"{r1.restarts} on one")
            row.update(n=A.n_rows, nnz=A.nnz, devices=n_dev,
                       first_wall_s=wall_d, single=row1,
                       single_first_wall_s=wall_1)
            log(json.dumps(row))
            rows.append(row)
    emit("distributed", results=rows)
    return rows


def main() -> int:
    global CACHE_DIR
    CACHE_DIR = backend.use_compile_cache()
    dev = phase_device()
    if ARGS.four:
        phase_distributed()
        dev = backend.describe_devices()
    else:
        A_main = convection_diffusion_2d(NX_MAIN, beta=2.0)
        A_mesh = unstructured_mesh(N_MESH, run=8)
        A_ilu = convection_diffusion_2d(NX_ILU_MAX, beta=2.0)
        phase_layers(A_main, A_mesh, A_ilu)
        phase_solve(A_main, A_mesh, A_ilu)
        if ARGS.cpu:
            phase_distributed()
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
