"""The one place that asks which device the solver runs on.

Platform questions are answered here, from a table keyed by
``jax.default_backend()``.  The table knows ``gpu`` and ``cpu``; any other
platform is an error rather than a guess.  Both platforms run the same
plain ``jax.numpy``/``lax`` forms, left to XLA, so the format choices need
no per-platform answer:

- SpMV: shifted fused multiply-adds for DIA operators, a gather plus a
  sorted segment sum for CSR (the reference's ``cusparse?csrmv`` role);
- exact ILU: the factors' dependency-level count of Jacobi sweeps while
  that fits the work budget, else the level-scheduled substitution
  (``precond/level_ilu.py``), else a clear error.

What the table does decide is the inner loop's schedule:

- ``unroll_inner``: unroll all m Arnoldi steps and select the restart
  post hoc.  Off, the FIXED policy runs a rolled ``fori_loop`` and the
  others a ``while_loop`` with early exit;
- ``lowsync_mgs_single_device``: whether ``low_sync_mgs=None`` turns the
  one-reduce ICWY MGS step on without a mesh.  Distributed solves always
  take it, since it saves k+1 allreduces per step.

This module also places JAX's persistent compilation cache
(``use_compile_cache``) and describes the devices for benchmark output.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess

import jax


@dataclasses.dataclass(frozen=True)
class Backend:
    platform: str
    unroll_inner: bool
    lowsync_mgs_single_device: bool


_TABLE = {
    "gpu": Backend("gpu", unroll_inner=False, lowsync_mgs_single_device=False),
    "cpu": Backend("cpu", unroll_inner=False, lowsync_mgs_single_device=False),
}


def current() -> Backend:
    """The answers for the platform JAX runs on; raises on an unknown one."""
    name = jax.default_backend()
    try:
        return _TABLE[name]
    except KeyError:
        raise RuntimeError(
            f"gmres_tpu runs on {sorted(_TABLE)}; JAX's default backend is "
            f"{name!r}. Run on an NVIDIA GPU or set JAX_PLATFORMS=cpu."
        ) from None


def unroll_inner() -> bool:
    return current().unroll_inner


def lowsync_mgs_auto(distributed: bool) -> bool:
    """Whether ``low_sync_mgs=None`` turns the ICWY MGS step on."""
    return distributed or current().lowsync_mgs_single_device


def describe_devices() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    current()
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """``describe_devices()`` for a measurement that must run on a GPU;
    exits with code 1 when JAX found none."""
    try:
        dev = describe_devices()
    except RuntimeError as e:
        print(f"no GPU: {e}", flush=True)
        raise SystemExit(1) from None
    if dev["platform"] != "gpu":
        print(f"no GPU: JAX runs on {dev['platform']!r}", flush=True)
        raise SystemExit(1)
    return dev


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per card, one line each); a note when
    ``nvidia-smi`` is unavailable.  Runs a child process that stays off
    JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out


CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def use_compile_cache() -> str:
    """Keep JAX's persistent compilation cache where
    ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads that itself, so nothing
    is set here), or else at ``<checkout>/.jax_cache``, a fixed path.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
