"""Solver checkpoint/resume for long solves on preemptible machines.

The reference has no in-solver checkpointing (SURVEY.md §5.4 — its
resumability is the append-only experiment CSV).  Here the restart loop can
persist (x, restart index, total iterations, policy state) every K restarts
and resume from the file transparently: GMRES restarts are natural
checkpoint boundaries because the only state that survives a restart is x
and the small policy scalars.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from gmres_tpu.solver.policies import PolicyState


@dataclasses.dataclass
class CheckpointSpec:
    path: str
    every: int = 10  # restarts between saves


def save(path: str, x, i: int, total_iters: int, pstate: PolicyState):
    """Atomic write (tmp + rename) so preemption can't corrupt."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                x=np.asarray(x),
                i=np.int64(i),
                total_iters=np.int64(total_iters),
                is_first=np.asarray(pstate.is_first),
                second_restart_length=np.asarray(pstate.second_restart_length),
                restart_tol=np.asarray(pstate.restart_tol),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str):
    """Returns (x, i, total_iters, pstate) or None if absent."""
    if not os.path.exists(path):
        return None
    import jax.numpy as jnp

    with np.load(path) as z:
        pstate = PolicyState(
            is_first=jnp.asarray(z["is_first"]),
            second_restart_length=jnp.asarray(z["second_restart_length"]),
            restart_tol=jnp.asarray(z["restart_tol"]),
        )
        return z["x"], int(z["i"]), int(z["total_iters"]), pstate
