"""Multi-host entry points (SURVEY.md §5.8; new scope vs the single-device
reference).

A multi-host run is N identical processes, each owning some of the
devices, cooperating through one global mesh: ``initialize`` wires up the
JAX distributed runtime, after which ``solve_distributed(...,
multihost=True)`` runs the row-partitioned solver across all processes —
shard uploads are per-host (``jax.make_array_from_callback``), the cycle's
collectives (psum reductions, ppermute halo exchange) are emitted by XLA
(NCCL on GPUs), and the host driver loop stays in lockstep because it only
ever fetches replicated scalars.

On CPU the same code path runs under simulated processes (gloo
collectives) — see tests/test_multihost.py.
"""

from __future__ import annotations

import jax
import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Wire up the JAX distributed runtime (idempotent).

    Where a cluster manager is detected JAX fills in the arguments; for
    manual launches pass the coordinator's ``host:port``, the process count
    and this process's id (``jax.distributed.initialize`` semantics).
    """
    # NOTE: must not touch the XLA backend before distributed init
    # (jax.process_count() would initialize it); is_initialized is safe
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def pack_offsets(offs, max_count: int) -> np.ndarray:
    """Fixed-shape wire format for a cross-process set-union vote: a
    ``(max_count + 1,)`` int64 array ``[count, sorted values..., pad]``
    with ``count = -1`` signalling local overflow (> max_count values).
    One format shared by every lockstep offset vote (halo DIA gate,
    block-ILU factor-pattern vote) so the protocols cannot drift."""
    arr = np.full(max_count + 1, np.iinfo(np.int64).min, np.int64)
    if len(offs) > max_count:
        arr[0] = -1
    else:
        arr[0] = len(offs)
        arr[1 : 1 + len(offs)] = sorted(offs)
    return arr


def union_offsets(rows: np.ndarray, max_count: int):
    """Union the gathered ``pack_offsets`` payloads; None when any process
    overflowed or the union itself exceeds ``max_count``."""
    rows = np.asarray(rows)
    if (rows[:, 0] < 0).any():
        return None
    union: set[int] = set()
    for row in rows:
        union.update(int(o) for o in row[1 : 1 + int(row[0])])
    return union if len(union) <= max_count else None


def exchange_host_array(arr: np.ndarray) -> np.ndarray:
    """Allgather a small fixed-shape host array across processes: returns
    the ``(process_count,) + arr.shape`` stack, in process order.

    The per-host partitioners (``halo.partition_halo`` on a
    ``RowBlockCSR``) combine their metadata partials through this — the
    payloads are O(hundreds of bytes), never data arrays.  Single-process
    runs get a leading axis of 1 without touching the collectives.
    """
    if not jax.distributed.is_initialized() or jax.process_count() == 1:
        return np.asarray(arr)[None]
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(np.asarray(arr)))
