"""Distributed GMRES over a 1-D device mesh (shard_map).

The same restart-cycle code as the single-device solver runs inside
``shard_map``: each shard rebuilds its local CSR block and the cycle's
reductions (`nrm2`/`dot`/Gram matvecs) psum over the ``rows`` axis while the
SpMV all-gathers its operand (SURVEY.md §5.8).  The host driver loop is
shared with the single-device path (``solver/gmres.py:drive_restarts``).

Scalar results (norms, policy state, iteration counts) are replicated
across shards by construction — every shard computes them from psum'd
reductions — so one host fetch per restart serves the whole mesh.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gmres_tpu.config import GmresConfig, Precond
from gmres_tpu.ops.blas import nrm2
from gmres_tpu.precond.apply import typesafe_apply
from gmres_tpu.precond.build import (
    IdentityPrec,
    ILUJacobiPrec,
    JacobiPrec,
    build_preconditioner,
)
from gmres_tpu.parallel.partition import (
    PartitionedCSR,
    pad_vector,
    partition_rows,
)
from gmres_tpu.solver.gmres import (
    GmresResult,
    chunk_while,
    drive_restarts,
    prepare_operators,
    restart_cycle_impl,
)

from gmres_tpu.sparse import CSRMatrix

_f64 = jnp.float64
AXIS = "rows"

# id-keyed, weakref-cleaned staging cache for partitioned+uploaded operators
# (the same pattern as solver.gmres._STAGING_CACHE)
_DIST_STAGE_CACHE: dict = {}


def _dist_stage_cache_get(A, key):
    import weakref  # noqa: F401

    entry = _DIST_STAGE_CACHE.get(id(A))
    if entry is not None and entry[0]() is A:
        return entry[1].get(key)
    return None


def _dist_stage_cache_put(A, key, value):
    import weakref

    entry = _DIST_STAGE_CACHE.get(id(A))
    if entry is None or entry[0]() is not A:
        aid = id(A)
        entry = (weakref.ref(A, lambda _, i=aid: _DIST_STAGE_CACHE.pop(i, None)), {})
        _DIST_STAGE_CACHE[id(A)] = entry
    entry[1][key] = value


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("lower", "upper", "inv_diag"),
    meta_fields=("steps",),
)
@dataclasses.dataclass(frozen=True)
class DistILUJacobiPrec:
    """Row-partitioned ILU-Jacobi factors (global padded inv_diag is
    sharded alongside)."""

    lower: PartitionedCSR
    upper: PartitionedCSR
    inv_diag: jax.Array
    steps: int


@dataclasses.dataclass(frozen=True)
class _PendingBILU:
    """Host-side marker: block-Jacobi ILU factors are built AT partition
    time (they need the final shard height, which depends on format
    routing) — see ``_partition_prec`` / ``precond/bilu.py``."""

    steps: int
    dtype: np.dtype


def _partition_matrix(A: CSRMatrix, n_shards: int, use_halo: bool,
                      owned=None, exchange=None):
    """Halo partition when the pattern allows (neighbor-local coupling),
    else the allgather row partition.  ``owned``: per-host mode — only
    those shards' arrays are materialized (multi-host, SURVEY.md §5.8).
    ``exchange``: host allgather combining metadata partials when ``A`` is
    a per-host ``RowBlockCSR``."""
    if use_halo:
        from gmres_tpu.parallel.halo import partition_halo

        H = partition_halo(A, n_shards, owned=owned, exchange=exchange)
        if H is not None:
            return H
    return partition_rows(A, n_shards, owned=owned)


def process_row_range(mesh: Mesh, n: int, owned=None,
                      rows_per: int | None = None) -> tuple[int, int]:
    """The contiguous global row range this process's shards cover on a
    1-D row mesh — the range to pass to ``load_matrix_rows`` for pod-scale
    per-host input.  ``rows_per`` overrides the shard height (pass
    ``sell_rows_per(n, P)`` when the solve will force the SELL format).
    Raises if the process's shards are not contiguous in the mesh (an
    exotic device assignment this input form does not support)."""
    if owned is None:
        pid = jax.process_index()
        owned = [s for s, d in enumerate(mesh.devices.flat)
                 if d.process_index == pid]
    owned = sorted(owned)
    if owned and owned != list(range(owned[0], owned[-1] + 1)):
        raise ValueError(
            f"process shards {owned} are not contiguous; per-host row-block "
            "input needs a contiguous shard-per-process mesh layout"
        )
    from gmres_tpu.parallel.partition import padded_size

    r = (rows_per if rows_per is not None
         else padded_size(n, mesh.devices.size) // mesh.devices.size)
    if not owned:
        return 0, 0
    return min(owned) * r, min(n, (max(owned) + 1) * r)


def _partition_prec(M, n_shards: int, use_halo: bool = True,
                    rows_per: int | None = None, owned=None,
                    A=None, exchange=None):
    """``rows_per`` (from a SELL-partitioned operator) forces every piece
    onto the same ROWS_PER_BLOCK-aligned shard height.  ``A``/``exchange``
    serve the block-Jacobi ILU build (factors are per-shard, so they are
    built here where the final shard height is known)."""
    if isinstance(M, IdentityPrec):
        return M
    if isinstance(M, _PendingBILU):
        from gmres_tpu.parallel.partition import padded_size
        from gmres_tpu.precond.bilu import build_bilu_jacobi

        r = (rows_per if rows_per is not None
             else padded_size(A.n_rows, n_shards) // n_shards)
        return build_bilu_jacobi(A, n_shards, r, M.dtype, M.steps,
                                 owned=owned, exchange=exchange)
    if isinstance(M, JacobiPrec):
        # padded rows get inv_diag 1.0: they only ever see zero inputs
        pad = pad_vector(np.asarray(M.inv_diag), n_shards, rows_per)
        n = np.asarray(M.inv_diag).shape[0]
        pad[n:] = 1.0
        return JacobiPrec(inv_diag=jnp.asarray(pad))
    if isinstance(M, ILUJacobiPrec):
        pad = pad_vector(np.asarray(M.inv_diag), n_shards, rows_per)
        n = np.asarray(M.inv_diag).shape[0]
        pad[n:] = 1.0
        if rows_per is not None:
            lower = partition_rows(M.lower, n_shards, rows_per=rows_per,
                                   owned=owned)
            upper = partition_rows(M.upper, n_shards, rows_per=rows_per,
                                   owned=owned)
        else:
            lower = _partition_matrix(M.lower, n_shards, use_halo, owned)
            upper = _partition_matrix(M.upper, n_shards, use_halo, owned)
        return DistILUJacobiPrec(
            lower=lower,
            upper=upper,
            inv_diag=jnp.asarray(pad),
            steps=M.steps,
        )
    raise TypeError(f"cannot partition {type(M)}")


def _localize_matrix(A):
    """Inside shard_map: PartitionedCSR blocks rebuild a local CSRMatrix;
    PartitionedSELL rebuilds the shard-local SELL pack; halo operators
    pass through (spmv dispatches on them directly)."""
    from gmres_tpu.parallel.sell_dist import PartitionedSELL

    if isinstance(A, PartitionedCSR):
        return A.local_block()
    if isinstance(A, PartitionedSELL):
        return A.local_sell()
    return A


def _localize_prec(M):
    """Inside shard_map: rebuild the shard-local preconditioner."""
    from gmres_tpu.precond.bilu import BlockILUCSR, BlockILUDia, localize_bilu

    if isinstance(M, DistILUJacobiPrec):
        return ILUJacobiPrec(
            lower=_localize_matrix(M.lower),
            upper=_localize_matrix(M.upper),
            inv_diag=M.inv_diag,
            steps=M.steps,
        )
    if isinstance(M, (BlockILUDia, BlockILUCSR)):
        return localize_bilu(M)
    return M


def _shard_map(f, mesh, in_specs, out_specs):
    try:
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False)
    except (AttributeError, TypeError):
        from jax.experimental.shard_map import shard_map as _sm

        return _sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=False)


import functools


@functools.lru_cache(maxsize=32)
def make_distributed_cycle(cfg: GmresConfig, mesh: Mesh):
    """shard_map'd restart cycle; same signature as restart_cycle_impl but
    over partitioned operands.

    Memoized on (cfg, mesh): the returned ``chunked`` jit must be the SAME
    callable across solve_distributed calls, or every solve recompiles the
    whole sharded cycle (measured ~10 s per call at n=1M)."""
    cfg = cfg.with_(axis_name=AXIS)

    def local_cycle(Ao, Ai, M, b, x, b_norm, minvb_norm, a_norm, pstate):
        A_out = _localize_matrix(Ao)
        A_in = _localize_matrix(Ai)
        M_loc = _localize_prec(M)
        return restart_cycle_impl(
            cfg, A_out, A_in, M_loc, b, x, b_norm, minvb_norm, a_norm, pstate
        )

    sharded = P(AXIS)
    repl = P()
    fn = _shard_map(
        local_cycle,
        mesh,
        in_specs=(sharded, sharded, sharded, sharded, sharded, repl, repl, repl, repl),
        out_specs=(sharded, repl),
    )

    # Chunked driver: up to `chunk` restarts per dispatch (chunk_while), the
    # shard_map'd cycle inside the device-side while_loop.
    @partial(jax.jit, static_argnums=(0,))
    def chunked(chunk, Ao, Ai, M, b, x, b_norm, minvb_norm, a_norm, pstate):
        return chunk_while(
            lambda xx, ps: fn(Ao, Ai, M, b, xx, b_norm, minvb_norm, a_norm, ps),
            chunk, x, pstate,
        )

    return chunked, cfg


def _dist_ckpt_hooks(checkpoint, mesh: Mesh, shard0, rows_per: int, owned,
                     exchange=None):
    """Checkpoint persistence for sharded x (SURVEY.md §5.4 at pod scale —
    preemption is the common case on large slices).  Each process saves
    its own contiguous block of shards to its own file
    (``<path>.p<process>``under multi-host); resume rebuilds the sharded
    array via ``make_array_from_callback``, so no process ever
    materializes global x.  Resume requires the same
    mesh/process layout as the save.

    A preemption can land BETWEEN two processes' saves, leaving the
    per-process files one interval apart; the returned ``consensus`` hook
    reconciles that on resume: processes exchange their (restart, iters,
    policy-state) headers and all adopt the LOWEST restart index (each
    keeps its own x block — a block saved a restart later is still a
    valid component of a starting iterate), so resume always succeeds
    without discarding progress."""
    import dataclasses as _dc

    n_shards = mesh.devices.size
    path = checkpoint.path
    if jax.process_count() > 1:
        path = f"{path}.p{jax.process_index()}"
    spec = (checkpoint if path == checkpoint.path
            else _dc.replace(checkpoint, path=path))
    owned_sorted = (sorted(owned) if owned is not None
                    else list(range(n_shards)))
    if owned_sorted != list(range(owned_sorted[0] if owned_sorted else 0,
                                  (owned_sorted[-1] + 1) if owned_sorted
                                  else 0)):
        raise ValueError(
            f"checkpointing needs contiguous per-process shards, got "
            f"{owned_sorted}; use a contiguous shard-per-process mesh layout"
        )
    lo = (min(owned_sorted) if owned_sorted else 0) * rows_per

    def to_host(x):
        shards = sorted(x.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards])

    def from_host(x_np):
        x_np = np.asarray(x_np)

        def cb(idx, a=x_np):
            s = idx[0].start if idx[0].start is not None else 0
            return a[s - lo : s - lo + rows_per]

        return jax.make_array_from_callback((rows_per * n_shards,), shard0, cb)

    def consensus(state):
        """Reconcile per-process resume headers (multi-host only)."""
        if exchange is None:
            return state
        from gmres_tpu.solver.policies import PolicyState

        if state is None:
            hdr = np.array([-1.0, 0, 0, 0, 0], np.float64)
        else:
            _, i, iters, ps = state
            hdr = np.array([
                i, iters, float(np.asarray(ps.is_first)),
                float(np.asarray(ps.second_restart_length)),
                float(np.asarray(ps.restart_tol)),
            ], np.float64)
        g = np.asarray(exchange(hdr))
        if (g[:, 0] < 0).any():
            # some process lost its file: no consistent set exists — start
            # fresh everywhere (lockstep; the checkpoint is best-effort)
            if state is not None:
                import warnings

                warnings.warn(
                    "checkpoint files missing on some processes; "
                    "restarting the solve from scratch"
                )
            return None
        j = int(np.argmin(g[:, 0]))
        if state is not None and int(state[1]) != int(g[j, 0]):
            import warnings

            warnings.warn(
                f"per-process checkpoints disagree (restart {int(state[1])} "
                f"here vs {int(g[j, 0])} minimum); adopting the minimum — "
                "each process resumes from its own x block"
            )
        pstate = PolicyState(
            is_first=jnp.asarray(g[j, 2] != 0),
            second_restart_length=jnp.asarray(np.int32(g[j, 3])),
            restart_tol=jnp.asarray(g[j, 4], jnp.float64),
        )
        return (state[0], int(g[j, 0]), int(g[j, 1]), pstate)

    return spec, to_host, from_host, consensus


@functools.lru_cache(maxsize=32)
def _make_bilu_minvb(cfg: GmresConfig, mesh: Mesh):
    """jitted ``||M^{-1} b||`` for block-ILU factors (device-side, the
    factors only exist in partitioned form).  Memoized on (cfg, mesh) so
    repeated solves reuse the compiled apply."""
    in_dt = cfg.precision.inner_dtype

    def local(Mv, bl):
        w = typesafe_apply(_localize_prec(Mv), bl.astype(in_dt), None)
        return jax.lax.psum(jnp.sum(w.astype(jnp.float64) ** 2), AXIS)

    fn = _shard_map(local, mesh, in_specs=(P(AXIS), P(AXIS)), out_specs=P())
    return jax.jit(lambda Mv, bl: jnp.sqrt(fn(Mv, bl)))


def solve_distributed(
    A: CSRMatrix,
    b,
    cfg: GmresConfig | None = None,
    mesh: Mesh | None = None,
    x0=None,
    record_history: bool = False,
    progress=None,
    multihost: bool = False,
    force_sell: bool = False,
    checkpoint=None,
) -> GmresResult:
    """Row-partitioned GMRES over all devices (or the given mesh).

    Operators are partitioned for halo exchange when their pattern is
    neighbor-local (``parallel/halo.py``: HaloDIA for banded patterns,
    HaloCSR otherwise), else by the allgather row partition.
    ``force_sell=True`` packs the operator as per-shard SELL instead
    (``parallel/sell_dist.py``); no automatic route picks it.

    ``multihost=True`` runs over a process-spanning mesh (SURVEY.md §5.8):
    call ``gmres_tpu.parallel.multihost.initialize`` (or
    ``jax.distributed.initialize``) first, then invoke this with identical
    arguments on EVERY process.  Each process PARTITIONS and uploads only
    the row blocks its local devices own (``ShardStack`` pieces served
    through ``jax.make_array_from_callback``; partition metadata comes
    from range-at-a-time structure scans, so peak host memory for the
    partitioned forms is ~global/P rather than P x global) and the
    driver's per-chunk fetch reads
    only replicated scalars, so all processes run the same host loop in
    lockstep.  ``result.x`` is then a global (process-spanning) array.
    Validated under 2 simulated CPU processes in tests/test_multihost.py.
    """
    from gmres_tpu.sparse import RowBlockCSR

    cfg = cfg or GmresConfig()
    if mesh is None:
        mesh = jax.make_mesh((len(jax.devices()),), (AXIS,))
    n_shards = mesh.devices.size
    out_dt = jnp.dtype(cfg.precision.outer)
    in_dt = cfg.precision.inner_dtype
    n = A.n_rows
    is_block = isinstance(A, RowBlockCSR)

    # per-host partitioning (SURVEY.md §5.8): over a process-spanning mesh,
    # each process materializes ONLY the shard blocks its local devices
    # own (ShardStack leaves) — partitioning an O(nnz) operator globally
    # on every host is a P x global host-RAM wall at pod scale
    owned = None
    exchange = None
    if multihost:
        from gmres_tpu.parallel.multihost import exchange_host_array

        pid = jax.process_index()
        owned = frozenset(
            s for s, d in enumerate(mesh.devices.flat)
            if d.process_index == pid
        )
        exchange = exchange_host_array
    # the SELL pack stores f32 values: it serves f32 inner cycles only
    want_sell = force_sell and in_dt == jnp.float32
    if is_block:
        # per-host INPUT (pod scale): this process never saw the global
        # entry arrays — only its loaded row block
        # (io.loader.load_matrix_rows).  Metadata partials go through the
        # host allgather; preconditioners that need the global pattern
        # (GLOBAL ILU(0) factorization is inherently a sequential pass)
        # are out of scope for this input form — block-Jacobi ILU
        # (precond='bilu_jacobi') is the per-host ILU.
        from gmres_tpu.parallel.multihost import exchange_host_array

        if cfg.precond not in (Precond.IDENTITY, Precond.JACOBI,
                               Precond.BILU_JACOBI):
            raise ValueError(
                f"prec={cfg.precond.value} needs the global matrix "
                "(global ILU(0) factorization is a sequential pass); "
                "per-host RowBlockCSR input supports identity/jacobi/"
                "bilu_jacobi (block-Jacobi ILU factors each shard's "
                "diagonal block locally) — pass the full CSRMatrix for "
                "global ILU preconditioning"
            )
        if owned is None:
            owned = frozenset(range(n_shards))
        exchange = exchange_host_array
        rows_per_need = None
        if want_sell:
            # SELL shards sit on a ROWS_PER_BLOCK-aligned grid wider than
            # ceil(n/P) — the loaded block must cover THAT range
            from gmres_tpu.parallel.sell_dist import sell_rows_per

            rows_per_need = sell_rows_per(n, n_shards)
        lo_need, hi_need = process_row_range(mesh, n, owned=owned,
                                             rows_per=rows_per_need)
        covers = A.row_lo <= lo_need and hi_need <= A.row_hi
        if not covers:
            raise ValueError(
                f"row block [{A.row_lo}, {A.row_hi}) does not cover this "
                f"process's shards (rows [{lo_need}, {hi_need})); load "
                f"with load_matrix_rows(path, {lo_need}, {hi_need})"
                + (" — force_sell uses the SELL ROWS_PER_BLOCK-aligned "
                   "shard grid (process_row_range(..., rows_per="
                   "sell_rows_per(n, P)))" if force_sell else "")
            )

    t0 = time.perf_counter()
    if is_block:
        from gmres_tpu.precond.build import build_jacobi_rowblock

        A_out = A.astype(np.dtype(out_dt))
        A_in = A.astype(np.dtype(in_dt))
        if cfg.precond == Precond.JACOBI:
            M = build_jacobi_rowblock(
                A, np.dtype(cfg.precision.precond_dtype), exchange
            )
        elif cfg.precond == Precond.BILU_JACOBI:
            M = _PendingBILU(steps=cfg.jacobi_steps,
                             dtype=np.dtype(cfg.precision.precond_dtype))
        else:
            M = IdentityPrec()
    else:
        # keep CSR here: the row partitioner consumes CSR (DIA repacking
        # for the distributed path happens per-shard in halo.py, not yet
        # globally)
        A_out, A_in = prepare_operators(A, cfg.with_(auto_format=False))
        if cfg.precond == Precond.BILU_JACOBI:
            M = _PendingBILU(steps=cfg.jacobi_steps,
                             dtype=np.dtype(cfg.precision.precond_dtype))
        else:
            M = build_preconditioner(A, cfg)
    prec_seconds = time.perf_counter() - t0
    stage_key = (n_shards, cfg.auto_format, str(out_dt), str(in_dt),
                 str(cfg.precision.precond_dtype), cfg.precond,
                 cfg.jacobi_steps, multihost, want_sell)

    t1 = time.perf_counter()
    # one-time norms on the unpartitioned operands (single-device, O(n))
    b_arr = jnp.asarray(np.asarray(b), dtype=out_dt)
    b_norm = nrm2(b_arr).astype(_f64)
    if isinstance(M, _PendingBILU):
        minvb_norm = None  # needs the partitioned factors; computed below
    else:
        minvb_norm = nrm2(typesafe_apply(M, b_arr.astype(in_dt))).astype(_f64)
    if is_block:
        # ||A||_F from per-process partial sums of squares over the
        # DISJOINT owned row range [lo_need, hi_need) — the loaded block
        # may be wider (neighbors' blocks may overlap) and summing all
        # loaded values would count overlap rows once per process,
        # silently loosening the convergence denominator
        _, av = A_in.entries(lo_need, hi_need)
        av = np.asarray(av, dtype=np.float64)
        ss = exchange(np.array([np.dot(av, av)])).sum()
        a_norm = jnp.asarray(np.sqrt(ss), dtype=_f64)
    elif multihost:
        # host-side ||A||_F: nrm2 on device would upload the full nnz-long
        # vals array to every process's device 0
        av = np.asarray(A_in.vals, dtype=np.float64)
        a_norm = jnp.asarray(np.sqrt(np.dot(av, av)), dtype=_f64)
    else:
        a_norm = nrm2(A_in.vals).astype(_f64)

    # partition + shard (halo exchange when the pattern is neighbor-local,
    # allgather otherwise; cfg.auto_format opts out).  Partitioning is
    # host-side numpy — cached per matrix object like prepare_operators.
    # Single-host: all shards are stacked locally.  Multi-host: ``owned``
    # limits materialization to this process's shards (ShardStack); the
    # metadata passes scan one row range at a time, so peak host memory is
    # ~global/P (+halo), not P x global.
    cached = _dist_stage_cache_get(A, stage_key)
    if cached is None:
        psell = None
        if want_sell:
            from gmres_tpu.parallel.sell_dist import partition_sell

            psell = partition_sell(A, n_shards, owned=owned,
                                   exchange=exchange)
        if psell is not None:
            Ai_p = psell
            rows_per = psell.rows_per_shard
            if out_dt == in_dt:
                Ao_p = psell
            else:
                # fp64 outer residual keeps the CSR allgather (runs once
                # per restart), on SELL's ROWS_PER_BLOCK-aligned shards
                Ao_p = partition_rows(A_out, n_shards, rows_per=rows_per,
                                      owned=owned)
            M_p = _partition_prec(M, n_shards, use_halo=False,
                                  rows_per=rows_per, owned=owned,
                                  A=A, exchange=exchange)
        else:
            Ao_p = _partition_matrix(A_out, n_shards, cfg.auto_format, owned,
                                     exchange)
            Ai_p = Ao_p if A_in is A_out else _partition_matrix(
                A_in, n_shards, cfg.auto_format, owned, exchange)
            M_p = _partition_prec(M, n_shards, cfg.auto_format, owned=owned,
                                  A=A, exchange=exchange)
        from gmres_tpu.parallel.partition import local_partition_nbytes

        partition_local_bytes = (
            local_partition_nbytes((Ao_p, M_p))
            + (local_partition_nbytes(Ai_p) if Ai_p is not Ao_p else 0)
        )
    else:
        Ao_p, Ai_p, M_p = cached
        partition_local_bytes = None

    shard0 = NamedSharding(mesh, P(AXIS))

    from gmres_tpu.parallel.partition import ShardStack

    def _to_device(a):
        if isinstance(a, jax.Array) and a.sharding == shard0:
            return a  # already staged on this mesh
        if isinstance(a, ShardStack):
            # per-host partitioned leaf: the callback serves shard s from
            # this process's owned piece (never asked for non-owned ones)
            def cb(idx, a=a):
                s = idx[0].start if idx[0].start is not None else 0
                return a.pieces[s][None]

            return jax.make_array_from_callback(a.shape, shard0, cb)
        a = np.asarray(a)
        if multihost:
            # per-host shard materialization: the callback is only invoked
            # for indices this process's devices own
            return jax.make_array_from_callback(
                a.shape, shard0, lambda idx, a=a: a[idx]
            )
        return jax.device_put(a, shard0)

    put = lambda t: jax.tree.map(_to_device, t)
    shared = Ao_p is Ai_p
    Ai_p = put(Ai_p)
    if shared:
        Ao_p = Ai_p
    else:
        Ao_p = put(Ao_p)
    M_p = put(M_p) if not isinstance(M_p, IdentityPrec) else M_p
    if cached is None:
        _dist_stage_cache_put(A, stage_key, (Ao_p, Ai_p, M_p))

    # per-shard vector length follows the partitioned operator (SELL
    # shards are ROWS_PER_BLOCK-aligned, larger than ceil(n/P))
    rows_eff = getattr(Ai_p, "rows_per_shard", None)
    b_pad = _to_device(pad_vector(np.asarray(b, dtype=out_dt), n_shards,
                                  rows_eff))
    if minvb_norm is None:
        # block-Jacobi ILU: ||M^{-1}b|| needs the partitioned factors —
        # one tiny shard_map'd apply (communication: a single psum);
        # padded rows contribute exact zeros (empty factor rows, b=0)
        minvb_norm = _make_bilu_minvb(cfg, mesh)(M_p, b_pad).astype(_f64)
    if x0 is None:
        x = jax.jit(jnp.zeros_like, out_shardings=shard0)(b_pad)
    else:
        x = _to_device(pad_vector(np.asarray(x0, dtype=out_dt), n_shards,
                                  rows_eff))

    cycle, dist_cfg = make_distributed_cycle(cfg, mesh)

    def chunk_call(x, pstate, chunk):
        return cycle(chunk, Ao_p, Ai_p, M_p, b_pad, x, b_norm, minvb_norm,
                     a_norm, pstate)

    ckpt_spec = to_host = from_host = consensus = None
    if checkpoint is not None:
        from gmres_tpu.parallel.partition import padded_size

        ckpt_spec, to_host, from_host, consensus = _dist_ckpt_hooks(
            checkpoint, mesh, shard0,
            rows_eff or padded_size(n, n_shards) // n_shards,
            owned, exchange=exchange if multihost else None,
        )

    result = drive_restarts(chunk_call, x, dist_cfg, record_history, progress,
                            checkpoint=ckpt_spec,
                            ckpt_x_to_host=to_host,
                            ckpt_x_from_host=from_host,
                            ckpt_consensus=consensus)
    result.prec_seconds = prec_seconds
    # host bytes this process materialized for the partitioned operator
    # forms (None when served from the staging cache); the multi-host test
    # asserts this is ~global/P, not P x global
    result.partition_local_bytes = partition_local_bytes
    result.solve_seconds = time.perf_counter() - t1
    # slice the padding off under jit: multihost arrays have
    # non-addressable shards, and even single-host eager slicing of a
    # sharded array at a non-shard-aligned boundary (SELL's
    # ROWS_PER_BLOCK-padded shards) is an unresolvable eager gather
    if result.x.shape[0] != n:
        result.x = jax.jit(lambda a: a[:n])(result.x)
    return result


def dryrun(n_devices: int) -> None:
    """Compile + run one distributed step on tiny shapes (driver hook)."""
    from gmres_tpu.config import PrecisionSpec
    from gmres_tpu.io.rng import rand_vect
    from gmres_tpu.io.synth import poisson_2d
    from gmres_tpu.ops.spmv import spmv

    devs = jax.devices()[:n_devices]
    mesh = Mesh(np.array(devs), (AXIS,))
    A = poisson_2d(10)  # n=100
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(spmv(A, jnp.asarray(x_true)))
    cfg = GmresConfig(
        precision=PrecisionSpec.from_mode("mixed"),
        orth="cgsr",
        precond="ilu_jacobi",
        jacobi_steps=2,
        restart_length=8,
        tol=1e-8,
        max_restarts=50,
    )
    res = solve_distributed(A, b, cfg, mesh=mesh)
    assert res.converged, "distributed dryrun failed to converge"
    err = float(np.linalg.norm(np.asarray(res.x) - x_true))
    assert err < 1e-4, f"distributed dryrun error too large: {err}"
