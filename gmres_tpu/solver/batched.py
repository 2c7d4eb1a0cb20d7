"""Batched multi-RHS GMRES: solve A x_j = b_j for a batch of right-hand
sides in lockstep on one device.

A serving-oriented extension beyond the reference (which is strictly
single-RHS, ``gmres_perf_test.cpp``): the operator is staged ONCE and every
per-iteration kernel runs over the whole batch.  What amortizes — and what
cannot:

* per-solve fixed costs (dispatch round trips, one compiled program,
  one convergence chunk loop) amortize fully;
* the MATRIX bytes are shared across lanes, but at m=30 they are only
  ~7% of per-iteration traffic (D*n values vs 2*(m+1)*n basis reads) —
  each right-hand side owns its Krylov basis, so per-iteration bandwidth
  is inherently per-lane and the steady-state per-iteration ceiling is
  ~1.1x, NOT batch-size.  Lockstep masking (all lanes run until the
  slowest converges) eats further into the gain for heterogeneous RHS.

Design: ``restart_cycle_impl`` (solver/gmres.py) is a pure function of
``(b, x, norms, policy state)`` with the operator closed over, so the whole
restart cycle — SpMV, preconditioner, orthogonalization, Givens, policies,
solution update — batches with ONE ``jax.vmap``.  The chunked device loop
is re-derived with per-lane masking: finished lanes are frozen by selects
while the rest keep iterating (their cycle still computes under vmap's
both-branches semantics — the standard lockstep-batching trade).

Scope: banded operators ride the DIA path, whose SpMV becomes a shifted
SpMM over the B lanes.  The df64 tier, checkpointing, bf16
stall-escalation and the fp64 rescue are single-RHS features — use
``solve`` for those.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.config import GmresConfig
from gmres_tpu.ops.blas import nrm2
from gmres_tpu.precond.apply import typesafe_apply
from gmres_tpu.precond.build import build_preconditioner
from gmres_tpu.solver.gmres import (
    GmresResult,
    prepare_operators,
    restart_cycle_impl,
)
from gmres_tpu.solver.policies import PolicyState, initial_policy_state

_f64 = jnp.float64


def _batched_chunk(cfg: GmresConfig, chunk: int, A_out, A_in, M, B, X,
                   b_norms, minvb_norms, a_norm, pstates, stop0):
    """Up to ``chunk`` restart cycles for every active lane, one device
    dispatch.  Mirrors ``chunk_while`` with per-lane masking."""
    s = B.shape[0]

    def one(b, x, bn, mn, ps):
        return restart_cycle_impl(cfg, A_out, A_in, M, b, x, bn, mn,
                                  a_norm, ps)

    vcycle = jax.vmap(one)

    def cond(c):
        return (~jnp.all(c["stop"])) & (c["j"] < chunk)

    def body(c):
        j = c["j"]
        X_new, infos = vcycle(B, c["x"], b_norms, minvb_norms, c["pstate"])
        active = ~c["stop"]
        finite = jnp.isfinite(infos.rel_initial) & jnp.isfinite(infos.beta)
        div = ~finite
        conv = infos.converged0 & finite  # divergence wins (drive_restarts)
        x = jnp.where(active[:, None], X_new, c["x"])
        pstate = jax.tree.map(
            lambda new, old: jnp.where(
                active.reshape((s,) + (1,) * (new.ndim - 1)), new, old
            ),
            infos.pstate, c["pstate"],
        )
        return dict(
            x=x,
            pstate=pstate,
            j=j + 1,
            stop=c["stop"] | (active & (conv | div)),
            converged=jnp.where(active, conv, c["converged"]),
            diverged=jnp.where(active, div, c["diverged"]),
            ran=c["ran"].at[j].set(active),
            rel_initial=c["rel_initial"].at[j].set(infos.rel_initial),
            prec_rel0=c["prec_rel0"].at[j].set(infos.prec_rel0),
            k_final=c["k_final"].at[j].set(infos.k_final),
        )

    carry0 = dict(
        x=X,
        pstate=pstates,
        j=jnp.asarray(0, jnp.int32),
        stop=stop0,
        converged=jnp.zeros((s,), bool),
        diverged=jnp.zeros((s,), bool),
        ran=jnp.zeros((chunk, s), bool),
        rel_initial=jnp.zeros((chunk, s), _f64),
        prec_rel0=jnp.zeros((chunk, s), _f64),
        k_final=jnp.zeros((chunk, s), jnp.int32),
    )
    fin = jax.lax.while_loop(cond, body, carry0)
    return (fin["x"], fin["pstate"], fin["stop"], fin["j"], fin["converged"],
            fin["diverged"], fin["ran"], fin["rel_initial"],
            fin["prec_rel0"], fin["k_final"])


_batched_chunk_jit = jax.jit(_batched_chunk, static_argnums=(0, 1))


def solve_batched(A, B, cfg: GmresConfig | None = None, M=None,
                  record_history: bool = False) -> list[GmresResult]:
    """Solve ``A x_j = b_j`` for every row of ``B`` (shape ``(s, n)`` or a
    sequence of 1-D arrays) in one lockstep batch.  Returns one
    ``GmresResult`` per right-hand side, each equivalent to
    ``solve(A, B[j], cfg)`` (identical restart structure — the batching is
    a pure vectorization of the same cycle).
    ``record_history`` fills each result's per-cycle history like
    ``solve(record_history=True)``.

    Single-RHS-only features are rejected: df64 inner tier, distributed
    meshes (``cfg.axis_name``).  bf16 inner loops run without the stall
    escalation ``solve`` provides.
    """
    cfg = cfg or GmresConfig()
    if cfg.axis_name is not None:
        raise ValueError("solve_batched is single-device; use "
                         "solve_distributed for sharded solves")
    if cfg.precision.df64_inner:
        raise ValueError("solve_batched does not support the df64 inner "
                         "tier; use solve()")
    out_dt = jnp.dtype(cfg.precision.outer)
    in_dt = cfg.precision.inner_dtype

    B = jnp.asarray(np.stack([np.asarray(b) for b in B])
                    if not hasattr(B, "ndim") else B, dtype=out_dt)
    if B.ndim != 2 or B.shape[1] != A.n_rows:
        raise ValueError(f"B must be (batch, n={A.n_rows}); got {B.shape}")
    s = B.shape[0]

    t0 = time.perf_counter()
    if M is None:
        M = build_preconditioner(A, cfg)
    if cfg.auto_format:
        from gmres_tpu.precond.build import optimize_precond_format

        M = optimize_precond_format(M)
    A_out, A_in = prepare_operators(A, cfg)
    M = jax.device_put(M)
    prec_seconds = time.perf_counter() - t0

    t1 = time.perf_counter()
    X = jnp.zeros_like(B)
    b_norms = jax.vmap(nrm2)(B).astype(_f64)
    minvb_norms = jax.vmap(
        lambda b: nrm2(typesafe_apply(M, b.astype(in_dt)))
    )(B).astype(_f64)
    a_norm = nrm2(A_in.vals).astype(_f64)

    pstates = jax.tree.map(
        lambda leaf: jnp.broadcast_to(leaf, (s,) + leaf.shape),
        initial_policy_state(),
    )
    stop = jnp.zeros((s,), bool)
    converged = np.zeros((s,), bool)
    diverged = np.zeros((s,), bool)
    total_iters = np.zeros((s,), np.int64)
    restarts = np.zeros((s,), np.int64)
    rel_prec = np.full((s,), np.nan)
    hist = [[] for _ in range(s)] if record_history else None

    i = 0
    while i < cfg.max_restarts:
        chunk = min(cfg.host_sync_every, cfg.max_restarts - i)
        (X, pstates, stop, n_run, conv, div, ran, rels, precs, ks) = \
            _batched_chunk_jit(cfg, chunk, A_out, A_in, M, B, X,
                               b_norms, minvb_norms, a_norm, pstates, stop)
        n_run, conv, div, ran, rels, precs, ks = jax.device_get(
            (n_run, conv, div, ran, rels, precs, ks))
        n_run = int(n_run)
        # per-lane bookkeeping with drive_restarts semantics: a lane's
        # LAST ran row, when it latched conv/div this chunk, is the
        # terminal check — it counts neither an iteration nor a restart
        # (and a diverging row records no history, a converging one
        # records k=0)
        for lane in range(s):
            rows = np.nonzero(ran[:n_run, lane])[0]
            newly = bool(conv[lane] or div[lane]) and not bool(
                converged[lane] or diverged[lane])
            for idx, j in enumerate(rows):
                if newly and idx == rows.size - 1:
                    converged[lane] = bool(conv[lane])
                    diverged[lane] = bool(div[lane])
                    if conv[lane]:
                        rel_prec[lane] = float(precs[j, lane])
                        if record_history:
                            hist[lane].append(dict(
                                i=int(restarts[lane]), k=0,
                                rel_initial=float(rels[j, lane]),
                                prec_rel0=float(precs[j, lane])))
                else:
                    if record_history:
                        hist[lane].append(dict(
                            i=int(restarts[lane]), k=int(ks[j, lane]),
                            rel_initial=float(rels[j, lane]),
                            prec_rel0=float(precs[j, lane])))
                    total_iters[lane] += int(ks[j, lane])
                    restarts[lane] += 1
        i += n_run
        if bool(np.all(jax.device_get(stop))) or n_run == 0:
            break

    solve_seconds = time.perf_counter() - t1
    X_host = X  # one device array; per-lane views below are cheap slices
    out = []
    for lane in range(s):
        out.append(GmresResult(
            x=X_host[lane],
            converged=bool(converged[lane]),
            aborted=bool(diverged[lane]) or (not converged[lane]),
            total_iters=int(total_iters[lane]),
            restarts=int(restarts[lane]),
            final_k=0,
            rel_prec_res=float(rel_prec[lane]),
            diverged=bool(diverged[lane]),
            prec_seconds=prec_seconds,
            solve_seconds=solve_seconds,
            history=hist[lane] if record_history else None,
        ))
    return out
