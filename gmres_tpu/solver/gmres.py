"""Restarted GMRES(m), run on the device.

The reference's solvers (``gmres_baseline``/``gmres_singleUpdate``,
``gmres.cpp:24-245``) synchronize with the host every inner iteration (a
device fence plus a scalar read of ``|s(k+1)|``, ``gmres.cpp:113-114``) and
once more for every ``h(k+1,k)`` normalization.  On an accelerator that
structure is latency-bound, so the design here inverts it:

- **one jitted function per restart cycle** (static restart length m): the
  fp-high residual, the preconditioned norms, the whole Arnoldi/Givens inner
  loop (``lax.while_loop``), the restart-policy predicate, and the
  solution update all run on device;
- the host loop does exactly one scalar fetch per *restart*, implementing
  the reference's ``check_initial`` bookkeeping (restart counting, abort,
  convergence detection — which in the reference only ever fires at restart
  boundaries, SURVEY.md §2.2);
- all four precision modes are one code path with explicit dtype staging
  (``PrecisionSpec``): the reference's ``gmres_baseline`` is
  inner==outer, ``gmres_singleUpdate`` is fp64-outer/fp32-inner with the
  solution increment promoted before accumulation
  (``gmres.cpp:276-290``, ``Orthogonalization.hpp:67-73``).

Numerical contract parity (see SURVEY.md §2.2): initial convergence uses the
unpreconditioned residual against ``||b|| + ||A||_F ||x||`` with
``||A||_F`` taken from the *inner-dtype* values array; ``r_norm`` is
measured after the cast to the inner dtype; Givens rotations, the
``s=[beta,0,...]`` right-hand side, and the restart policies follow the
reference exactly.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu import backend
from gmres_tpu.config import GmresConfig, RestartPolicy
from gmres_tpu.ops.blas import nrm2
from gmres_tpu.ops.givens import accumulate_rotation, rotg
from gmres_tpu.ops.orth import orthonormalize_step, _masked_gram
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.ops.tri import trsv_upper_padded
from gmres_tpu.precond.apply import typesafe_apply
from gmres_tpu.precond.build import build_preconditioner
from gmres_tpu.solver.policies import PolicyState, initial_policy_state
from gmres_tpu.sparse import CSRMatrix

_HI = jax.lax.Precision.HIGHEST
_f64 = jnp.float64


class CycleInfo(NamedTuple):
    """Per-restart scalars returned to the host (one fetch per cycle)."""

    converged0: jax.Array    # bool: check_initial convergence test
    r_norm: jax.Array        # f64: unpreconditioned residual norm
    beta: jax.Array          # f64: preconditioned residual norm
    rel_initial: jax.Array   # f64: r_norm / (||b|| + ||A||_F ||x||)
    prec_rel0: jax.Array     # f64: beta / ||M^{-1} b||
    k_final: jax.Array       # i32: inner iterations this cycle
    arnoldi_final: jax.Array  # f64: |s(k+1)| at cycle end
    pstate: PolicyState


def _givens_policy_step(cfg: GmresConfig, c: dict, h_col, h_next, beta,
                        restart_tol, pstate: PolicyState, minvb_norm,
                        gram_vnext):
    """The Givens + restart-policy tail of one Arnoldi iteration, shared
    by the native-dtype and df64 inner loops (the H/Q/S dtype follows the
    carry).  ``gram_vnext()`` returns the masked <v_j, v_{k+1}> Gram
    vector for the orth-loss S-recurrence; called only under that policy.
    Returns the updated carry WITHOUT the basis entries (callers add V)."""
    m = cfg.m
    H, Q = c["H"], c["Q"]
    k = c["k"]
    k1 = k + 1
    # Apply all k previous rotations at once (rows > k of Q are
    # still identity, so hhat[k+1] = h_next), then generate + fold
    # in the new rotation (gmres.cpp:106-110, vectorized).
    hhat = jnp.matmul(Q, h_col, precision=_HI)
    r_, c_, s_ = rotg(hhat[k], hhat[k + 1])
    hhat = hhat.at[k].set(r_).at[k + 1].set(0)
    Q = accumulate_rotation(Q, k, c_, s_)
    # Happy-breakdown guard (explicit divergence from the reference,
    # which divides by zero here — Orthogonalization.hpp:59): when
    # h(k+1,k) == 0 the Krylov space is A-invariant; later columns are
    # vacuous zeros whose zero pivots would poison the triangular
    # solve (0 * inf = NaN).  ``kdim`` counts the columns usable by
    # the solution update: it advances only while no breakdown has
    # occurred AND the new R diagonal r_kk is nonzero (r_kk == 0 with
    # h_next == 0 means even column k is degenerate — e.g. beta == 0).
    # Post-breakdown iterations are harmless identity rotations
    # (rotg(0,0) = (1,0)).
    kdim = jnp.where(c["bd"] | (r_ == 0), c["kdim"], k1)
    bd = c["bd"] | (h_next == 0) | (r_ == 0)
    H = jax.lax.dynamic_update_slice(
        H, hhat[:, None], (jnp.zeros((), k.dtype), k)
    )
    # |s(k+1)| with s = Q @ (beta e1)
    arnoldi = jnp.abs(beta * Q[k1, 0]).astype(_f64)
    arn = c["arn"].at[k].set(arnoldi)

    # --- restart policy (IterUtil.hpp check()) ---
    pol_trigger = jnp.asarray(False)
    if cfg.policy == RestartPolicy.REL_PREC_RES:
        pol_trigger = arnoldi / minvb_norm <= restart_tol
    elif cfg.policy == RestartPolicy.REPEAT_ITERATION:
        pol_trigger = jnp.where(
            pstate.is_first,
            arnoldi / minvb_norm <= restart_tol,
            pstate.second_restart_length <= k1,
        )
    loss_sq = c["loss_sq"]
    S = c["S"]
    if cfg.policy == RestartPolicy.LOST_ORTHOGONALITY:
        mask = jnp.arange(m + 1) <= k
        u = gram_vnext()
        s_col = u - jnp.matmul(S[: m + 1, : m + 1], u, precision=_HI)
        s_col = jnp.where(mask, s_col, 0)
        S = jax.lax.dynamic_update_slice(S, s_col[:, None], (jnp.int32(0), k1))
        loss_sq = loss_sq + jnp.dot(s_col, s_col, precision=_HI).astype(_f64)
        pol_trigger = pol_trigger | (loss_sq >= cfg.restart_improvement**2)
    trig_k = jnp.minimum(
        c["trig_k"], jnp.where(pol_trigger, k1, jnp.asarray(m, jnp.int32))
    )
    restart = (cfg.m <= k1) | pol_trigger

    return dict(H=H, Q=Q, S=S, k=k1, kdim=kdim, bd=bd,
                done=restart, loss_sq=loss_sq, trig_k=trig_k, arn=arn)


def _inner_cycle(cfg: GmresConfig, A_in: CSRMatrix, M, w0, beta, restart_tol,
                 pstate: PolicyState, minvb_norm, n_local: int):
    """The Arnoldi / Givens / policy inner loop.  Returns (y @ V update
    pieces, k_final)."""
    axis = cfg.axis_name
    in_dt = cfg.precision.inner_dtype
    m = cfg.m
    orthloss = cfg.policy == RestartPolicy.LOST_ORTHOGONALITY
    # FIXED policy never exits the cycle early (IterUtil.hpp:57-65 just
    # counts to restart_length), so its inner loop has a static trip count
    # (a fori_loop, unrolled where ``backend.unroll_inner()`` says so:
    # every dynamic index becomes static and the small Givens/bookkeeping
    # ops of consecutive iterations can fuse).
    #
    # With ``unroll_inner`` the non-FIXED policies run the SAME static loop:
    # the cycle runs all m iterations and the restart trigger is selected
    # post hoc.  This is numerically identical to early exit because a
    # Givens rotation G_j only mixes rows j, j+1 — iterations past the
    # trigger t touch only s[j >= t] and H columns >= t, which the solution
    # update (bounded by kdim = t) never reads; the per-iteration |s(k+1)|
    # proxy is recorded before later rotations can touch its row.  The
    # trade: up to m - t wasted iterations per cycle against a rolled
    # while_loop's per-iteration launch overhead.
    unroll_all = cfg.policy == RestartPolicy.FIXED or backend.unroll_inner()

    # Compressed-basis tier (CB-GMRES, config.py:PrecisionSpec.basis): V is
    # STORED narrower than the arithmetic; w, H, Givens and every reduction
    # stay in the inner dtype — rounding happens only at the V row store.
    basis_dt = cfg.precision.basis_dtype
    V0 = jnp.zeros((m + 1, n_local), dtype=basis_dt)
    v0 = jnp.where(beta != 0, w0 / beta, jnp.zeros_like(w0))
    V0 = V0.at[0].set(v0.astype(basis_dt))
    H0 = jnp.zeros((m + 1, m), dtype=in_dt)
    # Accumulated rotation product Q = G_{k-1}...G_0 (see
    # ops/givens.py:accumulate_rotation); the Givens RHS is s = beta*Q[:,0].
    Q0 = jnp.eye(m + 1, dtype=in_dt)
    S0 = jnp.zeros((m + 1, m + 1), dtype=in_dt) if orthloss else jnp.zeros((1, 1), in_dt)

    # One-reduce ICWY MGS (ops/orth.py:mgs_lowsync_step): AUTO-on where
    # ``backend.lowsync_mgs_auto`` says so — always for distributed solves,
    # whose k+1 sequential allreduces it replaces with one.  Sequential
    # remains the reference-parity escape hatch (low_sync_mgs=False);
    # carry the strictly-lower triangular basis-coupling matrix L,
    # built one row per step.  AUTO leaves fp64 cycles (the uniform-fp64
    # baseline tier) on the sequential recurrence; low_sync_mgs=True
    # forces ICWY there too.
    lowsync = cfg.orth.value == "mgs" and (
        cfg.low_sync_mgs is True
        or (cfg.low_sync_mgs is None
            and in_dt != jnp.float64
            and backend.lowsync_mgs_auto(axis is not None)))
    acc_dt = _f64 if in_dt == jnp.float64 else jnp.float32

    carry0 = dict(
        V=V0, H=H0, Q=Q0, S=S0,
        k=jnp.asarray(0, jnp.int32),
        kdim=jnp.asarray(0, jnp.int32),
        bd=jnp.asarray(False),
        done=jnp.asarray(False),
        loss_sq=jnp.asarray(0.0, _f64),
        trig_k=jnp.asarray(m, jnp.int32),   # first k1 where the policy fired
        arn=jnp.zeros((max(m, 1),), _f64),  # |s(k+1)| after iteration k
    )
    if lowsync:
        carry0["L"] = jnp.zeros((m + 1, m + 1), acc_dt)

    def cond(c):
        return ~c["done"]

    def body(c):
        V = c["V"]
        k = c["k"]

        v_k = jax.lax.dynamic_index_in_dim(V, k, axis=0, keepdims=False)
        w = spmv(A_in, v_k.astype(in_dt), axis)
        w = typesafe_apply(M, w, axis)

        if lowsync:
            from gmres_tpu.ops.orth import mgs_lowsync_step

            h_col, w, ss_loc, L_new = mgs_lowsync_step(V, k, w, c["L"], axis)
            ss = jax.lax.psum(ss_loc, axis) if axis is not None else ss_loc
            h_next = jnp.sqrt(ss).astype(in_dt)
        else:
            h_col, w, h_next = orthonormalize_step(
                cfg.orth.value, V, k, w, axis, cfg.orth_steps,
                assume_zero_tail=True,
            )
        # The reference divides unconditionally (Orthogonalization.hpp:59 —
        # no happy-breakdown guard); we guard the h==0 case to a zero vector
        # (mirrors first_vector's beta==0 branch) instead of poisoning with NaN.
        v_next = jnp.where(h_next != 0, w / h_next, jnp.zeros_like(w))
        V = jax.lax.dynamic_update_index_in_dim(
            V, v_next.astype(basis_dt), k + 1, axis=0)
        h_col = h_col.at[k + 1].set(h_next)

        def gram_vnext():
            # S-recurrence Gram vector <v_j, v_{k+1}> for j<=k
            # (IterUtil.hpp:200-223)
            return _masked_gram(V, v_next, k, axis)

        out = _givens_policy_step(cfg, c, h_col, h_next, beta, restart_tol,
                                  pstate, minvb_norm, gram_vnext)
        out["V"] = V
        if lowsync:
            out["L"] = L_new
        return out

    return _run_inner(cond, body, carry0, m, unroll_all)


def _run_inner(cond, body, carry0, m, unroll_all):
    if unroll_all:
        # static trip count: a fori_loop, unrolled (dynamic indices become
        # static, small ops fuse across iterations) where the backend says
        # that is worth its compile time
        final = jax.lax.fori_loop(
            0, m, lambda i, c: body(c), carry0, unroll=backend.unroll_inner()
        )
        # post-hoc trigger selection: the cycle effectively ended at trig_k
        final["k"] = jnp.minimum(final["k"], final["trig_k"])
        final["kdim"] = jnp.minimum(final["kdim"], final["trig_k"])
    else:
        final = jax.lax.while_loop(cond, body, carry0)
        final["k"] = jnp.minimum(final["k"], final["trig_k"])
    return final


def _inner_cycle_df64(cfg: GmresConfig, A_in, M, w0h, w0l, beta, restart_tol,
                      pstate: PolicyState, minvb_norm, n_local: int):
    """The df64 inner Arnoldi loop (``PrecisionSpec.df64_inner``): the
    Krylov basis and work vectors are (hi, lo) fp32 pairs with error-free
    transforms (``ops/df64.py``, ~2^-48 accuracy), while the O(m^2)
    scalar machinery (H, Q, Givens, policies) stays true fp64 — it is
    tiny, and keeping it fp64 makes this tier converge like the
    all-fp64 baseline without emulated-fp64 arrays in the O(n·m) work.
    Mirrors ``_inner_cycle`` (shared ``_givens_policy_step`` tail)."""
    from gmres_tpu.ops.df64 import (
        df_gram,
        df_orthonormalize_step,
        df_scale,
        split_f64,
        spmv_df64_pair,
        typesafe_apply_df64,
    )

    axis = cfg.axis_name
    m = cfg.m
    orthloss = cfg.policy == RestartPolicy.LOST_ORTHOGONALITY
    # same auto-on rule as the native-dtype cycle above;
    # low_sync_mgs=False restores the sequential reference-parity recurrence
    lowsync = cfg.orth.value == "mgs" and (
        cfg.low_sync_mgs is True
        or (cfg.low_sync_mgs is None
            and backend.lowsync_mgs_auto(axis is not None)))
    unroll_all = cfg.policy == RestartPolicy.FIXED or backend.unroll_inner()

    Vh0 = jnp.zeros((m + 1, n_local), jnp.float32)
    Vl0 = jnp.zeros_like(Vh0)
    inv_beta = jnp.where(beta != 0, 1.0 / beta, jnp.zeros_like(beta))
    v0h, v0l = df_scale(w0h, w0l, *split_f64(inv_beta))
    Vh0 = Vh0.at[0].set(v0h)
    Vl0 = Vl0.at[0].set(v0l)

    carry0 = dict(
        Vh=Vh0, Vl=Vl0,
        H=jnp.zeros((m + 1, m), _f64),
        Q=jnp.eye(m + 1, dtype=_f64),
        S=(jnp.zeros((m + 1, m + 1), _f64) if orthloss
           else jnp.zeros((1, 1), _f64)),
        k=jnp.asarray(0, jnp.int32),
        kdim=jnp.asarray(0, jnp.int32),
        bd=jnp.asarray(False),
        done=jnp.asarray(False),
        loss_sq=jnp.asarray(0.0, _f64),
        trig_k=jnp.asarray(m, jnp.int32),
        arn=jnp.zeros((max(m, 1),), _f64),
    )
    if lowsync:
        carry0["L"] = jnp.zeros((m + 1, m + 1), _f64)

    def cond(c):
        return ~c["done"]

    def body(c):
        Vh, Vl = c["Vh"], c["Vl"]
        k = c["k"]

        vkh = jax.lax.dynamic_index_in_dim(Vh, k, axis=0, keepdims=False)
        vkl = jax.lax.dynamic_index_in_dim(Vl, k, axis=0, keepdims=False)
        wh, wl = spmv_df64_pair(A_in, vkh, vkl, axis)
        wh, wl = typesafe_apply_df64(M, wh, wl, axis)

        if lowsync:
            from gmres_tpu.ops.df64 import _psum_pairs, df_mgs_lowsync_step, merge_f64

            h_col, (wh, wl), (ssh, ssl), L_new = df_mgs_lowsync_step(
                Vh, Vl, k, wh, wl, c["L"], axis)
            if axis is not None:
                ssh, ssl = _psum_pairs(ssh, ssl, axis)
            h_next = jnp.sqrt(merge_f64(ssh, ssl))
        else:
            h_col, (wh, wl), h_next = df_orthonormalize_step(
                cfg.orth.value, Vh, Vl, k, wh, wl, axis, cfg.orth_steps,
            )
        inv_h = jnp.where(h_next != 0, 1.0 / h_next, jnp.zeros_like(h_next))
        vnh, vnl = df_scale(wh, wl, *split_f64(inv_h))
        Vh = jax.lax.dynamic_update_index_in_dim(Vh, vnh, k + 1, axis=0)
        Vl = jax.lax.dynamic_update_index_in_dim(Vl, vnl, k + 1, axis=0)
        h_col = h_col.at[k + 1].set(h_next)

        def gram_vnext():
            u = df_gram(Vh, Vl, vnh, vnl, axis)
            return jnp.where(jnp.arange(m + 1) <= k, u, 0)

        out = _givens_policy_step(cfg, c, h_col, h_next, beta, restart_tol,
                                  pstate, minvb_norm, gram_vnext)
        out["Vh"] = Vh
        out["Vl"] = Vl
        if lowsync:
            out["L"] = L_new
        return out

    return _run_inner(cond, body, carry0, m, unroll_all)


def restart_cycle_impl(cfg: GmresConfig, A_out: CSRMatrix, A_in: CSRMatrix, M,
                       b, x, b_norm, minvb_norm, a_norm, pstate: PolicyState):
    """One outer iteration: residual, check_initial quantities, inner
    Arnoldi loop (skipped when already converged), solution update."""
    axis = cfg.axis_name
    in_dt = cfg.precision.inner_dtype
    out_dt = jnp.dtype(cfg.precision.outer)
    m = cfg.m

    df64_in = cfg.precision.df64_inner
    # r = b - A x in the outer dtype (gmres.cpp:62-63, 172-174)
    r = b - spmv(A_out, x, axis)
    if df64_in:
        from gmres_tpu.ops.df64 import df_norm, split_f64, typesafe_apply_df64

        r_norm = nrm2(r, axis).astype(_f64)
        w0h, w0l = typesafe_apply_df64(
            M, *split_f64(r.astype(jnp.float64)), axis)
        beta = df_norm(w0h, w0l, axis)
    else:
        w0 = r.astype(in_dt)
        r_norm = nrm2(w0, axis).astype(_f64)
        w0 = typesafe_apply(M, w0, axis)
        beta = nrm2(w0, axis)
    x_norm = nrm2(x, axis).astype(_f64)

    rel_initial = r_norm / (b_norm + a_norm * x_norm)
    converged0 = rel_initial <= cfg.tol
    prec_rel0 = beta.astype(_f64) / minvb_norm

    # restart-policy threshold for this cycle
    if cfg.policy == RestartPolicy.REL_PREC_RES:
        restart_tol = prec_rel0 * cfg.restart_improvement
    elif cfg.policy == RestartPolicy.REPEAT_ITERATION:
        restart_tol = jnp.where(
            pstate.is_first, prec_rel0 * cfg.restart_improvement, pstate.restart_tol
        )
    else:
        restart_tol = pstate.restart_tol

    n_local = x.shape[0]

    def run(x):
        if df64_in:
            final = _inner_cycle_df64(cfg, A_in, M, w0h, w0l, beta,
                                      restart_tol, pstate, minvb_norm,
                                      n_local)
        else:
            final = _inner_cycle(cfg, A_in, M, w0, beta, restart_tol, pstate,
                                 minvb_norm, n_local)
        k_fin = final["k"]
        # solution_update (gmres.cpp:276-303): y = H[:k,:k]^{-1} s[:k];
        # x += V[:,:k] y, promoted to the outer dtype in mixed mode.
        # s = Q @ (beta e1) (ops/givens.py:accumulate_rotation).
        # kdim (== k_fin except after a happy breakdown) bounds the
        # triangular solve to the valid columns.
        s_fin = beta * final["Q"][:, 0]
        y = trsv_upper_padded(final["H"][:m, :m], s_fin[:m], final["kdim"])
        if df64_in:
            from gmres_tpu.ops.df64 import df_basis_comb, merge_f64

            inch, incl = df_basis_comb(final["Vh"][:m], final["Vl"][:m], y)
            x_new = x + merge_f64(inch, incl).astype(out_dt)
        else:
            x_inc = jnp.matmul(y, final["V"][:m], precision=_HI)
            x_new = x + x_inc.astype(out_dt)
        # |s(k+1)| at the (possibly post-hoc) cycle end: read the recorded
        # per-iteration proxy — rotations after the trigger have already
        # touched row k_fin of Q, so s_fin[k_fin] would be stale
        arnoldi_final = final["arn"][jnp.maximum(k_fin - 1, 0)]
        new_pstate = PolicyState(
            is_first=jnp.asarray(False),
            second_restart_length=jnp.where(
                pstate.is_first, k_fin, pstate.second_restart_length
            ).astype(jnp.int32),
            restart_tol=restart_tol.astype(_f64),
        )
        return x_new, k_fin, arnoldi_final, new_pstate

    def skip(x):
        return (
            x,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0.0, _f64),
            PolicyState(
                is_first=pstate.is_first,
                second_restart_length=pstate.second_restart_length,
                restart_tol=restart_tol.astype(_f64),
            ),
        )

    x_new, k_fin, arnoldi_final, new_pstate = jax.lax.cond(converged0, skip, run, x)

    info = CycleInfo(
        converged0=converged0,
        r_norm=r_norm,
        beta=beta.astype(_f64),
        rel_initial=rel_initial,
        prec_rel0=prec_rel0,
        k_final=k_fin,
        arnoldi_final=arnoldi_final,
        pstate=new_pstate,
    )
    return x_new, info


_restart_cycle = partial(jax.jit, static_argnums=(0,))(restart_cycle_impl)


class ChunkInfo(NamedTuple):
    """Per-chunk result of ``multi_cycle_impl``: everything the host loop
    needs, fetched in ONE transfer per ``cfg.host_sync_every`` restarts."""

    n_run: jax.Array          # i32: cycles executed this chunk (incl. final)
    converged: jax.Array      # bool
    diverged: jax.Array       # bool: non-finite residual seen
    rel_initial: jax.Array    # (chunk,) f64 per-cycle
    prec_rel0: jax.Array      # (chunk,) f64
    k_final: jax.Array        # (chunk,) i32
    arnoldi_final: jax.Array  # (chunk,) f64
    pstate: PolicyState


def chunk_while(cycle_fn, chunk: int, x, pstate: PolicyState):
    """Run up to ``chunk`` restart cycles on device (the reference only
    tests convergence at restart boundaries, IterUtil.hpp:42-51, so the
    whole outer loop is a device-side while_loop; the host syncs once per
    chunk instead of once per restart — dispatch latency would otherwise
    dominate the solve).

    ``cycle_fn(x, pstate) -> (x, CycleInfo)`` must be traceable; both the
    single-device cycle and the shard_map'd distributed cycle qualify.
    """

    def cond(c):
        return (~c["stop"]) & (c["j"] < chunk)

    def body(c):
        j = c["j"]
        x_new, info = cycle_fn(c["x"], c["pstate"])
        finite = jnp.isfinite(info.rel_initial) & jnp.isfinite(info.beta)
        return dict(
            x=x_new,
            pstate=info.pstate,
            j=j + 1,
            stop=info.converged0 | ~finite,
            converged=info.converged0,
            diverged=~finite,
            rel_initial=c["rel_initial"].at[j].set(info.rel_initial),
            prec_rel0=c["prec_rel0"].at[j].set(info.prec_rel0),
            k_final=c["k_final"].at[j].set(info.k_final),
            arnoldi_final=c["arnoldi_final"].at[j].set(info.arnoldi_final),
        )

    carry0 = dict(
        x=x,
        pstate=pstate,
        j=jnp.asarray(0, jnp.int32),
        stop=jnp.asarray(False),
        converged=jnp.asarray(False),
        diverged=jnp.asarray(False),
        rel_initial=jnp.zeros((chunk,), _f64),
        prec_rel0=jnp.zeros((chunk,), _f64),
        k_final=jnp.zeros((chunk,), jnp.int32),
        arnoldi_final=jnp.zeros((chunk,), _f64),
    )
    fin = jax.lax.while_loop(cond, body, carry0)
    return fin["x"], ChunkInfo(
        n_run=fin["j"],
        converged=fin["converged"],
        diverged=fin["diverged"],
        rel_initial=fin["rel_initial"],
        prec_rel0=fin["prec_rel0"],
        k_final=fin["k_final"],
        arnoldi_final=fin["arnoldi_final"],
        pstate=fin["pstate"],
    )


def multi_cycle_impl(cfg: GmresConfig, chunk: int, A_out, A_in, M, b, x,
                     b_norm, minvb_norm, a_norm, pstate: PolicyState):
    return chunk_while(
        lambda xx, ps: restart_cycle_impl(
            cfg, A_out, A_in, M, b, xx, b_norm, minvb_norm, a_norm, ps
        ),
        chunk, x, pstate,
    )


_multi_cycle = partial(jax.jit, static_argnums=(0, 1))(multi_cycle_impl)


@partial(jax.jit, static_argnames=("in_dt", "has_a_norm"))
def _setup_norms(M, b, vals, in_dt, a_norm=None, *, has_a_norm=False):
    """||b||, ||M^{-1} b||, ||A||_F in one device dispatch (each separate
    call costs a host-device round trip).

    ``a_norm``: pack-time ||A||_F carried as operator metadata (SELL
    packs) — passing it avoids materializing the padded slot-value view
    just to take one norm; ``vals`` is then an empty placeholder.  It
    rides as a TRACED 0-d value (only the has/has-not flag is static) so
    a new matrix does not retrace this dispatch."""
    b_norm = nrm2(b).astype(_f64)
    minvb_norm = nrm2(typesafe_apply(M, b.astype(in_dt))).astype(_f64)
    if has_a_norm:
        a_norm = jnp.asarray(a_norm, dtype=_f64)
    else:
        a_norm = nrm2(vals).astype(_f64)
    return b_norm, minvb_norm, a_norm


@dataclasses.dataclass
class GmresResult:
    x: jax.Array
    converged: bool
    aborted: bool
    total_iters: int
    restarts: int                 # the reference's `i` at termination
    final_k: int                  # 0 when converged at check_initial
    rel_prec_res: float           # beta/||M^{-1}b|| at the converged check
    residual_norm: float | None = None  # true fp-high ||b - A x|| (driver)
    error_norm: float | None = None     # ||x - x_true|| when truth known
    prec_seconds: float = 0.0
    solve_seconds: float = 0.0
    setup_seconds: float = 0.0    # host-side pre-dispatch cost inside solve()
    history: list | None = None   # per-cycle (rel_initial, prec_rel0, k)
    diverged: bool = False        # non-finite residual detected
    fellback_to_fp64: bool = False
    stalled: bool = False         # stagnation detected (no progress window)
    escalated: bool = False       # bf16 inner escalated to f32 mid-solve
    # distributed per-host input: this process's materialized partition
    # bytes (matrix shards + halos; the pod-scale memory bound the
    # multihost test asserts).  None on single-device solves.
    partition_local_bytes: int | None = None


_STAGING_CACHE = None  # weakref.WeakKeyDictionary, created lazily


def prepare_operators(A: CSRMatrix, cfg: GmresConfig):
    """Stage the matrix into (outer, inner) dtypes.  When the dtypes match
    (all baseline-style modes) one array serves both roles, like the
    reference's single ``A_type``; the mixed mode keeps both
    (``gmres.cpp:136-141``).

    With ``cfg.auto_format`` (single-device only), banded matrices are
    re-packed into DIA form, whose SpMV needs no column indices and no
    gather (see ``ops/dia.py``); other patterns stay CSR.

    Staged views are cached per operator object (id-keyed with weakref
    cleanup; the matrix pytrees hold jax arrays and are not hashable), so
    repeated solves on the same matrix skip conversion, casts and
    uploads."""
    global _STAGING_CACHE
    import weakref

    if _STAGING_CACHE is None:
        _STAGING_CACHE = {}

    out_dt = jnp.dtype(cfg.precision.outer)
    in_dt = cfg.precision.inner_dtype
    key = (cfg.auto_format and cfg.axis_name is None, str(out_dt), str(in_dt))
    entry = _STAGING_CACHE.get(id(A))
    if entry is not None and entry[0]() is A and key in entry[1]:
        return entry[1][key]

    A_fmt = A
    if cfg.auto_format and cfg.axis_name is None and isinstance(A, CSRMatrix):
        from gmres_tpu.ops.dia import from_csr

        dia = from_csr(A)
        if dia is not None:
            A_fmt = dia
    same = out_dt == in_dt
    # Commit the staged operators to the device ONCE (the reference's
    # host->device deep_copy boundary, types_cuda.hpp:103-114).  Construction
    # keeps numpy-backed pytrees for host-side setup work; without this the
    # jitted cycle re-uploads the whole matrix on every call.
    A_in = jax.device_put(A_fmt.astype(in_dt))
    A_out = A_in if same else jax.device_put(A_fmt.astype(out_dt))
    if entry is None or entry[0]() is not A:
        aid = id(A)
        entry = (weakref.ref(A, lambda _, i=aid: _STAGING_CACHE.pop(i, None)), {})
        _STAGING_CACHE[id(A)] = entry
    entry[1][key] = (A_out, A_in)
    return A_out, A_in


def stage(A: CSRMatrix, cfg: GmresConfig | None = None):
    """Pre-stage an operator for repeated solves: format conversion
    (CSR -> DIA when banded) + device upload happen once here instead of
    inside every ``solve`` call.  Returns the staged operator; pass it to
    ``solve`` in place of the CSR matrix (the per-call dtype casts on an
    already-device-resident operator are cheap).

    This mirrors the reference's pre-timed host->device deep_copy
    (``gmres_perf_test.cpp:218-221``)."""
    cfg = cfg or GmresConfig()
    if cfg.auto_format and isinstance(A, CSRMatrix):
        from gmres_tpu.ops.dia import from_csr

        dia = from_csr(A)
        if dia is not None:
            A = dia
    return jax.device_put(A)


def solve(
    A: CSRMatrix,
    b,
    cfg: GmresConfig | None = None,
    x0=None,
    M=None,
    record_history: bool = False,
    progress=None,
    reorder: str | None = None,
    checkpoint=None,
) -> GmresResult:
    """Solve A x = b with restarted GMRES(m) under the configured precision
    staging, orthogonalization, preconditioner and restart policy.

    ``A`` should be the assembled (typically fp64) matrix; dtype staging and
    preconditioner construction happen here, mirroring
    ``DoBaselineProblem``/``DoMixedPrecisionProblem``
    (``gmres_perf_test.cpp:53-182``).

    ``reorder="rcm"`` applies a bandwidth-reducing symmetric permutation at
    setup (solves the permuted system, returns the un-permuted solution) —
    which turns many irregular patterns into DIA-friendly bands (see
    ``ops/reorder.py``).
    """
    cfg = cfg or GmresConfig()
    out_dt = jnp.dtype(cfg.precision.outer)
    in_dt = cfg.precision.inner_dtype

    if (
        reorder is None
        and cfg.auto_reorder
        and isinstance(A, CSRMatrix)
        and M is None
        and x0 is None
    ):
        from gmres_tpu.ops.dia import from_csr as _dia_try

        if _dia_try(A) is None:
            reorder = "rcm"

    perm = None
    if reorder is not None:
        if reorder != "rcm":
            raise ValueError(f"unknown reorder {reorder!r}")
        from gmres_tpu.ops.reorder import permute_symmetric, rcm_permutation

        perm = rcm_permutation(A)
        A = permute_symmetric(A, perm)
        b = np.asarray(b)[perm]
        if x0 is not None:
            x0 = np.asarray(x0)[perm]
        if M is not None:
            raise ValueError("reorder with a prebuilt preconditioner is unsupported")

    t0 = time.perf_counter()
    if M is None:
        M = build_preconditioner(A, cfg)
    if cfg.auto_format and cfg.axis_name is None:
        from gmres_tpu.precond.build import optimize_precond_format

        M = optimize_precond_format(M)

    A_out, A_in = prepare_operators(A, cfg)
    M = jax.device_put(M)  # one upload, not one per jitted cycle call
    prec_seconds = time.perf_counter() - t0

    b = jnp.asarray(b, dtype=out_dt)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype=out_dt)

    t1 = time.perf_counter()
    # one-time norms (gmres.cpp:51-57, 162-168) — one fused dispatch.
    # ||A||_F is the Frobenius norm of the INNER-dtype values
    # (gmres.cpp:168 computes it from A_single); SELL operators carry it
    # as pack-time metadata instead of a padded slot-array norm
    a_norm_meta = getattr(A_in, "frob_norm", None)
    b_norm, minvb_norm, a_norm = _setup_norms(
        M, b, b[:0] if a_norm_meta is not None else A_in.vals, in_dt,
        jnp.float64(a_norm_meta if a_norm_meta is not None else 0.0),
        has_a_norm=a_norm_meta is not None)

    def chunk_call(x, pstate, chunk):
        return _multi_cycle(
            cfg, chunk, A_out, A_in, M, b, x, b_norm, minvb_norm, a_norm,
            pstate
        )

    setup_seconds = time.perf_counter() - t0  # host-side pre-dispatch cost
    # bf16 inner loops floor around rel ~1e-6; watch for stagnation so the
    # solve can escalate to f32 instead of burning max_restarts
    stall_window = (
        6 if (in_dt == jnp.bfloat16 and cfg.bf16_escalation
              and cfg.tol < 1e-5) else None
    )
    result = drive_restarts(chunk_call, x, cfg, record_history, progress,
                            checkpoint=checkpoint, stall_window=stall_window)
    result.setup_seconds = setup_seconds
    result.prec_seconds = prec_seconds
    result.solve_seconds = time.perf_counter() - t1

    from gmres_tpu.config import PrecisionSpec as _PS

    if result.stalled and not result.converged and in_dt == jnp.bfloat16:
        # restart-in-higher-precision escalation (SURVEY.md §5.3): continue
        # from the current iterate with a float32 inner loop
        esc_prec = _PS(outer=cfg.precision.outer, inner="float32",
                       precond=cfg.precision.precond)
        esc = solve(
            A,
            np.asarray(b),
            cfg.with_(precision=esc_prec,
                      max_restarts=max(1, cfg.max_restarts - result.restarts)),
            x0=np.asarray(result.x),
            record_history=record_history, progress=progress,
            checkpoint=checkpoint,
        )
        esc.escalated = True
        esc.total_iters += result.total_iters
        esc.restarts += result.restarts
        esc.prec_seconds += prec_seconds
        esc.solve_seconds += result.solve_seconds
        if record_history and result.history is not None:
            esc.history = result.history + [dict(escalated=True)] + (
                esc.history or []
            )
        result = esc

    if result.diverged and cfg.nan_fallback and cfg.precision != _PS.from_mode("baseline"):
        # Rebuild the fp64 preconditioner from the matrix: reusing the
        # low-precision M would inherit exactly the brokenness (e.g.
        # fp32-flushed pivots) that made the solve diverge.
        fb = solve(
            A,
            np.asarray(b),
            cfg.with_(precision=_PS.from_mode("baseline")),
            record_history=record_history, progress=progress,
        )
        fb.fellback_to_fp64 = True
        fb.prec_seconds += prec_seconds
        fb.solve_seconds += result.solve_seconds
        result = fb

    if perm is not None:
        x_out = np.empty_like(np.asarray(result.x))
        x_out[perm] = np.asarray(result.x)
        result.x = jnp.asarray(x_out)
    return result


def drive_restarts(
    chunk_call, x, cfg: GmresConfig, record_history=False, progress=None,
    checkpoint=None, stall_window: int | None = None,
    ckpt_x_to_host=None, ckpt_x_from_host=None, ckpt_consensus=None,
) -> GmresResult:
    """The host outer loop, implementing the reference's ``check_initial``
    bookkeeping (restart counting / abort / convergence — IterUtil.hpp:42-51
    including the count-before-test quirk).

    ``chunk_call(x, pstate, chunk)`` runs up to ``chunk`` restart cycles on
    device (``chunk_while``) and returns ``(x, ChunkInfo)``; the host syncs
    once per ``cfg.host_sync_every`` restarts, then replays the per-cycle
    info arrays for history/abort/convergence bookkeeping.

    ``checkpoint`` (a ``utils.checkpoint.CheckpointSpec``) persists
    (x, i, iters, policy state) roughly every ``every`` restarts (rounded to
    chunk boundaries) and resumes from the file when present.
    ``ckpt_x_to_host``/``ckpt_x_from_host`` override how x is converted for
    persistence — the distributed solver saves each process's contiguous
    shard block and rebuilds the sharded array on
    resume (``parallel/dist_gmres._dist_ckpt_hooks``)."""

    pstate = initial_policy_state()
    history = [] if record_history else None
    total_iters = 0
    resume_i = 0
    if checkpoint is not None:
        from gmres_tpu.utils import checkpoint as ckpt_mod

        state = ckpt_mod.load(checkpoint.path)
        if ckpt_consensus is not None:
            # multi-host: reconcile per-process resume headers (a mid-save
            # preemption can leave files one interval apart) — all
            # processes adopt the same (i, iters, policy state) in lockstep
            state = ckpt_consensus(state)
        if state is not None:
            x_np, resume_i, total_iters, pstate = state
            if ckpt_x_from_host is not None:
                x = ckpt_x_from_host(x_np)
            else:
                x = jnp.asarray(x_np, dtype=jnp.asarray(x).dtype)
    converged = False
    aborted = False
    diverged = False
    stalled = False
    rel_prec_res = float("nan")
    final_k = 0
    i = resume_i
    stop = False
    best_rel = float("inf")
    best_i = 0
    while not stop:
        if i + 1 > cfg.max_restarts:
            # check_initial counts the restart before testing (IterUtil.hpp:42-45)
            aborted = True
            break
        chunk = min(cfg.host_sync_every, cfg.max_restarts - i)
        x, info = chunk_call(x, pstate, chunk)
        pstate = info.pstate  # stays on device for the next chunk
        # ONE device fetch per chunk (separate float()/bool() reads each
        # cost a host-device round trip).
        n_run, conv, div, rels, precs, ks, arns = jax.device_get(
            (info.n_run, info.converged, info.diverged, info.rel_initial,
             info.prec_rel0, info.k_final, info.arnoldi_final)
        )
        n_run = int(n_run)
        for j in range(n_run):
            last = j == n_run - 1
            if last and bool(div):
                # low-precision inner loop blew up (SURVEY.md §5.3)
                diverged = True
                aborted = True
                stop = True
                break
            if last and bool(conv):
                converged = True
                rel_prec_res = float(precs[j])
                final_k = 0
                if record_history:
                    history.append(
                        dict(i=i, k=0, rel_initial=float(rels[j]),
                             prec_rel0=float(precs[j]))
                    )
                stop = True
                break
            k = int(ks[j])
            total_iters += k
            rel_j = float(rels[j])
            if rel_j < 0.9 * best_rel:
                best_rel = rel_j
                best_i = i
            elif stall_window is not None and i - best_i >= stall_window:
                # no meaningful progress for a full window: stop so the
                # caller can escalate the inner precision (SURVEY.md §5.3)
                stalled = True
                stop = True
            if record_history:
                history.append(
                    dict(i=i, k=k, rel_initial=float(rels[j]),
                         prec_rel0=float(precs[j]),
                         arnoldi_final=float(arns[j]))
                )
            if progress is not None:
                progress(i, k, float(rels[j]))
            i += 1
            if stop:
                break
        if (
            checkpoint is not None
            and not stop
            and i > resume_i
            and (i % checkpoint.every) < cfg.host_sync_every
        ):
            from gmres_tpu.utils import checkpoint as ckpt_mod

            x_host = ckpt_x_to_host(x) if ckpt_x_to_host is not None else x
            ckpt_mod.save(checkpoint.path, x_host, i, total_iters, pstate)

    return GmresResult(
        x=x,
        converged=converged,
        aborted=aborted,
        total_iters=total_iters,
        restarts=i,
        final_k=final_k,
        rel_prec_res=rel_prec_res,
        history=history,
        diverged=diverged,
        stalled=stalled,
    )
