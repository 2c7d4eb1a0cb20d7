"""Condition-number estimator (``condest.cpp``).

sigma_max: power iteration on A with the Klein-LU iteration bound
(``condest.cpp:30-33,167-179``).  sigma_min: Golub-Kahan / LSQR-style
bidiagonalization on a manufactured problem, tracking ``min ||A d|| / ||d||``
over the error vectors ``d = x_exact - x_t`` (``condest.cpp:37-165``; the
method of Wiley NLA 10.1002/nla.2235 per the reference notebook).

Design: the per-iteration recurrences are pure SpMV + BLAS-1, so each
LSQR step is one jitted function; steps run in device-side chunks with the
(rare) stopping checks on host.  A^T is materialized as a second operator
at setup (the reference flips a cusparse transpose flag,
``types_cuda.hpp:145-151``; an explicit transposed layout keeps both
products on the same row-owned SpMV path).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmres_tpu.io.rng import rand_vect
from gmres_tpu.ops.blas import nrm2
from gmres_tpu.ops.spmv import spmv
from gmres_tpu.sparse import CSRMatrix, csr_from_coo


# Per-chunk device-time budget: chunked loops target this much device
# time per call, so the host regains control (and can stop) regularly.
_DEVICE_BUDGET_S = 15.0


def transpose_csr(A: CSRMatrix) -> CSRMatrix:
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    ci = np.asarray(A.col_idx)[:nnz]
    v = np.asarray(A.vals)[:nnz]
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp))
    return csr_from_coo(ci.astype(np.int64), rows, v, n_rows=A.n_cols,
                        n_cols=A.n_rows, sum_duplicates=False)


def klein_lu_bound(eps: float, delta: float, n: int) -> int:
    log_2n = math.log(2 * n)
    return int(math.ceil((log_2n * log_2n - math.log(eps * delta * delta)) / eps))


@partial(jax.jit, static_argnums=(2,))
def _power_iteration(A: CSRMatrix, x, iters: int):
    def body(_, carry):
        x, lam = carry
        y = spmv(A, x)
        lam = nrm2(y)
        return jnp.where(lam != 0, y / lam, y), lam

    x, lam = jax.lax.fori_loop(0, iters, body, (x, jnp.asarray(0.0, x.dtype)))
    return x, lam


@jax.jit
def _lsqr_step(A: CSRMatrix, At: CSRMatrix, state):
    """One Golub-Kahan step + sigma_min tracking (condest.cpp:97-133)."""
    u, v, w, x, alpha, beta, phi_bar, rho_bar, x_exact, sigma_min, v_min = state

    u = spmv(A, v) - alpha * u
    beta = nrm2(u)
    u = jnp.where(beta != 0, u / beta, u)

    v = spmv(At, u) - beta * v
    alpha = nrm2(v)
    v = jnp.where(alpha != 0, v / alpha, v)

    rho = jnp.sqrt(rho_bar**2 + beta**2)
    c = rho_bar / rho
    s = beta / rho
    theta = s * alpha
    rho_bar = -c * alpha
    phi = c * phi_bar
    phi_bar = s * phi_bar

    x = x + (phi / rho) * w
    w = v + (-theta / rho) * w

    d = x_exact - x
    d_norm = nrm2(d)
    Ad = spmv(A, d)
    ad_norm = nrm2(Ad)

    better = ad_norm < sigma_min * d_norm
    safe = d_norm != 0
    sigma_min = jnp.where(better & safe, ad_norm / d_norm, sigma_min)
    v_min = jnp.where(better & safe, d, v_min)

    new_state = (u, v, w, x, alpha, beta, phi_bar, rho_bar, x_exact,
                 sigma_min, v_min)
    scalars = dict(d_norm=d_norm, ad_norm=ad_norm,
                   x_norm=nrm2(x), sigma_min=sigma_min)
    return new_state, scalars


def condest(A: CSRMatrix, rand_seed: int = 42, max_iters: int = 100_000,
            verbose=print):
    """Estimate cond_2(A).  Returns (cond, sigma_max, sigma_min, iters)."""
    n = A.n_rows
    # Banded patterns run on DIA (the transpose is a band re-shift,
    # ops/dia.py:dia_transpose); others keep CSR with an explicit A^T.
    if isinstance(A, CSRMatrix):
        from gmres_tpu.ops.dia import dia_transpose, from_csr

        dia = from_csr(A)
        if dia is not None:
            A = jax.device_put(dia)
            At = jax.device_put(dia_transpose(dia))
        else:
            At = jax.device_put(transpose_csr(A))
            A = jax.device_put(A)
    else:
        from gmres_tpu.ops.dia import dia_transpose

        At = jax.device_put(dia_transpose(A))
        A = jax.device_put(A)

    eps = float(np.finfo(np.float64).eps)
    c1 = 8 * eps
    erfinv_c2 = 8.862271574665521045654e-4
    c3 = 1 / (64 * eps)
    c4 = math.sqrt(eps)
    c1_prime = 4 * eps
    power_iters = klein_lu_bound(0.1, 1e-12, n)

    # Device loops run in host-bounded chunks, each sized from a measured
    # probe chunk to about _DEVICE_BUDGET_S of device time.
    # A host round trip between chunks costs ~ms; the reference's
    # per-iteration host checks (condest.cpp:139-157) are what this
    # design avoids, and ceil(T/chunk) trips keep that property.
    import time as _time

    v_max = jnp.asarray(rand_vect(n, rand_seed + 5))
    probe = min(32, power_iters)
    x_p, lam = _power_iteration(A, v_max, probe)
    float(lam)  # sync (includes compile)
    t0 = _time.perf_counter()
    x_p, lam = _power_iteration(A, x_p, probe)  # cached: pure device time
    float(lam)
    per_iter = (_time.perf_counter() - t0) / probe
    done = 2 * probe
    chunk = max(32, min(50_000, int(_DEVICE_BUDGET_S / max(per_iter, 1e-7))))
    while done < power_iters:
        k = min(chunk, power_iters - done)
        x_p, lam = _power_iteration(A, x_p, k)
        float(lam)  # host sync bounds on-device time per call
        done += k
    sigma_max = float(lam)
    verbose(f"sigma_max = {sigma_max:g}")

    x_exact = jnp.asarray(rand_vect(n, rand_seed))
    x_rand_norm = float(nrm2(x_exact))
    x_exact = x_exact / x_rand_norm

    b = spmv(A, x_exact)
    b_norm = float(nrm2(b))
    beta = b_norm
    u = b / beta
    v = spmv(At, u)
    alpha = float(nrm2(v))
    v = v / alpha
    w = v
    x = jnp.zeros_like(v)

    state = (u, v, w, x,
             jnp.asarray(alpha), jnp.asarray(beta),
             jnp.asarray(beta),   # phi_bar
             jnp.asarray(alpha),  # rho_bar
             x_exact,
             jnp.asarray(sigma_max),  # sigma_min starts at sigma_max
             v_max)

    tau = math.sqrt(2) * erfinv_c2 / x_rand_norm

    # The reference evaluates the stopping thresholds on the host every
    # iteration (condest.cpp:139-157), one device sync per step.  All
    # quantities are device scalars, so both phases (iterate-until-
    # threshold, then 25% extra iterations) run as jitted while_loops — in
    # host-bounded CHUNKS (``t_end`` caps the loop counter per call).
    # Exiting a chunk early and re-entering with the same carry is
    # iteration-for-iteration identical to one long loop.
    # ``ops`` is threaded through the jitted chunks as an ARGUMENT: closing
    # over A/At would embed the operator arrays as HLO constants.
    def step(ops, carry):
        A, At = ops
        state, t, _fin, _deg, relaxed = carry
        state, sc = _lsqr_step(A, At, state)
        sigma_min = sc["sigma_min"]
        # The c4-triggered switch to c1' is PERMANENT in the reference
        # (condest.cpp:138-140 assigns c1 = c1_prime), so carry a
        # sticky flag rather than re-evaluating per iteration.
        relaxed = relaxed | (sigma_min / sigma_max <= c4)
        c1_eff = jnp.where(relaxed, c1_prime, c1)
        finished = (
            (sc["ad_norm"] / (sigma_max * sc["x_norm"] + b_norm) <= c1_eff)
            | (sc["d_norm"] <= tau)
            | (sigma_max / sigma_min >= c3)
        )
        degenerate = (sc["d_norm"] == 0) | jnp.isnan(sc["ad_norm"])
        return state, t + 1, finished, degenerate, relaxed

    @jax.jit
    def _phase1_chunk(ops, carry, t_end):
        return jax.lax.while_loop(
            lambda c: (~c[2]) & (~c[3]) & (c[1] <= t_end),
            lambda c: step(ops, c), carry)

    @jax.jit
    def _tail_chunk(ops, carry, t_end):
        # 'finished' is not re-evaluated in the tail (the reference guards
        # it with T != max_iters); degeneracy still stops.
        return jax.lax.while_loop(
            lambda c: (~c[3]) & (c[1] <= t_end),
            lambda c: step(ops, c), carry)

    ops = (A, At)

    lsqr_chunk = 16  # grown adaptively from each chunk's measured wall
    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(False),
             jnp.asarray(False), jnp.asarray(False))
    while True:
        t_host = int(carry[1])
        t_end = min(t_host + lsqr_chunk - 1, max_iters)
        t0 = _time.perf_counter()
        carry = _phase1_chunk(ops, carry, jnp.asarray(t_end, jnp.int32))
        t_new = int(carry[1])
        fin, deg = bool(carry[2]), bool(carry[3])
        wall = _time.perf_counter() - t0
        if fin or deg or t_new > max_iters:
            t1, state = t_new, carry[0]
            break
        per_it = wall / max(t_new - t_host, 1)
        lsqr_chunk = max(16, min(50_000,
                                 int(_DEVICE_BUDGET_S / max(per_it, 1e-7))))
    # The tail runs until ceil(1.25 * t_fire) TOTAL iterations, where
    # t_fire is the iteration at which 'finished' fired (the loop
    # counter was already incremented when we exited, hence t1 - 1 —
    # condest.cpp:142-148 sets T = ceil(1.25 t) inside iteration t).
    # No tail when the loop ended by degeneracy or max_iters.
    t_target = math.ceil((t1 - 1) * 1.25) if (fin and not deg) else 0
    carry = (state, carry[1], jnp.asarray(False), carry[3], carry[4])
    while int(carry[1]) <= t_target and not bool(carry[3]):
        t_host = int(carry[1])
        t_end = min(t_host + lsqr_chunk - 1, t_target)
        carry = _tail_chunk(ops, carry, jnp.asarray(t_end, jnp.int32))
        if int(carry[1]) == t_host:  # safety: no progress (t_end < t)
            break
    t = int(carry[1])
    sigma_min = float(carry[0][9])

    verbose(f"{t} iterations total")
    cond = sigma_max / sigma_min
    verbose(f"Computed cond(A) = {cond:g} = {sigma_max:g}/{sigma_min:g}")
    return cond, sigma_max, sigma_min, t
