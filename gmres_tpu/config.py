"""Solver configuration.

The reference exposes four hard-coded precision modes, three
orthogonalization kernels, four preconditioners and four restart policies
through CLI flags (``gmres_perf_test.cpp:327-394``).  Here the same surface
is a single frozen (hashable) dataclass: it is passed as a *static* argument
to the jitted restart cycle, so each distinct configuration compiles exactly
once.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Mode(str, enum.Enum):
    """The reference's four test modes (``gmres_perf_test.cpp:31-36``)."""

    BASELINE = "baseline"          # uniform fp64
    SINGLE_PREC = "single-prec"    # fp64 solver, fp32 preconditioner
    MIXED = "mixed"                # fp64 outer residual, fp32 inner cycle
    SINGLE = "single"              # uniform fp32
    # beyond-reference 5th mode: fp64-class inner loop carried as two-fp32
    # (double-float) pairs with error-free transforms (ops/df64.py)
    DF64 = "df64"


class Orth(str, enum.Enum):
    """Orthogonalization kernels (``Orthogonalization.hpp:76-136``)."""

    CGS = "cgs"
    MGS = "mgs"
    CGSR = "cgsr"


class Precond(str, enum.Enum):
    """Preconditioners (``gmres_perf_test.cpp:24-29``, ``types.hpp:244-448``)."""

    ILU = "ilu"                  # ILU(0), exact triangular solves
    ILU_JACOBI = "ilu_jacobi"    # ILU(0), Jacobi-iteration triangular solves
    JACOBI = "jacobi"            # inverse main diagonal
    IDENTITY = "identity"
    # distributed-only (new scope vs the single-device reference): each
    # shard factors its diagonal block; application is communication-free
    # and factorization divides by P (precond/bilu.py)
    BILU_JACOBI = "bilu_jacobi"


class RestartPolicy(str, enum.Enum):
    """Restart policies (``IterUtil.hpp:17-227``).

    The reference selects among these in ``alloc_convergence``
    (``gmres_perf_test.cpp:185-196``): ``rtol == 0`` means FIXED, otherwise
    ``--repeat-iter`` / ``--orthloss`` flags pick the variant, with
    relative-preconditioned-residual as the default.
    """

    FIXED = "fixed"
    REL_PREC_RES = "relres"
    REPEAT_ITERATION = "repeat"
    LOST_ORTHOGONALITY = "orthloss"


# Canonical dtype names accepted in PrecisionSpec.  Strings keep the config
# hashable; resolve with `np.dtype`/`jnp.dtype` at trace time.
_DTYPES = ("float64", "float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """Explicit dtype staging, generalizing the reference's four modes.

    - ``outer``: dtype of x, b and the true-residual accumulation
      (``r_accum`` in ``gmres.cpp:158``).
    - ``inner``: dtype of the Krylov basis, Hessenberg matrix, Givens
      rotations, and the matrix used inside the Arnoldi cycle
      (``A_single`` in ``gmres.cpp:139``).
    - ``precond``: dtype the preconditioner is built in and applied in;
      cross-dtype application round-trips through a cast
      (``typesafe_apply``, ``gmres.cpp:12-17``).
    """

    outer: str = "float64"
    inner: str = "float64"
    precond: str = "float64"
    # df64 tier (mode "df64"): the inner loop's vectors are carried as
    # two-fp32 (hi, lo) pairs with error-free transforms — fp64-class
    # accuracy (~2^-48) from fp32 arithmetic.
    # Requires inner == "float64" (it is a REPRESENTATION of fp64).
    df64_inner: bool = False
    # Compressed-basis tier (CB-GMRES — Aliaga, Anzt, Grützmacher, Quintana-
    # Ortí, Tomás, "Compressed Basis GMRES on High Performance GPUs",
    # arXiv:2009.12101): store the Krylov basis V in a NARROWER dtype than
    # the arithmetic.  The basis streams dominate orthogonalization HBM
    # traffic (CGSR reads V three times per iteration), so a bfloat16 basis
    # under a float32 inner loop (or float32 under float64) halves that
    # traffic while w, H, Givens and all reductions stay in the inner
    # dtype — unlike lowering `inner` itself, only the STORAGE of V is
    # compressed.  None = store the basis in the inner dtype (default).
    basis: str | None = None

    def __post_init__(self):
        for name in (self.outer, self.inner, self.precond):
            if name not in _DTYPES:
                raise ValueError(f"unsupported dtype {name!r}; use one of {_DTYPES}")
        if self.df64_inner and self.inner != "float64":
            raise ValueError(
                "df64_inner carries an fp64-quality inner loop as two-fp32 "
                "pairs; set inner='float64' with it"
            )
        if self.basis is not None:
            if self.basis not in _DTYPES:
                raise ValueError(
                    f"unsupported basis dtype {self.basis!r}; use one of {_DTYPES}")
            if self.df64_inner:
                raise ValueError(
                    "basis compression and df64_inner are exclusive (the "
                    "df64 loop already carries its own two-fp32 basis)")
            # _DTYPES is widest-first; the basis must be narrower or equal
            if _DTYPES.index(self.basis) < _DTYPES.index(self.inner):
                raise ValueError(
                    f"basis dtype {self.basis!r} is wider than inner "
                    f"{self.inner!r}; compression stores V narrower")

    @staticmethod
    def from_mode(mode: Mode | str) -> "PrecisionSpec":
        mode = Mode(mode)
        if mode == Mode.BASELINE:
            return PrecisionSpec("float64", "float64", "float64")
        if mode == Mode.SINGLE_PREC:
            return PrecisionSpec("float64", "float64", "float32")
        if mode == Mode.MIXED:
            return PrecisionSpec("float64", "float32", "float32")
        if mode == Mode.SINGLE:
            return PrecisionSpec("float32", "float32", "float32")
        if mode == Mode.DF64:
            # fp32 preconditioner: a df64-quality M buys nothing (M only
            # preconditions) and fp32 keeps its apply on the fast paths
            return PrecisionSpec("float64", "float64", "float32",
                                 df64_inner=True)
        raise ValueError(f"unknown mode {mode}")

    @property
    def outer_dtype(self) -> np.dtype:
        return np.dtype(self.outer)

    @property
    def inner_dtype(self):
        import jax.numpy as jnp

        return jnp.dtype(self.inner)

    @property
    def precond_dtype(self):
        import jax.numpy as jnp

        return jnp.dtype(self.precond)

    @property
    def basis_dtype(self):
        """Storage dtype of the Krylov basis (the inner dtype unless
        compressed — CB-GMRES, see the ``basis`` field)."""
        import jax.numpy as jnp

        return jnp.dtype(self.basis) if self.basis is not None else self.inner_dtype


@dataclasses.dataclass(frozen=True)
class GmresConfig:
    """Full solver configuration.  Hashable: used as a static jit argument.

    Field-by-field parity with the reference CLI (``gmres_perf_test.cpp``):
    ``tol`` (--tol), ``restart_length`` (--rlen), ``max_restarts``
    (--max-restarts), ``restart_improvement`` (--rtol / --rorth value),
    ``policy`` (--repeat-iter/--orthloss/rtol!=0 dispatch), ``orth``
    (--orth), ``precond`` (--prec), ``jacobi_steps`` (--jacobi-steps),
    ``precision`` (--mode, generalized).
    """

    precision: PrecisionSpec = PrecisionSpec()
    orth: Orth = Orth.MGS
    orth_steps: int = 2  # CGSR re-orthogonalization passes (gmres.cpp:357)
    precond: Precond = Precond.ILU
    jacobi_steps: int = 1
    policy: RestartPolicy = RestartPolicy.FIXED
    restart_length: int = 30
    restart_improvement: float = 0.0  # --rtol / --rorth
    tol: float = 1e-6
    max_restarts: int = 1_000_000
    # Name of the mesh axis rows are sharded over, or None for single-device.
    axis_name: str | None = None
    # Restart cycles executed per host synchronization: the device runs up
    # to this many restarts in one dispatch (lax.while_loop) before the host
    # fetches progress.  Higher = less dispatch latency; history/progress
    # granularity is unaffected (per-cycle info is returned in arrays).
    host_sync_every: int = 16
    # Auto-select the fastest operator format (DIA for banded matrices,
    # CSR fallback) at solve setup.  Off: keep the caller's format.
    auto_format: bool = True
    # When a low-precision inner loop produces non-finite residuals, retry
    # the solve in uniform fp64 instead of diverging (the reference just
    # diverges and records '-' rows — SURVEY.md §5.3; this is a documented
    # improvement, off by default for behavior parity).
    nan_fallback: bool = False
    # bfloat16 inner loops floor around rel residual ~1e-6 (BASELINE.md):
    # when progress stalls below the target tolerance, escalate the inner
    # precision to float32 and continue from the current iterate (restart
    # -in-higher-precision, SURVEY.md §5.3 design note).  On by default so
    # bf16 is usable rather than a footgun; the escalation is recorded in
    # GmresResult.escalated.
    bf16_escalation: bool = True
    # MGS reformulation: replace the k+1 sequential per-step reductions
    # with the one-reduce ICWY scheme (Świrydowicz et al. 2020) — one
    # batched psum + a tiny local triangular correction solve per Arnoldi
    # step, orthogonality loss O(eps*kappa) like true MGS.  Tri-state:
    #   None (default)  AUTO — on for distributed solves (where the k+1
    #                   sequential allreduces are the latency wall); on a
    #                   single device as ``backend.lowsync_mgs_auto`` says
    #                   (off on GPU and CPU: exact reference MGS sequence,
    #                   Orthogonalization.hpp:91-107 parity)
    #   True            force on everywhere
    #   False           force the textbook sequential recurrence
    low_sync_mgs: bool | None = None
    # Apply a bandwidth-reducing RCM reordering automatically when the
    # operator's pattern defeats the fast formats (DIA rejects it) — the
    # solve runs on the permuted system and returns the un-permuted
    # solution (solve(reorder="rcm") semantics).  Off by default: the
    # reference never reorders, and permutation changes the convergence
    # history (identical in exact arithmetic only).
    auto_reorder: bool = False

    def __post_init__(self):
        object.__setattr__(self, "orth", Orth(self.orth))
        object.__setattr__(self, "precond", Precond(self.precond))
        object.__setattr__(self, "policy", RestartPolicy(self.policy))
        if self.restart_length < 1:
            raise ValueError(
                "restart_length must be >= 1 (the reference CLI defaults to 0 "
                "and relies on callers always passing --rlen; we validate)"
            )
        if self.orth_steps < 1:
            raise ValueError("orth_steps must be >= 1")

    @property
    def m(self) -> int:
        return self.restart_length

    def with_(self, **kw) -> "GmresConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_flags(
        mode: str = "mixed",
        orth: str = "mgs",
        prec: str = "ilu",
        rlen: int = 30,
        rtol: float = 0.0,
        tol: float = 1e-6,
        max_restarts: int = 1_000_000,
        repeat_iter: bool = False,
        orthloss: bool = False,
        jacobi_steps: int = 1,
        **kw,
    ) -> "GmresConfig":
        """Map the reference's CLI flag semantics onto a config.

        Mirrors ``alloc_convergence`` (``gmres_perf_test.cpp:185-196``):
        rtol==0 -> fixed restart; else repeat-iter / orthloss flags pick the
        policy, default relative-preconditioned-residual.
        """
        if repeat_iter and orthloss:
            raise ValueError(
                "Repeated Iteration Restart cannot be used with OrthLoss restart"
            )
        if rtol == 0:
            policy = RestartPolicy.FIXED
        elif repeat_iter:
            policy = RestartPolicy.REPEAT_ITERATION
        elif orthloss:
            policy = RestartPolicy.LOST_ORTHOGONALITY
        else:
            policy = RestartPolicy.REL_PREC_RES
        return GmresConfig(
            precision=PrecisionSpec.from_mode(mode),
            orth=Orth(orth.lower()),
            precond=Precond(prec),
            jacobi_steps=jacobi_steps,
            policy=policy,
            restart_length=rlen,
            restart_improvement=rtol,
            tol=tol,
            max_restarts=max_restarts,
            **kw,
        )
