"""With the backend answering ``gpu``, staging, preconditioner builds and
the traced restart cycle take the plain XLA forms: never SELL, never a
double-float staged operator, never a Pallas kernel (interpreted or not).

``jax.default_backend`` is patched, so the GPU's answers are checked here
while the arrays still live on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmres_tpu import GmresConfig, PrecisionSpec, backend, stage
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d, unstructured_mesh
from gmres_tpu.ops.dia import DIAMatrix
from gmres_tpu.precond.build import (
    IdentityPrec,
    ILUJacobiPrec,
    JacobiPrec,
    build_preconditioner,
)
from gmres_tpu.precond.level_ilu import LevelILUPrec
from gmres_tpu.solver.gmres import prepare_operators, restart_cycle_impl
from gmres_tpu.solver.policies import initial_policy_state
from gmres_tpu.sparse import CSRMatrix

MATRICES = {
    "banded": lambda: convection_diffusion_2d(16, beta=2.0),
    "unstructured": lambda: unstructured_mesh(1024, run=3, seed=1),
}
PRECS = {
    "identity": (IdentityPrec,),
    "jacobi": (JacobiPrec,),
    "ilu_jacobi": (ILUJacobiPrec,),
    "ilu": (ILUJacobiPrec, LevelILUPrec),
}


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.current().platform == "gpu"


def _primitives(jaxpr, out=None):
    """Every primitive name in a closed jaxpr, sub-jaxprs included."""
    out = set() if out is None else out
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(sub, "eqns"):                 # Jaxpr
                    _primitives(sub, out)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    _primitives(sub.jaxpr, out)          # ClosedJaxpr
    return out


@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("mode", ["baseline", "mixed", "df64"])
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_single_device_routes(on_gpu, matrix, mode, prec):
    A = MATRICES[matrix]()
    cfg = GmresConfig(precision=PrecisionSpec.from_mode(mode), orth="cgsr",
                      precond=prec, jacobi_steps=2, restart_length=8,
                      tol=1e-8)
    want_fmt = DIAMatrix if matrix == "banded" else CSRMatrix

    assert type(stage(A)) is want_fmt
    A_out, A_in = prepare_operators(A, cfg)
    for op, dt in ((A_out, cfg.precision.outer), (A_in, cfg.precision.inner)):
        assert type(op) is want_fmt
        assert not hasattr(op, "data_hi")
        assert op.dtype == jnp.dtype(dt)
    M = build_preconditioner(A, cfg)
    assert isinstance(M, PRECS[prec])

    b = jnp.asarray(rand_vect(A.n_rows, 3))
    one = jnp.float64(1.0)
    jaxpr = jax.make_jaxpr(
        lambda Ao, Ai, M, b, x: restart_cycle_impl(
            cfg, Ao, Ai, M, b, x, one, one, one, initial_policy_state())
    )(A_out, A_in, jax.device_put(M), b, jnp.zeros_like(b))
    prims = _primitives(jaxpr.jaxpr)
    assert not any("pallas" in p for p in prims), prims
    assert {"while", "scan"} & prims  # the inner Arnoldi loop was traced


@pytest.mark.parametrize("mode", ["mixed", "baseline"])
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_distributed_routes(on_gpu, matrix, mode):
    """solve_distributed never stages SELL or a double-float operator by
    itself, and converges to the same restart count as solve()."""
    from gmres_tpu import solve, solve_distributed
    from gmres_tpu.parallel import dist_gmres

    A = MATRICES[matrix]()
    S = A.to_scipy()
    x_true = rand_vect(A.n_rows, 5)
    b = S @ x_true
    cfg = GmresConfig(precision=PrecisionSpec.from_mode(mode), orth="cgsr",
                      precond="jacobi", restart_length=20, tol=1e-9,
                      max_restarts=300)
    mesh = jax.make_mesh((4,), ("rows",), devices=jax.devices()[:4])
    rd = solve_distributed(A, b, cfg, mesh=mesh)
    r1 = solve(A, b, cfg)
    assert rd.converged and r1.converged
    assert rd.restarts == r1.restarts
    assert len(rd.x.sharding.device_set) == 4
    staged = [v for v in dist_gmres._DIST_STAGE_CACHE[id(A)][1].values()
              if isinstance(v, tuple)]
    names = {type(op).__name__ for t in staged for op in t[:2]}
    assert names <= {"HaloDIA", "HaloCSR", "PartitionedCSR"}, names
    assert not any(hasattr(op, "data_hi") for t in staged for op in t[:2])
    np.testing.assert_allclose(np.asarray(rd.x), np.asarray(r1.x),
                               rtol=1e-5, atol=1e-8)
