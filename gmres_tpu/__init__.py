"""Mixed-precision GMRES framework in JAX, run on NVIDIA GPUs through XLA.

A from-scratch re-design of the capabilities of the ICL/UTK mixed-precision
GMRES research code (``iamsonderr/icl-mixed-precision-gmres``, SMC 2020,
arXiv 2011.01850):

- restarted GMRES(m) over MatrixMarket CSR matrices, with the full precision
  configuration matrix of the reference (uniform-fp64 baseline,
  low-precision preconditioner, mixed high-outer/low-inner
  iterative-refinement style, uniform low precision) generalized into
  explicit dtype staging (fp64 / fp32 / bf16);
- CGS / MGS / CGSR orthogonalization;
- identity / Jacobi / ILU(0) (exact, level-scheduled) / ILU-Jacobi
  preconditioners;
- fixed-length / relative-preconditioned-residual / repeated-iteration /
  lost-orthogonality restart policies, all evaluated **on device** inside a
  single jitted restart cycle (the reference syncs to host every inner
  iteration; see ``gmres.cpp:113-114``);
- row-partitioned multi-device execution via ``shard_map`` with
  psum-allreduced reductions (new scope vs the single-device reference).

The mixed-precision scheme keeps fp64 work to O(1) vector operations per
restart; the inner Arnoldi loop moves half the bytes in fp32.  Which
device the solver runs on is decided in ``gmres_tpu.backend``.
"""

import jax as _jax

# The framework's high-precision outer loop requires fp64 semantics.  The
# reference library is fp64-first (gmres.cpp instantiates double everywhere);
# we follow suit and enable x64 at import, before any tracing happens.
_jax.config.update("jax_enable_x64", True)

from gmres_tpu.config import (  # noqa: E402
    GmresConfig,
    Mode,
    Orth,
    Precond,
    RestartPolicy,
    PrecisionSpec,
)
from gmres_tpu.sparse import CSRMatrix, csr_from_coo, csr_from_dense  # noqa: E402
from gmres_tpu.ops.dia import DIAMatrix  # noqa: E402
from gmres_tpu.ops.sell import SELLMatrix, sell_from_csr  # noqa: E402
from gmres_tpu.parallel.dist_gmres import solve_distributed  # noqa: E402
from gmres_tpu.solver.gmres import solve, stage, GmresResult  # noqa: E402
from gmres_tpu.solver.batched import solve_batched  # noqa: E402
from gmres_tpu.io.loader import load_matrix, load_vector  # noqa: E402
from gmres_tpu.io.rng import rand_vect  # noqa: E402

__all__ = [
    "GmresConfig",
    "Mode",
    "Orth",
    "Precond",
    "RestartPolicy",
    "PrecisionSpec",
    "CSRMatrix",
    "DIAMatrix",
    "SELLMatrix",
    "sell_from_csr",
    "csr_from_coo",
    "csr_from_dense",
    "solve_distributed",
    "solve",
    "solve_batched",
    "stage",
    "GmresResult",
    "load_matrix",
    "load_vector",
    "rand_vect",
]

__version__ = "0.1.0"
