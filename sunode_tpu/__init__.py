"""sunode_tpu — differentiable ODE solving in JAX/XLA.

A from-scratch rebuild of the capabilities of pymc-devs/sunode on an
accelerator: symbolically-defined (or direct-JAX) ODE problems, a
variable-order adaptive BDF/Adams integrator running inside
``lax.while_loop``, forward sensitivities, checkpointed adjoint gradients via
``jax.custom_vjp``, and vmapped/sharded batches of solves across a device
mesh.

Numerical work defaults to float64 (the reference's ``data_dtype``,
reference basic.py:40-43); we enable jax x64 mode on import unless
``SUNODE_TPU_NO_X64`` is set.  The computation dtype follows the inputs
end-to-end: float32 arrays run the whole pipeline in f32 (see
docs/performance.md "f32 speed mode").

``SympyProblem`` is resolved lazily, so ``import sunode_tpu``, ``JaxProblem``
and the batched solvers work where sympy is not installed.
"""

import os as _os

if not _os.environ.get("SUNODE_TPU_NO_X64"):
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from sunode_tpu.paramspec import ParamSpec, Record  # noqa: E402
from sunode_tpu.problem import JaxProblem, Problem  # noqa: E402
from sunode_tpu.solver import AdjointSolver, Solver, SolverError  # noqa: E402
import sunode_tpu.solver  # noqa: E402,F401  (reference parity: `import sunode.solver`)
from sunode_tpu.sample import nuts_sample, split_rhat, ess_bulk  # noqa: E402
from sunode_tpu.events import (  # noqa: E402
    HybridResult,
    make_event_fn,
    make_hybrid_solve_fn,
)

__all__ = [
    "make_event_fn",
    "make_hybrid_solve_fn",
    "HybridResult",
    "ParamSpec",
    "Record",
    "Problem",
    "JaxProblem",
    "SympyProblem",
    "Solver",
    "AdjointSolver",
    "SolverError",
    "nuts_sample",
    "split_rhat",
    "ess_bulk",
    "__version__",
]


def __getattr__(name):
    # sympy is a host-side code generator: import it only when asked for
    if name == "SympyProblem":
        from sunode_tpu.symode import SympyProblem

        return SympyProblem
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
