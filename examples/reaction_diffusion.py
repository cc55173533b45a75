"""Structured Jacobians on a stiff reaction-diffusion chain.

A 1-D method-of-lines Fisher-KPP system (tridiagonal Jacobian) solved four
ways, all producing the same trajectory:

  * dense Newton (the default),
  * ``linear_solver='band'`` with declared bandwidths — banded LU, O(n·w²),
  * ``linear_solver='sparse'`` — exact symbolic sparsity -> RCM permutation
    -> banded LU at the permuted bandwidth (the KLU role; here the states
    are deliberately SCRAMBLED so the natural bandwidth is O(n) and only
    the permutation recovers the band),
  * ``linear_solver='spgmr'`` — matrix-free GMRES Newton.

Unbatched solves and gradient pairs on a SympyProblem route automatically
to the native C++ core (no SUNDIALS, no numba); the same options drive the
jitted JAX path for batches.  Reference analogs: sunode
linear_solver='band'/'spgmr' (solver.py:326-358) and the KLU wrapper
(linear_solver_wrapper.py:99-122).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("EXAMPLE_FORCE_CPU", "1") == "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from sunode_tpu.symode import SympyProblem
from sunode_tpu.solver import Solver, AdjointSolver

N = 32
rng = np.random.default_rng(7)
sigma = rng.permutation(N)  # scrambled state order: natural bandwidth ~N


def fisher_kpp(t, y, p):
    u = y.u
    out = [None] * N
    for j in range(N):
        v = sigma[j]
        left = u[sigma[j - 1]] if j > 0 else 0
        right = u[sigma[j + 1]] if j < N - 1 else 0
        out[v] = p.k * (left - 2 * u[v] + right) + p.r * u[v] * (1 - u[v])
    return {"u": np.array(out, dtype=object)}


problem = SympyProblem(
    params={"k": (), "r": ()},
    states={"u": (N,)},
    rhs_sympy=fisher_kpp,
    derivative_params=[("k",), ("r",)],
)

y0 = 0.5 + 0.4 * np.sin(np.pi * np.arange(N) / (N - 1))
tvals = np.array([0.05, 0.2, 0.5, 1.0])
params = {"k": float(N * N / 8), "r": 1.5}  # stiff diffusion

# NOTE: no 'band' entry: declared bandwidths refer to the STORAGE order,
# and in the scrambled ordering the true bandwidths are O(N) — declaring
# (1, 1) would be a codegen error.  'sparse' finds the permutation that
# makes (1, 1) true; see docs/quickstart.md §6 for a naturally-ordered
# banded example.
configs = {
    "dense": {},
    "sparse": dict(linear_solver="sparse"),
    "spgmr": dict(linear_solver="spgmr"),
}

ref = None
for name, kw in configs.items():
    s = Solver(problem, abstol=1e-10, reltol=1e-8, **kw)
    s.set_params_dict(params)
    t0 = time.perf_counter()
    out = np.asarray(s.solve(0.0, tvals, y0))
    dt = (time.perf_counter() - t0) * 1e3
    if ref is None:
        ref = out
    err = np.max(np.abs(out - ref) / (1e-12 + np.abs(ref)))
    print(f"{name:7s} first solve {dt:8.1f} ms   max rel vs dense {err:.2e}")

# gradient pair through the sparse (RCM-permuted banded) stiff adjoint
adj = AdjointSolver(problem, reltol=1e-8, abstol=1e-8, linear_solver="sparse")
adj.set_params_dict(params)
ys = adj.solve_forward(0.0, tvals, y0)
grads = np.ones((len(tvals), N))
quad, lam = adj.solve_backward(tvals[-1], 0.0, tvals, grads)
print(
    "sparse adjoint dL/dk =", float(np.asarray(quad)[0]),
    " dL/dr =", float(np.asarray(quad)[1]),
)

# the sparse plan itself, for the curious
from sunode_tpu.ops.sparsity import SparsePlan  # noqa: E402

jac = np.asarray(problem._sym_dydt_jac, dtype=object)
pattern = np.vectorize(lambda e: e != 0)(jac).astype(bool)
plan = SparsePlan(pattern)
nat = max(abs(i - j) for i in range(N) for j in range(N) if pattern[i, j])
print(
    f"natural bandwidth {nat} -> RCM ({plan.lower}, {plan.upper}); "
    + plan.density_summary()
)
