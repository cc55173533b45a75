"""Batched stiff structured Newton at scale (VERDICT r3 item 1 "Done" gate).

The stiff large-state batched quadrant: a Fisher-KPP reaction-diffusion
chain (tridiagonal Jacobian, diffusion CFL ~1/(2D) makes BDF+Newton
mandatory) at n>=128 states and B>=1024 lanes — the workload class where
CVODES users reach for band/KLU
(/root/reference/sunode/linear_solver_wrapper.py:99-122).

Compares, on the same problem/tolerances:
  * batch-native band  — ``bdf_solve_batched(linear_solver='band')``:
    B lockstep banded LUs factored in ONE static column loop, O(B n w^2)
  * vmap fallback      — ``vmap(bdf_solve)`` with the single-lane banded
    Newton (what batched band/sparse users got before round 4)
  * adjoint gradients through ``make_batched_solve_fn(linear_solver='band')``
    (backward matrix at the transposed bandwidths)

Correctness is golden-gated against scipy LSODA at rtol 1e-11 on a lane
sample before any timing is reported.

Run on the real chip:  python scripts/bench_batched_structured.py [n] [B]
Results are recorded in docs/performance.md.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from sunode_tpu.ops.bdf import BDFOptions, bdf_solve
from sunode_tpu.ops.bdf_batched import bdf_solve_batched
from sunode_tpu.problem import JaxProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
B = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
# adjoint checkpoint rows: (CKPT+1, ~3N+2, B) f64 lives in device memory —
# 8192 rows at N=128/B=1024 is ~26 GB.  The solve takes a few hundred
# steps; 1024 rows is plenty (~3.2 GB).
CKPT = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
RTOL, ATOL = 1e-8, 1e-10
N_GOLD = 3  # lanes checked against the scipy oracle


def rhs(t, y, p):
    u = y.u
    lap = jnp.concatenate([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
    lap2 = jnp.concatenate(
        [jnp.zeros(1, u.dtype), u[:-2] - u[1:-1], jnp.zeros(1, u.dtype)]
    )
    return {"u": p.D * (lap + lap2) + p.r * u * (1.0 - u)}


problem = JaxProblem(
    params={"D": (), "r": ()},
    states={"u": (N,)},
    rhs=rhs,
    derivative_params=[("D",), ("r",)],
)

rng = np.random.default_rng(0)
y0 = 0.5 + 0.3 * rng.random((B, N))
# D ~ n^2/4 keeps the diffusion timescale ~(n/pi)^2/D = O(1) stiffness ratio
D_scale = 0.25 * N * N / 64.0
params = np.stack(
    [D_scale * (1 + 0.2 * rng.random(B)), 1.0 + 0.1 * rng.random(B)], axis=1
)
tvals = np.linspace(0.05, 1.0, 8)

opts_band = BDFOptions(
    rtol=RTOL, atol=ATOL, linear_solver="band", band_lower=1, band_upper=1
)
rhs_f = problem.make_rhs()
jac_band = problem.make_banded_jac(1, 1)

y0_j = jnp.asarray(y0)
p_j = jnp.asarray(params)
t_j = jnp.asarray(tvals)


def _golden_gate(ys):
    """scipy LSODA at rtol 1e-11 on N_GOLD lanes — independent oracle."""
    from scipy.integrate import solve_ivp as scipy_solve

    def f_np(t, u, D, r):
        lap = np.empty_like(u)
        lap[0] = u[1] - u[0]
        lap[-1] = u[-2] - u[-1]
        lap[1:-1] = u[2:] - 2 * u[1:-1] + u[:-2]
        return D * lap + r * u * (1 - u)

    for i in range(N_GOLD):
        sol = scipy_solve(
            f_np,
            (0.0, tvals[-1]),
            y0[i],
            t_eval=tvals,
            method="LSODA",
            rtol=1e-11,
            atol=1e-13,
            args=(params[i, 0], params[i, 1]),
        )
        err = np.max(np.abs(np.asarray(ys)[i] - sol.y.T))
        assert err < 5e-6, f"lane {i} golden gate failed: max err {err:.2e}"
    print(f"golden gate: {N_GOLD} lanes vs LSODA(1e-11) OK (max err {err:.2e})")


def _time(fn, *args, repeats=3):
    out = jax.block_until_ready(fn(*args))  # compile
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


# --- batch-native band -------------------------------------------------------
fwd_native = jax.jit(
    lambda y, p: bdf_solve_batched(rhs_f, jac_band, 0.0, y, p, t_j, opts_band)
)
t_native, res = _time(fwd_native, y0_j, p_j)
assert np.all(np.asarray(res.status) == 0), "batch-native band solve failed"
_golden_gate(res.ys)
print(
    f"batch-native band   n={N} B={B}: {t_native * 1e3:8.1f} ms  "
    f"({B / t_native:9.1f} solves/s)"
)

# --- vmap(bdf_solve) fallback (pre-round-4 path) -----------------------------
fwd_vmap = jax.jit(
    jax.vmap(
        lambda y, p: bdf_solve(rhs_f, jac_band, 0.0, y, p, t_j, opts_band).ys
    )
)
t_vmap, ys_v = _time(fwd_vmap, y0_j, p_j)
print(
    f"vmap(bdf_solve)     n={N} B={B}: {t_vmap * 1e3:8.1f} ms  "
    f"({B / t_vmap:9.1f} solves/s)   [{t_vmap / t_native:.2f}x slower]"
)

# --- adjoint gradients through the structured batched path -------------------
solve_adj = make_batched_solve_fn(
    problem,
    derivatives="adjoint",
    options=opts_band._replace(linear_solver="dense"),
    checkpoint_n=CKPT,
    linear_solver="band",
    linear_solver_kwargs=dict(lower_bandwidth=1, upper_bandwidth=1),
)
p_fix = jnp.zeros((0,))


@jax.jit
def grad_fn(ps):
    return jax.grad(
        lambda q: jnp.sum(solve_adj(0.0, y0_j, q, p_fix, t_j) ** 2)
    )(ps)


t_grad, g = _time(grad_fn, p_j)
assert np.all(np.isfinite(np.asarray(g))), "banded batched adjoint grad not finite"
print(
    f"band adjoint grads  n={N} B={B}: {t_grad * 1e3:8.1f} ms  "
    f"({B / t_grad:9.1f} grads/s)"
)
print(
    f"SUMMARY n={N} B={B}: batch-native band {B / t_native:.0f} solves/s, "
    f"{t_vmap / t_native:.2f}x over vmap fallback, "
    f"{B / t_grad:.0f} adjoint grads/s (golden-gated)"
)
