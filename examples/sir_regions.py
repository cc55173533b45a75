"""Multi-region SIR with batched adjoint gradients (BASELINE config 5, scaled).

The full configuration (1k regions x 10k chains) needs several devices — the
f64 adjoint checkpoints alone exceed one device's memory; the chain axis
shards over a mesh exactly as in ``__graft_entry__.dryrun_multichip``.  This
script runs the same model family at laptop scale.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("EXAMPLE_FORCE_CPU", "1") == "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax
import jax.numpy as jnp

from sunode_tpu.ops.bdf import BDFOptions
from sunode_tpu.problem import JaxProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

R = 64  # regions
B = 32  # chains


def rhs(t, y, p):
    I_eff = y.I + p.mix * (jnp.roll(y.I, 1) + jnp.roll(y.I, -1))
    inf = p.beta * y.S * I_eff
    rec = p.gamma * y.I
    return {"S": -inf, "I": inf - rec, "R": rec}


problem = JaxProblem(
    params={"beta": (), "gamma": (), "mix": ()},
    states={"S": (R,), "I": (R,), "R": (R,)},
    rhs=rhs,
    derivative_params=[("beta",), ("gamma",)],
)

solve = make_batched_solve_fn(
    problem,
    derivatives="adjoint",
    options=BDFOptions(rtol=1e-8, atol=1e-10),
    adjoint_options=BDFOptions(rtol=1e-8, atol=1e-10),
    checkpoint_n=1024,
    method="ADAMS",  # non-stiff: no Jacobians at all
)

rng = np.random.default_rng(0)
S0 = 0.99 + 0.005 * rng.standard_normal((B, R))
I0 = 0.01 * np.abs(1 + 0.1 * rng.standard_normal((B, R)))
y0 = jnp.asarray(np.concatenate([S0, I0, np.zeros((B, R))], axis=1))
psub = jnp.asarray(
    np.stack(
        [0.4 * (1 + 0.05 * rng.standard_normal(B)),
         0.15 * (1 + 0.05 * rng.standard_normal(B))],
        axis=1,
    )
)
p_fix = jnp.asarray([0.05])
tvals = jnp.linspace(5.0, 60.0, 12)


def loss(psub):
    ys = solve(0.0, y0, psub, p_fix, tvals)
    return jnp.sum(ys[:, :, R : 2 * R] ** 2)  # fit infected trajectories


gfn = jax.jit(jax.grad(loss))
g = gfn(psub)
g.block_until_ready()
t0 = time.perf_counter()
g = gfn(psub)
g.block_until_ready()
dt = time.perf_counter() - t0
print(f"{B} chains x {3*R} states: adjoint gradient in {dt*1000:.0f} ms "
      f"({B/dt:.0f} grad solves/s)")
print("dL/dbeta (first 4 chains):", np.asarray(g[:4, 0]))
print("all finite:", bool(jnp.isfinite(g).all()))
