"""Bayesian parameter inference for Lotka-Volterra with batch-lockstep NUTS.

The analog of the reference's notebooks/pymc_model.ipynb ("Usage in PyMC",
README.md:150-238): infer the posterior over (alpha, beta) from noisy
observations of a predator-prey system.  Where the reference forks one OS
process per PyMC chain, here the JAX-native NUTS (sunode_tpu/sample) runs
all chains in lockstep and every leapfrog step evaluates ONE batched
forward ODE solve + ONE batched adjoint solve for all chains together — on
the GPU this is the same kernel the 10k-chain benchmark uses.

Runs on CPU by default (fast startup); remove the platform override to run
on an accelerator.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("EXAMPLE_FORCE_CPU", "1") == "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from sunode_tpu.ops.bdf import BDFOptions
from sunode_tpu.sample import ess_bulk, nuts_sample, split_rhat
from sunode_tpu.symode import SympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn


def main():
    prob = SympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=lambda t, y, p: {
            "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
            "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
        },
        derivative_params=[("alpha",), ("beta",)],
    )
    solve = make_batched_solve_fn(
        prob,
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-8, atol=1e-8),
        adjoint_options=BDFOptions(rtol=1e-8, atol=1e-8),
        method="ADAMS",
        adjoint_interpolation="transition",
    )

    # ---- synthetic data from known parameters ---------------------------
    true = {"alpha": 1.0, "beta": 0.3}
    p_fix = jnp.asarray([1.0, 0.4])  # gamma, delta held fixed
    tvals = jnp.linspace(1.0, 10.0, 12)
    y0_single = jnp.asarray([10.0, 2.0])
    sigma = 0.1  # lognormal observation noise

    rng = np.random.default_rng(0)
    ys_true = solve(
        0.0,
        y0_single[None],
        jnp.asarray([[true["alpha"], true["beta"]]]),
        p_fix,
        tvals,
    )[0]
    obs_log = jnp.asarray(
        np.log(np.asarray(ys_true)) + sigma * rng.standard_normal(ys_true.shape)
    )

    # ---- posterior: lognormal likelihood, lognormal priors --------------
    C = 4
    y0s = jnp.broadcast_to(y0_single, (C, 2))
    mu0 = jnp.log(jnp.asarray([1.0, 0.3]))

    def logp(theta):  # theta = log(alpha, beta), (C, 2)
        ys = solve(0.0, y0s, jnp.exp(theta), p_fix, tvals)
        ys_safe = jnp.maximum(ys, 1e-10)
        loglik = -0.5 * jnp.sum(
            (jnp.log(ys_safe) - obs_log[None]) ** 2 / sigma**2, axis=(1, 2)
        )
        logprior = -0.5 * jnp.sum((theta - mu0) ** 2, axis=1)
        lp = loglik + logprior
        # a failed solve NaN-poisons -> -inf -> NUTS rejects the proposal
        return jnp.where(jnp.isfinite(lp), lp, -jnp.inf)

    key = jax.random.PRNGKey(0)
    init = mu0[None, :] + 0.3 * jax.random.normal(key, (C, 2))

    print(f"sampling {C} chains (200 warmup + 300 draws) ...")
    t0 = time.time()
    res = nuts_sample(
        logp, key, init, num_warmup=200, num_samples=300, max_treedepth=6
    )
    jax.block_until_ready(res.samples)
    wall = time.time() - t0

    s = np.exp(np.asarray(res.samples))  # (C, S, 2), natural scale
    rhat = split_rhat(np.asarray(res.samples))
    ess = ess_bulk(np.asarray(res.samples))
    n_div = int(np.asarray(res.diverging).sum())
    for i, name in enumerate(["alpha", "beta"]):
        post = s[:, :, i].reshape(-1)
        print(
            f"{name}: posterior {post.mean():.4f} +- {post.std():.4f} "
            f"(true {true[name]}), Rhat {rhat[i]:.4f}, ESS {ess[i]:.0f}"
        )
    print(f"divergences: {n_div}/{res.diverging.size}")
    print(f"wall: {wall:.1f}s  (step size {float(res.step_size):.3f})")
    assert (rhat < 1.05).all() and n_div == 0


if __name__ == "__main__":
    main()
