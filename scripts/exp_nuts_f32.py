"""BASELINE config 4 at scale and at both precisions: LV adjoint inside NUTS.

Runs the lockstep NUTS sampler over many chains on the chip, each leapfrog
step = ONE batched forward solve + ONE batched transition-adjoint solve for
ALL chains, at f64 (rtol 1e-8, the tolerance-matched config) and in the f32
speed mode (rtol 1e-6/1e-5).  Reports wall time, gradient-evaluation
throughput (chains x leapfrog steps / s), posterior recovery, Rhat, and
divergences.

Run: python scripts/exp_nuts_f32.py [--chains 512]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from sunode_tpu.ops.bdf import BDFOptions
from sunode_tpu.sample import ess_bulk, nuts_sample, split_rhat
from sunode_tpu.symode import SympyProblem
from sunode_tpu.utils.compile_cache import use_checkout_cache
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

use_checkout_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

TRUE = {"alpha": 1.0, "beta": 0.3}
SIGMA = 0.1


def build_problem():
    return SympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=lambda t, y, p: {
            "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
            "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
        },
        derivative_params=[("alpha",), ("beta",)],
    )


def run(prob, obs_log64, C, dtype, fwd_rtol, bwd_rtol, num_warmup, num_samples):
    # max_steps=2000 (vs the 100k library default): inside a sampler, early
    # warmup proposes pathological parameters; in a LOCKSTEP batch one such
    # chain makes every other chain pay its full step budget, so the budget
    # must be small enough that a doomed solve dies in ~ms and NaN-poisons
    # into an ordinary NUTS rejection (the reference ships mxstep=500 for
    # the same reason).  A sane LV solve here takes ~300 steps.
    solve = make_batched_solve_fn(
        prob,
        derivatives="adjoint",
        options=BDFOptions(
            rtol=fwd_rtol, atol=fwd_rtol, adams_max_order=6, max_steps=2000
        ),
        adjoint_options=BDFOptions(
            rtol=bwd_rtol, atol=bwd_rtol, adams_max_order=6, max_steps=4000
        ),
        method="ADAMS",
        adjoint_interpolation="transition",
    )
    tvals = jnp.linspace(1.0, 10.0, 12).astype(dtype)
    p_fix = jnp.asarray([1.0, 0.4], dtype)
    y0s = jnp.broadcast_to(jnp.asarray([10.0, 2.0], dtype), (C, 2))
    obs_log = jnp.asarray(obs_log64, dtype)
    mu0 = jnp.log(jnp.asarray([1.0, 0.3], dtype))

    def logp(theta):
        ys = solve(0.0, y0s, jnp.exp(theta), p_fix, tvals)
        ys_safe = jnp.maximum(ys, 1e-10)
        loglik = -0.5 * jnp.sum(
            (jnp.log(ys_safe) - obs_log[None]) ** 2 / SIGMA**2, axis=(1, 2)
        )
        logprior = -0.5 * jnp.sum((theta - mu0) ** 2, axis=1)
        lp = loglik + logprior
        return jnp.where(jnp.isfinite(lp), lp, -jnp.inf)

    key = jax.random.PRNGKey(0)
    init = mu0[None, :] + 0.3 * jax.random.normal(key, (C, 2), dtype)
    t0 = time.time()
    res = nuts_sample(
        logp, key, init, num_warmup=num_warmup, num_samples=num_samples,
        max_treedepth=6, dispatch_chunk=10,
    )
    jax.block_until_ready(res.samples)
    wall = time.time() - t0

    samples = np.asarray(res.samples, np.float64)
    s_nat = np.exp(samples)
    rhat = split_rhat(samples)
    ess = ess_bulk(samples)
    n_div = int(np.asarray(res.diverging).sum())
    # leapfrog count: tree of depth D costs 2^D - 1 gradient evals; the
    # recorded depth is per draw (post-warmup); scale to include warmup
    depths = np.asarray(res.tree_depth, np.float64)
    grads_per_draw = (2.0**depths - 1).mean()
    total_grads = C * grads_per_draw * (num_warmup + num_samples)
    print(f"  dtype {np.dtype(samples.dtype).name if False else res.samples.dtype}"
          f"  wall {wall:6.1f}s  ~{total_grads / wall:8.0f} grad evals/s"
          f"  divergences {n_div}")
    for i, name in enumerate(["alpha", "beta"]):
        post = s_nat[:, :, i].reshape(-1)
        print(
            f"    {name}: {post.mean():.4f} +- {post.std():.4f} "
            f"(true {TRUE[name]}), Rhat {rhat[i]:.4f}, ESS {ess[i]:.0f}"
        )
    return wall, total_grads / wall, rhat, n_div


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--samples", type=int, default=300)
    ap.add_argument("--skip-f64", action="store_true")
    ap.add_argument("--skip-f32", action="store_true")
    args = ap.parse_args()

    prob = build_problem()
    # synthetic data at tight tolerance, f64
    solve64 = make_batched_solve_fn(
        prob,
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-10, atol=1e-10, adams_max_order=6),
        method="ADAMS",
        adjoint_interpolation="transition",
    )
    tvals = jnp.linspace(1.0, 10.0, 12)
    ys_true = solve64(
        0.0,
        jnp.asarray([[10.0, 2.0]]),
        jnp.asarray([[TRUE["alpha"], TRUE["beta"]]]),
        jnp.asarray([1.0, 0.4]),
        tvals,
    )[0]
    rng = np.random.default_rng(0)
    obs_log64 = np.log(np.asarray(ys_true)) + SIGMA * rng.standard_normal(
        ys_true.shape
    )

    C = args.chains
    if not args.skip_f64:
        print(f"f64 (rtol 1e-8), {C} chains:")
        run(prob, obs_log64, C, jnp.float64, 1e-8, 1e-7, args.warmup, args.samples)
    if not args.skip_f32:
        print(f"f32 speed mode (rtol 1e-6/1e-5), {C} chains:")
        run(prob, obs_log64, C, jnp.float32, 1e-6, 1e-5, args.warmup, args.samples)


if __name__ == "__main__":
    main()
