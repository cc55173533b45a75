"""Backward-tolerance sweep on the north-star config.

The measured gradient error of the transition adjoint at backward
rtol=1e-8 is ~4e-5 worst-lane vs the golden FD fixture — 50x inside the
2e-3 gate.  The backward (fundamental-matrix) solve dominates wall time,
and its step count scales ~rtol^(-1/(p+1)); loosening ONLY the backward
tolerance trades unused accuracy margin for throughput.  This sweep
measures grads/s and golden error per backward rtol.

Run: python scripts/exp_bwd_tol.py   (GPU; several compiles)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.symode import SympyProblem
    from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

    problem = SympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=lambda t, y, p: {
            "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
            "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
        },
        derivative_params=[("alpha",), ("beta",)],
    )
    B = 10_000
    tvals = jnp.linspace(1.0, 10.0, 21)
    p_fix = jnp.array([1.0, 0.4])
    rng = np.random.default_rng(42)
    y0s = jnp.asarray(
        np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2)))
    )
    p_subs = jnp.asarray(
        np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((B, 2)))
    )
    g = np.load(
        os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "lv_adjoint.npz")
    )
    y0s = y0s.at[:16].set(jnp.asarray(g["y0s"]))
    p_subs = p_subs.at[:16].set(jnp.asarray(g["p_subs"]))

    for bwd_rtol in (1e-8, 3e-8, 1e-7, 1e-6):
        solve = make_batched_solve_fn(
            problem,
            derivatives="adjoint",
            options=BDFOptions(rtol=1e-8, atol=1e-8, adams_max_order=6),
            adjoint_options=BDFOptions(
                rtol=bwd_rtol, atol=bwd_rtol, adams_max_order=6
            ),
            method="ADAMS",
            adjoint_interpolation="transition",
        )

        def loss(y0s, p_subs):
            return jnp.sum(solve(0.0, y0s, p_subs, p_fix, tvals) ** 2)

        step = jax.jit(jax.grad(loss, argnums=(0, 1)))
        gy, gp = step(y0s, p_subs)
        jax.block_until_ready(gy)
        err_y = np.max(
            np.abs(np.asarray(gy[:16]) - g["gy"]) / (np.abs(g["gy"]) + 1e-3)
        )
        err_p = np.max(
            np.abs(np.asarray(gp[:16]) - g["gp"]) / (np.abs(g["gp"]) + 1e-3)
        )
        n_fin = int(jnp.isfinite(gy).all(axis=-1).sum())
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            gy, gp = step(y0s, p_subs)
            jax.block_until_ready(gy)
            times.append(time.perf_counter() - t0)
        gps = B / min(times)
        print(
            f"bwd_rtol {bwd_rtol:.0e}: {gps:8.0f} grads/s  "
            f"golden err gy {err_y:.2e} gp {err_p:.2e}  finite {n_fin}/{B}"
        )


if __name__ == "__main__":
    main()
