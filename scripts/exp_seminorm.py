"""Seminorm-style adjoint error control on the north-star config.

"Hey, that's not an ODE": Faster ODE Adjoints via Seminorms (Kidger et
al., arXiv:2009.09457) shows backward adjoint solves waste steps
error-controlling components whose accuracy the gradient barely needs.
The transition-mode backward state here is [y | vec(M)] with a vec(W)
quadrature block; the gradient composes from M and W while y exists only
to evaluate J(y(t)).  Two knobs approximate the paper's seminorm WITHOUT
code changes, now that rtol may be a per-component vector:

  * loosen the M block:   adjoint rtol = [tight]*n + [loose]*n^2
  * loosen the W block:   quad_rtol / quad_atol

Measures grads/s and worst-lane golden error (scipy LSODA 1e-12 + central
FD fixture) per variant.  Run: python scripts/exp_seminorm.py  (GPU)
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
    n = 2
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
        os.path.join(
            os.path.dirname(__file__), "..", "tests", "golden", "lv_adjoint.npz"
        )
    )

    def run(label, adj_opts):
        solve = make_batched_solve_fn(
            problem,
            derivatives="adjoint",
            options=BDFOptions(rtol=1e-8, atol=1e-8, adams_max_order=6),
            adjoint_options=adj_opts,
            checkpoint_n=384,
            method="ADAMS",
            adjoint_interpolation="transition",
        )

        @jax.jit
        def grad_step(y0s_, p_subs_):
            def loss(y0s_, p_subs_):
                ys = solve(0.0, y0s_, p_subs_, p_fix, tvals)
                return jnp.sum(ys**2)

            return jax.grad(loss, argnums=(0, 1))(y0s_, p_subs_)

        gy, gp = jax.block_until_ready(grad_step(y0s, p_subs))
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            gy, gp = jax.block_until_ready(grad_step(y0s, p_subs))
            best = min(best, time.perf_counter() - t0)
        err_y = np.max(
            np.abs(np.asarray(gy[:16]) - g["gy"])
            / (np.abs(g["gy"]) + 1e-3)
        )
        err_p = np.max(
            np.abs(np.asarray(gp[:16]) - g["gp"])
            / (np.abs(g["gp"]) + 1e-3)
        )
        print(
            f"{label:38s}: {B/best:9.0f} grads/s | worst-lane err "
            f"dy0 {err_y:.2e} dp {err_p:.2e}"
        )
        return B / best, max(err_y, err_p)

    base = 1e-7
    rtol_vec = np.concatenate([np.full(n, base), np.full(n * n, 1e-5)])
    rtol_vec6 = np.concatenate([np.full(n, 1e-6), np.full(n * n, 1e-5)])
    variants = [
        ("baseline (scalar 1e-7, W at 1e-7)",
         BDFOptions(rtol=base, atol=base, adams_max_order=6)),
        ("W loose (quad 1e-5)",
         BDFOptions(rtol=base, atol=base, adams_max_order=6,
                    quad_rtol=1e-5, quad_atol=1e-5)),
        ("M loose (vector rtol 1e-5 on M)",
         BDFOptions(rtol=rtol_vec, atol=base, adams_max_order=6)),
        ("M+W loose 1e-5",
         BDFOptions(rtol=rtol_vec, atol=base, adams_max_order=6,
                    quad_rtol=1e-5, quad_atol=1e-5)),
        ("y 1e-6 + M 1e-5 + W 1e-5",
         BDFOptions(rtol=rtol_vec6, atol=1e-6, adams_max_order=6,
                    quad_rtol=1e-5, quad_atol=1e-5)),
    ]
    for loose in (1e-4, 1e-3):
        rv = np.concatenate([np.full(n, 1e-7), np.full(n * n, loose)])
        variants.append((
            f"y 1e-7 + M {loose:g} + W {loose:g}",
            BDFOptions(rtol=rv, atol=1e-7, adams_max_order=6,
                       quad_rtol=loose, quad_atol=loose),
        ))
    for ytol in (3e-7, 1e-6):
        rv = np.concatenate([np.full(n, ytol), np.full(n * n, 1e-3)])
        variants.append((
            f"y {ytol:g} + M/W 1e-3",
            BDFOptions(rtol=rv, atol=ytol, adams_max_order=6,
                       quad_rtol=1e-3, quad_atol=1e-3),
        ))
    picks = sys.argv[1:]
    for label, opts in variants:
        if picks and not any(p in label for p in picks):
            continue
        run(label, opts)


if __name__ == "__main__":
    main()


