"""f32 speed mode: the adjoint pipeline in f32.

For workloads content with rtol ~1e-5..1e-6 the whole pipeline can run in
f32 (SUNODE_TPU_NO_X64=1 + f32 inputs).  This measures the
north-star workload in that mode and reports the gradient error against
the committed tight-tolerance golden fixture.

Run: python scripts/exp_f32.py   (re-execs itself with x64 disabled)
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("SUNODE_TPU_NO_X64") != "1":
    env = dict(os.environ, SUNODE_TPU_NO_X64="1")
    raise SystemExit(
        subprocess.run([sys.executable, os.path.abspath(__file__)], env=env).returncode
    )

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    assert not jax.config.jax_enable_x64

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
    tvals = jnp.linspace(1.0, 10.0, 21).astype(jnp.float32)
    p_fix = jnp.array([1.0, 0.4], jnp.float32)
    rng = np.random.default_rng(42)
    y0s = jnp.asarray(
        np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2))),
        jnp.float32,
    )
    p_subs = jnp.asarray(
        np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((B, 2))),
        jnp.float32,
    )
    g = np.load(
        os.path.join(
            os.path.dirname(__file__), "..", "tests", "golden", "lv_adjoint.npz"
        )
    )
    y0s = y0s.at[:16].set(jnp.asarray(g["y0s"], jnp.float32))
    p_subs = p_subs.at[:16].set(jnp.asarray(g["p_subs"], jnp.float32))

    for fwd_rtol, bwd_rtol in ((1e-5, 1e-4), (1e-6, 1e-5)):
        solve = make_batched_solve_fn(
            problem,
            derivatives="adjoint",
            options=BDFOptions(rtol=fwd_rtol, atol=fwd_rtol, adams_max_order=6),
            adjoint_options=BDFOptions(
                rtol=bwd_rtol, atol=bwd_rtol, adams_max_order=6
            ),
            method="ADAMS",
            adjoint_interpolation="transition",
        )

        def loss(y0s, p_subs):
            return jnp.sum(solve(0.0, y0s, p_subs, p_fix, tvals) ** 2)

        step = jax.jit(jax.grad(loss, argnums=(0, 1)))
        try:
            gy, gp = step(y0s, p_subs)
            jax.block_until_ready(gy)
        except Exception as e:  # noqa: BLE001
            print(f"rtol {fwd_rtol:.0e}: FAILED: {type(e).__name__}: {e}")
            continue
        n_fin = int(jnp.isfinite(gy).all(axis=-1).sum())
        err_y = np.max(
            np.abs(np.asarray(gy[:16], np.float64) - g["gy"])
            / (np.abs(g["gy"]) + 1e-3)
        )
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            gy, gp = step(y0s, p_subs)
            jax.block_until_ready(gy)
            times.append(time.perf_counter() - t0)
        print(
            f"f32 fwd rtol {fwd_rtol:.0e} / bwd {bwd_rtol:.0e}: "
            f"{B/min(times):8.0f} grads/s  golden err {err_y:.2e}  "
            f"finite {n_fin}/{B}  dtype {gy.dtype}"
        )


if __name__ == "__main__":
    main()
