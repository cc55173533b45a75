"""BASELINE config 5 at scale: SIR 1000-region adjoint gradients, one chip.

Measures the largest (regions x chains) configuration that fits a single
card and the achieved gradient throughput, for the three adjoint modes:

  * hermite    — checkpointed (S, 1+2n, B) f64 buffer: HBM-bound
  * resolve    — re-integrates y backward with lambda: NO checkpoints
  * (transition is n^2-state: wrong family at n = 3000, excluded by design)

Run on the real chip:  python scripts/bench_sir_scale.py [--f32] [R] [B ...]
(--f32: the f32 speed mode at rtol 1e-5 / atol 1e-7 — the SIR states are
O(1) fractions, comfortably inside f32 resolution; halves every buffer.)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from sunode_tpu.ops.bdf import BDFOptions
from sunode_tpu.utils.compile_cache import use_checkout_cache
from sunode_tpu.problem import JaxProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

argv = [a for a in sys.argv[1:] if not a.startswith("--")]
F32 = "--f32" in sys.argv[1:]
MODES = ("resolve", "hermite")
for a in sys.argv[1:]:
    if a.startswith("--modes="):
        MODES = tuple(a.split("=", 1)[1].split(","))
DTYPE = jnp.float32 if F32 else jnp.float64
RTOL, ATOL = (1e-5, 1e-7) if F32 else (1e-8, 1e-10)
R = int(argv[0]) if argv else 1000
BS = [int(b) for b in argv[1:]] or [64, 256, 1024]


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

tvals = jnp.linspace(5.0, 60.0, 12).astype(DTYPE)
p_fix = jnp.asarray([0.05], DTYPE)


SEMINORM = "--seminorm" in sys.argv[1:]


def build(mode, checkpoint_n=1024):
    adj_opts = BDFOptions(rtol=RTOL, atol=ATOL)
    if SEMINORM and mode == "resolve":
        # seminorm error control (Kidger et al., arXiv:2009.09457; see
        # scripts/exp_seminorm.py): the resolve backward state is [y | λ] —
        # only y's accuracy compounds into the gradient (it feeds J(y(t)));
        # the λ block's local error enters linearly, so it carries a loose
        # weight, expressed directly via the per-component rtol vector
        adj_rtol = np.concatenate([np.full(3 * R, RTOL), np.full(3 * R, 1e-3)])
        adj_opts = BDFOptions(
            rtol=adj_rtol, atol=ATOL, quad_rtol=1e-3, quad_atol=1e-3
        )
    return make_batched_solve_fn(
        problem,
        derivatives="adjoint",
        options=BDFOptions(rtol=RTOL, atol=ATOL),
        adjoint_options=adj_opts,
        checkpoint_n=checkpoint_n,
        method="ADAMS",
        adjoint_interpolation=mode,
    )


GOLDEN = os.path.join(
    os.path.dirname(HERE := os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden", "sir_1000.npz",
)


def run(mode, B):
    solve = build(mode)
    rng = np.random.default_rng(0)
    S0 = 0.99 + 0.005 * rng.standard_normal((B, R))
    I0 = 0.01 * np.abs(1 + 0.1 * rng.standard_normal((B, R)))
    y0 = np.concatenate([S0, I0, np.zeros((B, R))], axis=1)
    psub = np.stack(
        [0.4 * (1 + 0.05 * rng.standard_normal(B)),
         0.15 * (1 + 0.05 * rng.standard_normal(B))],
        axis=1,
    )
    # correctness gate (BASELINE bar: throughput only counts for a solve
    # that is right): pin lane 0 to the committed independent oracle
    # (scipy DOP853 rtol=1e-12 + central FD, tests/golden/sir_1000.npz)
    golden = None
    if R == 1000 and os.path.exists(GOLDEN):
        golden = np.load(GOLDEN)
        y0[0] = golden["y0"]
        psub[0] = golden["p0"][:2]
        np.testing.assert_allclose(
            float(p_fix[0]), golden["p0"][2], rtol=1e-6
        )  # device roundtrip may differ in the last ulp
    y0 = jnp.asarray(y0, DTYPE)
    psub = jnp.asarray(psub, DTYPE)

    def loss(psub):
        ys = solve(0.0, y0, psub, p_fix, tvals)
        # lane 0's trajectory rides along as aux so the correctness gate
        # reuses THIS compiled program (a separate forward-only solve would
        # double the multi-minute AOT compile per configuration)
        return jnp.sum(ys[:, :, R : 2 * R] ** 2), ys[0]

    gfn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, ys0_dev), g = gfn(psub)
    g.block_until_ready()
    assert bool(jnp.isfinite(g).all()), f"non-finite gradients ({mode}, B={B})"
    if golden is not None:
        # lanes are independent, so g[0] is lane 0's dL0/d(beta, gamma)
        ys0 = np.asarray(ys0_dev, np.float64)
        if F32:
            np.testing.assert_allclose(ys0, golden["ys"], rtol=1e-2, atol=2e-3)
            np.testing.assert_allclose(
                np.asarray(g[0], np.float64), golden["gp"], rtol=2e-2
            )
        else:
            np.testing.assert_allclose(ys0, golden["ys"], rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(
                np.asarray(g[0], np.float64), golden["gp"], rtol=1e-3
            )
        print(f"  lane-0 golden gate OK ({'f32' if F32 else 'f64'})")
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        (_, _), g = gfn(psub)
    g.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    print(
        f"mode={mode:10s} R={R} B={B:6d}: {dt*1e3:8.1f} ms/grad-batch "
        f"= {B/dt:9.1f} grad solves/s"
    )
    return B / dt


if __name__ == "__main__":
    use_checkout_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    print("devices:", jax.devices())
    for mode in MODES:
        for B in BS:
            try:
                run(mode, B)
            except Exception as e:  # OOM etc: record and continue
                print(f"mode={mode:10s} R={R} B={B:6d}: FAILED ({type(e).__name__}: {e})")
                break
