"""Benchmarks for the BASELINE.json configs.

Default: vmapped Lotka-Volterra adjoint-gradient solves/sec on one GPU —
the north-star metric.  The reference's own number
for one adjoint forward+backward pair is 1.25 ms on the author's CPU
(BASELINE.md — from_sympy.ipynb cell 7), i.e. 800 gradient pairs/sec;
``vs_baseline`` is measured throughput divided by that.

Other configs (``--config``): robertson (stiff BDF wall-clock),
lv_forward (forward solve), lv_sens (forward sensitivities).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"},
where "device" names the platform, ``device_kind``, device count and the
card's name and power limit from nvidia-smi.  Exits non-zero, measuring
nothing, when JAX finds no GPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_GRADS_PER_SEC = 800.0  # 1.25 ms per adjoint pair (BASELINE.md)
REFERENCE_LV_FORWARD_SEC = 200e-6  # README.md:128-130 (~200us, rtol 1e-10)


def _lv_problem():
    import __graft_entry__ as ge

    return ge.lv_problem(symbolic=True)


def bench_lv_adjoint(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as ge

    if args.batch == 1:
        return _bench_lv_adjoint_single(args)

    fn, _ = ge._build(
        batch=args.batch, tvals_n=21, rtol=args.rtol, checkpoint_n=384
    )
    rng = np.random.default_rng(42)
    y0s = jnp.asarray(
        np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((args.batch, 2)))
    )
    p_subs = jnp.asarray(
        np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((args.batch, 2)))
    )

    step = jax.jit(fn)
    gy, gp = step(y0s, p_subs)
    gy.block_until_ready()
    n_finite = int(jnp.isfinite(gy).all(axis=-1).sum())
    assert n_finite == args.batch, f"only {n_finite}/{args.batch} chains succeeded"

    # correctness gate: the measured gradients must tolerance-match the
    # committed independent oracle (scipy LSODA rtol=1e-12 + central FD,
    # tests/golden/lv_adjoint.npz) on the first 16 lanes — the throughput
    # number is only reported for a solve that is actually right.
    golden_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "lv_adjoint.npz"
    )
    if args.batch == 10000 and os.path.exists(golden_path):
        g = np.load(golden_path)
        np.testing.assert_allclose(np.asarray(gy[:16]), g["gy"], rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(gp[:16]), g["gp"], rtol=2e-3, atol=1e-3)

    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        gy, gp = step(y0s, p_subs)
        gy.block_until_ready()
        times.append(time.perf_counter() - t0)
    throughput = args.batch / min(times)
    return {
        "metric": "lv_adjoint_grads_per_sec_10k_vmapped"
        if not args.quick
        else "lv_adjoint_grads_per_sec_quick",
        "value": round(throughput, 1),
        "unit": "grad_solves/sec",
        "vs_baseline": round(throughput / REFERENCE_GRADS_PER_SEC, 3),
    }


def _bench_lv_adjoint_single(args):
    """Single-chain gradient pair through the AdjointSolver class API
    (`--batch 1`): the reference's per-process PyMC deployment mode, which
    runs one fwd+bwd per NUTS leapfrog (~1.25 ms/pair = ~800 pairs/s on the
    author CPU, BASELINE).  ADAMS/ADAMS routes through the native C++
    augmented backward solve.  Gated against lane 0 of the committed golden
    fixture (scipy rtol=1e-12 + central FD)."""
    import numpy as np

    from sunode_tpu.solver import AdjointSolver

    golden_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "lv_adjoint.npz"
    )
    g = np.load(golden_path)
    tvals = g["tvals"]
    y0 = g["y0s"][0]
    p_sub = g["p_subs"][0]
    p_fix = g["p_fix"]

    solver = AdjointSolver(
        _lv_problem(),
        reltol=args.rtol,
        abstol=args.rtol,
        adjoint_reltol=args.rtol * 10,
        adjoint_abstol=args.rtol * 10,
        solver="ADAMS",
        adjoint_solver="ADAMS",
    )
    solver.set_params_dict(
        {"alpha": p_sub[0], "beta": p_sub[1], "gamma": p_fix[0], "delta": p_fix[1]}
    )

    def pair():
        ys = solver.solve_forward(0.0, tvals, y0)
        grads = 2.0 * ys  # d sum(ys^2) / d ys
        quad, lam = solver.solve_backward(tvals[-1], 0.0, tvals, grads)
        return ys, -np.asarray(lam), np.asarray(quad)

    ys, gy, gp = pair()  # warm up (native codegen) + correctness gate
    np.testing.assert_allclose(gy, g["gy"][0], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(gp, g["gp"][0], rtol=2e-3, atol=1e-3)

    times = []
    for _ in range(max(args.repeats, 50)):
        t0 = time.perf_counter()
        pair()
        times.append(time.perf_counter() - t0)
    per_pair = min(times)
    return {
        "metric": "lv_adjoint_single_pair_wallclock",
        "value": round(per_pair * 1e6, 2),
        "unit": "us/grad pair (B=1, native host path)",
        "vs_baseline": round((1.0 / REFERENCE_GRADS_PER_SEC) / per_pair, 3),
    }


def bench_lv_adjoint_f32(args):
    """f32 speed mode: the north-star workload in f32.

    Dtype follows the inputs end-to-end, so f32 arrays run the whole
    pipeline (carry, backward pass, conditioning gates) at native f32 even
    with x64 enabled.  Solves at rtol 1e-6 fwd / 1e-5 bwd; gradients gated
    at 1e-2 worst-lane against the tight-tolerance golden fixture (measured
    2.6e-3 — docs/performance.md 'f32 speed mode')."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

    problem = _lv_problem()
    B = args.batch
    tvals = jnp.linspace(1.0, 10.0, 21).astype(jnp.float32)
    p_fix = jnp.asarray([1.0, 0.4], jnp.float32)
    rng = np.random.default_rng(42)
    y0s = jnp.asarray(
        np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2))),
        jnp.float32,
    )
    p_subs = jnp.asarray(
        np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((B, 2))),
        jnp.float32,
    )
    golden_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "lv_adjoint.npz"
    )
    golden = np.load(golden_path) if os.path.exists(golden_path) else None
    if golden is not None and B >= 16:
        y0s = y0s.at[:16].set(jnp.asarray(golden["y0s"], jnp.float32))
        p_subs = p_subs.at[:16].set(jnp.asarray(golden["p_subs"], jnp.float32))

    solve = make_batched_solve_fn(
        problem,
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-6, atol=1e-6, adams_max_order=6),
        adjoint_options=BDFOptions(rtol=1e-5, atol=1e-5, adams_max_order=6),
        method="ADAMS",
        adjoint_interpolation="transition",
    )

    def loss(y0s, p_subs):
        return jnp.sum(solve(0.0, y0s, p_subs, p_fix, tvals) ** 2)

    step = jax.jit(jax.grad(loss, argnums=(0, 1)))
    gy, gp = step(y0s, p_subs)
    gy.block_until_ready()
    assert gy.dtype == jnp.float32
    n_finite = int(jnp.isfinite(gy).all(axis=-1).sum())
    assert n_finite == B, f"only {n_finite}/{B} chains succeeded"
    if golden is not None and B >= 16:
        err = np.max(
            np.abs(np.asarray(gy[:16], np.float64) - golden["gy"])
            / (np.abs(golden["gy"]) + 1e-3)
        )
        assert err < 1e-2, f"f32 worst-lane gradient error {err:.2e} >= 1e-2"
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        gy, gp = step(y0s, p_subs)
        gy.block_until_ready()
        times.append(time.perf_counter() - t0)
    throughput = B / min(times)
    return {
        "metric": "lv_adjoint_grads_per_sec_f32",
        "value": round(throughput, 1),
        "unit": "grad_solves/sec (f32, rtol 1e-6/1e-5)",
        "vs_baseline": round(throughput / REFERENCE_GRADS_PER_SEC, 3),
    }


def bench_lv_forward(args):
    """README config: LV forward solve at rtol=1e-10 (reference ~200us/solve).

    ``--batch 1`` measures the single-chain class-API path (the literal
    README workload): ``Solver.solve`` routes B=1 through the native C++
    integrator, so a naively migrated single-chain script keeps
    reference-class latency instead of paying whole-batch jit machinery.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.ops.adams_batched import adams_solve_batched

    problem = _lv_problem()

    if args.batch == 1:
        from sunode_tpu.solver import Solver

        # LV is non-stiff: ADAMS is the method a CVODES user selects here
        # (same choice as the batched config below); the native Adams path
        # measured BOTH faster (~93us vs 253us BDF) and more accurate
        # (1.1e-8 vs 1.1e-7 worst relative vs a rtol=1e-13 oracle).
        solver = Solver(problem, reltol=1e-10, abstol=1e-10, solver="ADAMS")
        solver.set_params_dict(
            {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}
        )
        tvals = np.linspace(0.0, 10.0, 50)
        y0 = np.array([10.0, 2.0])
        out = solver.solve(0.0, tvals, y0)  # warm up (native codegen)
        assert np.isfinite(out).all()
        # correctness gate vs the tight native-BDF oracle
        oracle = Solver(problem, reltol=1e-13, abstol=1e-13)
        oracle.set_params_dict(
            {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}
        )
        ref = oracle.solve(0.0, tvals, y0)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-8)
        times = []
        for _ in range(max(args.repeats, 50)):
            t0 = time.perf_counter()
            solver.solve(0.0, tvals, y0)
            times.append(time.perf_counter() - t0)
        per_solve = min(times)
        return {
            "metric": "lv_forward_single_solve_wallclock",
            "value": round(per_solve * 1e6, 2),
            "unit": "us/solve (B=1, native host path)",
            "vs_baseline": round(REFERENCE_LV_FORWARD_SEC / per_solve, 3),
        }
    rhs = problem.make_rhs()
    tvals = jnp.linspace(0.0, 10.0, 50)
    rng = np.random.default_rng(42)
    B = args.batch
    y0s = jnp.asarray(np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2))))
    ps = jnp.asarray(
        np.array([1.0, 0.3, 1.0, 0.4]) * (1 + 0.05 * rng.standard_normal((B, 4)))
    )
    opts = BDFOptions(rtol=1e-10, atol=1e-10)
    run = jax.jit(lambda y, p: adams_solve_batched(rhs, 0.0, y, p, tvals, opts))
    r = run(y0s, ps)
    jax.block_until_ready(r.ys)
    assert int((r.status == 0).sum()) == B
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        r = run(y0s, ps)
        jax.block_until_ready(r.ys)
        times.append(time.perf_counter() - t0)
    per_solve = min(times) / B
    return {
        "metric": "lv_forward_solve_wallclock",
        "value": round(per_solve * 1e6, 2),
        "unit": "us/solve (batched)",
        "vs_baseline": round(REFERENCE_LV_FORWARD_SEC / per_solve, 3),
    }


def bench_lv_sens(args):
    """Forward sensitivities (sens_mode='simultaneous', d/dalpha d/dbeta).

    Runs the augmented state [y; vec(S)] through the functional-iteration
    Adams core — CV_ADAMS + CV_SIMULTANEOUS, the method a CVODES user would
    pick for non-stiff LV (the sensitivity equations are just more ODE
    components; the class API uses the same path).  The first 16 lanes are
    pinned to the committed golden fixture (scipy rtol=1e-12 + central FD)
    and tolerance-checked, so the number is only reported for a correct
    solve.
    """
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.ops.adams_batched import adams_solve_batched

    problem = _lv_problem()

    if args.batch == 1:
        # single-chain class-API path: Solver(sens_mode='simultaneous',
        # solver='ADAMS') routes B=1 through the native C++ augmented solve;
        # gated against lane 0 of the committed golden fixture
        from sunode_tpu.solver import Solver

        g = np.load(
            os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "tests",
                "golden",
                "lv_sens.npz",
            )
        )
        tv = g["tvals"]
        y0 = g["y0s"][0]
        p = g["ps"][0]
        solver = Solver(
            problem,
            reltol=args.rtol,
            abstol=args.rtol,
            sens_mode="simultaneous",
            solver="ADAMS",
        )
        solver.set_params_dict(
            {"alpha": p[0], "beta": p[1], "gamma": p[2], "delta": p[3]}
        )
        ys, sens = solver.solve(0.0, tv, y0)
        np.testing.assert_allclose(ys, g["ys"][0], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            np.asarray(sens), g["sens"][0], rtol=2e-3, atol=1e-4
        )
        times = []
        for _ in range(max(args.repeats, 50)):
            t0 = time.perf_counter()
            solver.solve(0.0, tv, y0)
            times.append(time.perf_counter() - t0)
        per_solve = min(times)
        return {
            "metric": "lv_sens_single_solve_wallclock",
            "value": round(per_solve * 1e6, 2),
            "unit": "us/sens-solve (B=1, native host path)",
            "vs_baseline": round((1.0 / REFERENCE_GRADS_PER_SEC) / per_solve, 3),
        }

    rhs = problem.make_rhs()
    sens_rhs = problem.make_sensitivity_rhs()
    n, k = 2, 2
    tvals = jnp.linspace(0.0, 10.0, 21)
    rng = np.random.default_rng(42)
    B = args.batch
    y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2)))
    ps = np.array([1.0, 0.3, 1.0, 0.4]) * (
        1 + 0.05 * rng.standard_normal((B, 4))
    )
    golden_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "lv_sens.npz"
    )
    golden = np.load(golden_path) if os.path.exists(golden_path) else None
    if golden is not None and B >= 16:
        y0s[:16] = golden["y0s"]
        ps[:16] = golden["ps"]
        tvals = jnp.asarray(golden["tvals"])

    def rhs_aug(t, z, p):
        y = z[:n]
        S = z[n:].reshape(k, n)
        return jnp.concatenate([rhs(t, y, p), sens_rhs(t, y, S, p).reshape(-1)])

    y0_aug = jnp.asarray(
        np.concatenate([y0s, np.zeros((B, k * n))], axis=1)
    )
    ps = jnp.asarray(ps)
    # adams_max_order=6: same measured throughput knob as the north-star
    # config (docs/performance.md)
    opts = BDFOptions(rtol=args.rtol, atol=args.rtol, adams_max_order=6)
    run = jax.jit(lambda y, p: adams_solve_batched(rhs_aug, 0.0, y, p, tvals, opts))
    r = run(y0_aug, ps)
    jax.block_until_ready(r.ys)
    assert int((r.status == 0).sum()) == B
    if golden is not None and B >= 16:
        sens = np.asarray(r.ys[:16, :, n:]).reshape(16, len(tvals), k, n)
        # bench solves at rtol=1e-8 (vs the golden test's 1e-9 run): global
        # error accumulation over [0, 10] reaches ~1e-6 relative
        np.testing.assert_allclose(
            np.asarray(r.ys[:16, :, :n]), golden["ys"], rtol=5e-6, atol=1e-8
        )
        np.testing.assert_allclose(sens, golden["sens"], rtol=2e-4, atol=5e-4)
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        r = run(y0_aug, ps)
        jax.block_until_ready(r.ys)
        times.append(time.perf_counter() - t0)
    throughput = B / min(times)
    return {
        "metric": "lv_forward_sens_solves_per_sec",
        "value": round(throughput, 1),
        "unit": "sens_solves/sec",
        "vs_baseline": round(throughput / REFERENCE_GRADS_PER_SEC, 3),
    }


def bench_robertson(args):
    """Robertson stiff kinetics wall-clock (adaptive BDF + Jacobian reuse)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.ops.bdf_batched import bdf_solve_batched
    from sunode_tpu.symode import SympyProblem

    def rob(t, y, p):
        r1 = p.k1 * y.a
        r2 = p.k2 * y.b * y.b
        r3 = p.k3 * y.b * y.c
        return {"a": -r1 + r3, "b": r1 - r2 - r3, "c": r2}

    problem = SympyProblem(
        params={"k1": (), "k2": (), "k3": ()},
        states={"a": (), "b": (), "c": ()},
        rhs_sympy=rob,
        derivative_params=[("k1",)],
    )
    rhs, jac = problem.make_rhs(), problem.make_jac_dense()
    tvals = jnp.asarray([4.0 * 10.0**k for k in range(-1, 7)])
    B = args.batch
    rng = np.random.default_rng(42)
    ps = jnp.asarray(
        np.array([0.04, 3e7, 1e4]) * (1 + 0.02 * rng.standard_normal((B, 3)))
    )
    y0s = jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (B, 1))
    opts = BDFOptions(rtol=1e-8, atol=jnp.asarray([1e-10, 1e-12, 1e-10]))
    run = jax.jit(lambda y, p: bdf_solve_batched(rhs, jac, 0.0, y, p, tvals, opts))
    r = run(y0s, ps)
    jax.block_until_ready(r.ys)
    assert int((r.status == 0).sum()) == B
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        r = run(y0s, ps)
        jax.block_until_ready(r.ys)
        times.append(time.perf_counter() - t0)
    per_solve = min(times) / B
    return {
        "metric": "robertson_stiff_solve_wallclock",
        "value": round(per_solve * 1e6, 2),
        "unit": "us/solve (batched, t=[0,4e6])",
        "vs_baseline": 0.0,  # no reference number published for Robertson
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--config",
        default="lv_adjoint",
        choices=["lv_adjoint", "lv_adjoint_f32", "lv_forward", "lv_sens", "robertson"],
    )
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--quick", action="store_true", help="small batch smoke run")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if args.quick:
        args.batch = 256
        args.repeats = 1

    import jax

    from chip_smoke import card_label

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, found platform {devices[0].platform!r}")
    from sunode_tpu.utils.compile_cache import use_checkout_cache

    use_checkout_cache()

    result = {
        "lv_adjoint": bench_lv_adjoint,
        "lv_adjoint_f32": bench_lv_adjoint_f32,
        "lv_forward": bench_lv_forward,
        "lv_sens": bench_lv_sens,
        "robertson": bench_robertson,
    }[args.config](args)
    result["device"] = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": card_label(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
