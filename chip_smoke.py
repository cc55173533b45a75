"""Smoke run of the batched differentiable ODE solve on an NVIDIA GPU.

    python chip_smoke.py               # phases 0-4 on one GPU
    python chip_smoke.py --four-cards  # the sharded paths on four GPUs

It drives the north-star path through its public entry points
(``make_batched_solve_fn`` -> ``jax.grad``) at full width, B = 10,000 chains,
and gates every result against the independent oracles in ``tests/golden/``
(scipy LSODA at rtol 1e-12 + central finite differences).  Everything runs in
this one process: a second JAX process would find the card's memory taken.
It refuses to run anywhere but a GPU: there is no CPU fallback.

Phases (one GPU):
  0  the device: platform must be ``gpu``; prints the card, JAX, x64, cache.
  1  LV adjoint gradients, f64, ADAMS + transition adjoint
     (``__graft_entry__._build``'s settings), JaxProblem RHS.
  2a Robertson forward solve, BDF + Newton + the pivoted LU.
  2b LV gradients again through BDF + Hermite checkpoints.
  3  LV gradients in f32.
  4  the same LV gradients through ``SympyProblem`` (only if sympy imports).

Phases (``--four-cards``):
  a  chain sharding: the phase-1 gradient at B = 40,000 over a 4-device
     ``chains`` mesh against the same step unsharded on card 0.
  b  state sharding: SIR-1000 (n = 3,000) adjoint gradient on a 2 x 2
     (chains x state) mesh against the unsharded gradient on card 0.

Tolerances, and why:
  * golden gates (phases 1, 2b): ``rtol=2e-3, atol=1e-3``, as ``bench.py``
    gates the north-star cell — the finite-difference oracle itself is only
    good to ~1e-4 relative.
  * Robertson (2a): ``rtol=2e-5, atol=1e-10``, as
    ``tests/test_golden.py::test_robertson_golden`` — a seven-decade stiff
    integration at rtol 1e-8 accumulates global error to ~1e-5.
  * f32 (3): worst lane < 1e-2 relative, as ``bench.py``'s f32 cell — f32
    solves at rtol 1e-6/1e-5 against an f64 oracle.
  * SympyProblem vs JaxProblem (4): ``rtol=1e-7, atol=1e-9``.  The two RHS
    lowerings order the same floating-point operations differently; the
    adaptive step controller turns round-off into different accept/reject
    decisions, so lanes agree to a small multiple of the solve tolerance
    (1e-8), not to the last bit.
  * chain sharding (a): ``rtol=1e-7, atol=1e-9``, for the same reason: the
    lanes are independent, but XLA compiles a (10,000)-lane shard and a
    (40,000)-lane batch into different kernels whose reductions may round
    differently, and the step controller amplifies that to the solve
    tolerance.
  * state sharding (b): ``rtol=1e-10, atol=1e-12``, as
    ``tests/test_sharding_state.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
BATCH = 10_000
FOUR_CARD_BATCH = 40_000
SIR_REGIONS = 1_000
SIR_BATCH = 64


class GateError(AssertionError):
    """A phase's result missed its stated gate."""


def _gate(ok: bool, message: str) -> None:
    if not ok:
        raise GateError(message)


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def _golden(name):
    return np.load(os.path.join(GOLDEN, name))


def _smoke(card: str, what: str, readings: dict) -> None:
    body = ", ".join(
        f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
        for k, v in readings.items()
    )
    print(f"  smoke reading, not a benchmark [{card}] {what}: {body}")


def _lv_inputs(batch, dtype):
    """Chain inputs as ``bench.py`` draws them, first 16 lanes pinned to the
    golden fixture's."""
    import jax.numpy as jnp

    g = _golden("lv_adjoint.npz")
    rng = np.random.default_rng(42)
    y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((batch, 2)))
    p_subs = np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((batch, 2)))
    n = min(batch, 16)
    y0s[:n] = g["y0s"][:n]
    p_subs[:n] = g["p_subs"][:n]
    return jnp.asarray(y0s, dtype), jnp.asarray(p_subs, dtype)


def _timed_step(fn, *args):
    """Compile ``fn`` ahead of time, run it once, then time one warm call."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, compile_s, time.perf_counter() - t0


def _worst_rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want) / (np.abs(want) + 1e-3)))


def _check_lv_gradients(gy, gp, batch, what):
    g = _golden("lv_adjoint.npz")
    n_bad = int(batch - np.isfinite(np.asarray(gy)).all(axis=1).sum())
    n_bad += int(batch - np.isfinite(np.asarray(gp)).all(axis=1).sum())
    _gate(n_bad == 0, f"{what}: {n_bad} non-finite gradient rows of {batch} lanes")
    n = min(batch, 16)
    np.testing.assert_allclose(np.asarray(gy[:n]), g["gy"][:n], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gp[:n]), g["gp"][:n], rtol=2e-3, atol=1e-3)
    return max(_worst_rel(gy[:n], g["gy"][:n]), _worst_rel(gp[:n], g["gp"][:n]))


def phase_lv_adjoint(batch=BATCH, method="ADAMS", card=""):
    """Phase 1 (ADAMS, transition adjoint) and 2b (BDF, Hermite checkpoints):
    the north-star gradient step at ``batch`` chains, gated on the golden
    gradients.  Returns the readings and the first 16 lanes' gradients."""
    import jax.numpy as jnp

    import __graft_entry__ as ge

    fn, _ = ge._build(
        batch=batch, tvals_n=21, rtol=1e-8,
        checkpoint_n=384 if method == "ADAMS" else 1024, method=method,
    )
    y0s, p_subs = _lv_inputs(batch, jnp.float64)
    (gy, gp), compile_s, warm_s = _timed_step(fn, y0s, p_subs)
    what = f"LV adjoint {method} B={batch}"
    readings = dict(worst_rel_err=_check_lv_gradients(gy, gp, batch, what),
                    compile_s=compile_s, warm_step_s=warm_s)
    if method == "ADAMS":
        readings.update(_attempt_counts(ge.lv_problem(), y0s, p_subs))
    _smoke(card, what, readings)
    return dict(readings, gy=np.asarray(gy[:16]), gp=np.asarray(gp[:16]))


def _attempt_counts(problem, y0s, p_subs):
    """Forward attempts and steps, and backward steps, of the phase-1
    gradient (the loops run until the slowest lane is done, so the max over
    lanes is what the lockstep batch pays)."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from sunode_tpu.adjoint import adjoint_backward_transition_batched
    from sunode_tpu.ops.adams_batched import adams_solve_batched

    fwd_opts, adj_opts = ge.solver_options(1e-8)
    rhs = problem.make_rhs()
    tvals = jnp.linspace(1.0, 10.0, 21)
    p = jnp.concatenate(
        [p_subs, jnp.broadcast_to(jnp.asarray([1.0, 0.4]), p_subs.shape)], axis=1
    )

    def counts(y0s, p):
        res = adams_solve_batched(rhs, 0.0, y0s, p, tvals, fwd_opts)
        adj = adjoint_backward_transition_batched(
            rhs, problem.make_adjoint_jac_dense(), problem.make_dfdp(), 0.0,
            tvals, 2.0 * res.ys, p, problem.n_params, res.ys[:, -1, :], adj_opts,
        )
        return (jnp.max(res.stats["n_attempts"]), jnp.max(res.stats["n_steps"]),
                jnp.max(adj.stats["n_backward_steps"]))

    fa, fs, bs = jax.jit(counts)(y0s, p)
    return dict(fwd_attempts=int(fa), fwd_steps_max=int(fs), bwd_steps_max=int(bs))


def _robertson_problem():
    from sunode_tpu.problem import JaxProblem

    def rob(t, y, p):
        return {
            "a": -p.k1 * y.a + p.k3 * y.b * y.c,
            "b": p.k1 * y.a - p.k2 * y.b * y.b - p.k3 * y.b * y.c,
            "c": p.k2 * y.b * y.b,
        }

    return JaxProblem(
        params={"k1": (), "k2": (), "k3": ()},
        states={"a": (), "b": (), "c": ()},
        rhs=rob,
        derivative_params=[("k1",), ("k2",), ("k3",)],
    )


def phase_robertson(batch=BATCH, card=""):
    """Phase 2a: stiff Robertson kinetics through the BDF core (Newton +
    pivoted LU), forward only, gated on the golden trajectories."""
    import jax.numpy as jnp

    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

    g = _golden("robertson.npz")
    solve = make_batched_solve_fn(
        _robertson_problem(),
        derivatives=None,
        options=BDFOptions(rtol=1e-8, atol=jnp.asarray([1e-10, 1e-12, 1e-10])),
        method="BDF",
    )
    rng = np.random.default_rng(42)
    ps = np.array([0.04, 3e7, 1e4]) * (1 + 0.02 * rng.standard_normal((batch, 3)))
    n = min(batch, 16)
    ps[:n] = g["ps"][:n]
    y0s = jnp.tile(jnp.asarray(g["y0"]), (batch, 1))
    tvals = jnp.asarray(g["tvals"])
    p_fix = jnp.zeros((0,))

    def run(y0s, ps):
        return solve(0.0, y0s, ps, p_fix, tvals)

    ys, compile_s, warm_s = _timed_step(run, y0s, jnp.asarray(ps))
    n_bad = int(batch - np.isfinite(np.asarray(ys)).all(axis=(1, 2)).sum())
    _gate(n_bad == 0, f"Robertson: {n_bad} of {batch} lanes failed")
    np.testing.assert_allclose(np.asarray(ys[:n]), g["ys"][:n], rtol=2e-5, atol=1e-10)
    # worst |error| / (atol + rtol |golden|): the gate holds while this <= 1
    err = float(np.max(np.abs(np.asarray(ys[:n]) - g["ys"][:n]) / (1e-10 + 2e-5 * np.abs(g["ys"][:n]))))
    readings = dict(worst_gate_ratio=err, compile_s=compile_s, warm_step_s=warm_s)
    _smoke(card, f"Robertson BDF forward B={batch}", readings)
    return readings


def phase_lv_adjoint_f32(batch=BATCH, card=""):
    """Phase 3: the LV gradient with f32 inputs (the whole pipeline follows
    the input dtype), at rtol 1e-6 forward / 1e-5 backward as in
    ``bench.py``'s f32 cell."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

    solve = make_batched_solve_fn(
        ge.lv_problem(),
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-6, atol=1e-6, adams_max_order=6),
        adjoint_options=BDFOptions(rtol=1e-5, atol=1e-5, adams_max_order=6),
        method="ADAMS",
        adjoint_interpolation="transition",
    )
    tvals = jnp.linspace(1.0, 10.0, 21).astype(jnp.float32)
    p_fix = jnp.asarray([1.0, 0.4], jnp.float32)

    def loss(y0s, p_subs):
        return jnp.sum(solve(0.0, y0s, p_subs, p_fix, tvals) ** 2)

    y0s, p_subs = _lv_inputs(batch, jnp.float32)
    (gy, gp), compile_s, warm_s = _timed_step(jax.grad(loss, argnums=(0, 1)), y0s, p_subs)
    _gate(gy.dtype == jnp.float32, f"f32 gradients came back as {gy.dtype}")
    n_bad = int(batch - np.isfinite(np.asarray(gy)).all(axis=1).sum())
    _gate(n_bad == 0, f"f32: {n_bad} of {batch} lanes non-finite")
    g = _golden("lv_adjoint.npz")
    n = min(batch, 16)
    err = _worst_rel(gy[:n], g["gy"][:n])
    _gate(err < 1e-2, f"f32 worst-lane gradient error {err:.3e} >= 1e-2")
    readings = dict(worst_rel_err=err, compile_s=compile_s, warm_step_s=warm_s)
    _smoke(card, f"LV adjoint f32 B={batch}", readings)
    return readings


def phase_sympy(reference_gy, reference_gp, card=""):
    """Phase 4: the LV gradient built through ``SympyProblem`` at B = 16 on
    the golden lanes must equal the JaxProblem gradients of phase 1.
    Returns None when sympy is not installed."""
    try:
        import sympy  # noqa: F401
    except ImportError:
        return None
    import jax.numpy as jnp

    import __graft_entry__ as ge

    fn, _ = ge._build(batch=16, tvals_n=21, rtol=1e-8, checkpoint_n=384,
                      problem=ge.lv_problem(symbolic=True))
    y0s, p_subs = _lv_inputs(16, jnp.float64)
    (gy, gp), compile_s, _ = _timed_step(fn, y0s, p_subs)
    np.testing.assert_allclose(np.asarray(gy), reference_gy, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gp), reference_gp, rtol=1e-7, atol=1e-9)
    diff = max(_worst_rel(gy, reference_gy), _worst_rel(gp, reference_gp))
    _smoke(card, "SympyProblem vs JaxProblem B=16",
           dict(max_rel_diff=diff, compile_s=compile_s))
    return diff


def phase_chain_sharding(batch=FOUR_CARD_BATCH, n_devices=4, card=""):
    """Four-card (a): the phase-1 gradient with chains sharded over an
    ``n_devices`` mesh against the same step unsharded on device 0."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from sunode_tpu.parallel.mesh import make_mesh, shard_over_chains

    fn, _ = ge._build(batch=batch, tvals_n=21, rtol=1e-8, checkpoint_n=384)
    y0s, p_subs = _lv_inputs(batch, jnp.float64)
    dev0 = jax.devices()[0]
    (gy_ref, gp_ref), c_ref, w_ref = _timed_step(
        fn, jax.device_put(y0s, dev0), jax.device_put(p_subs, dev0)
    )
    mesh = make_mesh(n_devices)
    chains = NamedSharding(mesh, P("chains"))
    sharded = jax.jit(fn, in_shardings=(chains, chains), out_shardings=chains)
    y0_sh, p_sh = shard_over_chains(mesh, (y0s, p_subs))
    (gy, gp), c_sh, w_sh = _timed_step(sharded, y0_sh, p_sh)
    _gate(len(gy.sharding.device_set) == n_devices,
          f"sharded gradients live on {len(gy.sharding.device_set)} devices")
    _check_lv_gradients(gy, gp, batch, f"chain-sharded B={batch}")
    np.testing.assert_allclose(np.asarray(gy), np.asarray(gy_ref), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gp_ref), rtol=1e-7, atol=1e-9)
    diff = max(_worst_rel(gy, np.asarray(gy_ref)), _worst_rel(gp, np.asarray(gp_ref)))
    _smoke(card, f"chain sharding {n_devices} devices B={batch}", dict(
        max_rel_diff_vs_unsharded=diff,
        compile_s_unsharded=c_ref, warm_step_s_unsharded=w_ref,
        compile_s_sharded=c_sh, warm_step_s_sharded=w_sh))
    return diff


def phase_state_sharding(regions=SIR_REGIONS, batch=SIR_BATCH, mesh_shape=(2, 2), card=""):
    """Four-card (b): the SIR many-regions adjoint gradient (n = 3R) with
    chains x state sharded over a 2-D mesh against the unsharded gradient,
    as ``tests/test_sharding_state.py`` checks it at R = 256."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sunode_tpu.ops.bdf import BDFOptions
    from sunode_tpu.parallel.mesh import make_mesh_2d, shard_batch_state
    from sunode_tpu.problem import JaxProblem
    from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

    R = regions

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
        checkpoint_n=512,
        method="ADAMS",
    )
    rng = np.random.default_rng(3)
    S0 = 0.99 + 0.005 * rng.standard_normal((batch, R))
    I0 = 0.01 * np.abs(1 + 0.1 * rng.standard_normal((batch, R)))
    y0 = jnp.asarray(np.concatenate([S0, I0, np.zeros((batch, R))], axis=1))
    psub = jnp.asarray(np.stack(
        [0.4 * (1 + 0.05 * rng.standard_normal(batch)),
         0.15 * (1 + 0.05 * rng.standard_normal(batch))], axis=1))
    p_fix = jnp.asarray([0.05])
    tvals = jnp.linspace(5.0, 40.0, 6)

    def loss(psub, y0):
        ys = solve(0.0, y0, psub, p_fix, tvals)
        return jnp.sum(ys[:, :, R:2 * R] ** 2)

    grad = jax.grad(loss)
    dev0 = jax.devices()[0]
    g_ref, c_ref, w_ref = _timed_step(grad, jax.device_put(psub, dev0), jax.device_put(y0, dev0))
    g_ref = np.asarray(g_ref)
    _gate(np.isfinite(g_ref).all(), "unsharded SIR gradient is not finite")
    mesh = make_mesh_2d(*mesh_shape)
    g_sh, c_sh, w_sh = _timed_step(
        grad,
        jax.device_put(psub, NamedSharding(mesh, P("chains"))),
        shard_batch_state(mesh, y0),
    )
    np.testing.assert_allclose(np.asarray(g_sh), g_ref, rtol=1e-10, atol=1e-12)
    diff = _worst_rel(g_sh, g_ref)
    _smoke(card, f"state sharding {mesh_shape[0]}x{mesh_shape[1]} SIR R={R} B={batch}", dict(
        max_rel_diff_vs_unsharded=diff,
        compile_s_unsharded=c_ref, warm_step_s_unsharded=w_ref,
        compile_s_sharded=c_sh, warm_step_s_sharded=w_sh))
    return diff


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)
    need = 4 if args.four_cards else 1

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, found platform {platform!r}; "
              "there is no CPU fallback", file=sys.stderr)
        return 1
    if len(devices) < need:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    import sunode_tpu  # noqa: F401  (turns on x64)
    from sunode_tpu.utils.compile_cache import use_checkout_cache

    cache = use_checkout_cache()
    card = card_label()
    kind = devices[0].device_kind
    print(f"device: {kind} x {len(devices)}")
    print(f"nvidia-smi: {card}")
    print(f"jax {jax.__version__}, x64 {jax.config.jax_enable_x64}, "
          f"compile cache {cache}")

    if args.four_cards:
        print("phase a: chain sharding")
        phase_chain_sharding(card=card)
        print("phase b: state sharding")
        phase_state_sharding(card=card)
    else:
        print("phase 1: LV adjoint gradients, f64, ADAMS + transition")
        lv = phase_lv_adjoint(card=card)
        print("phase 2a: Robertson, BDF forward")
        phase_robertson(card=card)
        print("phase 2b: LV adjoint gradients, BDF + hermite")
        phase_lv_adjoint(method="BDF", card=card)
        print("phase 3: LV adjoint gradients, f32")
        phase_lv_adjoint_f32(card=card)
        print("phase 4: SympyProblem front end")
        if phase_sympy(lv["gy"], lv["gp"], card=card) is None:
            print("  phase 4 did not run: sympy is not installed")

    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
