"""SIR-type epidemiological ODE with vector states (BASELINE config 5).

1k-region x 10k-chain full scale needs several devices (the f64 adjoint
checkpoints alone exceed one device's memory — see docs/limitations.md); these
tests run the same model family scaled down, through the same batched
adjoint code path, plus a sharded variant on the test mesh.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sunode_tpu.ops.bdf import BDFOptions
from sunode_tpu.problem import JaxProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

R = 16  # regions (scaled down from 1k)
B = 8   # chains


def make_sir_problem(n_regions=R):
    """Multi-region SIR with nearest-neighbour mixing.

    Written as a direct-JAX problem (the recommended authoring mode for
    vector states — expressions stay vectorised; sympy would emit 3R scalar
    assignments)."""

    def rhs(t, y, p):
        S, I, Rc = y.S, y.I, y.R
        # contact coupling: local + a bit of neighbour mixing (ring)
        I_eff = I + p.mix * (jnp.roll(I, 1) + jnp.roll(I, -1))
        inf = p.beta * S * I_eff
        rec = p.gamma * I
        return {"S": -inf, "I": inf - rec, "R": rec}

    return JaxProblem(
        params={"beta": (), "gamma": (), "mix": ()},
        states={"S": (n_regions,), "I": (n_regions,), "R": (n_regions,)},
        rhs=rhs,
        derivative_params=[("beta",), ("gamma",)],
    )


def _inputs(n_regions=R, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    S0 = 0.99 + 0.005 * rng.standard_normal((batch, n_regions))
    I0 = 0.01 * np.abs(1 + 0.1 * rng.standard_normal((batch, n_regions)))
    R0 = np.zeros((batch, n_regions))
    y0 = np.concatenate([S0, I0, R0], axis=1)
    psub = np.stack(
        [0.4 * (1 + 0.05 * rng.standard_normal(batch)),
         0.15 * (1 + 0.05 * rng.standard_normal(batch))],
        axis=1,
    )  # beta, gamma
    return jnp.asarray(y0), jnp.asarray(psub)


TVALS = jnp.linspace(5.0, 60.0, 8)
P_FIX = jnp.array([0.05])  # mix


@pytest.fixture(scope="module")
def sir():
    return make_sir_problem()


def test_sir_forward(sir):
    y0, psub = _inputs()
    solve = make_batched_solve_fn(
        sir, derivatives=None, options=BDFOptions(rtol=1e-8, atol=1e-10),
        method="ADAMS",
    )
    ys = jax.jit(lambda y, p: solve(0.0, y, p, P_FIX, TVALS))(y0, psub)
    ysn = np.asarray(ys)
    assert np.isfinite(ysn).all()
    # conservation: S+I+R per region constant
    n = R
    tot = ysn[:, :, :n] + ysn[:, :, n : 2 * n] + ysn[:, :, 2 * n :]
    np.testing.assert_allclose(
        tot, np.broadcast_to(tot[:, :1, :], tot.shape), rtol=1e-7
    )
    # epidemic actually happens
    assert (ysn[:, -1, 2 * n :] > 0.2).all()


def test_sir_batched_adjoint_grads(sir):
    y0, psub = _inputs()
    solve = make_batched_solve_fn(
        sir,
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-8, atol=1e-10),
        adjoint_options=BDFOptions(rtol=1e-8, atol=1e-10),
        checkpoint_n=1024,
        method="ADAMS",
    )

    def loss(psub):
        ys = solve(0.0, y0, psub, P_FIX, TVALS)
        n = R
        return jnp.sum(ys[:, :, n : 2 * n] ** 2)  # fit infected counts

    g = jax.jit(jax.grad(loss))(psub)
    gn = np.asarray(g)
    assert np.isfinite(gn).all() and (np.abs(gn) > 0).all()

    # finite-difference spot check on one chain's beta
    eps = 1e-6
    lo = np.array(psub)
    hi = np.array(psub)
    hi[3, 0] += eps
    lo[3, 0] -= eps
    fd = (float(loss(jnp.asarray(hi))) - float(loss(jnp.asarray(lo)))) / (2 * eps)
    np.testing.assert_allclose(gn[3, 0], fd, rtol=1e-3)


def test_sir_sharded_over_mesh(sir):
    """Chains sharded over the 8-device test mesh (the multi-chip scaling
    path for the full 1k-region x 10k-chain configuration)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sunode_tpu.parallel.mesh import make_mesh, shard_over_chains

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device test mesh")
    y0, psub = _inputs(batch=16)
    solve = make_batched_solve_fn(
        sir, derivatives="adjoint",
        options=BDFOptions(rtol=1e-6, atol=1e-8),
        adjoint_options=BDFOptions(rtol=1e-6, atol=1e-8),
        checkpoint_n=512,
        method="ADAMS",
    )
    mesh = make_mesh(8)
    y0s, psubs = shard_over_chains(mesh, (y0, psub))

    def loss(y0, psub):
        ys = solve(0.0, y0, psub, P_FIX, TVALS)
        return jnp.sum(ys**2)

    gfn = jax.jit(
        jax.grad(loss, argnums=1),
        in_shardings=(NamedSharding(mesh, P("chains")),) * 2,
    )
    g = gfn(y0s, psubs)
    assert np.isfinite(np.asarray(g)).all()
