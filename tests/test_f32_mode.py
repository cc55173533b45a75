"""f32 speed mode: dtype follows the inputs through every JAX-path surface.

The f32 pipeline (docs/performance.md "f32 speed mode") must stay f32
end-to-end even when x64 is globally enabled — a single hard-cast anywhere
(generated code, ParamSpec.combine, coefficient tables) either promotes the
whole solve back to f64 or breaks the while_loop carry outright.

The class API (Solver/AdjointSolver) is deliberately NOT covered: it is
fixed f64, matching the reference's realtype
(/root/reference/sunode/basic.py:40-43) and the native host path.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sunode_tpu.ops.bdf import BDFOptions

# a dtype leak on the f32 path surfaces as a JAX FutureWarning ("cannot
# safely cast float64 to float32") scheduled to become an ERROR — fail
# loudly now rather than on the next JAX upgrade
pytestmark = pytest.mark.filterwarnings("error::FutureWarning")
from sunode_tpu.symode import SympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn


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


B = 8
TVALS32 = jnp.linspace(1.0, 10.0, 6).astype(jnp.float32)
Y0S32 = jnp.tile(jnp.asarray([10.0, 2.0], jnp.float32), (B, 1))
PSUB32 = jnp.tile(jnp.asarray([1.0, 0.3], jnp.float32), (B, 1))
PFIX32 = jnp.asarray([1.0, 0.4], jnp.float32)


def test_generated_functions_follow_input_dtype(lv_problem):
    y = jnp.asarray([10.0, 2.0], jnp.float32)
    p = jnp.asarray([1.0, 0.3, 1.0, 0.4], jnp.float32)
    assert lv_problem.make_rhs()(0.0, y, p).dtype == jnp.float32
    assert lv_problem.make_jac_dense()(0.0, y, p).dtype == jnp.float32
    assert lv_problem.make_dfdp()(0.0, y, p).dtype == jnp.float32
    assert lv_problem.make_adjoint_jac_dense()(0.0, y, y, p).dtype == jnp.float32
    # f64 inputs still give f64 (no downcast regression)
    assert lv_problem.make_rhs()(0.0, y.astype(jnp.float64), p).dtype == jnp.float64


def test_paramspec_combine_follows_input_dtype(lv_problem):
    spec = lv_problem.params
    sub = jnp.zeros((B, 2), jnp.float32)
    rem = jnp.zeros((B, 2), jnp.float32)
    assert spec.combine(sub, rem, xp=jnp).dtype == jnp.float32
    assert spec.combine(sub.astype(jnp.float64), rem, xp=jnp).dtype == jnp.float64


def test_jaxproblem_rhs_follows_input_dtype():
    """Regression (round 4): JaxProblem.make_rhs used to coerce its output
    dict to the spec's f64 via flatten_dict, silently upcasting the whole
    f32 pipeline (caught by the SIR-1000 f32 bench: the adams carry broke
    with a f32/f64 while_loop mismatch)."""
    from sunode_tpu.problem import JaxProblem

    prob = JaxProblem(
        params={"k": ()},
        states={"x": (2,)},
        rhs=lambda t, y, p: {"x": -p.k * y.x},
        derivative_params=[("k",)],
    )
    rhs = prob.make_rhs()
    y32 = jnp.ones(2, jnp.float32)
    p32 = jnp.asarray([0.5], jnp.float32)
    assert rhs(0.0, y32, p32).dtype == jnp.float32
    assert rhs(0.0, y32.astype(jnp.float64), p32.astype(jnp.float64)).dtype == jnp.float64


def test_solve_ivp_follows_input_dtype():
    """solve_ivp contract: f32 leaves run the pipeline (and gradients) at
    f32; f64 leaves keep reference semantics."""
    from sunode_tpu.wrappers.as_jax import solve_ivp

    def rhs(t, y, p):
        return {"x": -p.k * y.x}

    def run(dtype):
        def loss(k):
            res = solve_ivp(
                0.0,
                {"x": (jnp.asarray([1.0, 2.0], dtype), (2,))},
                {"k": (k, ())},
                jnp.linspace(0.5, 2.0, 4).astype(dtype),
                rhs,
                derivatives="adjoint",
                # f32-reachable tolerances both directions (the default
                # 1e-10 backward pass cannot converge at f32)
                solver_kwargs=dict(
                    rtol=1e-5, atol=1e-6,
                    adjoint_options=BDFOptions(rtol=1e-5, atol=1e-6),
                ),
            )
            return jnp.sum(res.ys**2), res.ys.dtype

        k = jnp.asarray(0.7, dtype)
        (l, ys_dtype), g = jax.value_and_grad(loss, has_aux=True)(k)
        return ys_dtype, g.dtype, float(g)

    ys32, g32, gv32 = run(jnp.float32)
    assert ys32 == jnp.float32 and g32 == jnp.float32
    ys64, g64, gv64 = run(jnp.float64)
    assert ys64 == jnp.float64 and g64 == jnp.float64
    assert abs(gv32 - gv64) < 1e-3 * max(1.0, abs(gv64))


def test_forward_solve_f32(lv_problem):
    solve = make_batched_solve_fn(
        lv_problem,
        derivatives=None,
        options=BDFOptions(rtol=1e-5, atol=1e-5),
        method="BDF",
    )
    ys = solve(0.0, Y0S32, PSUB32, PFIX32, TVALS32)
    assert ys.dtype == jnp.float32
    assert np.isfinite(np.asarray(ys)).all()


@pytest.mark.parametrize("core", ["adams", "bdf"])
def test_extreme_params_no_livelock(lv_problem, core):
    """Params ~1e16 overflow the f32 WRMS norms in the initial-step
    estimate (inf/inf -> NaN h); a NaN h defeats every `h < h_min` guard
    (NaN comparisons are False) and the step loop used to run FOREVER.
    The lane must instead die promptly with a nonzero status."""
    from sunode_tpu.ops.adams_batched import adams_solve_batched
    from sunode_tpu.ops.bdf_batched import bdf_solve_batched

    rhs = lv_problem.make_rhs()
    jac = lv_problem.make_jac_dense()
    B = 4
    y0s = jnp.tile(jnp.asarray([10.0, 2.0], jnp.float32), (B, 1))
    # lane 0 sane; lanes 1-3 astronomically stiff / degenerate
    ps = jnp.asarray(
        [
            [1.0, 0.3, 1.0, 0.4],
            [7e16, 0.7, 1.0, 0.4],
            [1e-26, 28.0, 1.0, 0.4],
            [2e15, 6.0, 1.0, 0.4],
        ],
        jnp.float32,
    )
    tv = jnp.linspace(1.0, 10.0, 6).astype(jnp.float32)
    opts = BDFOptions(rtol=1e-5, atol=1e-5, max_steps=2000, adams_max_order=6)
    if core == "adams":
        res = adams_solve_batched(rhs, 0.0, y0s, ps, tv, opts)
    else:
        res = bdf_solve_batched(rhs, jac, 0.0, y0s, ps, tv, opts)
    status = np.asarray(res.status)
    assert status[0] == 0, status
    assert (status[1:] != 0).all(), status
    assert np.isfinite(np.asarray(res.ys[0])).all()


def test_nuts_f32_dtype():
    """The sampler's own scalars (dual-averaging state, step-size search)
    must follow the chain dtype — a default-f64 eps promoted q through the
    leapfrog and broke the f32 custom_vjp (lax.mul dtype mismatch)."""
    from sunode_tpu.sample import nuts_sample

    def logp(q):
        return -0.5 * jnp.sum(q * q, axis=1)

    init = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (4, 3), jnp.float32)
    res = nuts_sample(
        logp, jax.random.PRNGKey(1), init,
        num_warmup=50, num_samples=50, max_treedepth=5,
    )
    assert res.samples.dtype == jnp.float32
    s = np.asarray(res.samples)
    assert np.isfinite(s).all()
    # unit gaussian recovery, loose gates for 200 draws
    assert abs(s.mean()) < 0.3 and 0.7 < s.std() < 1.4


@pytest.mark.parametrize(
    "mode,method",
    [
        ("hermite", "BDF"),
        ("hermite", "ADAMS"),
        ("polynomial", "ADAMS"),
        ("resolve", "ADAMS"),
        ("transition", "ADAMS"),
    ],
)
def test_adjoint_modes_f32(lv_problem, mode, method):
    """Every adjoint interpolation mode stays f32 and produces gradients in
    the f32 accuracy class (checked against an f64 run of the same mode)."""
    kwargs = dict(
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-5, atol=1e-5),
        adjoint_options=BDFOptions(rtol=1e-4, atol=1e-4),
        method=method,
        adjoint_interpolation=mode,
        checkpoint_n=256,
    )
    solve = make_batched_solve_fn(lv_problem, **kwargs)

    def loss(solve_fn, y0s, p_subs, p_fix, tvals):
        return jnp.sum(solve_fn(0.0, y0s, p_subs, p_fix, tvals) ** 2)

    gy, gp = jax.grad(
        lambda a, b: loss(solve, a, b, PFIX32, TVALS32), argnums=(0, 1)
    )(Y0S32, PSUB32)
    assert gy.dtype == jnp.float32 and gp.dtype == jnp.float32
    assert np.isfinite(np.asarray(gy)).all()
    assert np.isfinite(np.asarray(gp)).all()

    gy64, gp64 = jax.grad(
        lambda a, b: loss(
            solve, a, b, PFIX32.astype(jnp.float64), TVALS32.astype(jnp.float64)
        ),
        argnums=(0, 1),
    )(Y0S32.astype(jnp.float64), PSUB32.astype(jnp.float64))
    assert gy64.dtype == jnp.float64
    rel = np.max(
        np.abs(np.asarray(gy, np.float64) - np.asarray(gy64))
        / (np.abs(np.asarray(gy64)) + 1e-2)
    )
    assert rel < 5e-2, f"{mode}/{method}: f32 vs f64 gradient mismatch {rel:.2e}"
