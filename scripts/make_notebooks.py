"""Author + execute the teaching notebooks (reference parity:
/root/reference/notebooks/from_sympy.ipynb and pymc_model.ipynb).

Builds the .ipynb files with nbformat and executes them with nbclient so the
committed notebooks carry real outputs (the reference commits executed
outputs too — they are its only timing record beyond the README).

Run: python scripts/make_notebooks.py  (~3-4 min, CPU)
"""

import os
import sys

import nbformat as nbf
from nbclient import NotebookClient

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

HEADER = """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
jax.config.update("jax_platforms", "cpu")  # fast startup; remove for the GPU
import sys
sys.path.insert(0, {root!r})
import numpy as np
import jax.numpy as jnp
"""


def md(src):
    return nbf.v4.new_markdown_cell(src)


def code(src):
    return nbf.v4.new_code_cell(src)


def build_from_sympy():
    nb = nbf.v4.new_notebook()
    nb.cells = [
        md(
            "# Solving ODEs with sunode-tpu: from a sympy right-hand side\n"
            "\n"
            "The analog of sunode's `notebooks/from_sympy.ipynb`: declare the\n"
            "Lotka-Volterra predator-prey system symbolically, solve it with\n"
            "the adaptive BDF/Adams integrators, and differentiate through\n"
            "the solve — first with forward sensitivities, then with the\n"
            "checkpointed adjoint."
        ),
        code(HEADER.format(root=os.path.abspath(ROOT))),
        md(
            "## Declare the problem\n"
            "\n"
            "States and parameters are named (possibly nested, possibly\n"
            "vector-valued) records; the RHS is written once in sympy terms\n"
            "and lowered to CSE-preserving JAX source."
        ),
        code(
            """\
from sunode_tpu.symode import SympyProblem

def lotka_volterra(t, y, p):
    return {
        'hares': p.alpha * y.hares - p.beta * y.lynx * y.hares,
        'lynx':  p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }

problem = SympyProblem(
    params={'alpha': (), 'beta': (), 'gamma': (), 'delta': ()},
    states={'hares': (), 'lynx': ()},
    rhs_sympy=lotka_volterra,
    derivative_params=[('alpha',), ('beta',)],
)
problem.n_states, problem.n_params"""
        ),
        md(
            "## Forward solve with the class API\n"
            "\n"
            "`Solver` mirrors sunode's class surface (`set_params_dict`,\n"
            "output buffers, xarray conversion).  A single unbatched solve\n"
            "routes through the native C++ integrator on the host\n"
            "(~260 µs for this problem at rtol=1e-10)."
        ),
        code(
            """\
from sunode_tpu.solver import Solver

solver = Solver(problem, reltol=1e-10, abstol=1e-10)
solver.set_params_dict({'alpha': 1.0, 'beta': 0.3, 'gamma': 1.0, 'delta': 0.4})
tvals = np.linspace(0, 10, 21)
y_out = solver.make_output_buffers(tvals)
solver.solve(t0=0.0, tvals=tvals, y0=np.array([10.0, 2.0]), y_out=y_out)
y_out[:5]"""
        ),
        code(
            """\
import time
t0 = time.perf_counter(); solver.solve(0.0, tvals, np.array([10.0, 2.0])); el = time.perf_counter() - t0
print(f"single forward solve: {el*1e6:.0f} us")"""
        ),
        code(
            """\
ds = solver.as_xarray(tvals, y_out)
ds"""
        ),
        md(
            "## Thousands of solves at once\n"
            "\n"
            "A leading batch axis on `y0` triggers the lockstep batch-native\n"
            "integrator — the replacement for sunode's fork-per-chain\n"
            "multiprocessing; on a GPU it runs 10,000 chains in one solve."
        ),
        code(
            """\
B = 256
rng = np.random.default_rng(0)
y0_batch = np.array([10.0, 2.0]) * (1 + 0.1 * rng.standard_normal((B, 2)))
out_b = solver.solve(0.0, tvals, y0_batch)
out_b.shape"""
        ),
        md(
            "## Forward sensitivities\n"
            "\n"
            "`sens_mode='simultaneous'` (or `'staggered'`) propagates\n"
            "S = dy/dp alongside y with joint error control — CVODES\n"
            "`CVodeSensInit` semantics."
        ),
        code(
            """\
sens_solver = Solver(problem, reltol=1e-8, abstol=1e-8, sens_mode='simultaneous')
sens_solver.set_params_dict({'alpha': 1.0, 'beta': 0.3, 'gamma': 1.0, 'delta': 0.4})
ys, sens = sens_solver.solve(0.0, tvals, np.array([10.0, 2.0]))
print("d hares(t=10) / d alpha =", sens[-1, 0, 0])"""
        ),
        md(
            "## Adjoint gradients with `jax.grad`\n"
            "\n"
            "The JAX-native wrapper exposes the solve as a differentiable\n"
            "function (`jax.custom_vjp` running the checkpointed adjoint\n"
            "backward solve), so it composes with `jit`/`vmap`/`grad` and\n"
            "any JAX sampler."
        ),
        code(
            """\
from sunode_tpu.wrappers.as_jax import solve_ivp

def loss(alpha):
    res = solve_ivp(
        t0=0.0,
        y0={'hares': (10.0, ()), 'lynx': (2.0, ())},
        params={'alpha': (alpha, ()), 'beta': (0.3, ()),
                'gamma': np.array(1.0), 'delta': np.array(0.4)},
        tvals=np.linspace(1, 10, 21),
        rhs=lotka_volterra,
        derivatives='adjoint',
        derivative_params=[('alpha',), ('beta',)],
    )
    return jnp.sum(res.solution['hares'] ** 2)

g = jax.grad(loss)(jnp.asarray(1.0))
print("dL/dalpha =", g)"""
        ),
        md(
            "Cross-check against the forward-sensitivity contraction and a\n"
            "central finite difference:"
        ),
        code(
            """\
eps = 1e-6
fd = (loss(jnp.asarray(1.0 + eps)) - loss(jnp.asarray(1.0 - eps))) / (2 * eps)
print("adjoint:", float(g), "  central FD:", float(fd))
assert abs(float(g) - float(fd)) / abs(float(fd)) < 1e-4"""
        ),
    ]
    return nb


def build_nuts_model():
    nb = nbf.v4.new_notebook()
    nb.cells = [
        md(
            "# Bayesian inference through the ODE solver with NUTS\n"
            "\n"
            "The analog of sunode's `notebooks/pymc_model.ipynb`: infer the\n"
            "posterior over Lotka-Volterra parameters from noisy\n"
            "observations.  Where sunode hands a PyTensor Op to PyMC (one\n"
            "forked OS process per chain), sunode-tpu ships a batch-lockstep\n"
            "NUTS whose every leapfrog step evaluates ONE batched forward +\n"
            "adjoint solve across all chains — the same kernel the 10k-chain\n"
            "benchmark uses.  (The drop-in `wrappers.as_pytensor` layer\n"
            "still exists for real PyMC models.)"
        ),
        code(HEADER.format(root=os.path.abspath(ROOT))),
        code(
            """\
from sunode_tpu.ops.bdf import BDFOptions
from sunode_tpu.sample import nuts_sample, split_rhat, ess_bulk
from sunode_tpu.symode import SympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn

problem = SympyProblem(
    params={'alpha': (), 'beta': (), 'gamma': (), 'delta': ()},
    states={'hares': (), 'lynx': ()},
    rhs_sympy=lambda t, y, p: {
        'hares': p.alpha * y.hares - p.beta * y.lynx * y.hares,
        'lynx':  p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    },
    derivative_params=[('alpha',), ('beta',)],
)
solve = make_batched_solve_fn(
    problem, derivatives='adjoint',
    options=BDFOptions(rtol=1e-8, atol=1e-8),
    adjoint_options=BDFOptions(rtol=1e-8, atol=1e-8),
    method='ADAMS', adjoint_interpolation='transition',
)"""
        ),
        md("## Synthetic data from known parameters"),
        code(
            """\
true_alpha, true_beta = 1.0, 0.3
p_fix = jnp.asarray([1.0, 0.4])          # gamma, delta held fixed
tvals = jnp.linspace(1.0, 8.0, 8)
y0_single = jnp.asarray([10.0, 2.0])
sigma = 0.1                               # lognormal observation noise

rng = np.random.default_rng(42)
ys_true = solve(0.0, y0_single[None], jnp.asarray([[true_alpha, true_beta]]), p_fix, tvals)[0]
obs_log = jnp.asarray(np.log(np.asarray(ys_true)) + sigma * rng.standard_normal(ys_true.shape))
np.asarray(ys_true)[:3]"""
        ),
        md(
            "## The posterior\n"
            "\n"
            "Lognormal likelihood, lognormal priors; sampling in log-space.\n"
            "A failed solve NaN-poisons the likelihood -> `-inf` -> NUTS\n"
            "rejects the proposal (the same contract sunode's PyTensor Ops\n"
            "implement for PyMC)."
        ),
        code(
            """\
C = 4                                      # chains, advanced in lockstep
y0s = jnp.broadcast_to(y0_single, (C, 2))
mu0 = jnp.log(jnp.asarray([1.0, 0.3]))

def logp(theta):                           # theta = log(alpha, beta), (C, 2)
    ys = solve(0.0, y0s, jnp.exp(theta), p_fix, tvals)
    ys_safe = jnp.maximum(ys, 1e-10)
    loglik = -0.5 * jnp.sum((jnp.log(ys_safe) - obs_log[None])**2 / sigma**2, axis=(1, 2))
    logprior = -0.5 * jnp.sum((theta - mu0)**2, axis=1)
    lp = loglik + logprior
    return jnp.where(jnp.isfinite(lp), lp, -jnp.inf)"""
        ),
        md("## Sample"),
        code(
            """\
import time
key = jax.random.PRNGKey(1)
init = mu0[None, :] + 0.3 * jax.random.normal(key, (C, 2))
t0 = time.time()
res = nuts_sample(logp, key, init, num_warmup=150, num_samples=250, max_treedepth=6)
jax.block_until_ready(res.samples)
print(f"wall: {time.time()-t0:.1f}s, step size {float(res.step_size):.3f}")"""
        ),
        md("## Diagnostics and parameter recovery"),
        code(
            """\
s = np.exp(np.asarray(res.samples))        # back to natural scale
rhat = split_rhat(np.asarray(res.samples))
ess = ess_bulk(np.asarray(res.samples))
for i, name in enumerate(['alpha', 'beta']):
    post = s[:, :, i].reshape(-1)
    true = [true_alpha, true_beta][i]
    print(f"{name}: {post.mean():.4f} +- {post.std():.4f}  (true {true}),"
          f"  Rhat {rhat[i]:.4f},  ESS {ess[i]:.0f}")
print("divergences:", int(np.asarray(res.diverging).sum()), "/", res.diverging.size)
assert (rhat < 1.05).all()"""
        ),
        md(
            "On a GPU the same gradient kernel runs at 10,000 chains — see\n"
            "`bench.py` and `chip_smoke.py`."
        ),
    ]
    return nb


def main():
    os.makedirs(os.path.join(ROOT, "notebooks"), exist_ok=True)
    for name, builder in [
        ("from_sympy", build_from_sympy),
        ("nuts_model", build_nuts_model),
    ]:
        nb = builder()
        client = NotebookClient(
            nb, timeout=1200, kernel_name="python3",
            resources={"metadata": {"path": ROOT}},
        )
        print(f"executing {name}.ipynb ...")
        client.execute()
        path = os.path.join(ROOT, "notebooks", f"{name}.ipynb")
        nbf.write(nb, path)
        print("wrote", path)


if __name__ == "__main__":
    main()
