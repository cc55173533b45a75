"""Fit Lotka-Volterra parameters with PyMC NUTS through the JAX solver.

The analog of the reference README's "Usage in PyMC" section +
notebooks/pymc_model.ipynb.  Requires pymc + pytensor (optional deps); the
script degrades to a logp/dlogp timing check if pymc is unavailable but
pytensor is present.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# single-instance solves are latency-bound: CPU is the right device (the
# batched 10k-chain path is what belongs on the GPU — see __graft_entry__)
if os.environ.get("EXAMPLE_FORCE_CPU", "1") == "1":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

try:
    import pytensor
    import pytensor.tensor as pt
except ImportError:
    # fall back to the vendored Op-protocol shim: the Ops + logp/dlogp path
    # below run unchanged (pymc itself still needs the real pytensor)
    from sunode_tpu._compat.pt_shim import install

    install()
    import pytensor
    import pytensor.tensor as pt

import sunode_tpu.wrappers.as_pytensor as sun_pt


def lotka_volterra(t, y, p):
    return {
        "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


times = np.arange(1900, 1921, 1)
lynx_data = np.array(
    [4.0, 6.1, 9.8, 35.2, 59.4, 41.7, 19.0, 13.0, 8.3, 9.1, 7.4,
     8.0, 12.3, 19.5, 45.7, 51.1, 29.7, 15.8, 9.7, 10.1, 8.6]
)
hare_data = np.array(
    [30.0, 47.2, 70.2, 77.4, 36.3, 20.6, 18.1, 21.4, 22.0, 25.4,
     27.1, 40.3, 57.0, 76.6, 52.3, 19.5, 11.2, 7.6, 14.6, 16.2, 24.7]
)

try:
    import pymc as pm

    with pm.Model() as model:
        hares_start = pm.HalfNormal("hares_start", sigma=50)
        lynx_start = pm.HalfNormal("lynx_start", sigma=50)
        ratio = pm.Beta("ratio", alpha=0.5, beta=0.5)
        fixed_hares = pm.HalfNormal("fixed_hares", sigma=50)
        period = pm.Gamma("period", mu=10, sigma=1)
        freq = pm.Deterministic("freq", 2 * np.pi / period)
        log_speed_ratio = pm.Normal("log_speed_ratio", mu=0, sigma=0.1)
        speed_ratio = np.exp(log_speed_ratio)

        alpha = pm.Deterministic("alpha", freq * speed_ratio * ratio)
        beta = pm.Deterministic("beta", freq * speed_ratio / fixed_hares)
        gamma = pm.Deterministic("gamma", freq / speed_ratio / ratio)
        delta = pm.Deterministic("delta", freq / speed_ratio / fixed_hares / ratio)

        y_hat, _, problem, solver, _, _ = sun_pt.solve_ivp(
            y0={"hares": (hares_start, ()), "lynx": (lynx_start, ())},
            params={
                "alpha": (alpha, ()),
                "beta": (beta, ()),
                "gamma": (gamma, ()),
                "delta": (delta, ()),
                "extra": np.zeros(1),
            },
            rhs=lotka_volterra,
            tvals=times,
            t0=times[0],
        )
        sd = pm.HalfNormal("sd")
        pm.LogNormal("hares", mu=pt.log(y_hat["hares"]), sigma=sd, observed=hare_data)
        pm.LogNormal("lynx", mu=pt.log(y_hat["lynx"]), sigma=sd, observed=lynx_data)

        t0 = time.perf_counter()
        idata = pm.sample(tune=200, draws=200, chains=2, cores=1, progressbar=False)
        print(f"sampling took {time.perf_counter()-t0:.1f}s")
        print(pm.summary(idata, var_names=["alpha", "beta", "gamma", "delta"]))
except ImportError:
    print("pymc not installed; timing raw logp/grad through the Ops instead")
    alpha = pt.dscalar("alpha")
    y_hat, flat, problem, solver, _, _ = sun_pt.solve_ivp(
        y0={"hares": (np.float64(30.0), ()), "lynx": (np.float64(4.0), ())},
        params={
            "alpha": (alpha, ()),
            "beta": np.float64(0.02),
            "gamma": np.float64(0.5),
            "delta": np.float64(0.01),
        },
        rhs=lotka_volterra,
        tvals=times.astype(float),
        t0=float(times[0]),
    )
    loss = (flat**2).sum()
    g = pytensor.grad(loss, alpha)
    f = pytensor.function([alpha], [loss, g])
    f(0.5)
    t0 = time.perf_counter()
    for _ in range(20):
        f(0.5)
    print(f"logp+grad pair: {(time.perf_counter()-t0)/20*1000:.2f} ms")
