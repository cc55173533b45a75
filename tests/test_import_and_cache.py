"""The package's import graph and the compile-cache helper.

sympy is a host-side code generator: ``import sunode_tpu``, ``JaxProblem``,
the batched solvers and the class API's B=1 route must work where it is not
installed (the GPU machine need not have it).  The compile cache goes where
``JAX_COMPILATION_CACHE_DIR`` says, else to ``<checkout>/.jax_cache``.
"""

import os
import subprocess
import sys
import textwrap

import jax
import pytest

import sunode_tpu
from sunode_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_SYMPY = textwrap.dedent(
    """
    import sys

    class _Block:
        # refuse sympy (and the optional xarray/pandas) as if not installed
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("sympy", "xarray", "pandas"):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, sys.argv[1])

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import sunode_tpu
    import __graft_entry__ as ge

    assert "sympy" not in sys.modules
    g = np.load(sys.argv[2])
    fn, _ = ge._build(batch=16, tvals_n=21, rtol=1e-8, checkpoint_n=384)
    gy, gp = jax.jit(fn)(jnp.asarray(g["y0s"]), jnp.asarray(g["p_subs"]))
    np.testing.assert_allclose(np.asarray(gy), g["gy"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(gp), g["gp"], rtol=2e-3, atol=1e-3)

    # B=1 class API: the native route needs sympy codegen and falls back
    solver = sunode_tpu.Solver(ge.lv_problem(), reltol=1e-8, abstol=1e-8, solver="ADAMS")
    solver.set_params_dict(dict(alpha=1.0, beta=0.3, gamma=1.0, delta=0.4))
    ys = solver.solve(0.0, np.linspace(0.0, 5.0, 6), np.array([10.0, 2.0]))
    assert np.isfinite(ys).all(), ys
    assert "sympy" not in sys.modules
    try:
        sunode_tpu.SympyProblem
    except ImportError:
        print("NO_SYMPY_OK")
    """
)


def test_import_and_batched_gradient_without_sympy():
    golden = os.path.join(REPO, "tests", "golden", "lv_adjoint.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _NO_SYMPY, REPO, golden], env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NO_SYMPY_OK" in out.stdout


def test_sympy_problem_resolves_lazily():
    from sunode_tpu.symode import SympyProblem

    assert "SympyProblem" not in vars(sunode_tpu)
    assert sunode_tpu.SympyProblem is SympyProblem
    from sunode_tpu import SympyProblem as again

    assert again is SympyProblem
    with pytest.raises(AttributeError):
        sunode_tpu.NoSuchName


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_dir(env_set, tmp_path, monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    if env_set:
        monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path))
        assert compile_cache.use_checkout_cache() == str(tmp_path)
        assert updates == []
    else:
        monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.use_checkout_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
