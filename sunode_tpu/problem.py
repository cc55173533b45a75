"""Problem abstraction: named ODE problems as pure JAX functions.

JAX-native replacement for the reference's ``Problem`` protocol + SUNDIALS
callback bridge (reference sunode/problem.py:14-98, 156-494).  The
reference wraps numba-njit functions into C-ABI ``@numba.cfunc`` callbacks for
CVODES; here every derivative function is a *pure JAX function on flat
vectors* that the integrator traces straight into one XLA computation — the
callback bridging layer disappears entirely.

Function signature conventions (flat float vectors):

    rhs(t, y, p)              -> (n_states,)        dy/dt
    jac_dense(t, y, p)        -> (n, n)             df/dy
    rhs_jac_prod(t, y, v, p)  -> (n,)               J @ v
    adjoint_rhs(t, y, lam, p) -> (n,)               -J^T @ lam
    adjoint_quad_rhs(t, y, lam, p) -> (n_deriv,)    lam^T @ df/dp_subset
    sensitivity_rhs(t, y, S, p) -> (n_deriv, n)     S @ J^T + (df/dp_subset)^T

where ``p`` is the *full* flat parameter vector and the derivative subset is
selected by ``self.params.subset_indices``.

Any subclass only has to supply ``make_rhs``; every other derivative falls
back to JAX autodiff (jacfwd/vjp/jvp) — the idiomatic-JAX analog of the
reference's symbolically-generated functions, and bit-identical in exact
arithmetic.  ``SympyProblem`` overrides them with symbolically-derived,
CSE'd closed forms.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sunode_tpu.paramspec import ParamSpec, Record

__all__ = ["Problem", "JaxProblem", "solution_to_xarray", "flat_solution_as_dict"]


class Problem:
    """Base class for ODE problems.

    Attributes set up by ``_init_specs``:
      - ``states``: ParamSpec of the state variables
      - ``params``: ParamSpec of the parameters (with derivative subset)
      - ``coords``: resolved coordinates for named dims
    """

    states: ParamSpec
    params: ParamSpec
    coords: dict[str, np.ndarray]

    def _init_specs(
        self,
        params: Mapping[str, Any],
        states: Mapping[str, Any],
        derivative_params: Any = (),
        coords: Optional[Mapping[str, Any]] = None,
        dtype: Any = np.float64,
    ) -> None:
        self.params = ParamSpec(
            params, derivative_params or (), coords=coords, dtype=dtype
        )
        self.states = ParamSpec(states, (), coords=coords, dtype=dtype)
        self.coords = self.params.resolved_coords

    # ------------------------------------------------------------------
    @property
    def n_states(self) -> int:
        return self.states.n_items

    @property
    def n_params(self) -> int:
        """Number of derivative parameters (reference Problem.n_params)."""
        return self.params.subset_n_items

    @property
    def n_all_params(self) -> int:
        return self.params.n_items

    # numpy structured-dtype parity (reference problem.state_dtype /
    # params_dtype — README.md:100-110 builds y0 with these)
    @property
    def state_dtype(self) -> np.dtype:
        return self.states.as_numpy_dtype()

    @property
    def params_dtype(self) -> np.dtype:
        return self.params.as_numpy_dtype()

    # Reference-parity dtype-ish accessors: users build y0 / params as nested
    # dicts instead of structured arrays; these helpers flatten them.
    def flatten_state(self, nested: Mapping[str, Any], xp: Any = jnp):
        return self.states.flatten_dict(nested, xp=xp)

    def flatten_params(self, nested: Mapping[str, Any], xp: Any = jnp):
        return self.params.flatten_dict(nested, xp=xp)

    # ------------------------------------------------------------------
    # Factories.  Only make_rhs is abstract.
    # ------------------------------------------------------------------
    def make_rhs(self) -> Callable:
        raise NotImplementedError

    def make_jac_dense(self) -> Callable:
        rhs = self.make_rhs()

        def jac_dense(t, y, p):
            return jax.jacfwd(rhs, argnums=1)(t, y, p)

        return jac_dense

    def make_rhs_jac_prod(self) -> Callable:
        rhs = self.make_rhs()

        def jac_prod(t, y, v, p):
            return jax.jvp(lambda y_: rhs(t, y_, p), (y,), (v,))[1]

        return jac_prod

    def make_adjoint_rhs(self) -> Callable:
        """lamda_dot = -J^T lam (reference symode/problem.py:147, 284-311)."""
        rhs = self.make_rhs()

        def adjoint_rhs(t, y, lam, p):
            _, pullback = jax.vjp(lambda y_: rhs(t, y_, p), y)
            return -pullback(lam)[0]

        return adjoint_rhs

    def make_adjoint_quad_rhs(self) -> Callable:
        """quad_dot = lam^T df/dp_subset (reference symode/problem.py:148, 313-340)."""
        rhs = self.make_rhs()
        subset_idx = self.params.subset_indices

        def adjoint_quad_rhs(t, y, lam, p):
            _, pullback = jax.vjp(lambda p_: rhs(t, y, p_), p)
            return pullback(lam)[0][subset_idx]

        return adjoint_quad_rhs

    def make_adjoint_jac_dense(self) -> Callable:
        """Jacobian of the adjoint system: -J^T (reference symode/problem.py:406-433)."""
        jac = self.make_jac_dense()

        def adjoint_jac_dense(t, y, lam, p):
            return -jac(t, y, p).T

        return adjoint_jac_dense

    def make_sensitivity_rhs(self) -> Callable:
        """S_dot[k] = J @ S[k] + df/dp_k for each derivative param k.

        S has shape (n_deriv_params, n_states), matching the reference's yS
        layout (problem.py:269-313).  Computed as S @ J^T + dfdp^T so the
        contraction is one matrix product for large systems.
        """
        jac = self.make_jac_dense()
        dfdp = self.make_dfdp()

        def sensitivity_rhs(t, y, S, p):
            J = jac(t, y, p)
            return S @ J.T + dfdp(t, y, p).T

        return sensitivity_rhs

    def make_banded_jac_dense(self, lower: int, upper: int) -> Callable:
        """df/dy exploiting banded structure: only lower+upper+1 jvp sweeps
        with striped seed vectors instead of n (the classic banded
        difference-quotient trick; reference linear_solver='band',
        solver.py:326-358 + sunmatrix_band).  Returns a dense (n, n) matrix
        that is exactly zero outside the band."""
        rhs = self.make_rhs()
        n = self.n_states
        w = lower + upper + 1

        def jac(t, y, p):
            f = lambda yy: rhs(t, yy, p)  # noqa: E731

            def stripe(s):
                seed = (jnp.arange(n) % w == s).astype(y.dtype)
                return jax.jvp(f, (y,), (seed,))[1]

            cols = jax.vmap(stripe)(jnp.arange(w))  # (w, n)
            i = jnp.arange(n)[:, None]
            j = jnp.arange(n)[None, :]
            band = (j - i <= upper) & (i - j <= lower)
            return jnp.where(band, cols[j % w, i], 0.0)

        return jac

    def make_banded_jac(self, lower: int, upper: int) -> Callable:
        """df/dy in (lower+upper+1, n) banded storage (ab[u+i-j, j] = J[i,j])
        from lower+upper+1 striped jvp sweeps — the input format of
        ops/banded.banded_factor, so a banded Newton solve never touches a
        dense matrix (SUNDIALS sunlinsol_band analog)."""
        rhs = self.make_rhs()
        n = self.n_states
        w = lower + upper + 1

        def jac(t, y, p):
            f = lambda yy: rhs(t, yy, p)  # noqa: E731

            def stripe(s):
                seed = (jnp.arange(n) % w == s).astype(y.dtype)
                return jax.jvp(f, (y,), (seed,))[1]

            cols = jax.vmap(stripe)(jnp.arange(w))  # (w, n): cols[s, i]
            j = jnp.arange(n)[None, :]
            r = jnp.arange(w)[:, None]
            i = j + r - upper
            valid = (i >= 0) & (i < n)
            return jnp.where(valid, cols[j % w, jnp.clip(i, 0, n - 1)], 0.0)

        return jac

    def jac_sparsity(self, n_probes: int = 3, seed: int = 0) -> np.ndarray:
        """Structural (n, n) boolean pattern of df/dy.

        Generic fallback: union of nonzero entries of the autodiff Jacobian
        at ``n_probes`` random probe points (probabilistic — an entry that
        vanishes at every probe but not identically is misclassified;
        ``SympyProblem`` overrides this with the EXACT pattern from its
        symbolic Jacobian).  Non-finite entries count as structurally
        nonzero (conservative).  This is the sparsity input the reference
        requires the user to hand to KLU (ref matrix.py:105-200); here it
        feeds the colored-jvp banded Newton path (ops/sparsity.py).
        """
        jac = self.make_jac_dense()
        n = self.n_states
        rng = np.random.default_rng(seed)
        pattern = np.zeros((n, n), bool)
        for _ in range(n_probes):
            y = jnp.asarray(0.5 + rng.uniform(0.1, 1.0, n))
            p = jnp.asarray(0.5 + rng.uniform(0.1, 1.0, self.n_all_params))
            t = float(rng.uniform(0.1, 1.0))
            J = np.asarray(jac(t, y, p))
            pattern |= ~(J == 0.0)  # NaN/inf -> True
        return pattern

    def make_dfdp(self) -> Callable:
        """df/dp_subset with shape (n_states, n_deriv_params)."""
        rhs = self.make_rhs()
        subset_idx = self.params.subset_indices

        def dfdp(t, y, p):
            return jax.jacfwd(lambda p_: rhs(t, y, p_))(p)[:, subset_idx]

        return dfdp

    # ------------------------------------------------------------------
    # Solution conversion (reference problem.py:100-154)
    # ------------------------------------------------------------------
    def solution_to_xarray(self, tvals, solution, *, unstack_state=True, unstack_params=False, params=None, sensitivity=None):
        return solution_to_xarray(
            self,
            tvals,
            solution,
            unstack_state=unstack_state,
            unstack_params=unstack_params,
            params=params,
            sensitivity=sensitivity,
        )

    def flat_solution_as_dict(self, solution) -> dict[str, Any]:
        return flat_solution_as_dict(self, solution)


class JaxProblem(Problem):
    """An ODE problem whose right-hand side is written directly in JAX.

    This is the JAX-first authoring mode (the analog of the reference's
    "manual numba RHS" escape hatch): the user writes

        def rhs(t, y, p):
            return {'hares': p.alpha * y.hares - p.beta * y.lynx * y.hares,
                    'lynx': ...}

    where ``y``/``p`` are attribute-access Records of jnp arrays.  All
    derivatives come from JAX autodiff.  For large vector states this is the
    recommended mode — expressions stay vectorised and XLA sees the natural
    array program rather than thousands of scalar assignments.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        states: Mapping[str, Any],
        rhs: Callable[[Any, Record, Record], Mapping[str, Any]],
        derivative_params: Any = (),
        coords: Optional[Mapping[str, Any]] = None,
        dtype: Any = np.float64,
    ):
        self._init_specs(params, states, derivative_params, coords, dtype)
        self._user_rhs = rhs

    def make_rhs(self) -> Callable:
        states = self.states
        params = self.params
        user_rhs = self._user_rhs

        def rhs(t, y, p):
            y_rec = states.record(y)
            p_rec = params.record(p)
            out = user_rhs(t, y_rec, p_rec)
            if not isinstance(out, Mapping):
                raise TypeError("JaxProblem rhs must return a dict of state derivatives")
            # follow the traced input dtype: an f32 pipeline must not be
            # upcast to the spec's f64 here (f32 speed mode)
            return states.flatten_dict(out, xp=jnp, follow_dtype=True)

        return rhs

    def make_root_fn(self, roots: Callable) -> Callable:
        """Lower a record-view event function to the flat ``(t, y, p) ->
        (nrt,)`` contract the integrator cores consume (CVodeRootInit's
        CVRootFn analog).  ``roots(t, y_record, p_record)`` returns a
        sequence/array of event-function values, same convention as the
        RHS."""
        states = self.states
        params = self.params

        def root_fn(t, y, p):
            out = roots(t, states.record(y), params.record(p))
            if isinstance(out, (list, tuple)):
                out = jnp.stack([jnp.asarray(g) for g in out])
            return jnp.asarray(out).reshape(-1)

        return root_fn


# ---------------------------------------------------------------------------
# Output conversion helpers
# ---------------------------------------------------------------------------
def flat_solution_as_dict(problem: Problem, solution) -> dict[str, Any]:
    """Split a (n_times, n_states) solution into named nested arrays
    (reference problem.py:147-154).  Works symbolically: only uses slicing
    and reshape, so `solution` may be numpy, jnp, or a PyTensor matrix."""
    from sunode_tpu.paramspec import nest_path_dict

    flat = {}
    for path in problem.states.paths:
        s = problem.states.slices[path]
        shape = (-1,) + problem.states.shapes[path]
        flat[path] = solution[:, s].reshape(shape)
    return nest_path_dict(flat)


def solution_to_xarray(
    problem: Problem,
    tvals,
    solution,
    *,
    unstack_state: bool = True,
    unstack_params: bool = False,
    params=None,
    sensitivity=None,
):
    """Convert a flat solution into an xarray.Dataset with named dims/coords
    (reference problem.py:100-145).  Falls back to the bundled lightweight
    Dataset when xarray is not installed.
    """
    try:
        import xarray as xr  # type: ignore
    except ImportError:
        from sunode_tpu.utils import dataset as xr  # type: ignore

    solution = np.asarray(solution)
    data = {}
    coords: dict[str, Any] = {"time": np.asarray(tvals)}
    for dim, vals in problem.coords.items():
        coords[dim] = np.asarray(vals)

    if unstack_state:
        named = problem.states.unflatten(solution)
        from sunode_tpu.paramspec import flatten_path_dict

        for path, arr in flatten_path_dict(named).items():
            name = "solution_" + "_".join(path)
            dims = ("time",) + problem.states.dims_for(path)
            data[name] = (dims, arr)
    else:
        data["solution"] = (("time", "state"), solution)

    if params is not None and unstack_params:
        from sunode_tpu.paramspec import flatten_path_dict

        named_p = problem.params.unflatten(np.asarray(params))
        for path, arr in flatten_path_dict(named_p).items():
            name = "parameter_" + "_".join(path)
            data[name] = (problem.params.dims_for(path), arr)

    if sensitivity is not None:
        data["sensitivity"] = (
            ("time", "dparam", "state"),
            np.asarray(sensitivity),
        )

    return xr.Dataset(data, coords=coords)
