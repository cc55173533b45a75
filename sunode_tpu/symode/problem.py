"""Symbolically-defined ODE problems (sympy) lowered to JAX.

JAX-native rebuild of the reference ``SympyProblem``
(reference sunode/symode/problem.py:24-611): the user writes the
right-hand side once as a sympy expression over named (nested) states and
params; Jacobian, adjoint RHS, quadrature RHS and forward-sensitivity RHS are
derived *symbolically* (same derivations as symode/problem.py:142-148) and
lowered through :func:`sunode_tpu.symode.lambdify.lambdify_jax` to pure JAX
functions with CSE preserved — instead of numba ``@cfunc`` C callbacks.

Differences from the reference, by design:
  - Flat ``jnp`` vectors replace structured numpy arrays; the named structure
    lives in :class:`sunode_tpu.paramspec.ParamSpec`.
  - Non-finite handling moves out of the generated functions and into the
    integrator's step controller (a rejected step retries with smaller h;
    reference symode/problem.py:266-269 returned CVODES "recoverable error 1"
    to get the same behavior).
  - The adjoint Jacobian is ``-J^T`` of the generated Jacobian rather than a
    separately generated function (equivalent, and one fewer codegen).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import sympy as sy

import jax.numpy as jnp

from sunode_tpu import problem as problem_mod
from sunode_tpu.paramspec import ParamSpec, nest_path_dict
from sunode_tpu.symode.lambdify import lambdify_jax

__all__ = ["SympyProblem"]


def _symbol_leaf(prefix: str, start: int, shape: tuple[int, ...]):
    """An object array (or bare symbol for scalars) of indexed real symbols."""
    if shape == ():
        return sy.Symbol(f"{prefix}{start}", real=True)
    flat = np.array(
        [sy.Symbol(f"{prefix}{start + k}", real=True) for k in range(int(np.prod(shape)))],
        dtype=object,
    )
    return flat.reshape(shape)


class SympyProblem(problem_mod.Problem):
    """Declare an ODE symbolically; mirrors reference SympyProblem ctor
    (symode/problem.py:25-33).

    Parameters
    ----------
    params, states:
        Nested ``{name: shape}`` specs (shape entries may be coord names).
    rhs_sympy:
        ``f(t, y, p) -> dict`` called once with sympy-symbol Records.
    derivative_params:
        Paths of params to differentiate with respect to.
    coords:
        Coordinate arrays for named dims.
    simplify:
        Optional per-element ``sympy.Expr -> Expr`` transform applied before
        lowering.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        states: Mapping[str, Any],
        rhs_sympy: Callable,
        derivative_params: Any = (),
        coords: Optional[Mapping[str, Any]] = None,
        simplify: Optional[Callable] = None,
        dtype: Any = np.float64,
    ):
        self._init_specs(params, states, derivative_params, coords, dtype)
        self._rhs_sympy_func = rhs_sympy
        self._simplify_elem = simplify

        n = self.n_states

        # --- symbol construction + varmap --------------------------------
        self._varmap: dict[str, str] = {"__t": "_t"}
        self._sym_time = sy.Symbol("__t", real=True)

        for i in range(n):
            self._varmap[f"__y_{i}"] = f"_y[{i}]"
        for j in range(self.n_all_params):
            self._varmap[f"__p_{j}"] = f"_p[{j}]"
        for i in range(n):
            self._varmap[f"__lam_{i}"] = f"_lam[{i}]"
        for k in range(self.n_params):
            for i in range(n):
                self._varmap[f"__s_{k}_{i}"] = f"_s[{k}, {i}]"

        self._sym_statevec = np.array(
            [sy.Symbol(f"__y_{i}", real=True) for i in range(n)], dtype=object
        )
        self._sym_paramvec = np.array(
            [sy.Symbol(f"__p_{j}", real=True) for j in range(self.n_all_params)],
            dtype=object,
        )
        self._sym_lamda = np.array(
            [sy.Symbol(f"__lam_{i}", real=True) for i in range(n)], dtype=object
        )
        self._sym_sens = np.array(
            [
                [sy.Symbol(f"__s_{k}_{i}", real=True) for i in range(n)]
                for k in range(self.n_params)
            ],
            dtype=object,
        ).reshape(self.n_params, n)

        state_rec = self.states.record(
            lambda path, shape: _symbol_leaf("__y_", self.states.slices[path].start, shape)
        )
        param_rec = self.params.record(
            lambda path, shape: _symbol_leaf("__p_", self.params.slices[path].start, shape)
        )

        # --- user RHS evaluation + flatten/validate ----------------------
        self._sym_dydt = self._make_dydt(state_rec, param_rec)

        # --- symbolic derivations (reference symode/problem.py:142-148) --
        dydt_mat = sy.Matrix(list(self._sym_dydt))
        statevec_mat = sy.Matrix(list(self._sym_statevec))
        derivvec = self._sym_paramvec[self.params.subset_indices]
        self._sym_dydt_jac = np.array(
            dydt_mat.jacobian(statevec_mat), dtype=object
        ).reshape(n, n)
        if len(derivvec):
            self._sym_dydp = np.array(
                dydt_mat.jacobian(sy.Matrix(list(derivvec))), dtype=object
            ).reshape(n, len(derivvec))
        else:
            self._sym_dydp = np.zeros((n, 0), dtype=object)

        # dlamda/dt_i = -sum_j lam_j J[j, i]
        lam = self._sym_lamda
        J = self._sym_dydt_jac
        self._sym_dlamdadt = np.array(
            [-sum(lam[j] * J[j, i] for j in range(n)) for i in range(n)], dtype=object
        )
        # quad_k = sum_j lam_j dydp[j, k]
        self._sym_quad_rhs = np.array(
            [
                sum(lam[j] * self._sym_dydp[j, k] for j in range(n))
                for k in range(self.n_params)
            ],
            dtype=object,
        )

        self._fn_cache: dict[str, Callable] = {}

    # pickling: generated jax functions don't pickle; they're pure caches and
    # rebuild on demand (reference Solver pickling contract, solver.py:304-324)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fn_cache"] = {}
        return state

    # ------------------------------------------------------------------
    def _make_dydt(self, state_rec, param_rec) -> np.ndarray:
        """Call the user RHS once and flatten the returned (nested) dict to a
        flat object vector, with shape/dims validation mirroring reference
        symode/problem.py:160-230."""
        rhs = self._rhs_sympy_func(self._sym_time, state_rec, param_rec)
        if not isinstance(rhs, Mapping):
            raise ValueError("rhs_sympy must return a dict of state derivatives")
        # mutable copy for pop-based bookkeeping
        rhs = _deep_copy_dict(rhs)

        out: list[Any] = []
        for path in self.states.paths:
            node = rhs
            for name in path[:-1]:
                if not isinstance(node, Mapping) or name not in node:
                    raise ValueError(
                        f"No right-hand-side for state {'.'.join(path)}"
                    )
                node = node[name]
            if not isinstance(node, Mapping) or path[-1] not in node:
                raise ValueError(f"No right-hand-side for state {'.'.join(path)}")
            item = node.pop(path[-1])
            shape = self.states.shapes[path]
            dims = self.states.dims_for(path)
            out.extend(
                _flatten_rhs_item(".".join(path), item, shape, dims, self.coords)
            )

        remaining = _flatten_keys(rhs)
        if remaining:
            raise ValueError(f"Unknown state variables in rhs: {remaining}")
        if len(out) != self.n_states:
            raise AssertionError("internal: dydt length mismatch")
        return np.array([sy.sympify(e) for e in out], dtype=object)

    # ------------------------------------------------------------------
    # Lowered functions (cached per derivative kind)
    # ------------------------------------------------------------------
    def _lower(self, key: str, argnames, exprs) -> Callable:
        if key not in self._fn_cache:
            exprs = np.asarray(exprs, dtype=object)
            if self._simplify_elem is not None:
                flat = [self._simplify_elem(e) for e in exprs.reshape(-1)]
                exprs = np.array(flat, dtype=object).reshape(exprs.shape)
            self._fn_cache[key] = lambdify_jax(
                argnames, exprs, self._varmap, name=key
            )
        return self._fn_cache[key]

    def make_rhs(self, *, debug: bool = False) -> Callable:
        """Generated dy/dt (reference symode/problem.py:251-282)."""
        return self._lower("rhs", ["_t", "_y", "_p"], self._sym_dydt)

    def make_jac_dense(self, *, debug: bool = False) -> Callable:
        """Generated df/dy (reference symode/problem.py:342-371)."""
        return self._lower("jac_dense", ["_t", "_y", "_p"], self._sym_dydt_jac)

    def jac_sparsity(self, **_ignored) -> np.ndarray:
        """EXACT structural pattern from the symbolic Jacobian — the zeros
        sympy already proved (the information the reference makes the user
        hand to KLU, ref matrix.py:105-200).  Feeds the colored-jvp banded
        Newton path (linear_solver='sparse', ops/sparsity.py)."""
        n = self.n_states
        pattern = np.zeros((n, n), bool)
        for i in range(n):
            for j in range(n):
                pattern[i, j] = self._sym_dydt_jac[i, j] != 0
        return pattern

    def make_dfdp(self, *, debug: bool = False) -> Callable:
        """Generated df/dp_subset, shape (n_states, n_deriv)."""
        return self._lower("dfdp", ["_t", "_y", "_p"], self._sym_dydp)

    def symbolic_roots(self, roots_sympy: Callable) -> np.ndarray:
        """Symbolic event-function vector (object array of sympy exprs).

        ``roots_sympy`` is called once with the same ``(t, states, params)``
        symbol records as ``rhs_sympy`` and must return a sympy expression
        or a list/tuple of them.  Shared by the JAX lowering
        (:meth:`make_root_fn`) and the native C codegen
        (``native/codegen.py`` ``sunode_roots``)."""
        state_rec = self.states.record(
            lambda path, shape: _symbol_leaf(
                "__y_", self.states.slices[path].start, shape
            )
        )
        param_rec = self.params.record(
            lambda path, shape: _symbol_leaf(
                "__p_", self.params.slices[path].start, shape
            )
        )
        exprs = roots_sympy(self._sym_time, state_rec, param_rec)
        if not isinstance(exprs, (list, tuple)):
            exprs = [exprs]
        vec = np.array([sy.sympify(e) for e in exprs], dtype=object)
        if self._simplify_elem is not None:
            vec = np.array(
                [self._simplify_elem(e) for e in vec], dtype=object
            )
        return vec

    def make_root_fn(self, roots_sympy: Callable) -> Callable:
        """Lower symbolic event functions to a JAX ``(t, y, p) -> (nrt,)``.

        ``roots_sympy`` is called once with the same ``(t, states, params)``
        symbol records as ``rhs_sympy`` and must return a sympy expression
        or a list/tuple of them; zero crossings of each component become
        events for ``bdf_solve(root_fn=...)`` / ``Solver(roots=...)``
        (CVodeRootInit analog — the reference declares the API,
        include/cvodes/16_cvodes.h:195, but never exposes it)."""
        vec = self.symbolic_roots(roots_sympy)
        # not routed through _fn_cache: distinct roots_sympy callables would
        # collide on any static key
        return lambdify_jax(["_t", "_y", "_p"], vec, self._varmap, name="roots")

    def make_adjoint_rhs(self, *, debug: bool = False) -> Callable:
        """Generated -lam^T J (reference symode/problem.py:284-311)."""
        fn = self._lower("adjoint_rhs", ["_t", "_y", "_lam", "_p"], self._sym_dlamdadt)
        return lambda t, y, lam, p: fn(t, y, lam, p)

    def make_adjoint_quad_rhs(self, *, debug: bool = False) -> Callable:
        """Generated lam^T df/dp (reference symode/problem.py:313-340)."""
        fn = self._lower("adjoint_quad_rhs", ["_t", "_y", "_lam", "_p"], self._sym_quad_rhs)
        return lambda t, y, lam, p: fn(t, y, lam, p)

    def make_rhs_jac_prod(self, *, debug: bool = False) -> Callable:
        """J @ v via the generated dense Jacobian (reference symode/problem.py:373-403)."""
        jac = self.make_jac_dense()

        def jac_prod(t, y, v, p):
            return jac(t, y, p) @ v

        return jac_prod

    def make_adjoint_jac_prod(self, *, debug: bool = False) -> Callable:
        """-J^T @ v (reference symode/problem.py:435-465)."""
        jac = self.make_jac_dense()

        def adjoint_jac_prod(t, y, lam, v, p):
            return -(jac(t, y, p).T @ v)

        return adjoint_jac_prod

    def make_sensitivity_rhs(self, *, debug: bool = False) -> Callable:
        """S @ J^T + dfdp^T from the generated J and dfdp, matching the
        reference's default numeric composition (symode/problem.py:557-583)."""
        jac = self.make_jac_dense()
        dfdp = self.make_dfdp()

        def sensitivity_rhs(t, y, S, p):
            J = jac(t, y, p)
            return S @ J.T + dfdp(t, y, p).T

        return sensitivity_rhs

    def make_sensitivity_rhs_explicit(self, *, debug: bool = False) -> Callable:
        """Fully-symbolic sensitivity RHS (reference symode/problem.py:511-555):
        every entry of J@S_k + df/dp_k is one generated expression."""
        n = self.n_states
        J = self._sym_dydt_jac
        S = self._sym_sens
        exprs = np.array(
            [
                [
                    sum(J[i, j] * S[k, j] for j in range(n)) + self._sym_dydp[i, k]
                    for i in range(n)
                ]
                for k in range(self.n_params)
            ],
            dtype=object,
        ).reshape(self.n_params, n)
        fn = self._lower("sensitivity_rhs_explicit", ["_t", "_y", "_s", "_p"], exprs)
        return lambda t, y, S_, p: fn(t, y, S_, p)


# ---------------------------------------------------------------------------
def _deep_copy_dict(d: Mapping[str, Any]) -> dict:
    return {
        k: (_deep_copy_dict(v) if isinstance(v, Mapping) else v) for k, v in d.items()
    }


def _flatten_keys(d: Mapping[str, Any], prefix: str = "") -> list[str]:
    out = []
    for k, v in d.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.extend(_flatten_keys(v, name + "."))
        else:
            out.append(name)
    return out


def _flatten_rhs_item(path, value, shape, dims, coords) -> list[Any]:
    """Validate + flatten one state's RHS entry (reference symode/problem.py:165-230).

    Accepts: scalar sympy expr (shape ()), array-likes of the right shape,
    nested lists, or dicts keyed by coordinate values for named dims.
    """
    if isinstance(value, sy.matrices.MatrixBase):
        value = np.array(value, dtype=object).reshape(value.shape)
        if shape != () and len(shape) == 1 and value.size == shape[0]:
            value = value.reshape(shape)
    if isinstance(value, sy.NDimArray):
        value = np.array(value.tolist(), dtype=object)

    if isinstance(value, np.ndarray):
        if value.shape != tuple(shape):
            raise ValueError(
                f"Invalid shape for right-hand-side state {path}. "
                f"It is {value.shape} but we expected {tuple(shape)}."
            )
        return list(value.reshape(-1))
    if isinstance(value, (list, tuple)):
        if len(shape) == 0 or len(value) != shape[0]:
            raise ValueError(f"Invalid shape for right-hand-side state {path}.")
        out = []
        for v in value:
            out.extend(_flatten_rhs_item(path, v, shape[1:], dims[1:], coords))
        return out
    if isinstance(value, Mapping):
        if len(shape) == 0:
            raise ValueError(f"Invalid shape for right-hand-side state {path}.")
        dim = dims[0]
        if dim not in coords:
            raise ValueError(
                f"Right-hand-side for state {path} is a dict, but dim "
                f"'{dim}' has no coords to key it by."
            )
        if len(value) != shape[0]:
            raise ValueError(f"Invalid shape for right-hand-side state {path}.")
        out = []
        for key in coords[dim]:
            if key not in value:
                raise ValueError(
                    f"Right-hand-side for state {path} is missing coord {key!r}."
                )
            out.extend(_flatten_rhs_item(path, value[key], shape[1:], dims[1:], coords))
        return out
    if tuple(shape) == ():
        return [value]
    raise ValueError(f"Unknown right-hand-side for state {path}.")
