"""Differentiable ODE solving as native JAX functions (``jax.custom_vjp``).

This is the JAX-native analog of the reference's PyTensor Op layer
(reference sunode/wrappers/as_pytensor.py): where the reference wraps
the solver in ``SolveODE`` / ``SolveODEAdjoint`` / ``SolveODEAdjointBackward``
Ops so PyTensor can differentiate through it, here the solve is a JAX function
with a custom VJP, so ``jax.grad`` / ``jax.vmap`` / ``jax.jit`` compose with
it directly — and PyMC NUTS (or any JAX sampler) can differentiate through
thousands of vmapped solves on a device mesh.

Gradient modes (reference ``derivatives=`` kwarg, as_pytensor.py:121-137):
  'adjoint' — checkpointed adjoint backsolve (SolveODEAdjoint.grad semantics)
  'forward' — forward sensitivities, gradient by contraction
              (SolveODE.grad, as_pytensor.py:251-263), including the
              '__initial_values' trick of carrying dy/dy0 rows
              (as_pytensor.py:217-230)
  None      — no gradient support (plain solve)

Failure contract: any solver failure NaN-poisons outputs and gradients so a
sampler rejects the proposal instead of crashing (as_pytensor.py:244-247,
289-291, 339-342).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Mapping, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sunode_tpu.adjoint import adjoint_backward, make_hermite_eval
from sunode_tpu.ops.bdf import BDFOptions, bdf_solve
from sunode_tpu.problem import Problem

__all__ = ["make_solve_fn", "make_batched_solve_fn", "solve_ivp", "SolveResult"]


def _poison(ys, status):
    return jnp.where(status == 0, ys, jnp.nan)


def _structured_setup(problem, rhs, linear_solver, linear_solver_kwargs,
                      options, adjoint_options):
    """Shared Newton-structure setup for the functional surfaces.

    Maps ``linear_solver`` ('dense' | 'band' | 'sparse') to the forward
    Jacobian callable + solver options, and to the backward (-J^T)
    structured Jacobian + options — the same treatment the class surface
    applies (``Solver``/``AdjointSolver(linear_solver=...)``; reference
    linear_solver_wrapper.py:99-122 role).  Returns
    ``(jac, options, adjoint_jac_struct_or_None, adjoint_options)``.
    """
    if linear_solver == "band":
        from sunode_tpu.ops.banded import dense_to_banded

        kw = dict(linear_solver_kwargs or {})
        if "lower_bandwidth" not in kw or "upper_bandwidth" not in kw:
            raise ValueError(
                "linear_solver='band' requires linear_solver_kwargs with "
                "'lower_bandwidth' and 'upper_bandwidth'"
            )
        lb, ub = int(kw["lower_bandwidth"]), int(kw["upper_bandwidth"])
        jac = problem.make_banded_jac(lb, ub)
        options = options._replace(
            linear_solver="band", band_lower=lb, band_upper=ub
        )
        # backward matrix is -J^T: bandwidths swap
        _aj_jac_dense = problem.make_adjoint_jac_dense()
        adjoint_jac_struct = lambda t, y, lam, p: dense_to_banded(  # noqa: E731
            _aj_jac_dense(t, y, lam, p), ub, lb
        )
        adjoint_options = adjoint_options._replace(
            linear_solver="band", band_lower=ub, band_upper=lb
        )
        return jac, options, adjoint_jac_struct, adjoint_options
    if linear_solver == "sparse":
        from sunode_tpu.ops.banded import dense_to_banded
        from sunode_tpu.ops.sparsity import SparsePlan, make_colored_banded_jac

        kw = dict(linear_solver_kwargs or {})
        pattern = (
            np.asarray(kw["sparsity"], bool)
            if "sparsity" in kw
            else problem.jac_sparsity()
        )
        plan_f = SparsePlan(
            pattern,
            permute=kw.get("permute", True),
            border=kw.get("border", "auto"),
        )
        jac = make_colored_banded_jac(rhs, plan_f)
        options = options._replace(
            linear_solver="sparse",
            band_lower=plan_f.lower,
            band_upper=plan_f.upper,
            sparse_perm=plan_f.perm,
            sparse_border=plan_f.k_border,
        )
        plan_b = SparsePlan(
            pattern.T,
            permute=kw.get("permute", True),
            border=kw.get("border", "auto"),
        )
        perm_b = jnp.asarray(plan_b.perm)
        _aj_jac_dense = problem.make_adjoint_jac_dense()

        if plan_b.k_border:
            from sunode_tpu.ops.bbd import dense_to_packed

            def adjoint_jac_struct(t, y, lam, p):
                return dense_to_packed(_aj_jac_dense(t, y, lam, p), plan_b)

        else:

            def adjoint_jac_struct(t, y, lam, p):
                A = _aj_jac_dense(t, y, lam, p)[perm_b][:, perm_b]
                return dense_to_banded(A, plan_b.lower, plan_b.upper)

        adjoint_options = adjoint_options._replace(
            linear_solver="sparse",
            band_lower=plan_b.lower,
            band_upper=plan_b.upper,
            sparse_perm=plan_b.perm,
            sparse_border=plan_b.k_border,
        )
        return jac, options, adjoint_jac_struct, adjoint_options
    if linear_solver != "dense":
        raise ValueError(
            "linear_solver must be 'dense', 'band' or 'sparse', got "
            f"{linear_solver!r}"
        )
    return problem.make_jac_dense(), options, None, adjoint_options


def make_solve_fn(
    problem: Problem,
    *,
    derivatives: Optional[str] = "adjoint",
    options: BDFOptions = BDFOptions(),
    adjoint_options: Optional[BDFOptions] = None,
    checkpoint_n: int = 4096,
    adjoint_interpolation: str = "hermite",
    linear_solver: str = "dense",
    linear_solver_kwargs: Optional[dict] = None,
) -> Callable:
    """Build ``solve(t0, y0_flat, params_subset, params_fixed, tvals) -> ys``.

    ``ys`` has shape (n_t, n_states).  Differentiable w.r.t. t0, y0,
    params_subset and tvals according to ``derivatives``; params_fixed always
    gets zero cotangent (reference semantics: gradients only for
    ``derivative_params``).

    ``linear_solver``: 'dense' (default), 'band' or 'sparse' — same
    structured-Newton contract as ``make_batched_solve_fn``; the backward
    adjoint matrix (-J^T) automatically gets the transposed structure.
    Forward sensitivities keep a dense Jacobian for the sensitivity RHS
    (S J^T needs the full matrix) while the Newton solves use the
    structured one.
    """
    rhs = problem.make_rhs()
    spec = problem.params
    n = problem.n_states
    n_deriv = problem.n_params

    if adjoint_options is None:
        # reference hardcodes 1e-10 backward tolerances (solver.py:599,614)
        adjoint_options = BDFOptions(rtol=1e-10, atol=1e-10)

    jac, options, _adjoint_jac_struct, adjoint_options = _structured_setup(
        problem, rhs, linear_solver, linear_solver_kwargs, options,
        adjoint_options,
    )

    def _combine(p_sub, p_fix):
        return spec.combine(p_sub, p_fix, xp=jnp)

    if derivatives is None:

        def solve(t0, y0, p_sub, p_fix, tvals):
            p = _combine(p_sub, p_fix)
            res = bdf_solve(rhs, jac, t0, y0, p, tvals, options)
            return _poison(res.ys, res.status)

        return solve

    if derivatives == "adjoint":
        adjoint_rhs = problem.make_adjoint_rhs()
        adjoint_jac = (
            _adjoint_jac_struct
            if _adjoint_jac_struct is not None
            else problem.make_adjoint_jac_dense()
        )
        quad_rhs = problem.make_adjoint_quad_rhs()
        fwd_options = options._replace(save_steps=checkpoint_n)
        if adjoint_interpolation == "polynomial":
            # polynomial interpolation reads only (t, y) rows
            fwd_options = fwd_options._replace(hermite_order=3)

        @jax.custom_vjp
        def solve(t0, y0, p_sub, p_fix, tvals):
            p = _combine(p_sub, p_fix)
            res = bdf_solve(rhs, jac, t0, y0, p, tvals, options)
            return _poison(res.ys, res.status)

        def solve_fwd(t0, y0, p_sub, p_fix, tvals):
            p = _combine(p_sub, p_fix)
            res = bdf_solve(rhs, jac, t0, y0, p, tvals, fwd_options)
            ys = _poison(res.ys, res.status)
            return ys, (t0, y0, p_sub, p_fix, tvals, res.saved, res.status)

        def solve_bwd(residuals, g):
            t0, y0, p_sub, p_fix, tvals, saved, status = residuals
            p = _combine(p_sub, p_fix)
            with jax.named_scope("sunode_backward"):
                adj = adjoint_backward(
                    adjoint_rhs,
                    adjoint_jac,
                    quad_rhs,
                    saved,
                    t0,
                    tvals,
                    g,
                    p,
                    n_deriv,
                    adjoint_options,
                    interpolation=adjoint_interpolation,
                )
            bad = (status != 0) | (adj.status != 0)
            lam = jnp.where(bad, jnp.nan, adj.lamda)
            quad = jnp.where(bad, jnp.nan, adj.quad)
            # d/dtvals_i = g_i . f(t_i, y(t_i))   (reference EvalRhs path,
            # as_pytensor.py:251-263)
            y_at = make_hermite_eval(saved)
            ys_at_t = jax.vmap(y_at)(tvals)
            f_at_t = jax.vmap(lambda t, y: rhs(t, y, p))(tvals, ys_at_t)
            d_tvals = jnp.einsum("ij,ij->i", g, f_at_t)
            d_tvals = jnp.where(bad, jnp.nan, d_tvals)
            # dL/dt0 = -lambda(t0)^T f(t0, y0)
            d_t0 = -jnp.dot(lam, rhs(t0, y0, p))
            return (d_t0, lam, quad, jnp.zeros_like(p_fix), d_tvals)

        solve.defvjp(solve_fwd, solve_bwd)
        return solve

    if derivatives == "forward":
        sens_rhs = problem.make_sensitivity_rhs()
        dfdp = problem.make_dfdp()
        # the sensitivity RHS needs the FULL matrix for S J^T whatever
        # structure the Newton solves exploit
        jac_dense = problem.make_jac_dense()

        # augmented sensitivity: rows [0:n_deriv] for params, rows
        # [n_deriv:n_deriv+n] for initial values (the reference's
        # '__initial_values' pseudo-params, as_pytensor.py:217-230)
        k_aug = n_deriv + n

        def sens_rhs_aug(t, y, S, p):
            J = jac_dense(t, y, p)
            extra = jnp.concatenate(
                [dfdp(t, y, p).T, jnp.zeros((n, n), dtype=S.dtype)], axis=0
            )
            return S @ J.T + extra

        def _run_forward(t0, y0, p_sub, p_fix, tvals):
            p = _combine(p_sub, p_fix)
            S0 = jnp.concatenate(
                [jnp.zeros((n_deriv, n), y0.dtype), jnp.eye(n, dtype=y0.dtype)],
                axis=0,
            )
            res = bdf_solve(
                rhs, jac, t0, y0, p, tvals, options,
                sens_rhs=sens_rhs_aug, S0=S0,
            )
            ys = _poison(res.ys, res.status)
            sens = jnp.where(res.status == 0, res.sens, jnp.nan)
            return ys, sens

        @jax.custom_vjp
        def solve(t0, y0, p_sub, p_fix, tvals):
            return _run_forward(t0, y0, p_sub, p_fix, tvals)[0]

        def solve_fwd(t0, y0, p_sub, p_fix, tvals):
            p = _combine(p_sub, p_fix)
            ys, sens = _run_forward(t0, y0, p_sub, p_fix, tvals)
            f_at_t = jax.vmap(lambda t, y: rhs(t, y, p))(tvals, ys)
            f0 = rhs(t0, y0, p)
            return ys, (sens, f_at_t, f0, p_fix)

        def solve_bwd(residuals, g):
            sens, f_at_t, f0, p_fix = residuals
            # dL/dp_k = sum_i g_i . S_k(t_i)   (as_pytensor.py:251-263)
            contr = jnp.einsum("ij,ikj->k", g, sens)
            d_p = contr[:n_deriv]
            d_y0 = contr[n_deriv:]
            d_tvals = jnp.einsum("ij,ij->i", g, f_at_t)
            d_t0 = -jnp.dot(d_y0, f0)
            return (d_t0, d_y0, d_p, jnp.zeros_like(p_fix), d_tvals)

        solve.defvjp(solve_fwd, solve_bwd)
        return solve

    raise ValueError(f"derivatives must be 'adjoint', 'forward' or None, got {derivatives!r}")


def make_batched_solve_fn(
    problem: Problem,
    *,
    derivatives: Optional[str] = "adjoint",
    options: BDFOptions = BDFOptions(),
    adjoint_options: Optional[BDFOptions] = None,
    checkpoint_n: int = 1024,
    method: str = "BDF",
    adjoint_interpolation: str = "hermite",
    linear_solver: str = "dense",
    linear_solver_kwargs: Optional[dict] = None,
) -> Callable:
    """Batch-native differentiable solver (the 10k-chains fast path).

    Returns ``solve(t0, y0, p_sub, p_fix, tvals) -> ys`` with y0 (B, n),
    p_sub (B, k); t0/tvals/p_fix shared across the batch.  Uses the
    structure-of-arrays integrator (ops/bdf_batched.py) instead of
    ``vmap(bdf_solve)`` — same math, one lockstep loop over the batch.  Only
    'adjoint' and None gradient modes for now.

    ``adjoint_interpolation``: 'hermite' (CVODES CV_HERMITE checkpoint
    analog; any stiffness; quintic rows by default — options.hermite_order),
    'polynomial' (CVODES CV_POLYNOMIAL analog: variable-degree Lagrange
    through the recorded y rows, the reference's default mode), or
    'resolve' (backsolve adjoint re-integrating y(t) backward; non-stiff +
    ADAMS only — smooth backward RHS, no checkpoint table; see
    ``adjoint_backward_batched``).

    ``linear_solver``: 'dense' (default), 'band' (banded-storage Jacobian +
    batched banded-LU Newton — O(B n w^2) instead of O(B n^3);
    ``linear_solver_kwargs`` must carry 'lower_bandwidth'/'upper_bandwidth'),
    or 'sparse' (KLU analog: exact structural sparsity -> RCM permutation ->
    colored-jvp banded Jacobian; pattern from ``problem.jac_sparsity()`` or
    ``linear_solver_kwargs['sparsity']``).  The backward adjoint system's
    matrix is -J^T, so its bandwidths/pattern are automatically the
    transpose's (same treatment as ``AdjointSolver``).  Requires
    method='BDF'.  This closes the stiff large-state batched quadrant:
    the reference's KLU/band users (linear_solver_wrapper.py:99-122) get a
    batch-native fast path instead of falling back to ``vmap``.
    """
    from sunode_tpu.adjoint import adjoint_backward_batched, make_hermite_eval_batched
    from sunode_tpu.ops.adams_batched import adams_solve_batched
    from sunode_tpu.ops.bdf_batched import bdf_solve_batched

    if method not in ("BDF", "ADAMS"):
        raise ValueError("method must be 'BDF' or 'ADAMS'")
    if linear_solver not in ("dense", "band", "sparse"):
        raise ValueError(
            "make_batched_solve_fn linear_solver must be 'dense', 'band' or "
            "'sparse'"
        )
    if linear_solver != "dense" and method != "BDF":
        raise ValueError(
            f"linear_solver={linear_solver!r} requires method='BDF' (ADAMS "
            "uses functional iteration — no Newton matrices)"
        )

    rhs = problem.make_rhs()
    spec = problem.params
    n_deriv = problem.n_params

    if adjoint_options is None:
        # reference hardcodes 1e-10 backward tolerances (solver.py:599,614)
        adjoint_options = BDFOptions(rtol=1e-10, atol=1e-10)

    jac, options, _adjoint_jac_struct, adjoint_options = _structured_setup(
        problem, rhs, linear_solver, linear_solver_kwargs, options,
        adjoint_options,
    )

    def _forward(t0, y0, p, tvals, opts):
        # named_scope -> profiler/HLO-metadata annotation: the forward and
        # backward integrations show up as separate blocks in a JAX trace
        with jax.named_scope("sunode_forward"):
            if method == "ADAMS":
                return adams_solve_batched(rhs, t0, y0, p, tvals, opts)
            return bdf_solve_batched(rhs, jac, t0, y0, p, tvals, opts)

    def _combine(p_sub, p_fix):
        # p_sub (B, k), p_fix (k2,) shared -> (B, n_p)
        B = p_sub.shape[0]
        p_fix_b = jnp.broadcast_to(p_fix, (B,) + p_fix.shape)
        return spec.combine(p_sub, p_fix_b, xp=jnp)

    def _poison_b(ys, status):
        return jnp.where((status == 0)[:, None, None], ys, jnp.nan)

    if derivatives is None:

        def solve(t0, y0, p_sub, p_fix, tvals):
            p = _combine(p_sub, p_fix)
            res = _forward(t0, y0, p, tvals, options)
            return _poison_b(res.ys, res.status)

        return solve

    if derivatives != "adjoint":
        raise NotImplementedError("batched solver supports derivatives='adjoint' or None")

    if adjoint_interpolation not in ("hermite", "polynomial", "resolve", "transition"):
        raise ValueError(
            f"adjoint_interpolation must be 'hermite', 'polynomial', "
            f"'resolve' or 'transition', got {adjoint_interpolation!r}"
        )
    if adjoint_interpolation in ("resolve", "transition") and method != "ADAMS":
        raise ValueError(
            f"adjoint_interpolation={adjoint_interpolation!r} requires method='ADAMS'"
        )
    resolve = adjoint_interpolation in ("resolve", "transition")

    adjoint_rhs = problem.make_adjoint_rhs()
    adjoint_jac = (
        _adjoint_jac_struct
        if _adjoint_jac_struct is not None
        else problem.make_adjoint_jac_dense()
    )
    quad_rhs = problem.make_adjoint_quad_rhs()
    dfdp = problem.make_dfdp() if adjoint_interpolation == "transition" else None
    # 'resolve'/'transition' re-integrate y backward: no checkpoint recording
    fwd_options = options if resolve else options._replace(save_steps=checkpoint_n)
    if adjoint_interpolation == "polynomial":
        # polynomial interpolation reads only (t, y) rows — skip fdot
        fwd_options = fwd_options._replace(hermite_order=3)
    rhs_tb = jax.vmap(rhs, in_axes=(0, 1, 1), out_axes=1)

    @jax.custom_vjp
    def solve(t0, y0, p_sub, p_fix, tvals):
        p = _combine(p_sub, p_fix)
        res = _forward(t0, y0, p, tvals, options)
        return _poison_b(res.ys, res.status)

    def solve_fwd(t0, y0, p_sub, p_fix, tvals):
        p = _combine(p_sub, p_fix)
        res = _forward(t0, y0, p, tvals, fwd_options)
        ys = _poison_b(res.ys, res.status)
        return ys, (t0, y0, p_sub, p_fix, tvals, res.saved, res.status, ys)

    def solve_bwd(residuals, g):
        t0, y0, p_sub, p_fix, tvals, saved, status, ys_fwd = residuals
        B = y0.shape[0]
        p = _combine(p_sub, p_fix)
        with jax.named_scope("sunode_backward"):
            if adjoint_interpolation == "transition":
                from sunode_tpu.adjoint import adjoint_backward_transition_batched

                adj = adjoint_backward_transition_batched(
                    rhs,
                    adjoint_jac,
                    dfdp,
                    t0,
                    tvals,
                    g,
                    p,
                    n_deriv,
                    ys_fwd[:, -1, :],
                    adjoint_options,
                )
            else:
                adj = adjoint_backward_batched(
                    adjoint_rhs,
                    adjoint_jac,
                    quad_rhs,
                    saved,
                    t0,
                    tvals,
                    g,
                    p,
                    n_deriv,
                    adjoint_options,
                    method=method,
                    interpolation=adjoint_interpolation,
                    rhs=rhs if resolve else None,
                    y_end=ys_fwd[:, -1, :] if resolve else None,
                )
        bad = (status != 0) | (adj.status != 0)
        lam = jnp.where(bad[:, None], jnp.nan, adj.lamda)  # (B, n)
        quad = jnp.where(bad[:, None], jnp.nan, adj.quad)  # (B, k)
        # d/dtvals_i = sum_b g_bi . f(t_i, y_b(t_i)): the forward emissions
        # ARE y(t_i) (exact integral-basis interpolation), so evaluate f on
        # them directly instead of re-gathering through the Hermite table
        f_at = jax.vmap(
            lambda te, yb: rhs_tb(jnp.full((B,), te, tvals.dtype), yb, p.T)
        )(tvals, jnp.moveaxis(ys_fwd, 0, 2))  # (n_t, n, B)
        d_tvals = jnp.einsum("bij,ijb->i", g, f_at)  # summed over batch (shared tvals)
        d_tvals = jnp.where(jnp.any(bad), jnp.nan, d_tvals)
        f0 = rhs_tb(jnp.full((B,), t0, tvals.dtype), y0.T, p.T)  # (n, B)
        d_t0 = -jnp.sum(lam * f0.T)
        d_p_fix = jnp.zeros_like(p_fix)
        return (d_t0, lam, quad, d_p_fix, d_tvals)

    solve.defvjp(solve_fwd, solve_bwd)
    return solve


class SolveResult(NamedTuple):
    solution: Mapping[str, Any]  # nested dict of named state arrays (n_t, ...)
    ys: jnp.ndarray  # flat (n_t, n_states)
    problem: Problem
    solve_fn: Callable  # the differentiable flat solver


def solve_ivp(
    t0,
    y0: Mapping[str, Any],
    params: Mapping[str, Any],
    tvals,
    rhs: Callable,
    derivatives: str | None = "adjoint",
    coords: Optional[Mapping[str, Any]] = None,
    derivative_params: Optional[list] = None,
    solver_kwargs: Optional[dict] = None,
    simplify: Optional[Callable] = None,
    use_sympy: bool = True,
) -> SolveResult:
    """Declare and solve an ODE in one call (reference
    ``sunode.wrappers.as_pytensor.solve_ivp``, as_pytensor.py:20-137 — but
    JAX-native: inputs may be jnp arrays or tracers, and the result is
    differentiable with ``jax.grad``).

    ``y0`` / ``params``: nested dicts whose leaves are either
      - ``(value, shape)`` tuples (value may be a traced jnp array), or
      - plain numpy/python values (shape inferred).
    ``derivative_params``: paths to differentiate w.r.t.; when None, every
    param leaf given as a jax array/tracer is selected (the reference
    auto-detects PyTensor variables the same way, as_pytensor.py:72-81).

    Dtype follows the inputs (f32 speed mode): float32 ``y0``/``params``
    leaves run the whole pipeline — forward carry, backward pass,
    gradients — in f32 even with x64 enabled (pair with rtol ~1e-5/1e-6;
    see docs/performance.md "f32 speed mode").
    Python scalars are weakly typed and follow the array leaves; all-f64
    (or all-scalar) inputs keep the reference's f64 semantics.
    """
    from sunode_tpu.paramspec import flatten_path_dict, nest_path_dict
    from sunode_tpu.problem import JaxProblem

    solver_kwargs = dict(solver_kwargs or {})

    def split_leaves(nested):
        values, shapes = {}, {}
        for path, leaf in flatten_path_dict(nested).items():
            if isinstance(leaf, tuple) and len(leaf) == 2 and not isinstance(leaf[0], str):
                value, shape = leaf
                if isinstance(shape, (int, np.integer)):
                    shape = (int(shape),)
                shapes[path] = tuple(shape)
                values[path] = value
            else:
                arr = np.asarray(leaf) if not isinstance(leaf, jax.Array) else leaf
                shapes[path] = tuple(arr.shape)
                values[path] = leaf
        return values, shapes

    y0_values, y0_shapes = split_leaves(y0)
    p_values, p_shapes = split_leaves(params)

    def is_traced(v):
        return isinstance(v, (jax.Array, jax.core.Tracer))

    if derivative_params is None:
        derivative_params = [p for p, v in p_values.items() if is_traced(v)]

    states_spec = nest_path_dict(y0_shapes)
    params_spec = nest_path_dict(p_shapes)

    if use_sympy:
        from sunode_tpu.symode.problem import SympyProblem

        problem = SympyProblem(
            params=params_spec,
            states=states_spec,
            rhs_sympy=rhs,
            derivative_params=derivative_params,
            coords=coords,
            simplify=simplify,
        )
    else:
        problem = JaxProblem(
            params=params_spec,
            states=states_spec,
            rhs=rhs,
            derivative_params=derivative_params,
            coords=coords,
        )

    options = solver_kwargs.pop("options", None) or BDFOptions(
        rtol=solver_kwargs.pop("rtol", 1e-8), atol=solver_kwargs.pop("atol", 1e-8)
    )
    solve_fn = make_solve_fn(
        problem,
        derivatives=derivatives,
        options=options,
        adjoint_options=solver_kwargs.pop("adjoint_options", None),
        checkpoint_n=solver_kwargs.pop("checkpoint_n", 4096),
    )
    if solver_kwargs:
        raise TypeError(f"Unknown solver_kwargs: {sorted(solver_kwargs)}")

    # flatten inputs (keeping traced leaves traced)
    y0_flat = _flatten_traced(problem.states, y0_values)
    p_sub = _flatten_subset_traced(problem.params, p_values)
    p_fix = _flatten_remainder_traced(problem.params, p_values)

    tvals = jnp.asarray(tvals)
    ys = solve_fn(jnp.asarray(t0, y0_flat.dtype), y0_flat, p_sub, p_fix, tvals)
    solution = problem.states.unflatten(ys)
    return SolveResult(solution=solution, ys=ys, problem=problem, solve_fn=solve_fn)


def _traced_dtype(spec, values, paths):
    """dtype follows the INPUTS (f32 speed mode contract: f32 leaves run
    the whole pipeline at f32 under x64); non-floating leaves (python
    ints/floats are weakly typed) promote to the spec dtype."""
    arrs = [values[p] for p in paths if hasattr(values[p], "dtype")]
    if not arrs:
        return spec.dtype
    dtype = jnp.result_type(*arrs)
    return dtype if jnp.issubdtype(dtype, jnp.floating) else spec.dtype


def _flatten_traced(spec, values):
    dtype = _traced_dtype(spec, values, spec.paths)
    parts = []
    for path in spec.paths:
        v = jnp.asarray(values[path], dtype)
        v = jnp.broadcast_to(v, spec.shapes[path])
        parts.append(v.reshape(-1))
    if not parts:
        return jnp.zeros((0,), spec.dtype)
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def _flatten_subset_traced(spec, values):
    dtype = _traced_dtype(spec, values, spec.subset_paths)
    parts = []
    for path in spec.subset_paths:
        v = jnp.asarray(values[path], dtype)
        v = jnp.broadcast_to(v, spec.shapes[path])
        parts.append(v.reshape(-1))
    if not parts:
        return jnp.zeros((0,), spec.dtype)
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def _flatten_remainder_traced(spec, values):
    rem_paths = [p for p in spec.paths if p not in spec.subset_paths]
    dtype = _traced_dtype(spec, values, rem_paths)
    parts = []
    for path in rem_paths:
        v = jnp.asarray(values[path], dtype)
        v = jnp.broadcast_to(v, spec.shapes[path])
        parts.append(v.reshape(-1))
    if not parts:
        return jnp.zeros((0,), spec.dtype)
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]
