"""Reference-parity solver classes over the JAX BDF core.

Mirrors the public surface of the reference's solver orchestration layer
(/root/reference/sunode/solver.py): ``Solver`` (l.213-527) and
``AdjointSolver`` (l.530-784), with the CVODES object lifecycle replaced by
jitted JAX computations.  Where the reference mutates C objects
(CVodeReInit, user_data params views), this class keeps plain numpy/jnp
state and re-invokes cached jitted solvers — params changes never recompile
(they're traced arguments), matching the "no runtime overhead" property of
the reference's structured-array views (README.md:100-110).

Differences by design:
  - outputs are returned (and optionally written into caller buffers) rather
    than written through C pointers;
  - pickling is trivial (all state is arrays + config) — the reference needs
    custom ``__getstate__`` to rebuild C state (solver.py:304-324) and its
    ``AdjointSolver`` cannot pickle at all;
  - a batch axis on y0/params triggers the vmapped solver: the accelerator
    replacement for fork-per-chain multiprocessing (README.md:233-238).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sunode_tpu.ops.bdf import MAX_ORDER, BDFOptions, bdf_solve
from sunode_tpu.adjoint import adjoint_backward
from sunode_tpu.problem import Problem

__all__ = ["Solver", "AdjointSolver", "SolverError"]


class SolverError(RuntimeError):
    """Raised when the integrator fails (reference solver.py SolverError)."""


# step budgets are traced as int32 (one compiled executable across
# retries); clamp so huge max_steps or 2**retry growth can't overflow
_I32_MAX = 2**31 - 1

_STATUS_MESSAGES = {
    1: "too many steps (max_steps exceeded; CV_TOO_MUCH_WORK analog)",
    2: "step size underflow (CV_TOO_CLOSE/CV_CONV_FAILURE analog)",
    3: "non-finite initial condition",
    4: "repeated error-test or Newton failures",
    5: "terminal root found (CV_ROOT_RETURN — success; see stats['roots_t'])",
    97: "transition adjoint ill-conditioned (residual check failed)",
    99: "adjoint checkpoint buffer overflow",
}


def _merge_root_segments(old, new, resume, batched, cap):
    """Concatenate segment-2 root records after segment-1's for resuming
    lanes.  A MAX_STEPS resume restarts the core with fresh root buffers
    (n_roots=0, roots_t=+inf); without this merge, a non-terminal-root
    solve that resumed would report only the final segment's roots.
    CVODES accumulates root reports across CVode() resumes the same way.
    Buffers hold the FIRST ``cap`` roots; the summed n_roots keeps
    counting, so n_roots > cap signals truncation."""
    keys = ("roots_t", "roots_y", "roots_found")

    def lead(x):
        a = np.asarray(x)
        return a if batched else a[None]

    rs = lead(resume).astype(bool)
    o_n = lead(old["n_roots"]).astype(np.int64)
    n_n = lead(new["n_roots"]).astype(np.int64)
    bufs = {k: np.array(lead(old[k]), copy=True) for k in keys}
    base = np.minimum(o_n, cap)
    for j in range(cap):
        dst = base + j
        valid = rs & (j < n_n) & (dst < cap)
        if not np.any(valid):
            break
        idx = np.nonzero(valid)[0]
        for k in keys:
            bufs[k][idx, dst[idx]] = lead(new[k])[idx, j]
    out = {k: (v if batched else v[0]) for k, v in bufs.items()}
    merged_n = np.where(rs, o_n + n_n, o_n)
    out["n_roots"] = merged_n if batched else merged_n[0]
    return out


def _make_fd_jac(rhs):
    """Finite-difference Jacobian (linear_solver='dense_finitediff' parity;
    the reference lets CVODES difference-quotient it, solver.py:326-358)."""

    def fd_jac(t, y, p):
        f0 = rhs(t, y, p)
        eps = jnp.sqrt(jnp.finfo(y.dtype).eps)
        hs = eps * jnp.maximum(jnp.abs(y), 1.0)

        def col(j):
            yj = y.at[j].add(hs[j])
            return (rhs(t, yj, p) - f0) / hs[j]

        cols = jax.vmap(col)(jnp.arange(y.shape[0]))
        return cols.T

    return fd_jac


class _SolverBase:
    """Shared params handling + output conversion."""

    _problem: Problem
    # working precision of the solve (np.float64 default = CVODES realtype
    # parity, ref basic.py:40-43; np.float32 opts into f32 speed mode)
    _dtype: np.dtype = np.dtype(np.float64)

    def _set_dtype(self, dtype) -> None:
        dt = np.dtype(dtype)
        if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(
                f"dtype must be float32 or float64, got {dt}"
            )
        self._dtype = dt

    def _init_params_state(self):
        self._params = np.zeros(self._problem.n_all_params, dtype=self._dtype)

    # --- dtype parity accessors (solver.py:436-445) -------------------
    @property
    def params_dtype(self):
        return self._problem.params_dtype

    @property
    def derivative_params_dtype(self):
        sub = self._problem.params
        import sunode_tpu.paramspec as ps

        spec = ps.nest_path_dict({p: sub.shapes[p] for p in sub.subset_paths})
        return ps.ParamSpec(spec, dtype=sub.dtype).as_numpy_dtype()

    @property
    def remainder_params_dtype(self):
        return self._problem.params.remainder.as_numpy_dtype()

    # --- params get/set (solver.py:447-465) ---------------------------
    def set_params(self, params):
        self._params = np.asarray(
            self._problem.params.coerce_flat(params), dtype=self._dtype
        ).copy()

    def get_params(self):
        return self._params.copy()

    def set_params_dict(self, params: Mapping[str, Any]) -> None:
        self._params = np.asarray(
            self._problem.params.flatten_dict(params), dtype=self._dtype
        )

    def get_params_dict(self):
        return self._problem.params.unflatten(self._params)

    def set_derivative_params(self, params) -> None:
        spec = self._problem.params
        if isinstance(params, Mapping):
            sub = np.asarray(spec.flatten_subset_dict(params))
        else:
            sub = np.asarray(params, dtype=self._dtype).reshape(-1)
        self._params[spec.subset_indices] = sub

    def set_remaining_params(self, params) -> None:
        spec = self._problem.params
        if isinstance(params, Mapping):
            rem = np.asarray(spec.remainder.flatten_dict(params))
        else:
            rem = np.asarray(params, dtype=self._dtype).reshape(-1)
        self._params[spec.remainder_indices] = rem

    def as_xarray(
        self, tvals, out, sens_out=None, unstack_state=True, unstack_params=True
    ):
        return self._problem.solution_to_xarray(
            tvals,
            out,
            sensitivity=sens_out,
            params=self._params,
            unstack_state=unstack_state,
            unstack_params=unstack_params,
        )

    def _check_status(self, status, where="solve"):
        status = np.asarray(status)
        if (status != 0).any():
            codes = sorted(set(int(s) for s in status.reshape(-1) if s != 0))
            msgs = "; ".join(_STATUS_MESSAGES.get(c, f"code {c}") for c in codes)
            raise SolverError(f"Integration failed in {where}: {msgs}")


class Solver(_SolverBase):
    """Forward (and forward-sensitivity) solver — reference Solver
    (solver.py:213-527)."""

    def __init__(
        self,
        problem: Problem,
        *,
        abstol: Any = None,
        reltol: Optional[float] = None,
        sens_mode: Optional[str] = None,
        scaling_factors: Optional[np.ndarray] = None,
        constraints: Optional[np.ndarray] = None,
        solver: str = "BDF",
        linear_solver: str = "dense",
        linear_solver_kwargs: Optional[dict] = None,
        max_steps: Optional[int] = None,
        max_retries: int = 5,
        options: Optional[BDFOptions] = None,
        native_single: bool = True,
        roots: Optional[Callable] = None,
        root_cap: int = 8,
        root_terminal: bool = True,
        root_directions: Optional[Any] = None,
        dtype: Any = np.float64,
    ):
        # reference defaults: abstol=1e-10, reltol=1e-10 (solver.py:242-254)
        if solver not in ("BDF", "ADAMS"):
            raise ValueError("solver must be 'BDF' or 'ADAMS'")
        # dtype=np.float32 opts the whole solve into f32 speed mode
        # (the default f64 matches the reference realtype, basic.py:40-43).
        # f32 runs skip the f64-only native host route and need tolerances
        # the precision can meet (rtol >~ 1e-6); see docs/limitations.md.
        self._set_dtype(dtype)
        if self._dtype == np.float32:
            _rt = 1e-10 if reltol is None else reltol
            if options is not None:
                _rt = options.rtol
            _rt = float(np.min(_rt))
            if _rt < 1e-7:
                raise ValueError(
                    f"reltol={_rt:g} is below float32 precision; pass "
                    "reltol>=1e-7 (1e-5 is a good default) with "
                    "dtype=np.float32"
                )
        # events / rootfinding (CVodeRootInit analog; ops/bdf.py root_fn):
        # a SympyProblem lowers a symbolic (t, states, params) callable,
        # any other problem passes a flat JAX (t, y, p) -> (nrt,) directly
        # CVODES rootfinding is LMM-independent (16_cvodes.h:195-198): both
        # the BDF and Adams cores run the shared _root_scan on their own
        # dense output
        self._roots_src = roots  # original callable (re-lowered on unpickle)
        self._root_fn = (
            problem.make_root_fn(roots)
            if roots is not None and hasattr(problem, "make_root_fn")
            else roots
        )
        self._root_cap = int(root_cap)
        self._root_terminal = bool(root_terminal)
        self._root_directions = (
            None if root_directions is None else np.asarray(root_directions)
        )
        if sens_mode not in (None, "simultaneous", "staggered"):
            if sens_mode == "staggered1":
                raise ValueError("staggered1 not implemented.")
            raise ValueError(
                'sens_mode must be one of "simultaneous" and "staggered"'
            )
        known_linsol = (
            "dense",
            "dense_finitediff",
            "band",
            "sparse",
            "spgmr",
            "spgmr_finitediff",
        )
        if linear_solver not in known_linsol:
            raise ValueError(f"linear_solver must be one of {known_linsol}")

        self._problem = problem
        self._solver_kind = solver
        self._sens_mode = sens_mode
        self._compute_sens = sens_mode is not None
        self._linear_solver = linear_solver
        self._max_retries = int(max_retries)
        self._init_params_state()

        # forward sensitivities with solver='ADAMS' run as an augmented state
        # [y; vec(S)] through the functional-iteration Adams core (CVODES
        # supports sens with CV_ADAMS the same way: the sens equations are
        # just more ODE components to the corrector; 16_cvodes.h:275-323 is
        # method-agnostic).  See _solver_fn.
        if options is None:
            options = BDFOptions(
                rtol=1e-10 if reltol is None else reltol,
                atol=1e-10 if abstol is None else abstol,
                max_steps=100_000 if max_steps is None else max_steps,
                constraints=None if constraints is None else np.asarray(constraints),
                sens_pbar=scaling_factors,
                sens_staggered=(sens_mode == "staggered"),
            )
            if solver == "ADAMS":
                from sunode_tpu.ops.adams import adams_options

                options = adams_options(options)
        else:
            conflicting = {
                "abstol": abstol,
                "reltol": reltol,
                "max_steps": max_steps,
                "constraints": constraints,
                "scaling_factors": scaling_factors,
            }
            bad = [k for k, v in conflicting.items() if v is not None]
            if bad:
                raise ValueError(
                    f"Pass {bad} inside options=BDFOptions(...) — they are "
                    "ignored when an explicit options object is given"
                )
            if sens_mode is not None:
                options = options._replace(
                    sens_staggered=(sens_mode == "staggered")
                )
        self._options = options

        self._linear_solver_kwargs = dict(linear_solver_kwargs or {})
        # B=1 host fast path: a single plain BDF solve routes through the
        # native C++ integrator (native/cvbdf.cpp; ~109us for README LV
        # via the Adams core, ~253us via BDF)
        # instead of paying the jitted whole-batch machinery — the
        # README-parity single-chain workload (ref README.md:128-130).
        # Falls back silently when the problem can't codegen to C.
        self._native_single_enabled = bool(native_single)
        self._init_derived()
        self._jit_cache: dict = {}
        self.last_stats: Optional[dict] = None

    def _init_derived(self):
        problem = self._problem
        linear_solver = self._linear_solver
        rhs = problem.make_rhs()
        self._jac_prod = None
        if linear_solver == "dense_finitediff":
            jacfn = _make_fd_jac(rhs)
        elif linear_solver == "band":
            kw = self._linear_solver_kwargs
            if "lower_bandwidth" not in kw or "upper_bandwidth" not in kw:
                raise ValueError(
                    "linear_solver='band' requires linear_solver_kwargs with "
                    "'lower_bandwidth' and 'upper_bandwidth'"
                )
            lb, ub = int(kw["lower_bandwidth"]), int(kw["upper_bandwidth"])
            # banded-storage Jacobian + true banded LU in the Newton solve:
            # O(n*(l+u)^2) instead of dense O(n^3)
            jacfn = problem.make_banded_jac(lb, ub)
            self._options = self._options._replace(
                linear_solver="band", band_lower=lb, band_upper=ub
            )
        elif linear_solver == "sparse":
            # KLU analog (ref linear_solver_wrapper.py:99-122): exact
            # structural sparsity (symbolic Jacobian zeros) -> RCM
            # permutation -> colored-jvp banded Jacobian -> banded LU; see
            # ops/sparsity.py.  Newton cost scales with the permuted
            # bandwidth (nnz structure), not n^2/n^3.
            from sunode_tpu.ops.sparsity import (
                SparsePlan,
                make_colored_banded_jac,
            )

            kw = self._linear_solver_kwargs
            pattern = (
                np.asarray(kw["sparsity"], bool)
                if "sparsity" in kw
                else problem.jac_sparsity()
            )
            plan = SparsePlan(
                pattern,
                permute=kw.get("permute", True),
                border=kw.get("border", "auto"),
            )
            self._sparse_plan = plan
            jacfn = make_colored_banded_jac(rhs, plan)
            self._options = self._options._replace(
                linear_solver="sparse",
                band_lower=plan.lower,
                band_upper=plan.upper,
                sparse_perm=plan.perm,
                sparse_border=plan.k_border,
            )
        elif linear_solver in ("spgmr", "spgmr_finitediff"):
            jacfn = problem.make_jac_dense()  # unused by the spgmr path
            self._options = self._options._replace(linear_solver="spgmr")
            if linear_solver == "spgmr":
                self._jac_prod = problem.make_rhs_jac_prod()
            else:
                # directional finite difference (CVODES difference-quotient
                # jtimes default)
                def fd_jac_prod(t, y, v, p):
                    import jax.numpy as jnp

                    eps = jnp.sqrt(jnp.finfo(y.dtype).eps)
                    nv = jnp.sqrt(jnp.sum(v * v))
                    # floor must stay representable in the working dtype
                    # (1e-300 underflows to 0 in f32 -> inf sig -> NaN)
                    tiny = jnp.finfo(y.dtype).tiny
                    sig = eps * jnp.maximum(nv, 1.0) / jnp.maximum(nv, tiny)
                    return (rhs(t, y + sig * v, p) - rhs(t, y, p)) / sig

                self._jac_prod = fd_jac_prod
        else:
            jacfn = problem.make_jac_dense()
        self._rhs = rhs
        self._jac = jacfn
        self._sens_rhs = problem.make_sensitivity_rhs() if self._compute_sens else None

    # --- pickling: drop derived functions, rebuild on load (the reference
    # rebuilds its C state the same way, solver.py:304-324) ---------------
    def __getstate__(self):
        state = self.__dict__.copy()
        for key in (
            "_rhs",
            "_jac",
            "_sens_rhs",
            "_jac_prod",
            "_jit_cache",
            "last_stats",
            "_native_solver",
            "_root_fn",
        ):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_derived()
        roots = getattr(self, "_roots_src", None)
        self._root_fn = (
            self._problem.make_root_fn(roots)
            if roots is not None and hasattr(self._problem, "make_root_fn")
            else roots
        )
        self._jit_cache = {}
        self.last_stats = None

    # --- output buffers (solver.py:419-426) ---------------------------
    def make_output_buffers(self, tvals):
        n_states = self._problem.n_states
        n_params = self._problem.n_params
        y_vals = np.zeros((len(tvals), n_states), dtype=self._dtype)
        if self._compute_sens:
            sens_vals = np.zeros(
                (len(tvals), n_params, n_states), dtype=self._dtype
            )
            return y_vals, sens_vals
        return y_vals

    def _adams_sens_setup(self, opts=None):
        """Augmented-state setup for solver='ADAMS' + sensitivities:
        integrate [y; vec(S)] through the functional-iteration core (the
        sensitivity equations are additional ODE components; the coupling is
        triangular, so functional iteration converges exactly as for y)."""
        if opts is None:
            opts = self._options
        n = self._problem.n_states
        k = self._problem.n_params
        rhs, sens_rhs = self._rhs, self._sens_rhs

        atol = np.broadcast_to(np.asarray(opts.atol, np.float64), (n,))
        pbar = (
            np.ones(k)
            if opts.sens_pbar is None
            else np.broadcast_to(np.asarray(opts.sens_pbar, np.float64), (k,))
        )
        rtol_v = np.broadcast_to(np.asarray(opts.rtol, np.float64), (n,))
        rtol_aug = np.concatenate([rtol_v, np.tile(rtol_v, k)])
        if opts.sens_err_con:
            # CVodeSensEEtolerances: atol_S[k] = atol / pbar_k
            atol_S = (atol[None, :] / pbar[:, None]).reshape(-1)
            atol_y = atol
        else:
            # excluded from error control: effectively infinite tolerance on
            # the sens rows.  The core's WRMS still averages over ALL
            # (1+k)*n components, so the ~zero-weighted sens terms would
            # dilute the state norm by sqrt(1+k); scaling the y-row scales
            # (atol AND rtol) by 1/sqrt(1+k) makes the augmented mean equal
            # the state-only mean exactly (CVODES errconS=FALSE norms over
            # y alone).
            atol_S = np.full(k * n, 1e12)
            f = 1.0 / np.sqrt(1.0 + k)
            atol_y = atol * f
            rtol_aug = rtol_aug * f
        atol_aug = np.concatenate([atol_y, atol_S])
        cons = opts.constraints
        cons_aug = (
            None
            if cons is None
            else np.concatenate(
                [np.broadcast_to(np.asarray(cons, np.float64), (n,)), np.zeros(k * n)]
            )
        )
        opts_aug = opts._replace(
            atol=jnp.asarray(atol_aug), rtol=rtol_aug, constraints=cons_aug
        )

        def rhs_aug(t, y_aug, p):
            y = y_aug[:n]
            S = y_aug[n:].reshape(k, n)
            return jnp.concatenate([rhs(t, y, p), sens_rhs(t, y, S, p).reshape(-1)])

        return rhs_aug, opts_aug

    def _native_eligible(self) -> bool:
        o = self._options
        # 'band'/'sparse' route to the native gbtrf/gbtrs Newton
        # (cvbdf_solve_banded) and 'spgmr'/'spgmr_finitediff' to the
        # matrix-free GMRES Newton (cvbdf_solve_spgmr, difference-quotient
        # jtimes) — BDF only; a SympyProblem is required for codegen.
        ls_ok = self._linear_solver == "dense" or (
            self._linear_solver
            in ("band", "sparse", "spgmr", "spgmr_finitediff")
            and self._solver_kind == "BDF"
            and hasattr(self._problem, "_sym_dydt_jac")
        )
        # constraints enforce CVodeSetConstraints semantics natively in
        # both cores (solve_one_lin / adams_solve_one)
        # events keep the native route when given symbolically (the C
        # rootfinding entries need sunode_roots codegen): dense/band/sparse
        # on both cores; spgmr and raw-JAX root callables fall to JAX
        roots_ok = self._root_fn is None or (
            getattr(self, "_roots_src", None) is not None
            and hasattr(self._problem, "symbolic_roots")
            and self._linear_solver in ("dense", "band", "sparse")
        )
        return (
            self._native_single_enabled
            and self._dtype == np.float64  # native realtype is f64-only
            and self._solver_kind in ("BDF", "ADAMS")
            and not self._compute_sens
            and np.ndim(o.rtol) == 0  # vector rtol is a JAX-core feature
            and roots_ok
            and ls_ok
            and o.first_step is None
            and (self._solver_kind == "ADAMS" or o.max_order == MAX_ORDER)
            and not np.isfinite(o.max_step)
            and o.min_step == 0.0
            and not o.use_ndf
            and o.save_steps == 0
        )

    def _native_sens_eligible(self) -> bool:
        o = self._options
        # ADAMS: functional-iteration augmented solve.  BDF: modified
        # Newton with one shared I - cJ factorization across the y and
        # sensitivity blocks (cvbdf_sens_solve[_banded]).
        ls_ok = self._linear_solver == "dense" or (
            self._linear_solver in ("band", "sparse")
            and self._solver_kind == "BDF"
            and hasattr(self._problem, "_sym_dydt_jac")
        )
        return (
            self._native_single_enabled
            and self._dtype == np.float64  # native realtype is f64-only
            and self._solver_kind in ("ADAMS", "BDF")
            and self._compute_sens
            and np.ndim(o.rtol) == 0  # vector rtol is a JAX-core feature
            and self._root_fn is None
            and self._sens_mode in ("simultaneous", "staggered")
            and o.sens_pbar is None
            and ls_ok
            and (o.constraints is None or self._solver_kind == "BDF")
            and o.first_step is None
            and (self._solver_kind == "ADAMS" or o.max_order == MAX_ORDER)
            and not np.isfinite(o.max_step)
            and o.min_step == 0.0
            and o.save_steps == 0
        )

    def _native_single(self):
        """Lazily-built native CpuSolver for the B=1 fast path (None when
        the problem can't be compiled to C)."""
        if not hasattr(self, "_native_solver"):
            try:
                from sunode_tpu.native.cpu_solver import CpuSolver

                ls_kw = {}
                if self._linear_solver == "band":
                    kw = self._linear_solver_kwargs
                    ls_kw = dict(
                        linear_solver="band",
                        linear_solver_kwargs=dict(
                            lower_bandwidth=int(kw["lower_bandwidth"]),
                            upper_bandwidth=int(kw["upper_bandwidth"]),
                        ),
                    )
                elif self._linear_solver == "sparse":
                    ls_kw = dict(linear_solver="sparse")
                elif self._linear_solver in ("spgmr", "spgmr_finitediff"):
                    ls_kw = dict(
                        linear_solver="spgmr",
                        linear_solver_kwargs=dict(self._linear_solver_kwargs),
                    )
                cons = self._options.constraints
                root_kw = {}
                if getattr(self, "_roots_src", None) is not None:
                    root_kw = dict(
                        roots=self._roots_src,
                        root_directions=self._root_directions,
                        root_cap=self._root_cap,
                        root_terminal=self._root_terminal,
                    )
                self._native_solver = CpuSolver(
                    self._problem,
                    abstol=np.asarray(self._options.atol),
                    reltol=float(self._options.rtol),
                    max_steps=int(self._options.max_steps)
                    * 2**self._max_retries,
                    method=self._solver_kind,
                    adams_max_order=int(self._options.adams_max_order),
                    constraints=None if cons is None else np.asarray(cons),
                    **root_kw,
                    **ls_kw,
                )
            except Exception:
                self._native_solver = None
        return self._native_solver

    def _solver_fn(self, n_t: int, batched: bool):
        """Jitted solve fn with TRACED (t0, first_step, max_steps): retries
        and resume-in-place reuse the one compiled executable (the reference
        CVode call resumes with a fresh mxstep budget, solver.py:510-519;
        here the resumed call passes per-lane t0=final_time,
        y0=final_state, first_step=final_step_size)."""
        key = (n_t, batched)
        if key not in self._jit_cache:
            opts = self._options
            rhs, jac, sens_rhs = self._rhs, self._jac, self._sens_rhs
            jac_prod = self._jac_prod
            n = self._problem.n_states
            k = self._problem.n_params

            solver_kind = self._solver_kind
            if solver_kind == "ADAMS" and self._compute_sens:
                rhs_aug, opts_aug = self._adams_sens_setup(opts)

            # batch-native structure-of-arrays cores: the fast path for chain
            # batches (see ops/bdf_batched.py for the rationale).
            # CV_STAGGERED runs batch-native too: per-lane state-error gating
            # of the sens corrector, with a real cond skipping the sens RHS
            # when every lane's state failed.
            # 'band'/'sparse' run batch-native too (lockstep lanes share the
            # static band/coloring plan — ops/bdf_batched.py structured
            # Newton), and matrix-free 'spgmr' runs batch-native through the
            # lockstep SoA GMRES (ops/krylov.py gmres_solve_batched).
            # rootfinding: BOTH batch-native cores carry the SoA _root_scan
            # analog (per-lane terminal stop, records, direction filters).
            use_batch_native = batched and opts.linear_solver in (
                "dense", "band", "sparse", "spgmr",
            )
            root_kw = (
                dict(
                    root_fn=self._root_fn,
                    root_cap=self._root_cap,
                    root_terminal=self._root_terminal,
                    root_directions=self._root_directions,
                )
                if self._root_fn is not None
                else {}
            )
            if use_batch_native:
                from sunode_tpu.ops.adams_batched import adams_solve_batched
                from sunode_tpu.ops.bdf_batched import bdf_solve_batched

                def run(t0, y0, params, tvals, sens0, max_steps, first_step):
                    if solver_kind == "ADAMS":
                        if self._compute_sens and opts.sens_staggered:
                            # genuine CV_STAGGERED in the batched functional
                            # core: state corrector + own error test first,
                            # then the per-lane-gated sens corrector
                            o = opts._replace(max_steps=max_steps)
                            res = adams_solve_batched(
                                rhs, t0, y0, params, tvals, o,
                                sens_rhs=sens_rhs, sens0=sens0,
                                first_step=first_step, **root_kw,
                            )
                            return res.ys, res.sens, res.status, res.stats
                        if self._compute_sens:
                            o = opts_aug._replace(max_steps=max_steps)
                            B = y0.shape[0]
                            y0_aug = jnp.concatenate(
                                [y0, sens0.reshape(B, -1)], axis=1
                            )
                            # event functions see the state block of the
                            # augmented vector (CVODES evaluates g on y only)
                            root_kw_aug = dict(root_kw)
                            if "root_fn" in root_kw_aug:
                                rf = root_kw_aug["root_fn"]
                                root_kw_aug["root_fn"] = (
                                    lambda t, z, p: rf(t, z[:n], p)
                                )
                            res = adams_solve_batched(
                                rhs_aug, t0, y0_aug, params, tvals, o,
                                first_step=first_step, **root_kw_aug,
                            )
                            ys = res.ys[:, :, :n]
                            sens = res.ys[:, :, n:].reshape(B, n_t, k, n)
                            stats = dict(res.stats)
                            if "roots_y" in stats:
                                # report the state block only, not the
                                # augmented sens tail
                                stats["roots_y"] = stats["roots_y"][:, :, :n]
                            return ys, sens, res.status, stats
                        o = opts._replace(max_steps=max_steps)
                        res = adams_solve_batched(
                            rhs, t0, y0, params, tvals, o,
                            first_step=first_step, **root_kw,
                        )
                        return res.ys, None, res.status, res.stats
                    o = opts._replace(max_steps=max_steps)
                    if self._compute_sens:
                        res = bdf_solve_batched(
                            rhs, jac, t0, y0, params, tvals, o,
                            sens_rhs=sens_rhs, S0=sens0, first_step=first_step,
                            jac_prod=jac_prod, **root_kw,
                        )
                        return res.ys, res.sens, res.status, res.stats
                    res = bdf_solve_batched(
                        rhs, jac, t0, y0, params, tvals, o, first_step=first_step,
                        jac_prod=jac_prod, **root_kw,
                    )
                    return res.ys, None, res.status, res.stats

                self._jit_cache[key] = jax.jit(run)
                return self._jit_cache[key]

            def run(t0, y0, params, tvals, sens0, max_steps, first_step):
                if solver_kind == "ADAMS":
                    from sunode_tpu.ops.adams import adams_solve

                    if self._compute_sens and opts.sens_staggered:
                        # genuine CV_STAGGERED for the unbatched jitted
                        # path too: the batch-native functional core at
                        # B=1 (it carries the SoA rootfinding scan, so
                        # events compose with staggering here as well)
                        from sunode_tpu.ops.adams_batched import (
                            adams_solve_batched,
                        )

                        o = opts._replace(max_steps=max_steps)
                        res = adams_solve_batched(
                            rhs, t0, y0[None], params[None], tvals, o,
                            sens_rhs=sens_rhs, sens0=sens0[None],
                            first_step=first_step, **root_kw,
                        )
                        stats = {
                            kk: vv[0] if getattr(vv, "ndim", 0) > 0 else vv
                            for kk, vv in res.stats.items()
                        }
                        return (
                            res.ys[0], res.sens[0], res.status[0], stats,
                        )
                    if self._compute_sens:
                        o = opts_aug._replace(max_steps=max_steps)
                        y0_aug = jnp.concatenate([y0, sens0.reshape(-1)])
                        # event functions see the state block of the
                        # augmented vector (CVODES evaluates g on y only)
                        root_kw_aug = dict(root_kw)
                        if "root_fn" in root_kw_aug:
                            rf = root_kw_aug["root_fn"]
                            root_kw_aug["root_fn"] = (
                                lambda t, z, p: rf(t, z[:n], p)
                            )
                        res = adams_solve(
                            rhs_aug, t0, y0_aug, params, tvals, o,
                            first_step=first_step, **root_kw_aug,
                        )
                        ys = res.ys[:, :n]
                        sens = res.ys[:, n:].reshape(n_t, k, n)
                        stats = dict(res.stats)
                        if "roots_y" in stats:
                            # report the state block only (CVodeGetRootInfo
                            # convention), not the augmented sens tail
                            stats["roots_y"] = stats["roots_y"][:, :n]
                        return ys, sens, res.status, stats
                    o = opts._replace(max_steps=max_steps)
                    res = adams_solve(
                        rhs, t0, y0, params, tvals, o, first_step=first_step,
                        **root_kw,
                    )
                    return res.ys, None, res.status, res.stats
                o = opts._replace(max_steps=max_steps)
                if self._compute_sens:
                    res = bdf_solve(
                        rhs, jac, t0, y0, params, tvals, o,
                        sens_rhs=sens_rhs, S0=sens0, jac_prod=jac_prod,
                        first_step=first_step, **root_kw,
                    )
                    return res.ys, res.sens, res.status, res.stats
                res = bdf_solve(
                    rhs, jac, t0, y0, params, tvals, o, jac_prod=jac_prod,
                    first_step=first_step, **root_kw,
                )
                return res.ys, None, res.status, res.stats

            if batched:
                run = jax.vmap(
                    run,
                    in_axes=(
                        0,
                        0,
                        0,
                        None,
                        0 if self._compute_sens else None,
                        None,
                        0,
                    ),
                )
            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def solve(self, t0, tvals, y0, y_out=None, *, sens0=None, sens_out=None):
        """Solve and fill ``y_out`` (reference solve, solver.py:467-527).

        ``y0`` may be a nested dict, a structured array (``state_dtype``), or
        a flat vector; with a leading batch axis the solve is vmapped.
        Returns ``y_out`` (and fills ``sens_out`` when sensitivities are on).
        """
        spec = self._problem.states
        dt = self._dtype
        y0_flat = np.asarray(spec.coerce_flat(y0, xp=np), dt)
        batched = np.ndim(y0_flat) == 2
        params = np.asarray(self._params, dt)
        if batched and params.ndim == 1:
            params = np.broadcast_to(params, (y0_flat.shape[0], params.size))
        # per-lane observation grids: tvals (B, n_t) rides the batch-native
        # cores directly (ragged datasets — pad each lane's grid with copies
        # of its final time); validated up front so the B=1 native routes
        # below never see a 2-D grid
        tva0 = np.asarray(tvals)
        if tva0.ndim == 2 and (not batched or tva0.shape[0] != y0_flat.shape[0]):
            raise ValueError(
                "per-lane tvals requires a matching batched y0: got "
                f"tvals {tva0.shape} with y0 {np.shape(y0_flat)}"
            )

        if not batched and self._native_eligible():
            ns = self._native_single()
            if ns is not None:
                ns._params = np.ascontiguousarray(self._params, np.float64)
                ys = ns.solve(t0, np.asarray(tvals, np.float64), y0_flat)
                self.last_stats = dict(ns.last_stats)
                if y_out is not None:
                    y_out[...] = ys
                    return y_out
                return ys

        # B=1 simultaneous-sensitivity fast path (ADAMS functional or BDF
        # shared-factorization Newton): the native augmented [y; vec(S)]
        # solve — same augmentation the jitted path uses, without the
        # whole-batch dispatch machinery
        if not batched and self._native_sens_eligible():
            ns = self._native_single()
            if ns is not None:
                ns._params = np.ascontiguousarray(self._params, np.float64)
                ys, sens = ns.solve_sens(
                    t0,
                    np.asarray(tvals, np.float64),
                    y0_flat,
                    sens0=sens0,
                    sens_mode=self._sens_mode,
                )
                self.last_stats = dict(ns.last_stats)
                if sens_out is not None:
                    sens_out[...] = sens
                if y_out is not None:
                    y_out[...] = ys
                    return y_out
                return ys, sens

        if self._compute_sens:
            if sens0 is None:
                k, n = self._problem.n_params, self._problem.n_states
                shape = (y0_flat.shape[0], k, n) if batched else (k, n)
                sens0 = np.zeros(shape, dtype=dt)
        B = y0_flat.shape[0] if batched else None
        t0_arr = np.full((B,), t0, dt) if batched else dt.type(t0)
        # honor a user-configured options.first_step on the initial segment
        # (the traced override short-circuits the in-core options fallback);
        # -1 sentinel -> automatic Hairer-Wanner h0
        fs_init = (
            float(self._options.first_step)
            if self._options.first_step is not None
            else -1.0
        )
        fs0 = np.full((B,), fs_init, dt) if batched else dt.type(fs_init)
        fn = self._solver_fn(tva0.shape[-1], batched)
        max_steps = jnp.asarray(
            min(int(self._options.max_steps), _I32_MAX), jnp.int32
        )
        tv = jnp.asarray(tvals, dt)
        ys, sens, status, stats = fn(
            jnp.asarray(t0_arr),
            jnp.asarray(y0_flat),
            jnp.asarray(params),
            tv,
            None if sens0 is None else jnp.asarray(sens0),
            max_steps,
            jnp.asarray(fs0),
        )
        # CV_TOO_MUCH_WORK bounded-retry parity (ref solver.py:510-519,
        # max_retries=5) with CVode-RESUME semantics: a MAX_STEPS
        # interruption continues from (final_time, final_state) with a fresh
        # budget and a warm step size — total work ~ sum of budgets (plus a
        # short order-1 ramp per resume), not 2^k full re-runs, and the one
        # compiled executable is reused (t0/first_step/max_steps are traced).
        retry = 0
        n = self._problem.n_states
        k = self._problem.n_params
        total_steps = np.asarray(stats["n_steps"]).copy()
        while np.any(np.asarray(status) == 1) and retry < self._max_retries:
            retry += 1
            status_np = np.asarray(status)
            resume = status_np == 1
            t_res = np.where(
                resume, np.asarray(stats["final_time"]), np.asarray(tvals)[..., -1]
            )
            z_res = np.asarray(stats["final_state"])
            y_res = z_res[..., :n]
            sens_res = (
                jnp.asarray(z_res[..., n : n + k * n]).reshape(
                    (-1, k, n) if batched else (k, n)
                )
                if self._compute_sens
                else None
            )
            h_res = np.asarray(stats["final_step_size"])
            # fresh budget per resumed segment, doubled per retry so the
            # total envelope still grows like the reference's bounded
            # retries — but only ACTUAL remaining steps are consumed
            ms_retry = jnp.asarray(
                min(int(self._options.max_steps) * 2**retry, _I32_MAX),
                jnp.int32,
            )
            ys2, sens2, status2, stats2 = fn(
                jnp.asarray(t_res if batched else dt.type(t_res)),
                jnp.asarray(y_res),
                jnp.asarray(params),
                tv,
                sens_res,
                ms_retry,
                jnp.asarray(h_res),
            )
            # merge: keep previously-emitted outputs (tvals <= resume time)
            # and non-resuming lanes' results
            tva = np.asarray(tvals)
            tol_t = 1e-14 * (1.0 + np.abs(t_res))
            if batched:
                tva_b = tva if tva.ndim == 2 else tva[None, :]
                emitted = tva_b <= (t_res + tol_t)[:, None]  # (B, n_t)
                keep_old = (~resume[:, None]) | emitted  # (B, n_t)
            else:
                emitted = tva <= t_res + tol_t  # (n_t,)
                keep_old = emitted | ~resume
            ys = np.where(keep_old[..., None], np.asarray(ys), np.asarray(ys2))
            if self._compute_sens:
                sens = np.where(
                    keep_old[..., None, None], np.asarray(sens), np.asarray(sens2)
                )
            status = np.where(resume, np.asarray(status2), status_np)
            # merge per-lane stats: lanes that did NOT resume keep their
            # earlier-segment diagnostics (the rerun is a degenerate no-op
            # for them — n_steps 0, order/iters reset).  Root buffers merge
            # by CONCATENATION for resuming lanes (the resumed segment
            # restarts with fresh buffers), not replacement.
            root_merged = None
            if self._root_fn is not None and "roots_t" in stats2:
                root_merged = _merge_root_segments(
                    stats, stats2, resume, batched, self._root_cap
                )
            merged = {}
            for k2, new_v in stats2.items():
                if root_merged is not None and k2 in root_merged:
                    merged[k2] = root_merged[k2]
                    continue
                new_a = np.asarray(new_v)
                old_a = np.asarray(stats.get(k2, new_v))
                if (
                    batched
                    and new_a.shape == old_a.shape
                    and new_a.ndim >= 1
                    and new_a.shape[0] == resume.shape[0]
                ):
                    r = resume.reshape((-1,) + (1,) * (new_a.ndim - 1))
                    merged[k2] = np.where(r, new_a, old_a)
                else:
                    merged[k2] = new_a
            stats = merged
            total_steps = total_steps + np.asarray(stats2["n_steps"])
        self.last_stats = {k_: np.asarray(v) for k_, v in stats.items()}
        self.last_stats["n_steps_total"] = total_steps
        self.last_stats["n_resumes"] = retry
        ys = np.asarray(ys)
        if y_out is not None:
            y_out[...] = ys
        if self._compute_sens:
            sens = np.asarray(sens)
            if sens_out is not None:
                sens_out[...] = sens
        status_f = np.asarray(status)
        if self._root_fn is not None:
            # CV_ROOT_RETURN (5) is a successful early return, not a failure:
            # the root location is in last_stats['roots_t'/'roots_y'/
            # 'roots_found'] and outputs past the root are NaN by contract
            status_f = np.where(status_f == 5, 0, status_f)
        self._check_status(status_f)
        if y_out is None:
            return (ys, sens) if self._compute_sens else ys
        return y_out

    @property
    def current_stats(self):
        """Reference BaseSolver.current_stats analog (solver.py:204-210) —
        much richer here: full counter set from the last solve."""
        return self.last_stats


class AdjointSolver(_SolverBase):
    """Adjoint-gradient solver — reference AdjointSolver (solver.py:530-784)."""

    def __init__(
        self,
        problem: Problem,
        *,
        abstol: float = 1e-10,
        reltol: float = 1e-10,
        checkpoint_n: int = 500_000,
        # both CVODES interpolation schemes are real here: 'hermite'
        # (CV_HERMITE; quintic rows by default — BDFOptions.hermite_order)
        # and 'polynomial' (CV_POLYNOMIAL, the reference default
        # solver.py:530-541: variable-degree Lagrange through recorded rows)
        interpolation: str = "hermite",
        constraints: Optional[np.ndarray] = None,
        solver: str = "BDF",
        adjoint_solver: str = "BDF",
        max_steps: int = 100_000,
        max_retries: int = 5,
        adjoint_abstol: float = 1e-10,
        adjoint_reltol: float = 1e-10,
        # structure-exploiting Newton solves for BOTH directions (beyond
        # the reference, whose AdjointSolver is dense-only,
        # solver.py:599): 'band' (linear_solver_kwargs bandwidths) or
        # 'sparse' (exact symbolic sparsity -> RCM + banded LU); the
        # backward system's matrix is -J^T, so its bandwidths/pattern are
        # the transpose's.  Requires solver='BDF', adjoint_solver='BDF'.
        linear_solver: str = "dense",
        linear_solver_kwargs: Optional[dict] = None,
        native_single: bool = True,
        roots: Optional[Callable] = None,
        root_directions: Optional[Any] = None,
        root_cap: int = 8,
        dtype: Any = np.float64,
    ):
        if solver not in ("BDF", "ADAMS") or adjoint_solver not in ("BDF", "ADAMS"):
            raise ValueError("solver/adjoint_solver must be 'BDF' or 'ADAMS'")
        # dtype=np.float32: f32 speed mode for forward AND backward
        # passes (f64 default = reference realtype).  The reference-default
        # 1e-10 tolerances are meaningless in f32 — require explicit,
        # representable tolerances.
        self._set_dtype(dtype)
        if self._dtype == np.float32 and (
            float(np.min(reltol)) < 1e-7 or float(np.min(adjoint_reltol)) < 1e-7
        ):
            raise ValueError(
                f"reltol={reltol!r}/adjoint_reltol={adjoint_reltol!r} below "
                "float32 precision; pass >=1e-7 (1e-5 is a good default) "
                "with dtype=np.float32"
            )
        # terminal events during the recording pass (CVodeF records while
        # rootfinding, 16_cvodes.h:365-439): solve_forward stops AT the
        # root (outputs past it NaN, stats['roots_t'] set), the checkpoint
        # record ends there, and solve_backward integrates the recorded
        # span — gradient rows at observation times past the root are
        # zeroed (a pre-impact observable cannot depend on them)
        self._roots_src = roots
        self._root_fn = (
            problem.make_root_fn(roots)
            if roots is not None and hasattr(problem, "make_root_fn")
            else roots
        )
        self._root_cap = int(root_cap)
        self._root_directions = (
            None if root_directions is None else np.asarray(root_directions)
        )
        if adjoint_solver == "ADAMS" and solver != "ADAMS":
            raise NotImplementedError(
                "adjoint_solver='ADAMS' requires solver='ADAMS'"
            )
        if interpolation not in ("polynomial", "hermite"):
            raise ValueError("interpolation must be 'polynomial' or 'hermite'")
        if linear_solver not in ("dense", "band", "sparse"):
            raise ValueError(
                "AdjointSolver linear_solver must be 'dense', 'band' or "
                "'sparse'"
            )
        if linear_solver != "dense" and (solver != "BDF" or adjoint_solver != "BDF"):
            raise ValueError(
                f"linear_solver={linear_solver!r} requires solver='BDF' and "
                "adjoint_solver='BDF'"
            )
        self._linear_solver = linear_solver
        self._linear_solver_kwargs = dict(linear_solver_kwargs or {})
        self._problem = problem
        self._solver_kind = solver
        self._adjoint_solver_kind = adjoint_solver
        self._interpolation = interpolation
        self._checkpoint_n = int(checkpoint_n)
        self._max_retries = int(max_retries)
        self._init_params_state()

        self._options = BDFOptions(
            rtol=reltol,
            atol=abstol,
            max_steps=max_steps,
            constraints=None if constraints is None else np.asarray(constraints),
            save_steps=self._checkpoint_n,
        )
        if interpolation == "polynomial":
            # CV_POLYNOMIAL reads only the (t, y) rows — don't pay the
            # per-step fdot jvp or the 1.5x checkpoint width of quintic rows
            self._options = self._options._replace(hermite_order=3)
        # reference hardcodes 1e-10 backward tolerances (solver.py:599,614)
        self._adjoint_options = BDFOptions(
            rtol=adjoint_reltol, atol=adjoint_abstol, max_steps=max_steps
        )

        # Single-chain fast paths: route through the native C++ backward
        # solves (native/cvbdf.cpp).  ADAMS/ADAMS uses the augmented
        # re-solve (cvadams_adjoint_*, ~230us per LV gradient pair at
        # rtol=1e-8 vs ~1.25ms for sunode/CVODES; y re-solved backward with
        # per-observation resets, so `interpolation` is moot).  BDF/BDF
        # with interpolation='hermite' uses the CVodeF/CVodeB split
        # (cvbdf_forward_record keeps the dense per-step Hermite record in
        # native memory; cvbdf_backward_recorded integrates the stiff
        # lambda/quad system over it — ~430us per LV pair).  Opt out with
        # native_single=False.
        self._native_single_enabled = bool(native_single)
        self._init_derived()
        self._jit_cache: dict = {}
        self._last_forward: Optional[dict] = None
        self.last_stats: Optional[dict] = None

    def _init_derived(self):
        problem = self._problem
        self._rhs = problem.make_rhs()
        self._adjoint_rhs = problem.make_adjoint_rhs()
        self._quad_rhs = problem.make_adjoint_quad_rhs()
        ls = self._linear_solver
        aj_dense = problem.make_adjoint_jac_dense()
        if ls == "band":
            from sunode_tpu.ops.banded import dense_to_banded

            kw = self._linear_solver_kwargs
            if "lower_bandwidth" not in kw or "upper_bandwidth" not in kw:
                raise ValueError(
                    "linear_solver='band' requires linear_solver_kwargs with "
                    "'lower_bandwidth' and 'upper_bandwidth'"
                )
            lb, ub = int(kw["lower_bandwidth"]), int(kw["upper_bandwidth"])
            self._jac = problem.make_banded_jac(lb, ub)
            self._options = self._options._replace(
                linear_solver="band", band_lower=lb, band_upper=ub
            )
            # backward matrix is -J^T: bandwidths swap
            self._adjoint_jac = lambda t, y, lam, p, _f=aj_dense: dense_to_banded(
                _f(t, y, lam, p), ub, lb
            )
            self._adjoint_options = self._adjoint_options._replace(
                linear_solver="band", band_lower=ub, band_upper=lb
            )
        elif ls == "sparse":
            from sunode_tpu.ops.banded import dense_to_banded
            from sunode_tpu.ops.sparsity import (
                SparsePlan,
                make_colored_banded_jac,
            )

            kw = self._linear_solver_kwargs
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
            self._sparse_plan = plan_f
            self._jac = make_colored_banded_jac(self._rhs, plan_f)
            self._options = self._options._replace(
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

            if plan_b.k_border:
                from sunode_tpu.ops.bbd import dense_to_packed

                def aj_sparse(t, y, lam, p, _f=aj_dense):
                    return dense_to_packed(_f(t, y, lam, p), plan_b)

            else:

                def aj_sparse(t, y, lam, p, _f=aj_dense):
                    A = _f(t, y, lam, p)[perm_b][:, perm_b]
                    return dense_to_banded(A, plan_b.lower, plan_b.upper)

            self._adjoint_jac = aj_sparse
            self._adjoint_options = self._adjoint_options._replace(
                linear_solver="sparse",
                band_lower=plan_b.lower,
                band_upper=plan_b.upper,
                sparse_perm=plan_b.perm,
                sparse_border=plan_b.k_border,
            )
        else:
            self._jac = problem.make_jac_dense()
            self._adjoint_jac = aj_dense

    # pickling: rebuild derived functions on load (note: the REFERENCE
    # AdjointSolver cannot pickle at all — fork-only multiprocessing,
    # quickstart_pymc.rst:154-163)
    def __getstate__(self):
        state = self.__dict__.copy()
        for key in (
            "_rhs",
            "_jac",
            "_adjoint_rhs",
            "_adjoint_jac",
            "_quad_rhs",
            "_jit_cache",
            "_last_forward",
            "last_stats",
            "_native_adj_solver",
            "_root_fn",
        ):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_derived()
        roots = getattr(self, "_roots_src", None)
        self._root_fn = (
            self._problem.make_root_fn(roots)
            if roots is not None and hasattr(self._problem, "make_root_fn")
            else roots
        )
        self._jit_cache = {}
        self._last_forward = None
        self.last_stats = None

    def make_output_buffers(self, tvals):
        """(y_out, grad_out, lamda_out) — reference solver.py:637-641."""
        n_states = self._problem.n_states
        n_params = self._problem.n_params
        y_vals = np.zeros((len(tvals), n_states), dtype=self._dtype)
        grad_vals = np.zeros(n_params, dtype=self._dtype)
        lamda_vals = np.zeros(n_states, dtype=self._dtype)
        return y_vals, grad_vals, lamda_vals

    def _forward_fn(self, n_t: int):
        key = ("fwd", n_t)
        if key not in self._jit_cache:
            rhs, jac, opts = self._rhs, self._jac, self._options
            root_kw = (
                dict(
                    root_fn=self._root_fn,
                    root_cap=self._root_cap,
                    root_terminal=True,
                    root_directions=self._root_directions,
                )
                if self._root_fn is not None
                else {}
            )

            if self._solver_kind == "ADAMS":
                from sunode_tpu.ops.adams import adams_solve

                def run(t0, y0, params, tvals):
                    res = adams_solve(
                        rhs, t0, y0, params, tvals, opts, **root_kw
                    )
                    return res.ys, res.status, res.saved, res.stats

            else:

                def run(t0, y0, params, tvals):
                    res = bdf_solve(
                        rhs, jac, t0, y0, params, tvals, opts, **root_kw
                    )
                    return res.ys, res.status, res.saved, res.stats

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _backward_fn(self, n_t: int):
        """max_steps is a traced argument: backward retries with a doubled
        budget reuse the one compiled executable."""
        key = ("bwd", n_t)
        if key not in self._jit_cache:
            aj_rhs, aj_jac, q_rhs = self._adjoint_rhs, self._adjoint_jac, self._quad_rhs
            n_deriv = self._problem.n_params
            base_opts = self._adjoint_options

            if self._adjoint_solver_kind == "ADAMS":
                # fused single-loop Adams backward (in-loop cotangent
                # injections) via the batch-native path at B=1 — the same
                # machinery the 10k-chain fast path uses
                from sunode_tpu.adjoint import adjoint_backward_batched

                def run(saved, t0, tvals, grads, params, max_steps):
                    opts = base_opts._replace(max_steps=max_steps)
                    yf_parts = [saved["y"], saved["f"]]
                    if "fd" in saved:
                        yf_parts.append(saved["fd"])
                    saved_b = {
                        "t": saved["t"][:, None],
                        "y": saved["y"][:, :, None],
                        "f": saved["f"][:, :, None],
                        # (S, 2n|3n, B) y|f[|fd] table:
                        # make_hermite_eval_batched dispatches on this key to
                        # the fast two-row-gather variant
                        "yf": jnp.concatenate(yf_parts, axis=1)[:, :, None],
                        "n_saved": saved["n_saved"][None],
                        "overflow": saved["overflow"][None],
                    }
                    if "fd" in saved:
                        saved_b["fd"] = saved["fd"][:, :, None]
                    if "L" in saved:
                        saved_b["L"] = saved["L"][:, None]
                    adj = adjoint_backward_batched(
                        aj_rhs, aj_jac, q_rhs, saved_b, t0, tvals,
                        grads[None], params[None], n_deriv, opts,
                        method="ADAMS",
                        interpolation=self._interpolation,
                    )
                    return (
                        adj.lamda[0],
                        adj.quad[0],
                        adj.status[0],
                        jax.tree_util.tree_map(lambda v: v[0] if getattr(v, "ndim", 0) else v, adj.stats),
                    )

            else:

                def run(saved, t0, tvals, grads, params, max_steps):
                    opts = base_opts._replace(max_steps=max_steps)
                    adj = adjoint_backward(
                        aj_rhs, aj_jac, q_rhs, saved, t0, tvals, grads, params,
                        n_deriv, opts,
                        interpolation=self._interpolation,
                    )
                    return adj.lamda, adj.quad, adj.status, adj.stats

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _native_adj_eligible(self) -> bool:
        o = self._options
        kinds = (self._solver_kind, self._adjoint_solver_kind)
        # BDF/BDF routes through the native CVodeF/CVodeB split
        # (cvbdf_forward_record + cvbdf_backward_recorded); the dense
        # per-step record in native memory serves both CV_HERMITE and
        # CV_POLYNOMIAL evaluation (FwdRecord::eval)
        kind_ok = kinds == ("ADAMS", "ADAMS") or (
            kinds == ("BDF", "BDF")
            and self._interpolation in ("hermite", "polynomial")
        )
        if self._dtype != np.float64:  # native realtype is f64-only
            return False
        if np.ndim(o.rtol) != 0:  # vector rtol is a JAX-core feature
            return False
        # banded Newton routes natively on the BDF/BDF path only (the
        # ADAMS pair has no Newton matrix; banded codegen needs sympy)
        ls_ok = self._linear_solver == "dense" or (
            self._linear_solver in ("band", "sparse")
            and kinds == ("BDF", "BDF")
            and hasattr(self._problem, "_sym_dydt_jac")
        )
        return (
            self._native_single_enabled
            and kind_ok
            and ls_ok
            and self._root_fn is None  # event recording is the JAX path
            and o.constraints is None
            and o.first_step is None
            and not np.isfinite(o.max_step)
            and o.min_step == 0.0
        )

    def _native_adj(self):
        """Lazily-built native CpuSolver for the single-chain adjoint fast
        path (None when the problem can't be compiled to C)."""
        if not hasattr(self, "_native_adj_solver"):
            try:
                from sunode_tpu.native.cpu_solver import CpuSolver

                ls_kw = {}
                if self._linear_solver == "band":
                    kw = self._linear_solver_kwargs
                    ls_kw = dict(
                        linear_solver="band",
                        linear_solver_kwargs=dict(
                            lower_bandwidth=int(kw["lower_bandwidth"]),
                            upper_bandwidth=int(kw["upper_bandwidth"]),
                        ),
                    )
                elif self._linear_solver == "sparse":
                    ls_kw = dict(linear_solver="sparse")
                self._native_adj_solver = CpuSolver(
                    self._problem,
                    abstol=np.asarray(self._options.atol),
                    reltol=float(self._options.rtol),
                    max_steps=int(self._options.max_steps)
                    * 2**self._max_retries,
                    method=self._solver_kind,
                    adams_max_order=int(self._options.adams_max_order),
                    hermite_order=int(self._options.hermite_order),
                    interpolation=(
                        "polynomial"
                        if self._interpolation == "polynomial"
                        else "hermite"
                    ),
                    **ls_kw,
                )
            except Exception:
                self._native_adj_solver = None
        return self._native_adj_solver

    def solve_forward(self, t0, tvals, y0, y_out=None):
        """Forward pass recording checkpoints (CVodeF; solver.py:682-721)."""
        spec = self._problem.states
        dt = self._dtype
        y0_flat = np.asarray(spec.coerce_flat(y0, xp=np), dt)
        if y0_flat.ndim == 1 and self._native_adj_eligible():
            ns = self._native_adj()
            if ns is not None:
                ns._params = np.ascontiguousarray(self._params, np.float64)
                if self._solver_kind == "BDF":
                    # CVodeF analog: keep the dense Hermite record alive in
                    # native memory for solve_backward
                    ys = ns.solve_forward_recorded(
                        t0, np.asarray(tvals, np.float64), y0_flat
                    )
                else:
                    ys = ns.solve(t0, np.asarray(tvals, np.float64), y0_flat)
                self.last_stats = dict(ns.last_stats)
                self._last_forward = dict(
                    native_ys=ys,
                    native_mode=self._solver_kind,
                    native_tvals=np.asarray(tvals, np.float64),
                    t0=float(t0),
                    params=self._params.copy(),
                )
                if y_out is not None:
                    y_out[...] = ys
                    return y_out
                return ys
        fn = self._forward_fn(len(tvals))
        ys, status, saved, stats = fn(
            jnp.asarray(t0, dt),
            jnp.asarray(y0_flat),
            jnp.asarray(self._params, dt),
            jnp.asarray(tvals, dt),
        )
        self._last_forward = dict(saved=saved, t0=float(t0), params=self._params.copy())
        self.last_stats = {k: np.asarray(v) for k, v in stats.items()}
        thin = int(np.max(self.last_stats.get("checkpoint_thinning_levels", 0)))
        if thin > 0:
            import warnings

            warnings.warn(
                f"adjoint checkpoint buffer filled: the recording was "
                f"thinned {thin}x (interpolation spacing grew 2^{thin}; "
                f"Hermite error grows ~16x per level).  Gradients remain "
                f"usable but degraded — increase checkpoint_n "
                f"(stats['checkpoint_thinning_levels'])",
                RuntimeWarning,
                stacklevel=2,
            )
        ys = np.asarray(ys)
        if y_out is not None:
            y_out[...] = ys
        status_f = np.asarray(status)
        if self._root_fn is not None:
            # CV_ROOT_RETURN (5) is a successful early return: the record
            # ends at the root and backward integrates the recorded span
            status_f = np.where(status_f == 5, 0, status_f)
        self._check_status(status_f, "solve_forward")
        return ys if y_out is None else y_out

    def checkpoint_info(self) -> dict:
        """Inspect the checkpoint table recorded by :meth:`solve_forward`
        (CVodeGetAdjCheckPointsInfo analog, 16_cvodes.h:429-439 — the
        reference declares but never exposes it).

        Returns a dict with ``n_recorded`` (rows actually holding data),
        ``capacity`` (buffer size; ``None`` for the native record, which
        grows unbounded), ``times`` (the recorded t values, ascending),
        ``t_first``/``t_last`` (coverage), ``dt_min``/``dt_max``/``dt_mean``
        (spacing of the interpolation grid the backward pass will read),
        ``thinning_level`` (halvings applied when the fixed JAX buffer
        filled — spacing grew 2^level) and ``overflow``.
        """
        if self._last_forward is None:
            raise SolverError("checkpoint_info called before solve_forward")
        fwd = self._last_forward
        if "native_ys" in fwd:
            if fwd.get("native_mode") == "BDF":
                times = self._native_adj().checkpoint_times()
            else:
                # ADAMS augmented re-solve: backward re-integrates y with
                # resets at the recorded observations — those rows ARE the
                # checkpoint table
                times = np.asarray(fwd["native_tvals"], np.float64)
            capacity: Optional[int] = None
            thin = 0
        else:
            saved = fwd["saved"]
            n_rec = int(np.asarray(saved["n_saved"]))
            times = np.asarray(saved["t"])[:n_rec]
            capacity = int(np.asarray(saved["t"]).shape[0])
            thin = int(
                np.max((self.last_stats or {}).get("checkpoint_thinning_levels", 0))
            )
        dts = np.diff(times) if len(times) > 1 else np.zeros(0)
        return dict(
            n_recorded=int(len(times)),
            capacity=capacity,
            times=times,
            t_first=float(times[0]) if len(times) else np.nan,
            t_last=float(times[-1]) if len(times) else np.nan,
            dt_min=float(dts.min()) if len(dts) else np.nan,
            dt_max=float(dts.max()) if len(dts) else np.nan,
            dt_mean=float(dts.mean()) if len(dts) else np.nan,
            thinning_level=thin,
            overflow=thin > 0,
        )

    def solve_backward(self, t0, tend, tvals, grads, grad_out=None, lamda_out=None):
        """Backward adjoint pass (CVodeB; solver.py:723-784).

        ``t0`` is the backward start (the forward end time) and ``tend`` the
        backward end (the forward initial time) — reference argument order.
        """
        if self._last_forward is None:
            raise SolverError("solve_backward called before solve_forward")
        fwd = self._last_forward
        if "native_ys" in fwd:
            # native fast path (see ctor comment): backward augmented solve
            # against the recorded forward observations.  Any leading
            # lambda=0 segment (t0 > tvals[-1]) is analytically zero, so
            # starting at tvals[-1] is exact.
            if not np.array_equal(np.asarray(tvals, np.float64), fwd["native_tvals"]):
                raise SolverError(
                    "solve_backward tvals must match solve_forward's on the "
                    "native path (pass native_single=False to disable it)"
                )
            ns = self._native_adj()
            ns._params = np.ascontiguousarray(fwd["params"], np.float64)
            if fwd.get("native_mode") == "BDF":
                # CVodeB analog: stiff backward over the kept Hermite record
                lam0, quad = ns.solve_backward_recorded(
                    tend,
                    fwd["native_tvals"],
                    np.asarray(grads, np.float64),
                    adjoint_reltol=float(self._adjoint_options.rtol),
                    adjoint_abstol=float(np.max(self._adjoint_options.atol)),
                )
            else:
                lam0, quad = ns.solve_adjoint_backward(
                    tend,
                    fwd["native_tvals"],
                    fwd["native_ys"],
                    np.asarray(grads, np.float64),
                    adjoint_reltol=float(self._adjoint_options.rtol),
                    adjoint_abstol=float(np.max(self._adjoint_options.atol)),
                )
            self.last_stats = (self.last_stats or {}) | dict(ns.last_stats)
            if lamda_out is not None:
                lamda_out[...] = -lam0
            if grad_out is not None:
                grad_out[...] = quad
            if grad_out is None and lamda_out is None:
                return quad, -lam0
            return grad_out, lamda_out
        grads = np.asarray(grads, self._dtype)
        if self._root_fn is not None and self.last_stats is not None:
            # CVodeB-after-CVodeF-root semantics: the recording stopped AT
            # the terminal root, observations past it are NaN by contract,
            # so their cotangent rows are zeroed — the backward pass then
            # computes the exact gradient of the pre-impact observable
            # (lambda stays identically 0 until the first retained
            # injection, so the truncated record costs nothing)
            rt = np.asarray(self.last_stats.get("roots_t", np.inf)).reshape(-1)
            t_root = float(rt[0]) if rt.size else np.inf
            post = np.asarray(tvals, np.float64) >= t_root
            if post.any():
                grads = grads.copy()
                grads[post] = 0.0
        dt = self._dtype
        args = (
            fwd["saved"],
            jnp.asarray(tend, dt),
            jnp.asarray(tvals, dt),
            jnp.asarray(grads, dt),
            jnp.asarray(fwd["params"], dt),
        )
        fn = self._backward_fn(len(tvals))
        base_ms = int(self._adjoint_options.max_steps)
        lam, quad, status, stats = fn(
            *args, jnp.asarray(min(base_ms, _I32_MAX), jnp.int32)
        )
        # bounded backward retries on step-budget exhaustion (the reference
        # retries CVodeB up to 50 times, solver.py:759-768); the budget is a
        # traced argument, so retries reuse the compiled executable
        retry = 0
        while np.any(np.asarray(status) == 1) and retry < self._max_retries:
            retry += 1
            lam, quad, status, stats = fn(
                *args, jnp.asarray(min(base_ms * 2**retry, _I32_MAX), jnp.int32)
            )
        lam = np.asarray(lam)
        quad = np.asarray(quad)
        # reference returns lamda with the opposite sign convention
        # (grad wrt y0 = -lamda_out; as_pytensor.py:294-308)
        if lamda_out is not None:
            lamda_out[...] = -lam
        if grad_out is not None:
            grad_out[...] = quad
        self.last_stats = (self.last_stats or {}) | {
            k: np.asarray(v) for k, v in stats.items()
        }
        self._check_status(status, "solve_backward")
        if grad_out is None and lamda_out is None:
            return quad, -lam
        return grad_out, lamda_out
