"""Lower sympy expression arrays to JAX functions with CSE preserved.

JAX-native replacement for the reference's sympy -> numba-AST compiler
(reference sunode/symode/lambdify.py:203 ``lambdify_consts``): where the
reference emits a Python module via raw ``ast`` construction and compiles it
with ``@numba.njit`` into a C-callable, we emit Python *source* whose body is a
sequence of let-bindings (one per ``sympy.cse`` replacement — the
"CSE preserved" contract of BASELINE.json) evaluating to ``jnp`` scalars, and
``exec`` it into a module namespace.  Under ``jax.jit`` the whole body traces
to a single fused XLA computation, so there is no Python in the hot loop —
the same property the reference gets from numba, achieved the XLA way.

Custom sympy functions carried over from the reference (lambdify.py:275-352):
``logaddexp``, ``expit``, ``dexpit``, ``CardinalBSpline``,
``interpolate_spline``, plus the ``logsumexp_2terms_opt`` rewrite.
"""

from __future__ import annotations

import itertools
import linecache
from functools import partial
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import sympy as sy
import sympy.codegen.rewriting
from sympy.printing.numpy import NumPyPrinter

__all__ = [
    "lambdify_jax",
    "logaddexp",
    "expit",
    "dexpit",
    "CardinalBSpline",
    "interpolate_spline",
    "logsumexp_2terms_opt",
    "explog_opt",
    "stabilize_exp_products",
    "DEFAULT_OPTIMS",
]


# ---------------------------------------------------------------------------
# Custom sympy functions (with correct derivatives) that lower to stable JAX
# primitives.  Math is standard; see reference lambdify.py:275-352 for the
# feature list these mirror.
# ---------------------------------------------------------------------------
class logaddexp(sy.Function):
    """log(exp(a) + exp(b)) computed stably; lowers to jnp.logaddexp."""

    nargs = (2,)

    def fdiff(self, argindex=1):
        if argindex in (1, 2):
            a, b = self.args
            other = b if argindex == 1 else a
            # d/da log(e^a + e^b) = sigmoid(a - b)
            return expit(self.args[argindex - 1] - other)
        raise sy.function.ArgumentIndexError(self, argindex)

    def _eval_is_real(self):
        return self.args[0].is_real and self.args[1].is_real


class expit(sy.Function):
    """Logistic sigmoid 1/(1+exp(-x)); lowers to jax.scipy.special.expit."""

    nargs = (1,)

    def fdiff(self, argindex=1):
        if argindex == 1:
            return dexpit(self.args[0])
        raise sy.function.ArgumentIndexError(self, argindex)

    def _eval_is_real(self):
        return self.args[0].is_real


class dexpit(sy.Function):
    """Derivative of expit: expit(x) * (1 - expit(x))."""

    nargs = (1,)

    def fdiff(self, argindex=1):
        if argindex == 1:
            x = self.args[0]
            return dexpit(x) * (1 - 2 * expit(x))
        raise sy.function.ArgumentIndexError(self, argindex)

    def _eval_is_real(self):
        return self.args[0].is_real


class CardinalBSpline(sy.Function):
    """Cardinal B-spline basis of given degree evaluated at x.

    ``CardinalBSpline(degree, x)`` == bspline basis on integer knots
    ``0..degree+1``.  At lowering time it is expanded to a horner-form
    Piecewise (same strategy as the reference, lambdify.py:328-341).
    """

    nargs = (2,)

    def fdiff(self, argindex=1):
        if argindex == 2:
            degree, x = self.args
            d = int(degree)
            if d == 0:
                return sy.Integer(0)
            # Standard B-spline derivative recurrence on cardinal knots:
            # B'_d(x) = B_{d-1}(x) - B_{d-1}(x - 1)
            return CardinalBSpline(d - 1, x) - CardinalBSpline(d - 1, x - 1)
        raise sy.function.ArgumentIndexError(self, argindex)

    def as_piecewise(self):
        degree, x = self.args
        d = int(degree)
        knots = tuple(sy.Integer(i) for i in range(d + 2))
        basis = sy.functions.special.bsplines.bspline_basis(d, knots, 0, x)
        pieces = [(sy.horner(e) if not e.is_Atom else e, c) for e, c in basis.args]
        return sy.Piecewise(*pieces)


def interpolate_spline(x, vals, lower, upper, degree, as_pure: bool = False):
    """Spline interpolation of `vals` on [lower, upper] with cardinal B-splines.

    Mirrors the reference helper (lambdify.py:343-352)."""
    n_vals = len(vals)
    n_knots = degree + n_vals + 1
    basis = partial(CardinalBSpline, degree)
    x = (x - lower) / (upper - lower)
    x = degree + x * (n_knots - 2 * degree - 1)
    basis_vecs = [basis(x - i) for i in range(n_vals)]
    if as_pure:
        basis_vecs = [b.as_piecewise() for b in basis_vecs]
    return sum(val * b for val, b in zip(vals, basis_vecs))


# Rewrite: log(exp(a) + exp(b)) -> logaddexp(a, b)   (reference lambdify.py:355-361)
logsumexp_2terms_opt = sympy.codegen.rewriting.ReplaceOptim(
    lambda l: (
        isinstance(l, sy.log)
        and l.args[0].is_Add
        and len(l.args[0].args) == 2
        and all(isinstance(t, sy.exp) for t in l.args[0].args)
    ),
    lambda l: logaddexp(l.args[0].args[0].args[0], l.args[0].args[1].args[0]),
)

DEFAULT_OPTIMS = (sympy.codegen.rewriting.log1p_opt, logsumexp_2terms_opt)


# --- exp-product stabilization (reference lambdify.py:362-432 analog) -------
def _is_exp_sum(e):
    """exp(a) or a 2-term sum of exps (the logaddexp-rewritable shape)."""
    if isinstance(e, sy.exp):
        return True
    return (
        isinstance(e, sy.Add)
        and len(e.args) == 2
        and all(isinstance(a, sy.exp) for a in e.args)
    )


def _is_exp_like_factor(e):
    if _is_exp_sum(e):
        return True
    if isinstance(e, sy.Pow) and _is_exp_sum(e.args[0]):
        return True
    if isinstance(e, sy.Mul):
        return any(_is_exp_like_factor(a) for a in e.args)
    return False


def _has_multiple_exp_factors(e):
    return isinstance(e, sy.Mul) and sum(
        bool(_is_exp_like_factor(a)) for a in e.args
    ) > 1


def stabilize_exp_products(expr, optims=None):
    """Rewrite sign-definite products/quotients of exp-sums through log space:
    ``exp(c2)/(exp(c1)+exp(c2))`` becomes ``exp(c2 - logaddexp(c1, c2))`` —
    overflow-safe softmax-style expressions (reference
    ``simplify_multiple_exp_sum``, lambdify.py:404-424)."""
    from sympy.assumptions import Q, ask

    if optims is None:
        optims = DEFAULT_OPTIMS
    pos = ask(Q.positive(expr))
    neg = False if pos else ask(Q.negative(expr))
    if not (pos or neg):
        if expr.args:
            return expr.func(
                *[stabilize_exp_products(a, optims) for a in expr.args]
            )
        return expr
    sign = sy.S.One if pos else sy.S.NegativeOne
    log_expr = sy.expand_log(sy.log(sign * expr), force=True)
    log_expr = sympy.codegen.rewriting.optimize(log_expr, optims)
    return sign * sy.exp(log_expr, evaluate=False)


# opt-in (pass via lambdify_jax(optims=DEFAULT_OPTIMS + (explog_opt,)) or
# SympyProblem rewrite options); matches the reference, which defines but
# does not enable it by default (reference lambdify.py:427-432)
def _explog_filter(l):
    from sympy.assumptions import Q, ask

    return (ask(Q.positive(l)) or ask(Q.negative(l))) and _has_multiple_exp_factors(l)


explog_opt = sympy.codegen.rewriting.ReplaceOptim(
    _explog_filter, stabilize_exp_products
)


# ---------------------------------------------------------------------------
# Printer
# ---------------------------------------------------------------------------
class _JaxExprPrinter(NumPyPrinter):
    """Print sympy scalars as jnp expressions, mapping problem symbols through
    a varmap of symbol-name -> access expression (e.g. '_y[3]', '_p[0]', '_t')."""

    _module = "jnp"

    def __init__(self, varmap: Mapping[str, str]):
        super().__init__()
        self._varmap = dict(varmap)

    def _print_Symbol(self, expr):
        name = expr.name
        if name in self._varmap:
            return self._varmap[name]
        return name  # CSE temporaries and loop-local names

    # numpy printer emits "numpy.foo"; rewrite module prefix to jnp
    def _module_format(self, fqn, register=True):
        out = super()._module_format(fqn, register)
        for prefix in ("numpy.", "np."):
            if out.startswith(prefix):
                return "jnp." + out[len(prefix):]
        return out

    def _print_And(self, expr):
        parts = [self._print(a) for a in expr.args]
        out = parts[0]
        for p in parts[1:]:
            out = f"jnp.logical_and({out}, {p})"
        return out

    def _print_Or(self, expr):
        parts = [self._print(a) for a in expr.args]
        out = parts[0]
        for p in parts[1:]:
            out = f"jnp.logical_or({out}, {p})"
        return out

    def _print_Not(self, expr):
        return f"jnp.logical_not({self._print(expr.args[0])})"

    def _print_logaddexp(self, expr):
        return (
            f"jnp.logaddexp({self._print(expr.args[0])}, {self._print(expr.args[1])})"
        )

    def _print_expit(self, expr):
        return f"_expit({self._print(expr.args[0])})"

    def _print_dexpit(self, expr):
        return f"_dexpit({self._print(expr.args[0])})"

    def _print_CardinalBSpline(self, expr):
        return self._print(expr.as_piecewise())

    def _print__safe_where(self, expr):
        cond, val, safe = expr.args
        return (
            f"jnp.where({self._print(cond)}, {self._print(val)}, "
            f"{self._print(safe)})"
        )

    def _print_Piecewise(self, expr):
        # Chain of jnp.where; final condition may be True.  Singular operands
        # inside pieces were already clamped by _apply_piecewise_guards
        # (safe-where) before CSE.
        result = None
        for e, c in reversed(expr.args):
            body = self._print(e)
            if c == sy.true or result is None:
                result = body
            else:
                result = f"jnp.where({self._print(c)}, {body}, {result})"
        return result


class _safe_where(sy.Function):
    """Opaque clamp ``_safe_where(cond, val, safe)`` -> where(cond, val, safe).

    A plain Piecewise guard would be re-evaluated (and sometimes folded away)
    by CSE's tree rebuilding; an undefined Function passes through sympy
    machinery untouched and is printed directly as jnp.where."""

    nargs = (3,)


def _apply_piecewise_guards(expr):
    """Safe-where pass over every Piecewise in ``expr`` (run BEFORE CSE so a
    hoisted common subexpression can't escape its guard).

    Piecewise lowers to jnp.where, and both branches of a where ALWAYS
    evaluate under XLA (no real branching as in the reference's numba
    codegen), so a domain-guarded piece like
    ``Piecewise((log(x), x > 0), (0, True))`` would produce spurious NaN
    values/gradients at x <= 0.  Each piece's singular operands are clamped
    via _guard_singular under the condition that selects the piece."""
    if not expr.has(sy.Piecewise):
        return expr

    def xform(pw):
        args = list(pw.args)
        conds = [c for _, c in args]
        new_args = []
        for i, (e, c) in enumerate(args):
            if c == sy.true:
                # default piece: selected where no earlier condition held
                earlier = [cc for cc in conds[:i] if cc != sy.true]
                guard = sy.Not(sy.Or(*earlier)) if earlier else None
            else:
                guard = c
            new_args.append((_guard_singular(e, guard), c))
        return sy.Piecewise(*new_args, evaluate=False)

    return expr.replace(lambda e: isinstance(e, sy.Piecewise), xform)


def _guard_singular(expr, guard):
    """Safe-where: inside a Piecewise branch used only where ``guard`` holds,
    clamp operands of singular functions (log, x**negative, x**fractional,
    asin/acos/atanh) to an in-domain constant on the lanes where the guard is
    false.  Those lanes' outputs are discarded by the surrounding jnp.where
    and their cotangents zeroed by its VJP, so this removes spurious NaNs
    from values and gradients without changing the selected result."""
    if guard is None or expr.is_Atom:
        return expr

    def rec(e):
        if e.is_Atom:
            return e
        args = tuple(rec(a) for a in e.args)
        if isinstance(e, sy.log):
            return sy.log(_safe_where(guard, args[0], sy.S.One), evaluate=False)
        if isinstance(e, sy.Pow):
            b, ex = args
            if ex.is_number and (ex.is_negative or ex.is_integer is False):
                return sy.Pow(_safe_where(guard, b, sy.S.One), ex, evaluate=False)
        if isinstance(e, (sy.asin, sy.acos, sy.atanh)):
            return e.func(_safe_where(guard, args[0], sy.S.Zero), evaluate=False)
        return e.func(*args)

    return rec(expr)


_module_counter = itertools.count()


def _expand_special(expr):
    """Pre-expand constructs the printer can't handle directly."""
    if expr.has(sy.Derivative):
        expr = expr.doit()
    return expr


def lambdify_jax(
    argnames: Sequence[str],
    exprs: Any,
    varmap: Mapping[str, str],
    *,
    name: str = "compute",
    optims: Sequence[Any] | None = None,
    simplify: bool = False,
    debug: bool = False,
) -> Callable:
    """Compile a sympy expression array into a JAX function.

    Parameters
    ----------
    argnames:
        Names of the function's positional arguments as they appear in the
        varmap access expressions (e.g. ``["_t", "_y", "_p"]``).
    exprs:
        A numpy object array (any rank) of sympy expressions; the function
        returns a jnp array of the same shape.
    varmap:
        Maps sympy symbol names to Python access expressions over argnames.
    optims:
        sympy.codegen.rewriting optimizations to apply element-wise before CSE
        (default: log1p + 2-term logsumexp, as in the reference).
    simplify:
        Run ``sympy.simplify`` per element first (reference SympyProblem's
        ``simplify_rhs`` analog).

    Returns
    -------
    A pure function ``f(*args) -> jnp.ndarray`` of the expression array shape,
    suitable for jit/vmap/grad.  The generated source is attached as
    ``f.__source__``.
    """
    exprs = np.asarray(exprs, dtype=object)
    shape = exprs.shape
    flat = [sy.sympify(e) for e in exprs.reshape(-1)]

    if simplify:
        flat = [sy.simplify(e) for e in flat]
    if optims is None:
        optims = DEFAULT_OPTIMS
    if optims:
        flat = [sympy.codegen.rewriting.optimize(e, optims) for e in flat]
    flat = [_expand_special(e) for e in flat]
    flat = [_apply_piecewise_guards(e) for e in flat]

    cse_symbols = sy.numbered_symbols("_x")
    replacements, reduced = sy.cse(flat, symbols=cse_symbols, order="none")

    printer = _JaxExprPrinter(varmap)

    lines = []
    lines.append("import jax")
    lines.append("import jax.numpy as jnp")
    lines.append("from jax.scipy.special import expit as _expit")
    lines.append("def _dexpit(x):")
    lines.append("    _s = _expit(x)")
    lines.append("    return _s * (1 - _s)")
    lines.append(f"def {name}({', '.join(argnames)}):")
    # Output dtype follows the floating dtype of the ARRAY arguments so an
    # f32 pipeline stays f32 even under x64 mode (Python-float args are
    # weakly typed and ignored); falls back to the session default when no
    # array argument carries a floating dtype.
    args_tuple = ", ".join(argnames) + ("," if len(argnames) == 1 else "")
    lines.append(
        f"    _c = [_a.dtype for _a in ({args_tuple})"
        " if hasattr(_a, 'dtype') and jnp.issubdtype(_a.dtype, jnp.floating)]"
    )
    lines.append("    _dt = jnp.result_type(*_c) if _c else _dtype")
    for sym, sub in replacements:
        lines.append(f"    {sym.name} = {printer.doprint(sub)}")
    elems = ", ".join(printer.doprint(e) for e in reduced)
    lines.append(f"    _out = jnp.array([{elems}], dtype=_dt)")
    if shape == ():
        lines.append("    return _out[0]")
    else:
        # batch-agnostic reshape: elements may carry trailing batch dims
        # (the batch-native integrator calls with (n, B)-shaped states)
        lines.append(f"    return _out.reshape({shape!r} + _out.shape[1:])")
    source = "\n".join(lines) + "\n"

    modname = f"<sunode_tpu.lambdify.{name}.{next(_module_counter)}>"
    namespace: dict[str, Any] = {"_dtype": None}
    # Default computation dtype follows jax x64 config at call time; bind f64
    # here (cheap no-op cast under x64, downcast guard otherwise).
    import jax.numpy as jnp

    namespace["_dtype"] = jnp.result_type(float)
    code = compile(source, modname, "exec")
    # register with linecache so tracebacks show generated source
    linecache.cache[modname] = (
        len(source),
        None,
        source.splitlines(keepends=True),
        modname,
    )
    exec(code, namespace)
    fn = namespace[name]
    fn.__source__ = source
    if debug:
        print(source)
    return fn
