"""Checkpointed adjoint gradients (CVODES CVODEA analog) as pure JAX.

Reference semantics being rebuilt (/root/reference/sunode/solver.py:530-784
``AdjointSolver`` + include/cvodes/16_cvodes.h:365-471 adjoint API):

  forward:  ``CVodeF`` records the solution while integrating
            -> here: ``bdf_solve(..., options.save_steps>0)`` records every
            accepted step's (t, y, f) — the CV_HERMITE checkpoint scheme.
  backward: ``CVodeB`` integrates lambda' = -J^T lambda with the quadrature
            q' = lambda^T df/dp, interval-wise between observation times,
            injecting lambda <- lambda + g_i at each observation
            (solver.py:750-784) -> here: a ``lax.scan`` over reversed
            observation intervals, each running the same BDF core on the
            time-reversed adjoint system, with y(t) reconstructed by cubic
            Hermite interpolation of the recorded forward trajectory.

Conventions (for L = sum_i g_i^T y(t_i)):
  dL/dy0       = lambda(t0)
  dL/dp_subset = quad(t0)
  dL/dt_i      = g_i^T f(t_i, y(t_i))
  dL/dt0       = -lambda(t0)^T f(t0, y0)

The reference returns (-lambda, quad) from its backward Op and negates in
``SolveODEAdjoint.grad`` (as_pytensor.py:294-308); we keep the positive
convention internally and expose gradients directly.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sunode_tpu.ops.bdf import BDFOptions, BDFResult, bdf_solve

__all__ = [
    "make_hermite_eval",
    "make_polynomial_eval",
    "adjoint_backward",
    "AdjointResult",
]


def _quintic_basis(tau):
    """Two-point quintic Hermite basis at tau in [0, 1]: weights for
    (y0, h f0, h^2 fd0, y1, h f1, h^2 fd1)."""
    t2 = tau * tau
    t3 = t2 * tau
    t4 = t3 * tau
    t5 = t4 * tau
    H0 = 1 - 10 * t3 + 15 * t4 - 6 * t5
    H1 = tau - 6 * t3 + 8 * t4 - 3 * t5
    H2 = 0.5 * t2 - 1.5 * t3 + 1.5 * t4 - 0.5 * t5
    H3 = 10 * t3 - 15 * t4 + 6 * t5
    H4 = -4 * t3 + 7 * t4 - 3 * t5
    H5 = 0.5 * t3 - t4 + 0.5 * t5
    return H0, H1, H2, H3, H4, H5


def make_hermite_eval(saved: dict) -> Callable:
    """Hermite evaluator over a recorded forward trajectory.

    ``saved`` is the ``BDFResult.saved`` dict: t (N,) padded with +inf,
    y (N, n), f (N, n), n_saved — plus fd (N, n) when the core recorded
    quintic rows (hermite_order=5, the default: O(h^6) reconstruction).
    Without fd this is CVODES's cubic CV_HERMITE interpolation
    (include/cvodes/16_cvodes.h:40-41); the reference defaults to polynomial
    interpolation but supports both (solver.py:531-585).
    """
    ts, ys, fs, n_saved = saved["t"], saved["y"], saved["f"], saved["n_saved"]
    fds = saved.get("fd")
    Ls = saved.get("L")

    def y_at(t):
        # bracketing interval [i, i+1]; ts padded with +inf so searchsorted
        # never picks padding as the left node
        idx = jnp.searchsorted(ts, t, side="right") - 1
        i = jnp.clip(idx, 0, n_saved - 2)
        t0 = ts[i]
        t1 = ts[i + 1]
        h = t1 - t0
        tau = jnp.clip((t - t0) / h, 0.0, 1.0)
        y0, y1 = ys[i], ys[i + 1]
        f0, f1 = fs[i], fs[i + 1]
        h00 = (1 + 2 * tau) * (1 - tau) ** 2
        h10 = tau * (1 - tau) ** 2
        h01 = tau**2 * (3 - 2 * tau)
        h11 = tau**2 * (tau - 1)
        cubic = h00 * y0 + h10 * h * f0 + h01 * y1 + h11 * h * f1
        if fds is None:
            return cubic
        H0, H1, H2, H3, H4, H5 = _quintic_basis(tau)
        fd0, fd1 = fds[i], fds[i + 1]
        h2 = h * h
        quintic = (
            H0 * y0
            + H1 * h * f0
            + H2 * h2 * fd0
            + H3 * y1
            + H4 * h * f1
            + H5 * h2 * fd1
        )
        if Ls is None:
            return quintic
        # Stiffness gate: the h^2*(J f) quintic term amplifies the forward
        # solution's O(tol) node error by (hL)^2 (two exact solutions a
        # distance d apart differ in curvature by ~L^2 d), and J f cancels
        # catastrophically near stiff equilibria — exactly where BDF takes
        # h L >> 1 steps.  Ungated quintic measured 2.7e-2 max-rel
        # interpolation error vs cubic's 1.8e-8 on Robertson to t=1e5, a
        # 1e-4 gradient bias.  Quintic only where h L <= 1 (the same gate
        # the native engine applies, cvbdf.cpp FwdRecord::eval); cubic —
        # CVODES's own CV_HERMITE choice — everywhere else.
        ok = h * jnp.maximum(Ls[i], Ls[i + 1]) <= 1.0
        return jnp.where(ok, quintic, cubic)

    return y_at


POLY_K = 6  # polynomial interpolation window (degree POLY_K-1, ~O(h^6))


def make_polynomial_eval(saved: dict) -> Callable:
    """Variable-degree polynomial dense output over the recorded steps —
    the true CV_POLYNOMIAL analog (include/cvodes/16_cvodes.h:40-41; the
    reference's *default* interpolation, solver.py:530-585).

    CVODES interpolates the checkpointed solution with a Newton polynomial
    through the stored step values; here a barycentric Lagrange interpolant
    of degree POLY_K-1 through the POLY_K recorded (t, y) rows bracketing
    the evaluation point (window clamped at the trajectory edges; degree
    reduces automatically when fewer than POLY_K rows were recorded).
    Uses only y rows — no derivative storage, unlike Hermite."""
    ts, ys, n_saved = saved["t"], saved["y"], saved["n_saved"]
    S = ts.shape[0]
    K = min(POLY_K, S)

    def y_at(t):
        idx = jnp.searchsorted(ts, t, side="right") - 1
        i = jnp.clip(idx, 0, n_saved - 2)
        # window of K rows around the bracketing interval
        s = jnp.clip(i - (K // 2 - 1), 0, jnp.maximum(n_saved - K, 0))
        off = jnp.arange(K)
        jdx = jnp.clip(s + off, 0, S - 1)
        valid = (s + off) < n_saved  # (K,)
        tj = ts[jdx]  # (K,)
        yj = ys[jdx]  # (K, n)
        # barycentric weights over the VALID nodes only (pad rows carry
        # t=+inf; excluding them from the products reduces the degree)
        diff = tj[:, None] - tj[None, :]
        offd = off[:, None] != off[None, :]
        prods = jnp.prod(
            jnp.where(offd & valid[None, :], diff, 1.0), axis=1
        )
        w = jnp.where(valid, 1.0 / prods, 0.0)
        d = t - tj
        absd = jnp.abs(d)
        exact = (absd <= 1e-14 * (1.0 + jnp.abs(t))) & valid
        any_exact = jnp.any(exact)
        c = w / jnp.where(exact, 1.0, d)
        c = jnp.where(exact, 0.0, c)
        num = jnp.sum(c[:, None] * yj, axis=0)
        den = jnp.sum(c)
        y_interp = num / den
        # NEAREST exact node only: two recorded rows can fall within the
        # tolerance of each other (tiny accepted steps at large t) and a
        # sum over all exact nodes would double-count
        nearest = jnp.argmin(jnp.where(valid, absd, jnp.inf))
        y_exact = yj[nearest]
        return jnp.where(any_exact, y_exact, y_interp)

    return y_at


def make_polynomial_eval_batched(saved: dict) -> Callable:
    """Trailing-batch variant of ``make_polynomial_eval``.

    ``saved``: t (S, B), n_saved (B,), and the packed yf (S, 2n|3n, B) table
    (only the y rows are read).  Returns ``y_at(t_b) -> (n, B)``."""
    ts, n_saved = saved["t"], saved["n_saved"]
    S, B = ts.shape
    yf = saved["yf"]
    quintic = "fd" in saved
    n = yf.shape[1] // (3 if quintic else 2)
    K = min(POLY_K, S)
    lanes = jnp.arange(B)

    def y_at(t):
        idx = _searchsorted_b(ts, t)  # (B,)
        i = jnp.clip(idx, 0, n_saved - 2)
        s = jnp.clip(i - (K // 2 - 1), 0, jnp.maximum(n_saved - K, 0))
        off = jnp.arange(K)
        jdx = jnp.clip(s[None, :] + off[:, None], 0, S - 1)  # (K, B)
        valid = (s[None, :] + off[:, None]) < n_saved[None, :]
        tj = ts[jdx, lanes[None, :]]  # (K, B)
        # K y-row gathers (n, B) each
        yj = jnp.stack([yf[jdx[k], :n, lanes].T for k in range(K)])  # (K, n, B)
        diff = tj[:, None, :] - tj[None, :, :]  # (K, K, B)
        offd = (off[:, None] != off[None, :])[:, :, None]
        prods = jnp.prod(jnp.where(offd & valid[None], diff, 1.0), axis=1)
        w = jnp.where(valid, 1.0 / prods, 0.0)  # (K, B)
        d = t[None, :] - tj
        absd = jnp.abs(d)
        exact = (absd <= 1e-14 * (1.0 + jnp.abs(t))[None, :]) & valid
        any_exact = jnp.any(exact, axis=0)  # (B,)
        c = jnp.where(exact, 0.0, w / jnp.where(exact, 1.0, d))
        num = jnp.sum(c[:, None, :] * yj, axis=0)  # (n, B)
        den = jnp.sum(c, axis=0)  # (B,)
        y_interp = num / den[None, :]
        # NEAREST exact node only (see make_polynomial_eval)
        nearest = jnp.argmin(jnp.where(valid, absd, jnp.inf), axis=0)  # (B,)
        y_exact = jnp.take_along_axis(
            yj, jnp.broadcast_to(nearest[None, None, :], (1,) + yj.shape[1:]),
            axis=0,
        )[0]
        return jnp.where(any_exact[None, :], y_exact, y_interp)

    return y_at


class AdjointResult(NamedTuple):
    lamda: jnp.ndarray  # (n,)  = dL/dy0
    quad: jnp.ndarray  # (k,)  = dL/dp_subset
    status: jnp.ndarray  # 0 on success
    stats: dict


def adjoint_backward(
    adjoint_rhs: Callable,  # (t, y, lam, p) -> -J^T lam
    adjoint_jac: Callable,  # (t, y, lam, p) -> -J^T
    quad_rhs: Callable,  # (t, y, lam, p) -> lam^T df/dp_subset
    saved: dict,
    t0,
    tvals: jnp.ndarray,
    grads: jnp.ndarray,  # (n_t, n) observation cotangents g_i
    params: jnp.ndarray,
    n_deriv: int,
    options: BDFOptions = BDFOptions(rtol=1e-10, atol=1e-10),
    lamda_end: Optional[jnp.ndarray] = None,
    interpolation: str = "hermite",
) -> AdjointResult:
    """Backward adjoint solve over observation intervals.

    Mirrors reference ``AdjointSolver.solve_backward`` (solver.py:723-784):
    walk the observation times in reverse; at each, inject the observation
    cotangent into lambda, then integrate the adjoint system down to the next
    one (and finally to t0).  ``interpolation`` selects the forward-
    trajectory reconstruction: 'hermite' (CV_HERMITE; cubic or quintic
    depending on the recorded rows) or 'polynomial' (CV_POLYNOMIAL:
    variable-degree Lagrange through the recorded y rows — the reference's
    default mode, solver.py:530-585).
    """
    dtype = saved["y"].dtype
    n = saved["y"].shape[-1]
    n_t = tvals.shape[0]
    tvals = jnp.asarray(tvals, dtype)
    grads = jnp.asarray(grads, dtype)
    t0 = jnp.asarray(t0, dtype)

    if interpolation == "polynomial":
        y_at = make_polynomial_eval(saved)
    elif interpolation == "hermite":
        y_at = make_hermite_eval(saved)
    else:
        raise ValueError(
            f"interpolation must be 'hermite' or 'polynomial', got "
            f"{interpolation!r}"
        )

    # Time-reversed adjoint system: tau = -t
    def rhs_b(tau, lam, p):
        t = -tau
        y = y_at(t)
        return -adjoint_rhs(t, y, lam, p)  # dlam/dtau = +J^T lam

    def jac_b(tau, lam, p):
        t = -tau
        y = y_at(t)
        return -adjoint_jac(t, y, lam, p)  # d(rhs_b)/dlam = +J^T

    def quad_b(tau, lam, p):
        t = -tau
        y = y_at(t)
        return quad_rhs(t, y, lam, p)  # dq/dtau = +lam^T df/dp

    quad_opts = options._replace(quad_err_con=True, save_steps=0)

    if lamda_end is None:
        lamda_end = jnp.zeros((n,), dtype)
    quad0 = jnp.zeros((n_deriv,), dtype)

    # interval endpoints in reverse: from tvals[n_t-1] down through tvals[0],
    # then to t0.  Interval i (scan step i): [upper=rev_t[i], lower=rev_lower[i]]
    rev_t = tvals[::-1]
    rev_g = grads[::-1]
    rev_lower = jnp.concatenate([tvals[::-1][1:], jnp.asarray([t0], dtype)])

    def interval(carry, inp):
        lam, q, status, nsteps, h_prev = carry
        t_hi, t_lo, g = inp
        lam = lam + g  # inject observation cotangent (solver.py:775-776)

        tiny = 1e-14 * (1.0 + jnp.abs(t_hi))
        nontrivial = (t_hi - t_lo) > tiny

        def do_solve(args):
            lam, q, h_prev = args
            res = bdf_solve(
                rhs_b,
                jac_b,
                -t_hi,
                lam,
                params,
                jnp.asarray([-t_lo], dtype),
                quad_opts,
                quad_rhs=quad_b,
                quad0=q,
                # warm-start the step size from the previous interval (the
                # adjoint dynamics don't change discontinuously even though
                # lambda does) — saves the h ramp-up on every reinit
                first_step=h_prev,
            )
            ok = res.status == 0
            lam_new = jnp.where(ok, res.ys[0], jnp.nan)
            q_new = jnp.where(ok, res.quad[0], jnp.nan)
            return lam_new, q_new, res.status, res.stats["n_steps"], res.stats[
                "final_step_size"
            ]

        def skip(args):
            lam, q, h_prev = args
            return lam, q, jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), h_prev

        lam, q, st, ns, h_prev = lax.cond(nontrivial, do_solve, skip, (lam, q, h_prev))
        status = jnp.maximum(status, st)
        return (lam, q, status, nsteps + ns, h_prev), None

    carry0 = (
        lamda_end,
        quad0,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(-1.0, dtype),  # sentinel: automatic h0 on first interval
    )
    (lam, q, status, nsteps, _), _ = lax.scan(
        interval, carry0, (rev_t, rev_lower, rev_g)
    )

    # checkpoint-buffer overflow -> the recorded trajectory is incomplete and
    # the Hermite reconstruction silently wrong; poison instead.
    overflow = saved.get("overflow", saved["n_saved"] >= saved["t"].shape[0])
    lam = jnp.where(overflow, jnp.nan, lam)
    q = jnp.where(overflow, jnp.nan, q)
    status = jnp.where(overflow, 99, status)

    return AdjointResult(
        lamda=lam,
        quad=q,
        status=status.astype(jnp.int32),
        stats=dict(n_backward_steps=nsteps),
    )


def adjoint_backward_transition_batched(
    rhs: Callable,  # single-instance forward f(t, y, p)
    adjoint_jac: Callable,  # (t, y, lam, p) -> -J^T
    dfdp: Callable,  # (t, y, p) -> (n, n_p_deriv) parameter Jacobian
    t0,
    tvals: jnp.ndarray,  # (n_t,) shared, ascending, > t0
    grads: jnp.ndarray,  # (B, n_t, n) observation cotangents
    params: jnp.ndarray,  # (B, n_p)
    n_deriv: int,
    y_end: jnp.ndarray,  # (B, n) = y(tvals[-1]) from the forward emissions
    options: BDFOptions = BDFOptions(rtol=1e-10, atol=1e-10),
) -> AdjointResult:
    """Fundamental-matrix ("transition") adjoint: ONE smooth backward solve.

    The adjoint system lambda' = -J^T lambda is linear in lambda, so instead
    of injecting each observation cotangent g_k into a running lambda (which
    forces an h-collapse + ramp at every observation: the multistep history
    cannot represent a state jump at tolerance scale, whatever order is
    retained), integrate the n x n fundamental matrix of the backward system

        dM/dtau = J^T(y(t)) M,   M(tau0) = I,   tau = -t

    together with y itself (backsolve) and the matrix quadrature
    W(tau) = int_tau0^tau M^T (df/dp) ds — a SMOOTH system with no events.
    Every cotangent then composes algebraically from the emitted M, W at the
    observation times:

        x_k      = M(tau_k)^{-1} g_k
        lambda   = M(tau1) sum_k x_k                      (= dL/dy0)
        dL/dp    = sum_k x_k^T (W(tau1) - W(tau_k))

    Measured on the LV north-star config: the backward step count drops to
    the no-event count (~300 vs ~490) because nothing ever interrupts the
    step/order machinery.

    Scaling: the backward state is n + n^2 (+ n*n_deriv quadrature rows), so
    this path is for SMALL n (the typical PyMC ODE: 2-20 states).  Accuracy
    degrades with cond(M) (transition-matrix composition), which is modest
    for non-stiff dynamics; stiff/strongly-contracting systems should use the
    'hermite' checkpoint path.

    Reference semantics covered: AdjointSolver.solve_backward
    (/root/reference/sunode/solver.py:723-784) — same gradients, produced by
    superposition instead of interval-wise re-initialization.
    """
    from sunode_tpu.ops.adams_batched import adams_solve_batched
    from sunode_tpu.ops.linalg import solve_dense

    dtype = grads.dtype
    B, n_t, n = grads.shape
    tvals = jnp.asarray(tvals, dtype)
    t0 = jnp.asarray(t0, dtype)
    params_t = jnp.asarray(params, dtype)

    rhs_b = jax.vmap(rhs, in_axes=(0, 1, 1), out_axes=1)
    aj_jac_b = jax.vmap(adjoint_jac, in_axes=(0, 1, 1, 1), out_axes=2)
    dfdp_b = jax.vmap(dfdp, in_axes=(0, 1, 1), out_axes=2)

    n_state = n + n * n  # [y | vec(M)]
    m_quad = n * n_deriv  # vec(W)

    def split(z):
        y = z[:n]
        M = z[n:].reshape(n, n, -1)
        return y, M

    def rhs_c(tau, z, p):
        t = -tau
        y, M = split(z)
        lam_dummy = jnp.zeros_like(y)
        matJT = -aj_jac_b(t, y, lam_dummy, p)  # J^T, (n, n, B)
        # dM/dtau[i, j] = sum_k J^T[i, k] M[k, j]
        dM = jnp.sum(matJT[:, :, None, :] * M[None, :, :, :], axis=1)
        dy = -rhs_b(t, y, p)
        return jnp.concatenate([dy, dM.reshape(n * n, -1)])

    def quad_c(tau, z, p):
        t = -tau
        y, M = split(z)
        Bm = dfdp_b(t, y, p)  # (n, n_deriv, B)
        # dW/dtau[i, j] = sum_k M[k, i] B[k, j]
        dW = jnp.sum(M[:, :, None, :] * Bm[:, None, :, :], axis=0)
        return dW.reshape(n * n_deriv, -1)

    quad_opts = options._replace(quad_err_con=True, save_steps=0)

    eyeM = jnp.broadcast_to(jnp.eye(n, dtype=dtype).reshape(n * n, 1), (n * n, B))
    z0 = jnp.concatenate([jnp.asarray(y_end, dtype).T, eyeM]).T  # (B, n_state)
    q0 = jnp.zeros((B, m_quad), dtype)

    # emission times: every observation except the last (M=I, W=0 there),
    # plus the backward terminal -t0
    tv_solver = jnp.concatenate([(-tvals[:-1])[::-1], (-t0)[None]])

    res = adams_solve_batched(
        rhs_c,
        -tvals[-1],
        z0,
        params_t,
        tv_solver,
        quad_opts,
        quad_rhs=quad_c,
        quad0=q0,
        batched_fns=True,
    )
    # emissions: ys (B, n_t, n_state), quad (B, n_t, m_quad)
    ok = res.status == 0
    ys_e = res.ys
    W_e = res.quad.reshape(B, n_t, n, n_deriv)
    M_e = ys_e[:, :, n:].reshape(B, n_t, n, n)

    M_end = M_e[:, -1]  # (B, n, n) at tau1 = -t0
    W_end = W_e[:, -1]

    # x_k = M(tau_k)^{-1} g_k.  Solver emission index j corresponds to
    # observation index k = n_t-2-j (tv_solver reverses tvals[:-1]); the last
    # observation k = n_t-1 is the backward start where M = I, W = 0.
    g_rev = jnp.flip(grads[:, :-1, :], axis=1)  # (B, n_t-1, n), obs k=n_t-2..0
    M_obs = M_e[:, : n_t - 1]  # (B, n_t-1, n, n)
    W_obs = W_e[:, : n_t - 1]

    solve2 = jax.vmap(jax.vmap(solve_dense))  # over (B, n_t-1)
    x = solve2(M_obs, g_rev)  # (B, n_t-1, n)
    x_last = grads[:, -1, :]  # M = I at the start
    x_sum = jnp.sum(x, axis=1) + x_last  # (B, n)

    # Conditioning monitor (fail-loudly contract, ref basic.py:84-103).
    # Two cheap per-solve diagnostics, flagged as status 97 -> NaN poison
    # downstream instead of returning silently degraded gradients:
    #   * relative residual |M x - g| / |g| — catches elimination error in
    #     the dense solve (~ eps * cond for unlucky g);
    #   * growth factor ||M||_inf * ||x||_inf / ||g||_inf — the LU solve is
    #     backward-stable (error in x ~ eps * ||M|| * ||x||), so eps * growth
    #     bounds the relative error the superposition lam = M_end sum x_k
    #     inherits; contracting/stiff dynamics blow ||M|| up exponentially
    #     while x stays O(|g| / m_small), making growth ~ cond(M).
    # Gates are DTYPE-AWARE: a healthy solve leaves rel_resid ~ few * eps,
    # so the f64 thresholds (rel_resid 1e-6 / growth 1e10 ~ 10 lost digits)
    # would false-flag nearly every f32 solve (measured median f32
    # rel_resid ~ 8 eps).  In f32 the same lost-digits budget is ~1e-3 /
    # 3e4 (predicted composition error eps * growth ~ 4e-3 at the gate —
    # the accuracy class of an f32 run anyway).
    if float(jnp.finfo(dtype).eps) < 1e-10:
        resid_gate, growth_gate = 1e-6, 1e10
    else:
        resid_gate, growth_gate = 1e-3, 3e4
    # division floor must be representable in the working dtype: a bare
    # 1e-300 underflows to +0.0 in f32, turning an all-zero cotangent row
    # into 0/0 = NaN and silently disabling the `ill` gate (NaN > gate is
    # False) — use the dtype's own tiny instead
    div_floor = float(jnp.finfo(dtype).tiny)
    if n_t > 1:
        resid = jnp.einsum("bkij,bkj->bki", M_obs, x) - g_rev
        g_mag = jnp.max(jnp.abs(g_rev), axis=2)  # (B, n_t-1)
        rel_resid = jnp.max(
            jnp.max(jnp.abs(resid), axis=2) / (g_mag + div_floor), axis=1
        )
        growth = jnp.max(
            jnp.max(jnp.abs(M_obs), axis=(2, 3))
            * jnp.max(jnp.abs(x), axis=2)
            / (g_mag + div_floor),
            axis=1,
        )
    else:
        rel_resid = jnp.zeros((B,), dtype)
        growth = jnp.ones((B,), dtype)
    # M_end enters every lane's composition even when n_t == 1
    growth = jnp.maximum(
        growth,
        jnp.max(jnp.abs(M_end), axis=(1, 2))
        * jnp.max(jnp.abs(x_sum), axis=1)
        / (jnp.max(jnp.abs(grads), axis=(1, 2)) + div_floor),
    )
    ill = (rel_resid > resid_gate) | (growth > growth_gate)

    lam = jnp.einsum("bij,bj->bi", M_end, x_sum)
    # dL/dp = sum_k x_k^T (W_end - W_k); for the last obs W_k = 0
    dW = W_end[:, None] - W_obs  # (B, n_t-1, n, n_deriv)
    q = jnp.einsum("bki,bkij->bj", x, dW) + jnp.einsum(
        "bi,bij->bj", x_last, W_end
    )

    ok = ok & ~ill
    status = jnp.where(
        ill & (res.status == 0), jnp.asarray(97, jnp.int32), res.status
    )
    lam = jnp.where(ok[:, None], lam, jnp.nan)
    q = jnp.where(ok[:, None], q, jnp.nan)
    return AdjointResult(
        lamda=lam,
        quad=q,
        status=status.astype(jnp.int32),
        stats=dict(
            n_backward_steps=res.stats["n_steps"],
            transition_rel_residual=rel_resid,
            transition_growth=growth,
        ),
    )


# ---------------------------------------------------------------------------
# Batch-native backward pass (companion to ops/bdf_batched.py)
# ---------------------------------------------------------------------------
def _searchsorted_b(ts, t):
    """Rightmost i with ts[i] <= t, per lane.  ts: (S, B) ascending with +inf
    padding; t: (B,).

    Uses a single vectorized comparison+reduce pass instead of a binary
    search: each of the log2(S) sequential gathers can cost as much as the
    whole O(S*B) fused pass at checkpoint-table sizes.  (Chosen when f64 was
    emulated in software; the GPU ledger has yet to confirm it.)  Falls back
    to binary search for very large tables."""
    S, B = ts.shape
    if S <= 8192:
        return jnp.sum((ts <= t[None, :]).astype(jnp.int32), axis=0) - 1
    lanes = jnp.arange(B)
    lo = jnp.zeros((B,), jnp.int32)
    hi = jnp.full((B,), S, jnp.int32)
    # S+1 possible insertion points -> ceil(log2(S+1)) halvings.  With
    # ceil(log2(S)) a power-of-two S left the final candidate untested
    # (S=16384 returned -1 where numpy searchsorted gives 0).  Updates are
    # guarded by lo < hi so extra iterations are no-ops (an unguarded
    # iteration at lo == hi == S gathers out of bounds, which JAX clamps,
    # and pushes lo past S).
    for _ in range(max(1, int(np.ceil(np.log2(S + 1))))):
        mid = (lo + hi) // 2
        vals = ts[jnp.minimum(mid, S - 1), lanes]
        open_ = lo < hi
        go_right = open_ & (vals <= t)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(open_ & ~go_right, mid, hi)
    return lo - 1


def make_hermite_eval_batched(saved: dict) -> Callable:
    """Trailing-batch cubic Hermite evaluator.

    ``saved``: t (S, B), n_saved (B,), and either a packed tyf (S, 1+2n, B)
    or split y/f (S, n, B) arrays — the layout produced by the batched
    cores.  Returns ``y_at(t_b) -> (n, B)``.

    With the packed buffer each evaluation is exactly two row gathers
    (the bracketing rows) instead of six strided ones."""
    ts, n_saved = saved["t"], saved["n_saved"]

    if "yf" in saved:
        # two wide row-gathers from the (S, 2n|3n, B) y|f[|fd] table + two
        # scalar gathers from ts, in place of six strided gathers (chosen
        # when f64 was emulated in software; the GPU ledger has yet to
        # confirm it)
        yf = saved["yf"]
        S, W, B = yf.shape
        quintic = "fd" in saved
        Ls = saved.get("L")  # (S, B) per-row ||J|| for the stiffness gate
        n = W // 3 if quintic else W // 2
        lanes = jnp.arange(B)

        def y_at(t):
            idx = _searchsorted_b(ts, t)
            i = jnp.clip(idx, 0, n_saved - 2)
            t0 = ts[i, lanes]
            t1 = ts[i + 1, lanes]
            r0 = yf[i, :, lanes].T  # (W-1, B)
            r1 = yf[i + 1, :, lanes].T
            y0, f0 = r0[:n], r0[n : 2 * n]
            y1, f1 = r1[:n], r1[n : 2 * n]
            h = t1 - t0
            tau = jnp.clip((t - t0) / h, 0.0, 1.0)
            h00 = (1 + 2 * tau) * (1 - tau) ** 2
            h10 = tau * (1 - tau) ** 2
            h01 = tau**2 * (3 - 2 * tau)
            h11 = tau**2 * (tau - 1)
            cubic = (
                h00[None] * y0
                + (h10 * h)[None] * f0
                + h01[None] * y1
                + (h11 * h)[None] * f1
            )
            if not quintic:
                return cubic
            fd0, fd1 = r0[2 * n :], r1[2 * n :]
            H0, H1, H2, H3, H4, H5 = _quintic_basis(tau)
            h2 = h * h
            quin = (
                H0[None] * y0
                + (H1 * h)[None] * f0
                + (H2 * h2)[None] * fd0
                + H3[None] * y1
                + (H4 * h)[None] * f1
                + (H5 * h2)[None] * fd1
            )
            if Ls is None:
                return quin
            # per-lane stiffness gate h*L <= 1 — the h^2*(J f) term
            # amplifies node error by (hL)^2 in stiff regions; cubic
            # fallback beyond (see make_hermite_eval / cvbdf.cpp)
            ok = h * jnp.maximum(Ls[i, lanes], Ls[i + 1, lanes]) <= 1.0
            return jnp.where(ok[None], quin, cubic)

        return y_at

    # (a former raw-'tyf' pre-finalize branch lived here; it assumed cubic
    # W = 1+2n rows and would mis-slice the quintic default layout — removed
    # as dead code rather than left silently wrong)
    ys, fs = saved["y"], saved["f"]
    S, n, B = ys.shape
    lanes = jnp.arange(B)

    def y_at(t):
        idx = _searchsorted_b(ts, t)
        i = jnp.clip(idx, 0, n_saved - 2)
        t0 = ts[i, lanes]
        t1 = ts[i + 1, lanes]
        h = t1 - t0
        tau = jnp.clip((t - t0) / h, 0.0, 1.0)  # (B,)
        y0 = ys[i, :, lanes].T  # (n, B)
        y1 = ys[i + 1, :, lanes].T
        f0 = fs[i, :, lanes].T
        f1 = fs[i + 1, :, lanes].T
        h00 = (1 + 2 * tau) * (1 - tau) ** 2
        h10 = tau * (1 - tau) ** 2
        h01 = tau**2 * (3 - 2 * tau)
        h11 = tau**2 * (tau - 1)
        return (
            h00[None] * y0 + (h10 * h)[None] * f0 + h01[None] * y1 + (h11 * h)[None] * f1
        )

    return y_at


def adjoint_backward_batched(
    adjoint_rhs: Callable,  # single-instance (t, y, lam, p) -> -J^T lam
    adjoint_jac: Callable,  # (t, y, lam, p) -> -J^T
    quad_rhs: Callable,  # (t, y, lam, p) -> lam^T df/dp_subset
    saved: dict,  # trailing-batch layout from bdf_solve_batched
    t0,
    tvals: jnp.ndarray,  # (n_t,) shared
    grads: jnp.ndarray,  # (B, n_t, n)
    params: jnp.ndarray,  # (B, n_p)
    n_deriv: int,
    options: BDFOptions = BDFOptions(rtol=1e-10, atol=1e-10),
    method: str = "BDF",
    interpolation: str = "hermite",
    rhs: Optional[Callable] = None,  # forward f(t, y, p); required for 'resolve'
    y_end: Optional[jnp.ndarray] = None,  # (B, n) y(tvals[-1]); for 'resolve'
) -> AdjointResult:
    """Batch-native interval-wise backward solve (see ``adjoint_backward``).

    ``method='ADAMS'`` integrates the backward adjoint system with the
    functional-iteration Adams core — appropriate when the forward problem is
    non-stiff (the adjoint inherits the stiffness of the forward dynamics).

    ``interpolation`` selects how the forward trajectory y(t) enters the
    backward RHS:
      'hermite'  — CVODES CV_HERMITE analog: cubic Hermite over the recorded
                   (t, y, f) checkpoints (16_cvodes.h:40-41).  Robust for any
                   stiffness, but the reconstruction is only C^1 at each
                   recorded step boundary — those derivative kinks cap the
                   backward step size (measured ~2.3x the forward step count
                   on LV at rtol 1e-8).
      'resolve'  — re-integrate y(t) backward as part of the adjoint system
                   z = [y; lambda] from y(t_end) (the "backsolve" adjoint).
                   Smooth RHS -> forward-like step counts, no checkpoint
                   table, gathers, or overflow.  Only appropriate for
                   non-stiff dynamics (backward y integration of a
                   dissipative system is unstable); requires ``rhs`` and
                   ``y_end``.
    """
    from sunode_tpu.ops.adams_batched import adams_solve_batched
    from sunode_tpu.ops.bdf_batched import bdf_solve_batched

    dtype = grads.dtype
    if interpolation == "resolve":
        if method != "ADAMS":
            raise NotImplementedError("interpolation='resolve' requires method='ADAMS'")
        if rhs is None or y_end is None:
            raise ValueError("interpolation='resolve' requires rhs and y_end")
        B, n_t_g, n = grads.shape
        if n_t_g != tvals.shape[0]:
            raise ValueError(
                f"grads has {n_t_g} observation rows but tvals has "
                f"{tvals.shape[0]} times"
            )
        tvals = jnp.asarray(tvals, dtype)
        t0 = jnp.asarray(t0, dtype)
        params_t = jnp.asarray(params, dtype)
        rhs_b = jax.vmap(rhs, in_axes=(0, 1, 1), out_axes=1)
        aj_rhs_b = jax.vmap(adjoint_rhs, in_axes=(0, 1, 1, 1), out_axes=1)
        q_rhs_b = jax.vmap(quad_rhs, in_axes=(0, 1, 1, 1), out_axes=1)

        def rhs_c(tau, z, p):
            t = -tau
            y, lam = z[:n], z[n:]
            # dy/dtau = -f(t, y);  dlam/dtau = +J^T lam = -adjoint_rhs
            return jnp.concatenate([-rhs_b(t, y, p), -aj_rhs_b(t, y, lam, p)])

        def quad_c(tau, z, p):
            t = -tau
            return q_rhs_b(t, z[:n], z[n:], p)

        quad_opts = options._replace(quad_err_con=True, save_steps=0)
        z0 = jnp.concatenate([jnp.asarray(y_end, dtype), grads[:, -1, :]], axis=1)
        q0 = jnp.zeros((B, n_deriv), dtype)
        ev_times = (-tvals[:-1])[::-1]
        ev_deltas = jnp.flip(grads[:, :-1, :], axis=1)  # (B, n_e, n)
        ev_deltas = jnp.moveaxis(ev_deltas, 0, 2)  # (n_e, n, B)
        # lambda rows jump at observations; y rows are continuous
        ev_deltas = jnp.concatenate([jnp.zeros_like(ev_deltas), ev_deltas], axis=1)

        res = adams_solve_batched(
            rhs_c,
            -tvals[-1],
            z0,
            params_t,
            jnp.asarray([-t0], dtype),
            quad_opts,
            quad_rhs=quad_c,
            quad0=q0,
            batched_fns=True,
            inject_times=ev_times,
            inject_deltas=ev_deltas,
        )
        zfin = res.stats["final_state"]  # (B, 2n + n_deriv)
        ok = res.status == 0
        y_back = zfin[:, :n]
        lam = jnp.where(ok[:, None], zfin[:, n : 2 * n], jnp.nan)
        q = jnp.where(ok[:, None], zfin[:, 2 * n :], jnp.nan)
        return AdjointResult(
            lamda=lam,
            quad=q,
            status=res.status.astype(jnp.int32),
            stats=dict(
                n_backward_steps=res.stats["n_steps"],
                n_attempts=res.stats["n_attempts"],
                # reconstruction quality indicator: the backward-resolved
                # y(t0) is an independent re-computation of the initial state
                y0_resolved=y_back,
            ),
        )

    dtype = saved["y"].dtype
    S, n, B = saved["y"].shape
    n_t = tvals.shape[0]
    tvals = jnp.asarray(tvals, dtype)
    grads = jnp.asarray(grads, dtype)
    t0 = jnp.asarray(t0, dtype)
    params_t = jnp.asarray(params, dtype)  # (B, n_p) leading; core transposes

    if interpolation == "polynomial":
        y_at = make_polynomial_eval_batched(saved)
    elif interpolation == "hermite":
        y_at = make_hermite_eval_batched(saved)
    else:
        raise ValueError(
            f"interpolation must be 'hermite', 'polynomial' or 'resolve', "
            f"got {interpolation!r}"
        )
    aj_rhs_b = jax.vmap(adjoint_rhs, in_axes=(0, 1, 1, 1), out_axes=1)
    aj_jac_b = jax.vmap(adjoint_jac, in_axes=(0, 1, 1, 1), out_axes=2)
    q_rhs_b = jax.vmap(quad_rhs, in_axes=(0, 1, 1, 1), out_axes=1)

    def rhs_b(tau, lam, p):
        t = -tau
        y = y_at(t)
        return -aj_rhs_b(t, y, lam, p)

    def jac_b(tau, lam, p):
        t = -tau
        y = y_at(t)
        return -aj_jac_b(t, y, lam, p)

    def quad_b(tau, lam, p):
        t = -tau
        y = y_at(t)
        return q_rhs_b(t, y, lam, p)

    quad_opts = options._replace(quad_err_con=True, save_steps=0)

    if method == "ADAMS":
        # FUSED backward: one loop over the whole backward span with
        # in-loop cotangent injections (history reset + warm step size at
        # each observation) instead of one cold solver start per interval.
        lam0 = grads[:, -1, :]  # inject the last observation at the start
        q0 = jnp.zeros((B, n_deriv), dtype)
        ev_times = (-tvals[:-1])[::-1]  # ascending tau events
        ev_deltas = jnp.flip(grads[:, :-1, :], axis=1)  # (B, n_e, n)
        ev_deltas = jnp.moveaxis(ev_deltas, 0, 2)  # (n_e, n, B)

        # y(t) along the recorded forward trajectory is independent of
        # lambda, so it is staged ONCE per step attempt instead of once per
        # corrector iteration (the Hermite gather is the single most
        # expensive op in the backward loop)
        def stage_y(tau):
            return y_at(-tau)

        def rhs_staged(tau, lam, p, y):
            return -aj_rhs_b(-tau, y, lam, p)

        def quad_staged(tau, lam, p, y):
            return q_rhs_b(-tau, y, lam, p)

        res = adams_solve_batched(
            rhs_staged,
            -tvals[-1],
            lam0,
            params_t,
            jnp.asarray([-t0], dtype),
            quad_opts,
            quad_rhs=quad_staged,
            quad0=q0,
            batched_fns=True,
            inject_times=ev_times,
            inject_deltas=ev_deltas,
            stage_fn=stage_y,
        )
        zfin = res.stats["final_state"]  # (B, n + n_deriv)
        ok = res.status == 0
        lam = jnp.where(ok[:, None], zfin[:, :n], jnp.nan)
        q = jnp.where(ok[:, None], zfin[:, n:], jnp.nan)
        overflow = saved["overflow"]
        lam = jnp.where(overflow[:, None], jnp.nan, lam)
        q = jnp.where(overflow[:, None], jnp.nan, q)
        status = jnp.where(overflow, 99, res.status)
        return AdjointResult(
            lamda=lam,
            quad=q,
            status=status.astype(jnp.int32),
            stats=dict(n_backward_steps=res.stats["n_steps"]),
        )

    lam0 = jnp.zeros((B, n), dtype)
    q0 = jnp.zeros((B, n_deriv), dtype)

    rev_t = tvals[::-1]
    rev_g = jnp.flip(grads, axis=1)  # (B, n_t, n) reversed over time
    rev_lower = jnp.concatenate([tvals[::-1][1:], t0[None]])

    def interval(carry, inp):
        lam, q, status, nsteps, h_prev = carry
        t_hi, t_lo, g = inp  # g: (B, n)
        lam = lam + g

        tiny = 1e-14 * (1.0 + jnp.abs(t_hi))
        nontrivial = (t_hi - t_lo) > tiny  # shared scalar

        def do_solve(args):
            # (method == 'ADAMS' already returned via the fused path above)
            lam, q, h_prev = args
            res = bdf_solve_batched(
                rhs_b,
                jac_b,
                -t_hi,
                lam,
                params_t,
                jnp.asarray([-t_lo], dtype),
                quad_opts,
                quad_rhs=quad_b,
                quad0=q,
                first_step=h_prev,
                batched_fns=True,
            )
            ok = res.status == 0  # (B,)
            lam_new = jnp.where(ok[:, None], res.ys[:, 0, :], jnp.nan)
            q_new = jnp.where(ok[:, None], res.quad[:, 0, :], jnp.nan)
            return lam_new, q_new, res.status, res.stats["n_steps"], res.stats[
                "final_step_size"
            ]

        def skip(args):
            lam, q, h_prev = args
            return lam, q, jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32), h_prev

        lam, q, st, ns, h_prev = lax.cond(
            nontrivial, do_solve, skip, (lam, q, h_prev)
        )
        status = jnp.maximum(status, st)
        return (lam, q, status, nsteps + ns, h_prev), None

    carry0 = (
        lam0,
        q0,
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B,), -1.0, dtype),
    )
    (lam, q, status, nsteps, _), _ = lax.scan(
        interval, carry0, (rev_t, rev_lower, jnp.swapaxes(rev_g, 0, 1))
    )

    overflow = saved["overflow"]
    lam = jnp.where(overflow[:, None], jnp.nan, lam)
    q = jnp.where(overflow[:, None], jnp.nan, q)
    status = jnp.where(overflow, 99, status)

    return AdjointResult(
        lamda=lam,  # (B, n)
        quad=q,  # (B, n_deriv)
        status=status.astype(jnp.int32),
        stats=dict(n_backward_steps=nsteps),
    )
