"""Batch-native Adams-Moulton integrator (non-stiff fast path).

Structure-of-arrays companion to ``ops/adams.py``, built like
``ops/bdf_batched.py`` (trailing batch axis, shared loop indices, unrolled
masked iterations — see that module for the rationale).  Functional
iteration means NO Jacobians, NO factorizations and NO linear solves: each
attempt is a handful of fused elementwise passes, which makes this the
fastest path for non-stiff workloads (Lotka-Volterra chains, SIR
epidemiological families) at roughly half the steps of BDF.

Supports a quadrature block (combined z = [y | q]; quadratures ride the same
corrector since they don't couple back), which is what the adjoint backward
pass needs.

Sensitivities: genuine CV_STAGGERED (16_cvodes.h:31-33) via ``sens_rhs``/
``sens0``: the state corrector converges and passes its OWN error test
first, then a per-lane-gated functional corrector advances the sensitivity
block against the converged state (z = [y | q | S]; the whole sens phase is
a real ``lax.cond`` so an attempt where every lane's state failed evaluates
no sensitivity RHS at all — same sequencing as ``ops/bdf_batched.py``).
CV_SIMULTANEOUS callers should instead augment the state vector with
vec(S) and pass the augmented rhs (triangular coupling: functional
iteration converges exactly as for y) — see ``Solver._adams_sens_setup``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sunode_tpu.ops.adams import (
    _GAMMA,
    _GAMMA_STAR,
    _C_INT,
    FUNCTIONAL_MAXITER,
)
from sunode_tpu.ops.bdf import (
    MAX_CONSECUTIVE_FAILS,
    MIN_FACTOR,
    MAX_FACTOR,
    STATUS,
    THRESH,
    BDFOptions,
    BDFResult,
)

__all__ = ["adams_solve_batched"]


def adams_solve_batched(
    rhs: Callable,
    t0,
    y0: jnp.ndarray,  # (B, n)
    params: jnp.ndarray,  # (B, n_p)
    tvals: jnp.ndarray,  # (n_t,) shared or (B, n_t) per-lane grids
    options: BDFOptions = BDFOptions(),
    *,
    quad_rhs: Optional[Callable] = None,
    quad0: Optional[jnp.ndarray] = None,  # (B, m)
    sens_rhs: Optional[Callable] = None,  # (t, y, S, p) -> (k, n), staggered
    sens0: Optional[jnp.ndarray] = None,  # (B, k, n)
    root_fn: Optional[Callable] = None,  # (t, y, p) -> (nrt,) event functions
    root_cap: int = 8,
    root_terminal: bool = True,
    root_directions: Optional[Any] = None,
    first_step: Optional[Any] = None,
    batched_fns: bool = False,
    inject_times: Optional[jnp.ndarray] = None,  # (n_e,) ascending, shared
    inject_deltas: Optional[jnp.ndarray] = None,  # (n_e, n, B) added to y
    stage_fn: Optional[Callable] = None,  # t(B,) -> aux, computed ONCE per attempt
) -> BDFResult:
    """Batched Adams solve; outputs leading-batch like ``bdf_solve_batched``."""
    dtype = jnp.result_type(y0.dtype, jnp.float32)
    y0 = jnp.asarray(y0, dtype).T  # (n, B)
    n, B = y0.shape
    # t0 may be per-lane (B,) — resume-in-place support (see bdf_batched)
    t0 = jnp.broadcast_to(jnp.asarray(t0, dtype), (B,))
    tvals = jnp.asarray(tvals, dtype)
    # per-lane observation grids: tvals may be (B, n_t) — each lane emits on
    # its own (ascending) grid (ragged datasets; pad a lane's grid with
    # copies of its last time).  Shared (n_t,) stays the fast layout.
    per_lane_tvals = tvals.ndim == 2
    if per_lane_tvals:
        tvals_tb = tvals.T  # (n_t, B)
        n_t = tvals_tb.shape[0]
        t_end = tvals_tb[-1]  # (B,)

        def _t_emit(i_out):  # (B,) indices -> (B,) per-lane times
            idx = jnp.minimum(i_out, n_t - 1)
            return jnp.take_along_axis(tvals_tb, idx[None, :], axis=0)[0]

    else:
        tvals_tb = tvals[:, None]
        n_t = tvals.shape[0]
        t_end = tvals[-1]

        def _t_emit(i_out):
            return tvals[jnp.minimum(i_out, n_t - 1)]

    params = jnp.asarray(params, dtype).T

    with_inject = inject_times is not None
    if with_inject:
        inject_times = jnp.asarray(inject_times, dtype)
        n_ev = inject_times.shape[0]

    with_quad = quad_rhs is not None
    m_quad = quad0.shape[1] if with_quad else 0
    # staggered sensitivities append the S block AFTER the quad rows
    # (z = [y | q | S]) so the state+quad corrector rows stay contiguous
    with_sens = sens_rhs is not None
    k_sens = sens0.shape[1] if with_sens else 0
    n_S = k_sens * n
    n_yq = n + m_quad
    nz = n_yq + n_S
    sl_y = slice(0, n)
    sl_Q = slice(n, n_yq)
    sl_S = slice(n_yq, nz)
    if with_sens:
        assert inject_times is None and stage_fn is None, (
            "staggered sensitivities do not combine with the adjoint "
            "backward machinery"
        )
    with_roots = root_fn is not None
    if with_roots:
        assert inject_times is None and stage_fn is None, (
            "rootfinding does not combine with the adjoint backward "
            "machinery"
        )
        if batched_fns:
            root_b = root_fn  # (t (B,), y (n, B), p (n_p, B)) -> (nrt, B)
        else:
            root_b = jax.vmap(
                lambda tt, yy, pp: jnp.asarray(
                    root_fn(tt, yy, pp), dtype
                ).reshape(-1),
                in_axes=(0, 1, 1),
                out_axes=1,
            )

    P_MAX = min(options.adams_max_order, 12)
    KAB = P_MAX + 3  # DF rows 0..p+2

    if batched_fns:
        rhs_b = rhs
        quad_rhs_b = quad_rhs
        sens_rhs_b = sens_rhs
    else:
        rhs_b = jax.vmap(rhs, in_axes=(0, 1, 1), out_axes=1)
        if with_quad:
            quad_rhs_b = jax.vmap(quad_rhs, in_axes=(0, 1, 1), out_axes=1)
        if with_sens:
            sens_rhs_b = jax.vmap(sens_rhs, in_axes=(0, 1, 2, 1), out_axes=2)
    if with_quad:
        quad0_t = jnp.asarray(quad0, dtype).T
    if with_sens:
        S0_t = jnp.asarray(sens0, dtype).transpose(1, 2, 0)  # (k, n, B)

    with_stage = stage_fn is not None

    def fz(t, y, stage=None):
        """Combined derivative [f(y) | g(y)] -> (nz, B).

        ``stage`` is per-attempt precomputed context (e.g. the interpolated
        forward trajectory in the adjoint backward pass — it does NOT depend
        on the iterated state, so it is evaluated once per attempt rather
        than once per corrector iteration)."""
        if with_stage:
            f = rhs_b(t, y, params, stage)
            if with_quad:
                g = quad_rhs_b(t, y, params, stage)
                return jnp.concatenate([f, g])
            return f
        f = rhs_b(t, y, params)
        if with_quad:
            g = quad_rhs_b(t, y, params)
            return jnp.concatenate([f, g])
        return f

    # scalar or per-state (n,) vector rtol (CVodeVVtolerances analog;
    # see ops/bdf.py) — heuristics use the tightest component
    rtol = jnp.broadcast_to(jnp.asarray(options.rtol, dtype), (n,))
    rtol_s = jnp.min(rtol)
    atol = jnp.broadcast_to(jnp.asarray(options.atol, dtype), (n,))
    gamma = jnp.asarray(_GAMMA, dtype)
    gamma_star_abs = jnp.asarray(np.abs(_GAMMA_STAR), dtype)

    # combined error weights over z
    n_blocks = (
        1
        + (1 if (with_quad and options.quad_err_con) else 0)
        + (k_sens if (with_sens and options.sens_err_con) else 0)
    )
    v_parts = [jnp.full((n,), 1.0 / (n * n_blocks), dtype)]
    atol_parts = [atol]
    rtol_parts = [rtol]
    if with_quad:
        quad_rtol = (
            jnp.asarray(options.quad_rtol, dtype)
            if options.quad_rtol is not None
            else rtol_s
        )
        quad_atol = jnp.broadcast_to(
            jnp.asarray(
                options.quad_atol if options.quad_atol is not None else options.atol,
                dtype,
            ),
            (m_quad,),
        )
        atol_parts.append(quad_atol)
        rtol_parts.append(jnp.full((m_quad,), quad_rtol, dtype))
        v_parts.append(
            jnp.full(
                (m_quad,),
                (1.0 / (m_quad * n_blocks)) if options.quad_err_con else 0.0,
                dtype,
            )
        )
    if with_sens:
        # CVodeSensEEtolerances analog: atol_S[k] = atol / pbar_k (see
        # ops/bdf_batched.py — identical block structure)
        pbar = (
            jnp.broadcast_to(jnp.asarray(options.sens_pbar, dtype), (k_sens,))
            if options.sens_pbar is not None
            else jnp.ones((k_sens,), dtype)
        )
        atol_parts.append((atol[None, :] / pbar[:, None]).reshape(-1))
        rtol_parts.append(jnp.tile(rtol, k_sens))
        v_parts.append(
            jnp.full(
                (n_S,),
                (1.0 / (n * n_blocks)) if options.sens_err_con else 0.0,
                dtype,
            )
        )
    atol_z = jnp.concatenate(atol_parts) if len(atol_parts) > 1 else atol_parts[0]
    rtol_z = jnp.concatenate(rtol_parts) if len(rtol_parts) > 1 else rtol_parts[0]
    v_err = jnp.concatenate(v_parts) if len(v_parts) > 1 else v_parts[0]

    if options.constraints is not None:
        constraints = jnp.broadcast_to(jnp.asarray(options.constraints, dtype), (n,))
    else:
        constraints = None

    newton_tol = options.newton_tol_factor * jnp.maximum(
        10 * jnp.finfo(dtype).eps / rtol_s, jnp.minimum(0.03, jnp.sqrt(rtol_s))
    )

    t0_b = t0
    stage0 = stage_fn(t0_b) if with_stage else None
    if with_stage:
        f0 = rhs_b(t0_b, y0, params, stage0)
    else:
        f0 = rhs_b(t0_b, y0, params)
    fz0 = fz(t0_b, y0, stage0)
    bad_init = ~(jnp.all(jnp.isfinite(y0), axis=0) & jnp.all(jnp.isfinite(f0), axis=0))

    # initial step (Hairer-Wanner, order-1 estimate)
    scale0 = atol[:, None] + rtol[:, None] * jnp.abs(y0)
    w0 = 1.0 / scale0
    d0n = jnp.sqrt(jnp.mean((y0 * w0) ** 2, axis=0))
    d1n = jnp.sqrt(jnp.mean((f0 * w0) ** 2, axis=0))
    h0a = jnp.where((d0n < 1e-5) | (d1n < 1e-5), 1e-6, 0.01 * d0n / d1n)
    h0a = jnp.minimum(h0a, 0.5 * (t_end - t0))
    y1 = y0 + h0a[None, :] * f0
    if with_stage:
        f1 = rhs_b(t0_b + h0a, y1, params, stage_fn(t0_b + h0a))
    else:
        f1 = rhs_b(t0_b + h0a, y1, params)
    d2n = jnp.sqrt(jnp.mean(((f1 - f0) * w0) ** 2, axis=0)) / h0a
    dmn = jnp.maximum(d1n, d2n)
    h1a = jnp.where(dmn <= 1e-15, jnp.maximum(1e-6, h0a * 1e-3), jnp.sqrt(0.01 / dmn))
    h_auto = jnp.minimum(jnp.minimum(100 * h0a, h1a), t_end - t0)
    h_auto = jnp.minimum(h_auto, options.max_step)
    if first_step is not None:
        fs = jnp.broadcast_to(jnp.asarray(first_step, dtype), (B,))
        h0 = jnp.where(fs > 0, jnp.minimum(fs, t_end - t0), h_auto)
    elif options.first_step is not None:
        h0 = jnp.full((B,), options.first_step, dtype)
    else:
        h0 = h_auto
    h0 = jnp.maximum(h0, 1e-12)
    # extreme params overflow the WRMS norms (inf/inf -> NaN h0); a NaN h
    # defeats every `h < h_min` guard and livelocks the step loop — fall
    # back to a small finite h so the lane dies through underflow instead
    h0 = jnp.where(jnp.isfinite(h0), h0, jnp.asarray(1e-6, dtype))

    z0 = jnp.concatenate([y0, quad0_t]) if with_quad else y0
    if with_sens:
        fS0 = sens_rhs_b(t0_b, y0, S0_t, params).reshape(n_S, B)
        z0 = jnp.concatenate([z0, S0_t.reshape(n_S, B)])
        fz0 = jnp.concatenate([fz0, fS0])
    DF0 = jnp.zeros((KAB, nz, B), dtype).at[0].set(fz0)

    save_steps = int(options.save_steps)
    thinning = bool(options.checkpoint_thinning)
    # fdot rows need a stage-free rhs; recording is a forward-solve feature
    # and the staged rhs only appears in the (non-recording) backward pass
    rec_fd = save_steps > 0 and options.hermite_order == 5 and not with_stage
    if save_steps > 0:
        from sunode_tpu.ops._recording import fdot, init_saved_batched

        row_parts0 = [t0_b[None, :], y0, f0]
        if rec_fd:
            row_parts0.append(
                fdot(lambda tt, yy, pp: rhs_b(tt, yy, pp), t0_b, y0, f0, params)
            )
        row0 = jnp.concatenate(row_parts0)
        buf0 = jnp.full((save_steps, row0.shape[0], B), jnp.inf, dtype)
        buf0 = buf0.at[:, 1:, :].set(0.0).at[0].set(row0)
        saved0 = init_saved_batched(buf0, thinning)
    else:
        saved0 = None

    zs0 = jnp.full((n_t, nz, B), jnp.nan, dtype)
    emit_mask0 = tvals_tb <= t0[None, :]  # (n_t, B) per-lane
    zs0 = jnp.where(emit_mask0[:, None, :], z0[None], zs0)
    i_out0 = jnp.sum(emit_mask0, axis=0).astype(jnp.int32)

    zeros_i = jnp.zeros((B,), jnp.int32)
    if with_roots:
        from sunode_tpu.ops.bdf import _validate_rdir

        g_init0 = root_b(t0_b, y0, params)  # (nrt, B)
        nrt = g_init0.shape[0]
        root_cap = max(int(root_cap), 1)
        rdir = _validate_rdir(nrt, root_directions)
        root_carry0 = dict(
            g_prev=g_init0,
            root_t=jnp.full((root_cap, B), jnp.inf, dtype),
            root_y=jnp.zeros((root_cap, n, B), dtype),
            root_dirs=jnp.zeros((root_cap, nrt, B), jnp.int32),
            n_roots=zeros_i,
        )
    else:
        root_carry0 = {}
    carry0 = dict(
        **root_carry0,
        t=t0_b,
        z=z0,
        h=h0,
        h_D=h0,
        p=jnp.ones((B,), jnp.int32),
        DF=DF0,
        n_equal=zeros_i,
        i_out=i_out0,
        zs=zs0,
        status=jnp.where(bad_init, STATUS["BAD_INIT"], -1).astype(jnp.int32),
        consec_fails=zeros_i,
        nsteps=zeros_i,
        nfev=jnp.full((B,), 2, jnp.int32),
        nfevS=jnp.full((B,), 1 if with_sens else 0, jnp.int32),
        nniters=zeros_i,
        n_err_fails=zeros_i,
        n_conv_fails=zeros_i,
        # per-lane post-mortem snapshot of the fatal attempt (ref error_*)
        pm_t=jnp.full((B,), jnp.nan, dtype),
        pm_h=jnp.full((B,), jnp.nan, dtype),
        pm_q=jnp.full((B,), -1, jnp.int32),
        pm_worst=jnp.full((B,), -1, jnp.int32),
        it=jnp.asarray(0, jnp.int32),
        i_ev=zeros_i,
        saved=saved0,
    )

    def lane_active(c):
        return (c["status"] == -1) & (c["i_out"] < n_t)

    def cond(c):
        return jnp.any(lane_active(c))

    def _rescale(DF, p, factor):
        """R(factor)U rescale of the leading p block; unrolled elementwise."""
        K = P_MAX + 1

        def build(fac):
            rows = [[jnp.ones_like(fac) for _ in range(K)]]
            for i in range(1, K):
                rows.append([rows[-1][j] * (i - 1 - fac * j) / i for j in range(K)])
            out = []
            for i in range(K):
                row = []
                for j in range(K):
                    inblock = (i <= p - 1) & (j <= p - 1)
                    eye = 1.0 if i == j else 0.0
                    row.append(jnp.where(inblock, rows[i][j], eye))
                out.append(row)
            return out

        R = build(factor)
        U = build(jnp.ones_like(factor))
        rowsD = [DF[j] for j in range(K)]
        t1 = [sum(R[j][i][None, :] * rowsD[j] for j in range(K)) for i in range(K)]
        head = [sum(U[j][i][None, :] * t1[j] for j in range(K)) for i in range(K)]
        return DF.at[:K].set(jnp.stack(head))

    def body(c):
        active = lane_active(c)
        t, p, z_prev = c["t"], c["p"], c["z"]
        y_prev = z_prev[sl_y]

        h_min_loc = 10 * jnp.finfo(dtype).eps * jnp.maximum(jnp.abs(t), jnp.abs(t_end))
        # NaN-robust form (see ops/bdf.py): non-finite h terminates the lane
        underflow = active & ~(c["h"] >= jnp.maximum(h_min_loc, options.min_step))
        if with_inject:
            i_ev = c["i_ev"]
            t_lim = jnp.where(
                i_ev < n_ev,
                inject_times[jnp.minimum(i_ev, n_ev - 1)],
                t_end,
            )
            t_lim = jnp.minimum(t_lim, t_end)
        else:
            t_lim = t_end
        h_use = jnp.where(
            active, jnp.maximum(jnp.minimum(c["h"], t_lim - t), 0.0), c["h"]
        )
        t_new = t + h_use

        pre_factor = h_use / jnp.maximum(c["h_D"], 1e-300)
        DF = _rescale(c["DF"], p, pre_factor)

        # predictor sums + f extrapolation (masked, unrolled)
        K = P_MAX + 1
        acc_z = jnp.zeros_like(z_prev)
        f_extrap = jnp.zeros_like(z_prev)
        for i in range(K):
            m = jnp.where(i <= p - 1, 1.0, 0.0)[None, :]
            acc_z = acc_z + m * gamma[i] * DF[i]
            f_extrap = f_extrap + m * DF[i]
        z_pred = z_prev + h_use[None, :] * acc_z
        c_A = h_use * gamma[p - 1]  # (B,)

        scale_z = atol_z[:, None] + rtol_z[:, None] * jnp.abs(z_pred)
        w_z = 1.0 / scale_z
        w_y = w_z[sl_y]
        pred_ok = jnp.all(jnp.isfinite(z_pred), axis=0)

        stage = stage_fn(t_new) if with_stage else None

        # fixed-point corrector (statically unrolled, per-lane masked) —
        # phase 1: state+quad rows only; the sens block (if any) waits for
        # the converged state (CV_STAGGERED sequencing, below)
        z_pred_yq = z_pred[:n_yq] if with_sens else z_pred
        f_extrap_yq = f_extrap[:n_yq] if with_sens else f_extrap
        y_it = z_pred[sl_y]
        conv = ~active
        div = jnp.zeros((B,), bool)
        bad = jnp.zeros((B,), bool)
        dy_old = jnp.full((B,), jnp.inf, dtype)
        niter = zeros_i
        def fbody(st):
            k, y_it_c, conv_c, div_c, bad_c, dy_old_c, niter_c = st
            fz_k = fz(t_new, y_it_c, stage)
            bad_f = ~jnp.all(jnp.isfinite(fz_k), axis=0)
            z_next = z_pred_yq + c_A[None, :] * (fz_k - f_extrap_yq)
            delta = z_next[sl_y] - y_it_c
            dy_norm = jnp.sqrt(jnp.mean((delta * w_y) ** 2, axis=0))
            rate = dy_norm / dy_old_c
            live = ~(conv_c | div_c | bad_c)
            y_it_c = jnp.where(live[None, :], z_next[sl_y], y_it_c)
            conv_new = (
                (dy_norm == 0.0)
                | ((k > 0) & (rate < 1.0) & (rate / (1 - rate) * dy_norm < newton_tol))
                | (dy_norm < 0.1 * newton_tol)
            )
            div_new = (k > 0) & (rate >= 2.0)
            bad_c = bad_c | (live & bad_f)
            conv_c = conv_c | (live & conv_new & ~bad_c)
            div_c = div_c | (live & div_new & ~conv_new)
            niter_c = niter_c + live.astype(jnp.int32)
            dy_old_c = jnp.where(live, dy_norm, dy_old_c)
            return k + 1, y_it_c, conv_c, div_c, bad_c, dy_old_c, niter_c

        finit = (jnp.asarray(0, jnp.int32), y_it, conv, div, bad, dy_old, niter)
        # small n: static unroll (iterations are one cheap fused rhs eval);
        # large n: while_loop with all-lanes early exit — each iteration is
        # an O(n·B) rhs eval, and the batch typically converges in 1-2
        # (same tradeoff as the batched BDF Newton, ops/bdf_batched.py)
        if n <= 16:
            fst = finit
            for _ in range(FUNCTIONAL_MAXITER):
                fst = fbody(fst)
        else:

            def fcond(st):
                k, _, conv_c, div_c, bad_c, _, _ = st
                return (k < FUNCTIONAL_MAXITER) & jnp.any(~(conv_c | div_c | bad_c))

            fst = lax.while_loop(fcond, fbody, finit)
        _, y_it, conv, div, bad, dy_old, niter = fst
        conv = conv & ~bad & pred_ok
        # final combined derivative at the converged y
        fz_new = fz(t_new, y_it, stage)
        d_yq = fz_new - f_extrap_yq  # (n_yq, B)
        y_new = (z_pred_yq + c_A[None, :] * d_yq)[sl_y]
        nfev_n = niter + 1

        state_err_ok = jnp.ones((B,), bool)
        nfevS_n = zeros_i
        if with_sens:
            # CV_STAGGERED (16_cvodes.h:31-33): the state must converge AND
            # pass its OWN error test before any sensitivity work.  Per-lane
            # gate + a real lax.cond so an attempt where every lane's state
            # failed evaluates no sensitivity RHS at all (mirrors
            # ops/bdf_batched.py's staggered Newton sequencing, functional
            # iteration here).
            gsp_gate = gamma_star_abs[p]  # (B,)
            err_y_only = jnp.sqrt(
                jnp.mean(
                    (((gsp_gate * h_use)[None, :] * d_yq[sl_y]) * w_y) ** 2,
                    axis=0,
                )
            )
            state_err_ok = conv & (err_y_only <= 1.0)
            sens_gate = active & state_err_ok
            S_pred = z_pred[sl_S].reshape(k_sens, n, B)
            fS_extrap = f_extrap[sl_S].reshape(k_sens, n, B)
            wS = w_z[sl_S].reshape(k_sens, n, B)

            def sbody(st):
                it_s, S_it, old, s_conv, s_div, s_bad, nfs = st
                FS = sens_rhs_b(t_new, y_new, S_it, params)
                bad_f = ~jnp.all(jnp.isfinite(FS), axis=(0, 1))
                S_next = S_pred + c_A[None, None, :] * (FS - fS_extrap)
                norm = jnp.sqrt(
                    jnp.mean(((S_next - S_it) * wS) ** 2, axis=(0, 1))
                )
                rate = norm / old
                live = ~(s_conv | s_div | s_bad)
                S_it = jnp.where(live[None, None, :], S_next, S_it)
                conv_new = (
                    (norm == 0.0)
                    | (
                        (it_s > 0)
                        & (rate < 1.0)
                        & (rate / (1 - rate) * norm < newton_tol)
                    )
                    | (norm < 0.1 * newton_tol)
                )
                div_new = (it_s > 0) & (rate >= 2.0)
                s_bad = s_bad | (live & bad_f)
                s_conv = s_conv | (live & conv_new & ~s_bad)
                s_div = s_div | (live & div_new & ~conv_new)
                nfs = nfs + live.astype(jnp.int32)
                return (
                    it_s + 1, S_it, jnp.where(live, norm, old),
                    s_conv, s_div, s_bad, nfs,
                )

            sinit = (
                jnp.asarray(0, jnp.int32),
                S_pred,
                jnp.full((B,), jnp.inf, dtype),
                ~sens_gate,  # gated-out lanes sit converged (frozen)
                jnp.zeros((B,), bool),
                jnp.zeros((B,), bool),
                zeros_i,
            )

            def run_sens(_):
                if n <= 16:
                    sst = sinit
                    for _ in range(FUNCTIONAL_MAXITER):
                        sst = sbody(sst)
                else:

                    def scond(st):
                        it_s, _, _, s_conv_c, s_div_c, s_bad_c, _ = st
                        return (it_s < FUNCTIONAL_MAXITER) & jnp.any(
                            ~(s_conv_c | s_div_c | s_bad_c)
                        )

                    sst = lax.while_loop(scond, sbody, sinit)
                # final corrector derivative at the converged S (same
                # pattern as the state phase)
                _, S_fin, _, s_conv, s_div, s_bad, nfs = sst
                FS_fin = sens_rhs_b(t_new, y_new, S_fin, params)
                return (
                    FS_fin, s_conv, s_div, s_bad,
                    nfs + sens_gate.astype(jnp.int32),
                )

            FS_fin, s_conv, s_div, s_bad, nfevS_n = lax.cond(
                jnp.any(sens_gate),
                run_sens,
                lambda _: (fS_extrap, sinit[3], sinit[4], sinit[5], zeros_i),
                None,
            )
            d_S = (FS_fin - fS_extrap).reshape(n_S, B)
            # a gated-off sens corrector must not mask the state rejection:
            # acceptance requires state_err_ok anyway (below)
            conv = conv & ((s_conv & ~s_bad & ~s_div) | ~state_err_ok)
            d_S = jnp.where(state_err_ok[None, :], d_S, 0.0)
            d_fz = jnp.concatenate([d_yq, d_S])
        else:
            d_fz = d_yq
        z_new = z_pred + c_A[None, :] * d_fz
        y_new = z_new[sl_y]

        if constraints is not None:
            cns = constraints[:, None]
            viol = (
                ((cns == 1) & (y_new < 0))
                | ((cns == -1) & (y_new > 0))
                | ((cns == 2) & (y_new <= 0))
                | ((cns == -2) & (y_new >= 0))
            )
            constraint_fail = jnp.any(viol, axis=0)
        else:
            constraint_fail = jnp.zeros((B,), bool)

        # error test: LTE = |gamma*_p| h d_fz
        DF_upd = _update(DF, p, d_fz)
        gsp = gamma_star_abs[p]  # (B,)
        err_rows = jnp.stack(
            [
                (gsp * h_use)[None, :] * d_fz,
                (gamma_star_abs[jnp.maximum(p - 1, 0)] * h_use)[None, :]
                * _take_row(DF_upd, p - 1),
                (gamma_star_abs[jnp.minimum(p + 1, P_MAX + 1)] * h_use)[None, :]
                * _take_row(DF_upd, p + 1),
            ]
        )
        err3 = jnp.sqrt(
            jnp.sum((err_rows * w_z[None]) ** 2 * v_err[None, :, None], axis=1)
        )
        err_norm = err3[0]
        if with_sens:
            # the state's OWN error test gates acceptance, and the
            # step-reduction factor must see the state failure too (a gated
            # sens corrector left the d_S block zero) — see bdf_batched.py
            err_norm = jnp.maximum(err_norm, err_y_only)
            err_ok = (err_norm <= 1.0) & state_err_ok
        else:
            err_ok = err_norm <= 1.0
        accept = active & conv & err_ok & ~constraint_fail
        err_reject = active & conv & (~err_ok | constraint_fail)

        n_equal = jnp.where(accept, c["n_equal"] + 1, 0)
        t_next = jnp.where(accept, t_new, t)
        z_next_carry = jnp.where(accept[None, :], z_new, z_prev)

        if with_inject:
            tiny_ev = 1e-12 * (1.0 + jnp.abs(t_lim))
            at_event = accept & (i_ev < n_ev) & (t_new >= t_lim - tiny_ev)
            delta_ev = jnp.take_along_axis(
                inject_deltas,
                jnp.broadcast_to(
                    jnp.minimum(i_ev, n_ev - 1)[None, None, :],
                    (1,) + inject_deltas.shape[1:],
                ),
                axis=0,
            )[0]  # (n, B)
            y_inj = z_new[sl_y] + jnp.where(at_event[None, :], delta_ev, 0.0)
            z_inj = (
                jnp.concatenate([y_inj, z_new[sl_Q]]) if with_quad else y_inj
            )
            z_next_carry = jnp.where(
                (accept & at_event)[None, :], z_inj, z_next_carry
            )
            # the state jumped: rebuild the history from scratch with
            # DF[0] = f(z_injected), order 1 (warm h is kept)
            fz_inj = fz(t_new, y_inj, stage)
            i_ev_next = i_ev + at_event.astype(jnp.int32)
        else:
            at_event = jnp.zeros((B,), bool)

        def _z_interp(tt):  # tt (B,) -> (nz, B): integral-basis dense output
            s = (tt - t_new) / h_use
            acc = jnp.zeros_like(z_new)
            for i in range(K):
                coefs = _C_INT[i]
                ci = jnp.zeros_like(s)
                for a in coefs[::-1]:
                    ci = ci * s + a
                wgt = jnp.where(i <= p, ci, 0.0)
                acc = acc + wgt[None, :] * DF_upd[i]
            return z_new + h_use[None, :] * acc

        # ---- rootfinding (SoA _root_scan analog on the Adams dense
        # output; one bisection loop localizes every accepting lane's
        # leftmost bracket — see ops/bdf_batched.py) ------------------------
        if with_roots:

            def _rscan(_):
                g_new = root_b(t_new, y_new, params)  # (nrt, B)
                gp = c["g_prev"]
                changed = ((gp * g_new) < 0) | ((g_new == 0.0) & (gp != 0.0))
                cross_dir = jnp.sign(g_new - gp).astype(jnp.int32)
                changed = changed & (
                    (rdir[:, None] == 0) | (rdir[:, None] == cross_dir)
                )
                changed = changed & accept[None, :]
                lane_hit = jnp.any(changed, axis=0)  # (B,)

                def g_at(tt):  # tt (B,)
                    return root_b(tt, _z_interp(tt)[sl_y], params)

                def bis(_i, st):
                    lo, hi, glo = st
                    mid = 0.5 * (lo + hi)
                    gm = g_at(mid)
                    in_left = jnp.any(
                        changed & ((glo * gm < 0) | ((gm == 0.0) & (glo != 0.0))),
                        axis=0,
                    )  # (B,)
                    return (
                        jnp.where(in_left, lo, mid),
                        jnp.where(in_left, mid, hi),
                        jnp.where(in_left[None, :], glo, gm),
                    )

                lo, hi, _ = lax.fori_loop(0, 64, bis, (t, t_new, gp))
                tr = 0.5 * (lo + hi)
                ttol = (
                    100.0
                    * jnp.finfo(dtype).eps
                    * (jnp.abs(t_new) + jnp.abs(h_use))
                )
                g_up = g_at(jnp.minimum(tr + ttol, t_new))
                here = changed & (gp * g_up <= 0)
                dirs = jnp.where(
                    here,
                    jnp.where(
                        g_up != 0.0, jnp.sign(g_up), jnp.sign(g_new - gp)
                    ).astype(jnp.int32),
                    0,
                )  # (nrt, B)
                y_root = _z_interp(tr)[sl_y]
                tr = jnp.where(lane_hit, tr, jnp.inf)
                return lane_hit, tr, dirs, y_root, g_new

            def _rskip(_):
                return (
                    jnp.zeros((B,), bool),
                    jnp.full((B,), jnp.inf, dtype),
                    jnp.zeros((nrt, B), jnp.int32),
                    jnp.zeros((n, B), dtype),
                    c["g_prev"],
                )

            root_hit, t_root, root_dirs_now, y_root, g_new = lax.cond(
                jnp.any(accept), _rscan, _rskip, None
            )
            can_rec = root_hit & (c["n_roots"] < root_cap)  # (B,)
            ridx = jnp.minimum(c["n_roots"], root_cap - 1)
            onehot_r = (
                jnp.arange(root_cap)[:, None] == ridx[None, :]
            )  # (cap, B)
            wrec = onehot_r & can_rec[None, :]
            root_t_buf = jnp.where(wrec, t_root[None, :], c["root_t"])
            root_y_buf = jnp.where(
                wrec[:, None, :], y_root[None], c["root_y"]
            )
            root_dirs_buf = jnp.where(
                wrec[:, None, :], root_dirs_now[None], c["root_dirs"]
            )
            n_roots_new = c["n_roots"] + root_hit.astype(jnp.int32)
            g_prev_new = jnp.where(accept[None, :], g_new, c["g_prev"])
            if root_terminal:
                t_stop = jnp.where(root_hit, t_root, jnp.inf)  # (B,)
            else:
                t_stop = None
        else:
            t_stop = None

        # ---- emission (exact integral-basis interpolation) ---------------
        def emit_cond(st):
            i_out = st[0]
            te = _t_emit(i_out)
            pend = accept & (i_out < n_t) & (te <= t_new + 1e-14 * jnp.abs(t_new))
            if t_stop is not None:
                pend = pend & (te <= t_stop)
            return jnp.any(pend)

        def emit_body(st):
            i_out, zs = st
            te = _t_emit(i_out)
            pend = accept & (i_out < n_t) & (te <= t_new + 1e-14 * jnp.abs(t_new))
            if t_stop is not None:
                pend = pend & (te <= t_stop)
            zi = _z_interp(te)
            onehot = jnp.arange(n_t)[:, None] == jnp.minimum(i_out, n_t - 1)[None, :]
            write = onehot[:, None, :] & pend[None, None, :]
            zs = jnp.where(write, zi[None], zs)
            return i_out + pend.astype(jnp.int32), zs

        i_out, zs = lax.while_loop(emit_cond, emit_body, (c["i_out"], c["zs"]))

        # ---- checkpoint recording (see ops/_recording.py) -----------------
        if save_steps > 0:
            from sunode_tpu.ops._recording import fdot, record_step_batched

            row_parts_r = [t_new[None, :], y_new, fz_new[sl_y]]
            if rec_fd:
                row_parts_r.append(
                    fdot(
                        lambda tt, yy, pp: rhs_b(tt, yy, pp),
                        t_new, y_new, fz_new[sl_y], params,
                    )
                )
            row = jnp.concatenate(row_parts_r)
            pad = jnp.concatenate(
                [
                    jnp.full((1, B), jnp.inf, dtype),
                    jnp.zeros((row.shape[0] - 1, B), dtype),
                ]
            )
            row = jnp.where(accept[None, :], row, pad)
            sv = record_step_batched(
                c["saved"], c["it"], accept, row, save_steps, thinning
            )
        else:
            sv = c["saved"]

        # ---- order & step adaptation -------------------------------------
        can_adapt = n_equal >= p + 1
        err_m = jnp.where(p > 1, err3[1], jnp.inf)
        err_p_ = jnp.where(p < P_MAX, err3[2], jnp.inf)

        def fac(e, qq):
            unavailable = ~jnp.isfinite(e)
            e_safe = jnp.clip(e, 1e-30, 1e30)
            f = 0.9 * e_safe ** (-1.0 / (qq + 1.0))
            return jnp.where(unavailable, 0.0, f)

        f_m = fac(err_m, (p - 1).astype(dtype))
        f_0 = fac(err_norm, p.astype(dtype))
        f_p = fac(err_p_, (p + 1).astype(dtype))
        facs = jnp.stack([f_m, f_0, f_p])
        best = jnp.argmax(facs, axis=0)
        dq = best.astype(jnp.int32) - 1
        factor_best = jnp.clip(
            jnp.take_along_axis(facs, best[None, :], axis=0)[0], MIN_FACTOR, MAX_FACTOR
        )
        do_change = can_adapt & (
            (factor_best >= THRESH) | (factor_best < 1.0) | (dq != 0)
        )
        p_acc = jnp.where(do_change, jnp.clip(p + dq, 1, P_MAX), p)
        factor_acc = jnp.where(do_change, factor_best, 1.0)
        factor_acc = jnp.minimum(
            factor_acc, options.max_step / jnp.maximum(h_use, 1e-300)
        )
        n_equal = jnp.where(do_change & accept, 0, n_equal)

        factor_rej = jnp.clip(
            0.9 * jnp.clip(err_norm, 1e-30, 1e30) ** (-1.0 / (p + 1.0)),
            MIN_FACTOR,
            0.9,
        )
        factor_rej = jnp.where(constraint_fail & err_ok, 0.25, factor_rej)
        factor_fail = jnp.where(active & ~conv, 0.25, factor_rej)

        # breakdown detector (see ops/adams.py): marginal accepts keep the
        # failure counter; 4 accumulated failures trigger a per-lane history
        # RESET (keep nabla^0 f only) and an order-1 restart.
        failed_lane = active & ~accept
        cfails_fail = c["consec_fails"] + 1
        reset = failed_lane & (cfails_fail >= 4)
        # decay counter (see ops/bdf.py)
        cfails = jnp.where(
            accept,
            jnp.where(
                err_norm <= 0.9,
                jnp.maximum(c["consec_fails"] - 1, 0),
                c["consec_fails"],
            ),
            jnp.where(reset, 0, jnp.where(failed_lane, cfails_fail, c["consec_fails"])),
        )
        factor_next = jnp.where(accept, factor_acc, jnp.where(reset, 0.25, factor_fail))
        h_next = jnp.where(active, h_use * factor_next, c["h"])
        p_next = jnp.where(accept, p_acc, jnp.where(reset, 1, p))
        row0 = (jnp.arange(KAB) == 0).astype(dtype)[:, None, None]
        DF_next = jnp.where(accept[None, None, :], DF_upd, jnp.where(reset[None, None, :], DF * row0, DF))
        if with_inject:
            keep = max(1, int(options.inject_keep_order))
            if keep <= 1:
                # CVODES semantics: full history reset, order-1 restart
                DF_event = jnp.zeros_like(DF_next).at[0].set(fz_inj)
                p_event = jnp.ones_like(p_next)
            else:
                # linear-adjoint retention: replace nabla^0 f with the
                # post-injection derivative, keep higher differences below
                # `keep` (the jump's own difference terms are O((hL)^j) and
                # the error test guards the approximation), zero the rest
                row_idx = jnp.arange(KAB)[:, None, None]
                DF_event = jnp.where(
                    row_idx == 0,
                    fz_inj[None],
                    jnp.where(row_idx < keep, DF_upd, 0.0),
                )
                p_event = jnp.minimum(p_next, keep)
            DF_next = jnp.where(at_event[None, None, :], DF_event, DF_next)
            p_next = jnp.where(at_event, p_event, p_next)
            n_equal = jnp.where(at_event, 0, n_equal)
            # resume with the WORKING step size (c["h"]), not the clamped
            # final sliver of the interval — and never 0 (duplicate
            # observation times produce legal zero-length event steps)
            h_next = jnp.where(at_event, jnp.maximum(c["h"], h_min_loc * 4), h_next)
        DF_next = jnp.where(active[None, None, :], DF_next, c["DF"])

        too_many = cfails >= MAX_CONSECUTIVE_FAILS

        status = c["status"]
        status = jnp.where(
            (status == -1) & active & too_many & ~accept,
            STATUS["REPEATED_FAILURES"],
            status,
        )
        nsteps = c["nsteps"] + accept.astype(jnp.int32)
        status = jnp.where(
            (status == -1) & active & (nsteps >= options.max_steps),
            STATUS["MAX_STEPS"],
            status,
        )
        status = jnp.where((status == -1) & underflow, STATUS["STEP_UNDERFLOW"], status)
        root_ret_now = jnp.zeros((B,), bool)
        if with_roots and root_terminal:
            root_ret_now = (status == -1) & root_hit
            status = jnp.where(root_ret_now, STATUS["ROOT_RETURN"], status)

        # per-lane post-mortem: snapshot (t, attempted h, order, worst state)
        # on the attempt where a lane's status turns fatal (ref
        # symode/problem.py:150-158 error_* analog)
        fatal_now = (c["status"] == -1) & (status != -1) & ~root_ret_now
        e_err = jnp.abs(err_rows[0, sl_y]) * w_z[sl_y]
        e_newt = jnp.abs((z_new - z_pred)[sl_y]) * w_z[sl_y]
        worst = jnp.argmax(
            jnp.where(conv[None, :], e_err, e_newt), axis=0
        ).astype(jnp.int32)
        pm_t = jnp.where(fatal_now, c["t"], c["pm_t"])
        pm_h = jnp.where(fatal_now, h_use, c["pm_h"])
        pm_q = jnp.where(fatal_now, p, c["pm_q"]).astype(jnp.int32)
        pm_worst = jnp.where(fatal_now, worst, c["pm_worst"]).astype(jnp.int32)

        if with_roots:
            root_updates = dict(
                g_prev=g_prev_new,
                root_t=root_t_buf,
                root_y=root_y_buf,
                root_dirs=root_dirs_buf,
                n_roots=n_roots_new.astype(jnp.int32),
            )
        else:
            root_updates = {}

        return dict(
            **root_updates,
            t=t_next,
            z=z_next_carry,
            h=h_next,
            h_D=jnp.where(active, h_use, c["h_D"]),
            p=p_next,
            DF=DF_next,
            n_equal=n_equal.astype(jnp.int32),
            i_out=i_out,
            zs=zs,
            status=status.astype(jnp.int32),
            consec_fails=cfails.astype(jnp.int32),
            nsteps=nsteps,
            nfev=c["nfev"] + nfev_n,
            nfevS=c["nfevS"] + nfevS_n,
            nniters=c["nniters"] + niter,
            n_err_fails=c["n_err_fails"] + err_reject.astype(jnp.int32),
            n_conv_fails=c["n_conv_fails"] + (active & ~conv).astype(jnp.int32),
            pm_t=pm_t,
            pm_h=pm_h,
            pm_q=pm_q,
            pm_worst=pm_worst,
            it=c["it"] + 1,
            i_ev=i_ev_next if with_inject else c["i_ev"],
            saved=sv,
        )

    def _take_row(DF, idx):
        # masked sum instead of take_along_axis: gathers over the tiny
        # leading axis are ~5x slower than KAB fused selects at large B
        idx = jnp.clip(idx, 0, KAB - 1)
        out = jnp.zeros_like(DF[0])
        for i in range(KAB):
            out = out + jnp.where(i == idx, 1.0, 0.0)[None, :] * DF[i]
        return out

    def _update(DF, p, d_fz):
        """Accepted-step f-difference update (J = p-1):
        i<=p-1: sum_{j=i..p-1} DF[j] + d;  i==p: d;  i==p+1: d - DF[p]."""
        S = [None] * (KAB + 1)
        S[KAB] = jnp.zeros_like(DF[0])
        for i in range(KAB - 1, -1, -1):
            S[i] = S[i + 1] + DF[i]
        Sp = jnp.zeros_like(DF[0])
        for i in range(KAB + 1):
            Sp = Sp + jnp.where(i == p, 1.0, 0.0)[None, :] * S[i]
        DFp = _take_row(DF, p)
        rows = []
        for i in range(KAB):
            low = (i <= p - 1)[None, :]
            is_p = (i == p)[None, :]
            is_p1 = (i == p + 1)[None, :]
            val = jnp.where(
                low,
                S[i] - Sp + d_fz,
                jnp.where(is_p, d_fz, jnp.where(is_p1, d_fz - DFp, DF[i])),
            )
            rows.append(val)
        return jnp.stack(rows)

    final = lax.while_loop(cond, body, carry0)

    status = jnp.where(
        final["status"] == -1, STATUS["SUCCESS"], final["status"]
    ).astype(jnp.int32)
    stats = dict(
        n_steps=final["nsteps"],
        n_rhs_evals=final["nfev"],
        n_jac_evals=jnp.zeros((B,), jnp.int32),
        n_factorizations=jnp.zeros((B,), jnp.int32),
        n_newton_iters=final["nniters"],
        n_error_test_fails=final["n_err_fails"],
        n_conv_fails=final["n_conv_fails"],
        final_order=final["p"],
        final_step_size=final["h"],
        final_time=final["t"],
        n_attempts=final["it"],
        # where each fatal lane died (NaN / -1 on success); see body()
        error_time=final["pm_t"],
        error_step_size=final["pm_h"],
        error_order=final["pm_q"],
        error_worst_state=final["pm_worst"],
        # final carried state (leading batch): the fused backward pass reads
        # lambda/quad from here (post-injection), not from the emissions
        final_state=final["z"].T,
    )
    if save_steps > 0:
        from sunode_tpu.ops._recording import finalize_saved_batched

        stats["checkpoint_thinning_levels"] = (
            final["saved"]["shift"] if thinning else jnp.asarray(0, jnp.int32)
        )
        saved_out = finalize_saved_batched(final["saved"], n, thinning)
    else:
        saved_out = None

    if with_sens:
        stats["n_sens_rhs_evals"] = final["nfevS"]
    if with_roots:
        stats["n_roots"] = final["n_roots"]
        stats["roots_t"] = final["root_t"].T  # (B, cap)
        stats["roots_y"] = final["root_y"].transpose(2, 0, 1)  # (B, cap, n)
        stats["roots_found"] = final["root_dirs"].transpose(2, 0, 1)
    zs = final["zs"]
    ys = jnp.moveaxis(zs[:, sl_y, :], 2, 0)
    quad = jnp.moveaxis(zs[:, sl_Q, :], 2, 0) if with_quad else None
    sens = (
        jnp.moveaxis(zs[:, sl_S, :], 2, 0).reshape(B, n_t, k_sens, n)
        if with_sens
        else None
    )
    return BDFResult(
        ys=ys, status=status, stats=stats, saved=saved_out, sens=sens, quad=quad
    )
