"""Variable-order adaptive BDF integrator inside ``lax.while_loop``.

This is the JAX-native replacement for the CVODES C integrator itself
(reference L0; API surface reference include/cvodes/16_cvodes.h): a
variable-order (1-5), variable-step BDF method with

  * backward-difference history array ``D`` (the classic fixed-leading-
    coefficient formulation of the ode15s / CVODES lineage),
  * WRMS-norm error control with scalar/vector atol,
  * modified Newton iteration reusing a cached Jacobian and a cached
    factorization of ``M = I - c J`` until they go stale (CVODES's stale-J
    strategy),
  * step/order selection from estimated truncation errors at orders q-1, q,
    q+1 with CVODES-style hysteresis (no change unless the factor > 1.5),
  * dense output by Newton backward-difference interpolation (replaces
    ``CVodeGetDky``), emitted at the requested ``tvals`` (CV_NORMAL
    semantics),
  * an optional **forward-sensitivity block** propagating S = dy/dp alongside
    y with the same step/order, solved with the cached Newton matrix
    (CVodeSensInit simultaneous/staggered semantics, CVodeSetSensErrCon),
  * an optional **quadrature block** integrating pure quadratures
    (CVodeQuadInit semantics; explicit corrector — no solve needed since
    quadratures don't couple back),
  * optional recording of every accepted step (t, y, f) for the
    Hermite-interpolated checkpointed adjoint (CV_HERMITE analog),
  * optional inequality constraints on the state (CVodeSetConstraints).

Everything is a single ``lax.while_loop`` whose body attempts ONE step:
data-dependent control flow (rejection, order change, Newton failure) is
encoded in the carry, so the whole solve jits once and ``vmap`` turns it into
a lockstep batched integrator.

Performance notes (the layout was tuned on an earlier target where f64 was
emulated in software; the GPU ledger has yet to confirm each choice):
  - the expensive per-iteration ops are the 6x6 f64 difference-rescaling
    contractions; the loop is structured so each difference array is rescaled
    exactly ONCE per attempt (lazily, at the start of the next attempt)
    instead of once per cause (clamp/adapt/reject);
  - accept/reject bookkeeping is fully masked (``jnp.where``) rather than
    ``lax.cond`` — under ``vmap`` both branches run anyway, and masking
    avoids duplicated rescale/update work;
  - ``inf`` must not reach ``**`` (a software-emulated f64 returned nan for
    inf**negative where CPU gives 0).

Failures follow the reference's recoverable-error contract: non-finite RHS or
a failed error test shrink the step (symode/problem.py:266-269); persistent
failure sets a status code and the caller NaN-fills outputs
(solver.py:510-519 + as_pytensor.py:244-247 semantics).

Float64 throughout by default; the Newton solve uses the pure-jnp LU /
closed forms from ``sunode_tpu.ops.linalg`` (written where XLA's own
LuDecomposition was f32-only).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sunode_tpu.ops.linalg import factor_newton, solve_factored

__all__ = ["BDFOptions", "bdf_solve", "BDFResult", "STATUS"]

MAX_ORDER = 5
KD = MAX_ORDER + 3  # rows of the difference array: D[0..q+2] needed
NEWTON_MAXITER = 4
SENS_MAXITER = 3
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
# CVODES-style hysteresis: don't change h unless the proposed factor is
# at least THRESH (cvode eta THRESH = 1.5)
THRESH = 1.5
MAX_CONSECUTIVE_FAILS = 10

STATUS = {
    "SUCCESS": 0,
    "MAX_STEPS": 1,
    "STEP_UNDERFLOW": 2,
    "BAD_INIT": 3,
    "REPEATED_FAILURES": 4,
    # terminal root found (CV_ROOT_RETURN, 16_cvodes.h:202 return flag):
    # the solve stopped AT the root; outputs beyond it stay NaN and the
    # root location lives in stats['roots_t'] / ['roots_found'] / ['roots_y']
    "ROOT_RETURN": 5,
}


class BDFOptions(NamedTuple):
    rtol: float = 1e-8
    atol: Any = 1e-8
    max_steps: int = 100_000
    first_step: Optional[float] = None  # None -> automatic (Hairer-Wanner)
    max_order: int = MAX_ORDER
    max_step: float = np.inf
    min_step: float = 0.0
    use_ndf: bool = False  # NDF(kappa) modification; False = plain BDF (CVODES)
    constraints: Optional[Any] = None  # per-state: 0 none, 1 >=0, -1 <=0, 2 >0, -2 <0
    save_steps: int = 0  # record accepted steps (for the adjoint checkpointing)
    newton_tol_factor: float = 1.0
    # sensitivity block (CVodeSetSensErrCon / CVodeSetSensParams pbar)
    sens_err_con: bool = True
    sens_pbar: Optional[Any] = None  # (k,) scaling factors; None -> 1
    # CV_STAGGERED sequencing (16_cvodes.h:31-33; ref solver.py:360-392):
    # the state corrector must converge AND pass its own error test before
    # any sensitivity corrector work runs; the sensitivity block then gets
    # its own convergence + error test.  False = CV_SIMULTANEOUS (combined).
    sens_staggered: bool = False
    # quadrature block (CVodeSetQuadErrCon)
    quad_err_con: bool = False
    quad_atol: Optional[Any] = None  # defaults to atol-style scalar
    quad_rtol: Optional[float] = None
    # Newton linear solver: 'dense' (LU / closed forms), 'spgmr' (matrix-free
    # GMRES on jvp's; reference linear_solver='spgmr'), 'band' (banded LU
    # with partial pivoting, O(n*(l+u)^2) — SUNDIALS sunlinsol_band analog;
    # jac must then return (band_lower+band_upper+1, n) banded storage), or
    # 'sparse' (KLU analog: jac returns the RCM-PERMUTED banded storage from
    # colored jvp sweeps — ops/sparsity.py — and the Newton solve permutes
    # residuals through sparse_perm around the banded LU)
    linear_solver: str = "dense"
    krylov_dim: int = 5  # CVODES SUNLinSol_SPGMR default maxl
    band_lower: int = 0  # bandwidths for linear_solver='band'/'sparse'
    band_upper: int = 0
    # static RCM permutation (permuted index -> original index) for
    # linear_solver='sparse'; None = identity
    sparse_perm: Optional[Any] = None
    # bordered-block-diagonal Schur solve for linear_solver='sparse':
    # number of border vertices ordered LAST by sparse_perm (SparsePlan
    # border='auto'; ops/bbd.py).  jac must then return the packed
    # (band_lower+band_upper+1+2k, n) storage.  0 = plain banded plan.
    sparse_border: int = 0
    # Adams order cap (separate from the BDF max_order so explicit low caps
    # stay expressible); default 8 — see ops/adams.py for the conditioning
    # rationale.  Hard ceiling 12 (CV_ADAMS max).
    adams_max_order: int = 8
    # Cotangent-injection history retention (fused adjoint backward only).
    # CVODES reinitializes the backward integrator at every observation
    # (solver.py:750-784), i.e. order-1 restart.  Because the adjoint system
    # is LINEAR in lambda, the pre-jump difference history remains a good
    # approximation of the post-jump trajectory's history up to terms
    # O((h L)^j) (L = local Jacobian scale): keeping min(p, inject_keep_order)
    # orders after an injection avoids the order ramp-up entirely, and the
    # per-step error test still guards accuracy (a polluted history shows up
    # as a large measured correction and rejects the step).  1 = CVODES
    # behavior (full restart).
    inject_keep_order: int = 1
    # Bounded-checkpoint recovery (CVodeAdjInit bounded-buffer analog, ref
    # solver.py:530-588): when the recording buffer fills, keep every second
    # row and double the recording stride instead of failing — see
    # ops/_recording.py.  False restores the legacy clamp+overflow behavior.
    checkpoint_thinning: bool = True
    # Hermite checkpoint degree: 5 records (t, y, f, fdot, ||J||) per
    # accepted step (fdot = J f + f_t, one extra jvp per step) and the
    # adjoint interpolates with QUINTIC Hermite — O(h^6) reconstruction
    # error vs cubic O(h^4), closing the accuracy gap to the
    # resolve/transition adjoint modes.  Stiff-safe via a per-interval
    # gate: quintic only where h*||J|| <= 1, cubic fallback beyond (the
    # h^2*(J f) term amplifies node error by (h*||J||)^2 in the stiff
    # regime — see adjoint.py make_hermite_eval).  3 = CVODES CV_HERMITE
    # parity (t, y, f only).
    hermite_order: int = 5


class BDFResult(NamedTuple):
    ys: jnp.ndarray  # (n_t, n) solution at tvals (NaN where failed)
    status: jnp.ndarray  # int32 status code
    stats: dict  # counters and final state
    saved: Optional[dict]  # recorded steps if save_steps > 0
    sens: Optional[jnp.ndarray] = None  # (n_t, k, n)
    quad: Optional[jnp.ndarray] = None  # (n_t, m)


def _wrms(x, w):
    """CVODES weighted root-mean-square norm with weights w = 1/scale."""
    return jnp.sqrt(jnp.mean((x * w) ** 2))


def _order_constants(use_ndf: bool, dtype):
    k = np.arange(1, MAX_ORDER + 1)
    gamma = np.concatenate([[0.0], np.cumsum(1.0 / k)])  # gamma[q], q=0..5
    if use_ndf:
        kappa = np.array([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0])
    else:
        kappa = np.zeros(MAX_ORDER + 1)
    alpha = (1 - kappa) * gamma
    alpha[0] = 1.0  # unused; avoid div-by-zero
    error_const = kappa * gamma + 1.0 / np.arange(1, MAX_ORDER + 2)
    return (
        jnp.asarray(gamma, dtype),
        jnp.asarray(alpha, dtype),
        jnp.asarray(error_const, dtype),
    )


def _build_R(q, factor, dtype):
    """The 6x6 difference-rescaling matrix, masked to act as identity outside
    the leading (q+1)x(q+1) block.  R[0,:]=1; R[i,j] = R[i-1,j]*(i-1-factor*j)/i.
    """
    K = MAX_ORDER + 1
    j = jnp.arange(K, dtype=dtype)
    rows = [jnp.ones(K, dtype)]
    for i in range(1, K):
        rows.append(rows[-1] * (i - 1 - factor * j) / i)
    R = jnp.stack(rows)  # (K, K)
    ar = jnp.arange(K)
    inblock = (ar[:, None] <= q) & (ar[None, :] <= q)
    eye = jnp.eye(K, dtype=dtype)
    return jnp.where(inblock, R, eye)


def _rescale_P(q, factor, dtype):
    """Masked (R(factor), U=R(1)) pair for the difference rescaling.

    Applied as two thin contractions on D rather than forming R@U — for the
    small state sizes of vmapped-chain workloads two (6,n) contractions beat
    a batched f64 6x6 matmul."""
    R = _build_R(q, jnp.asarray(factor, dtype), dtype)
    U = _build_R(q, jnp.asarray(1.0, dtype), dtype)
    return R, U


def _apply_P(RU, D):
    # head <- (R U)^T head == U^T (R^T head)
    R, U = RU
    K = MAX_ORDER + 1
    t1 = jnp.einsum("ji,j...->i...", R, D[:K])
    D_head = jnp.einsum("ji,j...->i...", U, t1)
    return D.at[:K].set(D_head)


def _rescale_D(D, q, factor):
    """Rescale a difference array (KD, ...) for a step change h -> factor*h.

    Shampine/Reichelt transformation: D[:q+1] <- (R(factor) U)^T D[:q+1]
    with U = R(1); verified against directly-recomputed differences in tests.
    Works for any trailing dims (state, sens, quad blocks).
    """
    return _apply_P(_rescale_P(q, factor, D.dtype), D)


def _predict(D, q, gamma, alpha):
    """pred = sum_{i<=q} D[i];  psi = (1/alpha_q) sum_{1<=i<=q} gamma_i D[i]."""
    K = MAX_ORDER + 1
    ar = jnp.arange(K)
    wy = (ar <= q).astype(D.dtype)
    pred = jnp.einsum("i,i...->...", wy, D[:K])
    wp = jnp.where((ar >= 1) & (ar <= q), gamma[:K], 0.0)
    psi = jnp.einsum("i,i...->...", wp, D[:K]) / alpha[q]
    return pred, psi


def _update_D(D, q, d):
    """After an accepted step with correction d = y_new - y_pred:
    D[q+2] = d - D[q+1]; D[q+1] = d; D[i] += D[i+1] for i = q..0.

    Equivalent closed form (one masked contraction in place of
    dynamic-index scatters at a traced q under vmap; chosen when f64 was
    emulated in software, and the GPU ledger has yet to confirm it):
      i <= q   : D_new[i] = sum_{j=i..q} D[j] + d
      i == q+1 : D_new[i] = d
      i == q+2 : D_new[i] = d - D[q+1]
      i >  q+2 : unchanged
    Works for any trailing dims."""
    dtype = D.dtype
    i = jnp.arange(KD)[:, None]
    j = jnp.arange(KD)[None, :]
    low = i <= q
    # coefficient of D[j] in D_new[i]
    W = jnp.where(
        low & (j >= i) & (j <= q),
        1.0,
        jnp.where((i == q + 2) & (j == q + 1), -1.0, ((i == j) & (i > q + 2)).astype(dtype)),
    ).astype(dtype)
    # coefficient of d in D_new[i]
    wd = (low | (i[:, 0] == q + 1)[:, None] | (i[:, 0] == q + 2)[:, None])[
        :, 0
    ].astype(dtype)
    out = jnp.einsum("ij,j...->i...", W, D) + wd.reshape((KD,) + (1,) * (D.ndim - 1)) * d[None]
    return out


def _interpolate(D, q, t_n, h, t_eval):
    """Newton backward-difference evaluation of the interpolant at t_eval.

    P(t_n + s h) = sum_{i=0..q} D[i] prod_{m=0..i-1} (s+m)/(m+1).
    Replaces CVodeGetDky dense output.  Works for any trailing dims."""
    s = (t_eval - t_n) / h
    out = D[0]
    w = jnp.asarray(1.0, D.dtype)
    for i in range(1, MAX_ORDER + 1):
        w = w * (s + i - 1) / i
        out = out + jnp.where(i <= q, w, 0.0) * D[i]
    return out


def _root_setup(root_fn, t0, y0, params, dtype, root_cap, root_directions):
    """Evaluate g(t0, y0), validate ``root_directions`` eagerly, and return
    ``(g_init, nrt, rdir, root_cap)``.  Shared by the BDF and Adams cores
    (CVodeRootInit + CVodeSetRootDirection input handling) — a mismatch
    would otherwise surface as an opaque broadcast error in the step body."""
    g_init = jnp.asarray(root_fn(t0, y0, params), dtype).reshape(-1)
    nrt = g_init.shape[0]
    root_cap = max(int(root_cap), 1)
    return g_init, nrt, _validate_rdir(nrt, root_directions), root_cap


def _validate_rdir(nrt, root_directions):
    """Validate CVodeSetRootDirection-style input; returns (nrt,) int32."""
    if root_directions is None:
        return jnp.zeros((nrt,), jnp.int32)
    rdir_np = np.asarray(root_directions, np.int32).reshape(-1)
    if rdir_np.shape != (nrt,):
        raise ValueError(
            f"root_directions must have one entry per root_fn "
            f"component: expected shape ({nrt},), got {rdir_np.shape}"
        )
    if not np.all(np.isin(rdir_np, (-1, 0, 1))):
        raise ValueError(
            "root_directions entries must be -1 (falling only), 0 "
            "(both) or +1 (rising only); got "
            f"{rdir_np[~np.isin(rdir_np, (-1, 0, 1))][:5]}"
        )
    return jnp.asarray(rdir_np)


def _root_scan(root_fn, params, rdir, g_prev, t, t_new, h_use, y_new, y_at, dtype):
    """Event detection + leftmost-root localization on one step [t, t_new].

    Shared by the BDF and Adams cores (CVodeRootInit analog; cvRootfind's
    task).  ``y_at(tt)`` evaluates the calling core's dense output at tt.
    Per-component sign-change detection (direction-filtered by ``rdir``:
    0 both, +1 rising only, -1 falling only), then 64 halvings of a SINGLE
    scalar bracket that tracks the leftmost sign change of any watched
    component — one full-vector g eval per halving, like cvRootfind's one
    scalar sequence, instead of nrt per-component sequences.  Machine
    precision, deterministic, XLA-shaped.  The caller gates the whole scan
    on step acceptance.  Returns (root_hit, t_root, dirs, y_root, g_new)."""
    g_new = jnp.asarray(root_fn(t_new, y_new, params), dtype).reshape(-1)
    nrt = g_new.shape[0]
    changed = ((g_prev * g_new) < 0) | ((g_new == 0.0) & (g_prev != 0.0))
    # crossing direction over the step: sign(g_new - g_prev) is monotone
    # across a sign change (CVodeSetRootDirection filter)
    cross_dir = jnp.sign(g_new - g_prev).astype(jnp.int32)
    changed = changed & ((rdir == 0) | (rdir == cross_dir))
    root_hit = jnp.any(changed)

    def _locate(_):
        def g_at(tt):
            return jnp.asarray(root_fn(tt, y_at(tt), params), dtype).reshape(-1)

        def bis(_i, st):
            lo, hi, glo = st
            mid = 0.5 * (lo + hi)
            gm = g_at(mid)
            # does any watched component change sign inside [lo, mid]?
            in_left = jnp.any(
                changed & ((glo * gm < 0) | ((gm == 0.0) & (glo != 0.0)))
            )
            return (
                jnp.where(in_left, lo, mid),
                jnp.where(in_left, mid, hi),
                jnp.where(in_left, glo, gm),
            )

        lo, hi, _ = lax.fori_loop(0, 64, bis, (t, t_new, g_prev))
        tr = 0.5 * (lo + hi)
        # CVODES ttol: components rooting within 100*uround*(|t|+|h|) of
        # the leftmost one report together (cvRcheck3 semantics) — detected
        # by a sign change of g over [t, tr + ttol]
        ttol = 100.0 * jnp.finfo(dtype).eps * (jnp.abs(t_new) + jnp.abs(h_use))
        g_up = g_at(jnp.minimum(tr + ttol, t_new))
        here = changed & (g_prev * g_up <= 0)
        # CVodeGetRootInfo sign convention: +1 g increasing through zero,
        # -1 decreasing (an exact zero just past the root takes the secant
        # slope's sign)
        dirs = jnp.where(
            here,
            jnp.where(
                g_up != 0.0, jnp.sign(g_up), jnp.sign(g_new - g_prev)
            ).astype(jnp.int32),
            0,
        )
        return tr, dirs, y_at(tr)

    def _no_root(_):
        return (
            jnp.asarray(jnp.inf, dtype),
            jnp.zeros((nrt,), jnp.int32),
            jnp.zeros_like(y_new),
        )

    t_root, dirs, y_root = lax.cond(root_hit, _locate, _no_root, None)
    return root_hit, t_root, dirs, y_root, g_new


def _initial_step(rhs, t0, y0, f0, p, t_end, rtol, atol, max_step, dtype):
    """Hairer-Wanner automatic initial step size (order-1 estimate)."""
    scale = atol + rtol * jnp.abs(y0)
    w = 1.0 / scale
    d0 = _wrms(y0, w)
    d1 = _wrms(f0, w)
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    h0 = jnp.minimum(h0, 0.5 * (t_end - t0))
    y1 = y0 + h0 * f0
    f1 = rhs(t0 + h0, y1, p)
    d2 = _wrms(f1 - f0, w) / h0
    dm = jnp.maximum(d1, d2)
    h1 = jnp.where(dm <= 1e-15, jnp.maximum(1e-6, h0 * 1e-3), jnp.sqrt(0.01 / dm))
    h = jnp.minimum(100 * h0, h1)
    h = jnp.minimum(h, t_end - t0)
    h = jnp.minimum(h, max_step)
    # Extreme params overflow the f0/f1 WRMS norms (inf/inf -> NaN h); a
    # NaN h then defeats every later `h < h_min` guard (NaN compares
    # False) and the step loop never terminates.  Fall back to a small
    # finite h: the lane will reject and die through the normal
    # underflow/failure path instead of livelocking.
    h = jnp.where(jnp.isfinite(h) & (h > 0), h, jnp.asarray(1e-6, dtype))
    return jnp.asarray(h, dtype)


def bdf_solve(
    rhs: Callable,
    jac: Callable,
    t0,
    y0: jnp.ndarray,
    params: jnp.ndarray,
    tvals: jnp.ndarray,
    options: BDFOptions = BDFOptions(),
    *,
    sens_rhs: Optional[Callable] = None,
    S0: Optional[jnp.ndarray] = None,
    quad_rhs: Optional[Callable] = None,
    quad0: Optional[jnp.ndarray] = None,
    first_step: Optional[Any] = None,  # traced override; <=0 -> automatic
    jac_prod: Optional[Callable] = None,  # (t, y, v, p) -> J@v, for spgmr
    root_fn: Optional[Callable] = None,  # (t, y, p) -> (nrt,) event functions
    root_cap: int = 8,  # max recorded roots (non-terminal mode)
    root_terminal: bool = True,  # stop at the first root (CV_ROOT_RETURN)
    root_directions: Optional[Any] = None,  # per-component: 0 both, +1/-1 only
) -> BDFResult:
    """Integrate dy/dt = rhs(t, y, p) from t0, emitting y(tvals).

    rhs: (t, y, p) -> (n,);  jac: (t, y, p) -> (n, n) = df/dy.
    sens_rhs: (t, y, S, p) -> (k, n) with S of shape (k, n); S0 required.
    quad_rhs: (t, y, p) -> (m,); quad0 required.  Quadratures are integrated
    explicitly (they don't couple back into y).
    tvals must be increasing with tvals[0] >= t0.  Fully jit/vmap-compatible.

    root_fn: (t, y, p) -> (nrt,) enables CVODES-style rootfinding
    (CVodeRootInit analog, reference include/cvodes/16_cvodes.h:195 — bound
    there but never exposed by its Python layer).  After each accepted step,
    every component of g is checked for a sign change over the step and the
    leftmost root is localized by bisection on the dense output.  With
    root_terminal=True (default) the solve STOPS at the first root with
    status ROOT_RETURN: outputs at tvals past the root stay NaN, and
    stats['roots_t'][0] / ['roots_y'][0] / ['roots_found'][0] carry the root
    time, state, and per-component crossing directions (+1 rising, -1
    falling — CVodeGetRootInfo convention).  With root_terminal=False up to
    root_cap roots are recorded while integration continues; the buffers
    hold the FIRST root_cap roots and stats['n_roots'] keeps counting, so
    n_roots > root_cap signals truncation.  Components
    equal to zero at t0 are ignored until they move off zero, and at most
    one root per accepted step is reported (CVODES's even-crossing caveats
    apply equally).  root_directions (CVodeSetRootDirection analog,
    16_cvodes.h optional-input block) filters per component: 0 reports both
    crossings, +1 only rising, -1 only falling.  The ADAMS core takes the
    same kwargs (shared ``_root_scan``); under vmap the localization runs
    as a masked select, so batched event solves pay its cost every step.

    Internally the state, sensitivities and quadratures live in ONE combined
    vector z = [y | vec(S) | q] with a single difference array, so the
    per-step rescale/predict/update contractions and the error-norm reduce
    happen once regardless of how many blocks are active (CVODES runs the
    analogous loops per N_Vector; here they fuse into one array program).
    """
    dtype = jnp.result_type(y0.dtype, jnp.float32)
    y0 = jnp.asarray(y0, dtype)
    t0 = jnp.asarray(t0, dtype)
    tvals = jnp.asarray(tvals, dtype)
    n = y0.shape[0]
    n_t = tvals.shape[0]
    t_end = tvals[-1]

    use_spgmr = options.linear_solver == "spgmr"
    use_sparse = options.linear_solver == "sparse"
    use_band = options.linear_solver == "band" or use_sparse
    if options.linear_solver not in ("dense", "spgmr", "band", "sparse"):
        raise ValueError(
            "options.linear_solver must be 'dense', 'spgmr', 'band' or "
            "'sparse'"
        )
    if use_band:
        from sunode_tpu.ops.banded import banded_factor, banded_solve

        band_l, band_u = int(options.band_lower), int(options.band_upper)
        if use_sparse and options.sparse_perm is not None:
            sp_perm = jnp.asarray(np.asarray(options.sparse_perm), jnp.int32)
            sp_inv = jnp.asarray(np.argsort(options.sparse_perm), jnp.int32)
        else:
            sp_perm = sp_inv = None
        k_bord = int(options.sparse_border) if use_sparse else 0
        if k_bord:
            # bordered-block-diagonal Schur solve (ops/bbd.py): jac returns
            # packed (l+u+1+2k, n) storage; banded LU on the interior plus
            # a k x k dense Schur complement over the border
            from sunode_tpu.ops.bbd import (
                bbd_factor,
                bbd_form_newton,
                bbd_solve,
            )
    if use_spgmr and jac_prod is None:
        # matrix-free default: jvp of the rhs
        def jac_prod(t, y, v, p):  # noqa: F811
            return jax.jvp(lambda y_: rhs(t, y_, p), (y,), (v,))[1]

    with_sens = sens_rhs is not None
    with_quad = quad_rhs is not None
    k_sens = S0.shape[0] if with_sens else 0
    m_quad = quad0.shape[0] if with_quad else 0
    n_S = k_sens * n
    n_tot = n + n_S + m_quad
    sl_y = slice(0, n)
    sl_S = slice(n, n + n_S)
    sl_Q = slice(n + n_S, n_tot)

    # rtol may be a scalar or a per-state (n,) vector (CVodeVVtolerances
    # analog, ref solver.py:398-403; the per-component WRMS weight
    # atol_i + rtol_i*|y_i| is the natural form here).  Step-size/Newton
    # heuristics use the tightest component.
    rtol = jnp.broadcast_to(jnp.asarray(options.rtol, dtype), (n,))
    rtol_s = jnp.min(rtol)
    atol = jnp.broadcast_to(jnp.asarray(options.atol, dtype), (n,))
    gamma, alpha, error_const = _order_constants(options.use_ndf, dtype)
    max_order = min(options.max_order, MAX_ORDER)

    # combined tolerance vectors over z
    atol_parts = [atol]
    rtol_parts = [rtol]
    # error-norm entry weights: block-mean of block-wrms^2 (CVODES cvSensNorm)
    n_blocks = 1 + (k_sens if (with_sens and options.sens_err_con) else 0) + (
        1 if (with_quad and options.quad_err_con) else 0
    )
    v_parts = [jnp.full((n,), 1.0 / (n * n_blocks), dtype)]
    if with_sens:
        S0 = jnp.asarray(S0, dtype)
        pbar = (
            jnp.broadcast_to(jnp.asarray(options.sens_pbar, dtype), (k_sens,))
            if options.sens_pbar is not None
            else jnp.ones((k_sens,), dtype)
        )
        # CVodeSensEEtolerances: atol_S[k] = atol / pbar_k
        atol_S = (atol[None, :] / pbar[:, None]).reshape(-1)
        atol_parts.append(atol_S)
        # per-state rtol applies to each sensitivity block (CVODES scales
        # sens tolerances from the state tolerances)
        rtol_parts.append(jnp.tile(rtol, k_sens))
        v_parts.append(
            jnp.full(
                (n_S,),
                (1.0 / (n * n_blocks)) if options.sens_err_con else 0.0,
                dtype,
            )
        )
    if with_quad:
        quad0 = jnp.asarray(quad0, dtype)
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
    atol_z = jnp.concatenate(atol_parts) if len(atol_parts) > 1 else atol_parts[0]
    rtol_z = jnp.concatenate(rtol_parts) if len(rtol_parts) > 1 else rtol_parts[0]
    v_err = jnp.concatenate(v_parts) if len(v_parts) > 1 else v_parts[0]

    def err_norm_of(e, w_z):
        return jnp.sqrt(jnp.sum((e * w_z) ** 2 * v_err))

    if options.constraints is not None:
        constraints = jnp.broadcast_to(jnp.asarray(options.constraints, dtype), (n,))
    else:
        constraints = None

    newton_tol = options.newton_tol_factor * jnp.maximum(
        10 * jnp.finfo(dtype).eps / rtol_s, jnp.minimum(0.03, jnp.sqrt(rtol_s))
    )

    f0 = rhs(t0, y0, params)
    bad_init = ~(jnp.all(jnp.isfinite(y0)) & jnp.all(jnp.isfinite(f0)))

    h_auto = _initial_step(
        rhs, t0, y0, f0, params, t_end, rtol, atol, options.max_step, dtype
    )
    if first_step is not None:
        fs = jnp.asarray(first_step, dtype)
        h0 = jnp.where(fs > 0, jnp.minimum(fs, t_end - t0), h_auto)
    elif options.first_step is not None:
        h0 = jnp.asarray(options.first_step, dtype)
    else:
        h0 = h_auto
    h0 = jnp.maximum(h0, 1e-12)

    z_parts = [y0]
    fz_parts = [f0]
    if with_sens:
        fS0 = sens_rhs(t0, y0, S0, params)
        z_parts.append(S0.reshape(-1))
        fz_parts.append(fS0.reshape(-1))
    if with_quad:
        fQ0 = quad_rhs(t0, y0, params)
        z_parts.append(quad0)
        fz_parts.append(fQ0)
    z0 = jnp.concatenate(z_parts) if len(z_parts) > 1 else z_parts[0]
    fz0 = jnp.concatenate(fz_parts) if len(fz_parts) > 1 else fz_parts[0]

    D0 = jnp.zeros((KD, n_tot), dtype)
    D0 = D0.at[0].set(z0).at[1].set(h0 * fz0)

    save_steps = int(options.save_steps)
    thinning = bool(options.checkpoint_thinning)
    if options.hermite_order not in (3, 5):
        raise ValueError("options.hermite_order must be 3 or 5")
    rec_fd = save_steps > 0 and options.hermite_order == 5

    # combined output buffer (n_t, n_tot), sliced at the end
    zs0 = jnp.full((n_t, n_tot), jnp.nan, dtype)
    emit_mask = tvals <= t0
    zs0 = jnp.where(emit_mask[:, None], z0[None, :], zs0)
    i_out0 = jnp.sum(emit_mask).astype(jnp.int32)

    if use_spgmr:
        # matrix-free: no Jacobian matrix, no factorization state
        factors0 = (jnp.zeros((1, 1), dtype),)
        J0 = jnp.zeros((1, 1), dtype)
    elif use_band:
        J0 = jac(t0, y0, params)
        if k_bord:
            # identity in packed storage: M = I - 0*J
            factors0 = bbd_factor(
                bbd_form_newton(
                    jnp.zeros_like(J0), jnp.zeros((), dtype), band_l, band_u,
                    k_bord,
                ),
                band_l,
                band_u,
                k_bord,
            )
        else:
            # identity in banded storage; jac returns (l+u+1, n) banded rows
            eye_ab = (
                jnp.zeros((band_l + band_u + 1, n), dtype).at[band_u].set(1.0)
            )
            factors0 = banded_factor(eye_ab, band_l, band_u)
    else:
        factors0 = factor_newton(jnp.eye(n, dtype=dtype))
        # CVODES evaluates a real Jacobian before the first BDF Newton
        # iteration; starting from J=0 would silently run functional
        # iteration instead.
        J0 = jac(t0, y0, params)

    def _lip_norm(J):
        # Lipschitz estimate for the quintic stiffness gate: dense ->
        # ||J||_inf (max abs row sum); banded storage -> ||J||_1 (column
        # sums — an equally valid scale); matrix-free spgmr has no J, so
        # +inf forces the evaluator's cubic fallback (stiff + matrix-free
        # is exactly where the quintic data cannot be trusted).  A stale
        # Newton Jacobian is fine — the gate is an order-of-magnitude test.
        if use_spgmr:
            return jnp.asarray(jnp.inf, dtype)
        if use_band:
            return jnp.max(jnp.sum(jnp.abs(J), axis=0))
        return jnp.max(jnp.sum(jnp.abs(J), axis=1))

    if save_steps > 0:
        from sunode_tpu.ops._recording import fdot, init_saved_single

        # packed (t | y | f [| fdot | L]) rows: ONE scatter per accepted
        # step.  +inf time padding so searchsorted in the adjoint works
        # directly.  Quintic rows also carry L ~ ||J|| so the evaluator can
        # gate the h^2*(J f) term on h*L <= 1 — in stiff regions (h L >> 1,
        # where BDF lives by design) that term amplifies the forward
        # solution's O(tol) node error by (hL)^2 and the ungated quintic is
        # strictly WORSE than cubic (measured 2.7e-2 vs 1.8e-8 max-rel
        # interpolation error on Robertson t<=1e5; see adjoint.py).
        row_parts = [t0[None], y0, f0]
        if rec_fd:
            row_parts.append(fdot(rhs, t0, y0, f0, params))
            row_parts.append(_lip_norm(J0)[None])
        row0 = jnp.concatenate(row_parts)
        buf0 = jnp.full((save_steps, row0.shape[0]), jnp.inf, dtype)
        buf0 = buf0.at[:, 1:].set(0.0).at[0].set(row0)
        saved0 = init_saved_single(buf0, thinning)
    else:
        saved0 = None

    with_roots = root_fn is not None
    if with_roots:
        g_init, nrt, rdir, root_cap = _root_setup(
            root_fn, t0, y0, params, dtype, root_cap, root_directions
        )

    # h: desired next step size; h_D: spacing the difference arrays currently
    # represent.  Rescaling to h happens lazily at the start of each attempt
    # (exactly one rescale contraction pair per attempt).
    carry0 = dict(
        t=t0,
        h=h0,
        h_D=h0,
        q=jnp.asarray(1, jnp.int32),
        D=D0,
        n_equal=jnp.asarray(0, jnp.int32),
        J=J0,
        J_current=jnp.asarray(True),
        factors=factors0,
        c_factored=jnp.asarray(0.0, dtype),
        need_factor=jnp.asarray(True),
        i_out=i_out0,
        zs=zs0,
        status=jnp.where(bad_init, STATUS["BAD_INIT"], -1).astype(jnp.int32),
        consec_err_fails=jnp.asarray(0, jnp.int32),
        consec_conv_fails=jnp.asarray(0, jnp.int32),
        nsteps=jnp.asarray(0, jnp.int32),
        nfev=jnp.asarray(2, jnp.int32),
        njev=jnp.asarray(1, jnp.int32),
        nfactor=jnp.asarray(0, jnp.int32),
        nniters=jnp.asarray(0, jnp.int32),
        nfevS=jnp.asarray(1 if with_sens else 0, jnp.int32),
        n_err_fails=jnp.asarray(0, jnp.int32),
        n_conv_fails=jnp.asarray(0, jnp.int32),
        # post-mortem snapshot of the fatal attempt (analog of the
        # reference's user_data.error_* capture, ref symode/problem.py:150-158)
        pm_t=jnp.asarray(jnp.nan, dtype),
        pm_h=jnp.asarray(jnp.nan, dtype),
        pm_q=jnp.asarray(-1, jnp.int32),
        pm_worst=jnp.asarray(-1, jnp.int32),
        saved=saved0,
    )
    if with_roots:
        carry0.update(
            g_prev=g_init,
            root_t=jnp.full((root_cap,), jnp.inf, dtype),
            root_y=jnp.zeros((root_cap, n), dtype),
            root_dirs=jnp.zeros((root_cap, nrt), jnp.int32),
            n_roots=jnp.asarray(0, jnp.int32),
        )

    def cond(c):
        return (c["status"] == -1) & (c["i_out"] < n_t)

    def newton_iterate(t_new, y_pred, psi, c_coef, factors, scale_w, lin_solve):
        """Modified-Newton solve of d = c f(y_pred + d) - psi (y block)."""

        def nbody(st):
            k, y, d, dy_norm_old, conv, div, bad, nfev = st
            f = rhs(t_new, y, params)
            bad_f = ~jnp.all(jnp.isfinite(f))
            res = c_coef * f - psi - d
            delta = lin_solve(res)
            bad_d = ~jnp.all(jnp.isfinite(delta))
            dy_norm = _wrms(delta, scale_w)
            rate = dy_norm / dy_norm_old
            diverged = (k > 0) & (
                (rate >= 2.0)
                | (
                    (rate < 1.0)
                    & (rate ** (NEWTON_MAXITER - k) / (1 - rate) * dy_norm > newton_tol)
                )
            )
            d = d + delta
            y = y + delta
            converged = (dy_norm == 0.0) | (
                (k > 0) & (rate < 1.0) & (rate / (1 - rate) * dy_norm < newton_tol)
            )
            bad = bad_f | bad_d
            return (
                k + 1,
                y,
                d,
                dy_norm,
                converged & ~bad,
                diverged & ~converged,
                bad,
                nfev + 1,
            )

        def ncond(st):
            k, y, d, dy_norm_old, conv, div, bad, nfev = st
            return (k < NEWTON_MAXITER) & ~(conv | div | bad)

        init = (
            jnp.asarray(0, jnp.int32),
            y_pred,
            jnp.zeros_like(y_pred),
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.asarray(0, jnp.int32),
        )
        k, y, d, _, conv, div, bad, nfev = lax.while_loop(ncond, nbody, init)
        return conv, div | bad, y, d, k, nfev

    def body(c):
        t, q = c["t"], c["q"]

        h_min_loc = 10 * jnp.finfo(dtype).eps * jnp.maximum(jnp.abs(t), jnp.abs(t_end))
        # ~(h >= min): NaN-robust — a non-finite h must terminate the lane,
        # not loop forever (NaN < x and NaN >= x are both False)
        underflow = ~(c["h"] >= jnp.maximum(h_min_loc, options.min_step))
        # desired step, clamped to land exactly on t_end
        h_use = jnp.minimum(c["h"], t_end - t)
        t_new = t + h_use

        # ---- the single lazy rescale: bring D from spacing h_D to h_use ----
        pre_factor = h_use / jnp.maximum(c["h_D"], 1e-300)
        D = _apply_P(_rescale_P(q, pre_factor, dtype), c["D"])

        # (re)build + factor Newton matrix if stale
        c_coef = h_use / alpha[q]
        c_changed = (
            jnp.abs(c_coef / jnp.where(c["c_factored"] == 0, 1.0, c["c_factored"]) - 1.0)
            > 1e-12
        )
        need_factor = c["need_factor"] | c_changed

        if use_band and k_bord:

            def do_factor(_):
                M_pk = bbd_form_newton(c["J"], c_coef, band_l, band_u, k_bord)
                return (
                    bbd_factor(M_pk, band_l, band_u, k_bord),
                    c_coef,
                    c["nfactor"] + 1,
                )

        elif use_band:

            def do_factor(_):
                # M = I - c*J directly in banded storage (diagonal = row u)
                M_ab = (-c_coef) * c["J"]
                M_ab = M_ab.at[band_u].add(1.0)
                return banded_factor(M_ab, band_l, band_u), c_coef, c["nfactor"] + 1

        else:

            def do_factor(_):
                M = jnp.eye(n, dtype=dtype) - c_coef * c["J"]
                return factor_newton(M), c_coef, c["nfactor"] + 1

        if use_spgmr:
            factors, c_factored, nfactor = c["factors"], c_coef, c["nfactor"]
        else:
            factors, c_factored, nfactor = lax.cond(
                need_factor,
                do_factor,
                lambda _: (c["factors"], c["c_factored"], c["nfactor"]),
                None,
            )

        # single stacked contraction: rows [pred; psi]
        K = MAX_ORDER + 1
        ar = jnp.arange(K)
        wy = (ar <= q).astype(dtype)
        wp = jnp.where((ar >= 1) & (ar <= q), gamma[:K], 0.0) / alpha[q]
        PP = jnp.stack([wy, wp])  # (2, K)
        pred_psi = jnp.einsum("wi,in->wn", PP, D[:K])
        z_pred, psi_z = pred_psi[0], pred_psi[1]

        scale_z = atol_z + rtol_z * jnp.abs(z_pred)
        w_z = 1.0 / scale_z
        y_pred = z_pred[sl_y]
        scale_w = w_z[sl_y]
        pred_ok = jnp.all(jnp.isfinite(z_pred))

        if use_spgmr:
            from sunode_tpu.ops.krylov import gmres_solve

            def lin_solve(res):
                return gmres_solve(
                    lambda v: v - c_coef * jac_prod(t_new, y_pred, v, params),
                    res,
                    maxl=options.krylov_dim,
                )
        elif use_band and k_bord:
            # solve in plan-permuted space (border last): z = P delta
            def lin_solve(res):
                rp = res[sp_perm] if sp_perm is not None else res
                z = bbd_solve(factors, rp, band_l, band_u, k_bord)
                return z[sp_inv] if sp_inv is not None else z

        elif use_band:
            if use_sparse and sp_perm is not None:
                # solve in RCM-permuted space: z = P delta, M_p z = P res
                def lin_solve(res):
                    z = banded_solve(factors, res[sp_perm], band_l, band_u)
                    return z[sp_inv]

            else:

                def lin_solve(res):
                    return banded_solve(factors, res, band_l, band_u)

        else:
            def lin_solve(res):
                return solve_factored(factors, res)

        conv, nfailed, y_new, d_corr, n_iters, nfev_n = newton_iterate(
            t_new, y_pred, psi_z[sl_y], c_coef, factors, scale_w, lin_solve
        )
        conv = conv & pred_ok
        d_parts = [d_corr]

        # ----- sensitivity corrector (linear; iterate with cached M) -------
        nfevS_n = jnp.asarray(0, jnp.int32)
        state_err_ok = jnp.asarray(True)
        if with_sens:
            staggered = bool(options.sens_staggered)
            S_pred = z_pred[sl_S].reshape(k_sens, n)
            psi_S = psi_z[sl_S].reshape(k_sens, n)
            wS = w_z[sl_S].reshape(k_sens, n)
            if use_spgmr or use_band:
                solve_rows = lambda _f, rows: jax.vmap(lin_solve)(rows)  # noqa: E731
            else:
                solve_rows = jax.vmap(solve_factored, in_axes=(None, 0))

            def sbody(st):
                it, S, dS, norm_old, s_conv, s_bad, nfs = st
                FS = sens_rhs(t_new, y_new, S, params)
                resS = c_coef * FS - psi_S - dS
                deltaS = solve_rows(factors, resS)
                s_bad = ~jnp.all(jnp.isfinite(deltaS))
                norm = _wrms(deltaS, wS)
                rate = norm / norm_old
                S = S + deltaS
                dS = dS + deltaS
                s_conv = (
                    (norm == 0.0)
                    | ((it > 0) & (rate < 1.0) & (rate / (1 - rate) * norm < newton_tol))
                    | (norm < 0.1 * newton_tol)
                )
                return it + 1, S, dS, norm, s_conv & ~s_bad, s_bad, nfs + 1

            def scond(st):
                it, S, dS, norm_old, s_conv, s_bad, nfs = st
                return (it < SENS_MAXITER) & ~(s_conv | s_bad)

            sinit = (
                jnp.asarray(0, jnp.int32),
                S_pred,
                jnp.zeros_like(S_pred),
                jnp.asarray(jnp.inf, dtype),
                jnp.asarray(False),
                jnp.asarray(False),
                jnp.asarray(0, jnp.int32),
            )

            if staggered:
                # CV_STAGGERED (16_cvodes.h:31-33): the state must converge
                # AND pass its own error test before any sensitivity work —
                # a real lax.cond, so state-rejected attempts never evaluate
                # the sensitivity RHS (the whole point of staggered mode)
                err_y_norm = _wrms(error_const[q] * d_corr, w_z[sl_y])
                state_err_ok = err_y_norm <= 1.0

                def run_sens(_):
                    return lax.while_loop(scond, sbody, sinit)

                def skip_sens(_):
                    return sinit

                _, S_new, dS_corr, _, s_conv, s_bad, nfevS_n = lax.cond(
                    conv & state_err_ok, run_sens, skip_sens, None
                )
                # a skipped sens corrector must not mask the state rejection:
                # acceptance requires state_err_ok anyway (below)
                conv = conv & (s_conv | ~state_err_ok)
            else:
                _, S_new, dS_corr, _, s_conv, s_bad, nfevS_n = lax.while_loop(
                    scond, sbody, sinit
                )
                conv = conv & s_conv
            d_parts.append(dS_corr.reshape(-1))
        # quadrature corrector is explicit: d_q = c * qdot(t_n, y_n) - psi_q
        if with_quad:
            psi_Q = psi_z[sl_Q]
            fQ = quad_rhs(t_new, y_new, params)
            dQ_corr = c_coef * fQ - psi_Q
            quad_bad = ~jnp.all(jnp.isfinite(dQ_corr))
            conv = conv & ~quad_bad
            d_parts.append(dQ_corr)

        d_z = jnp.concatenate(d_parts) if len(d_parts) > 1 else d_parts[0]

        # constraint check (CVodeSetConstraints semantics)
        if constraints is not None:
            viol = (
                ((constraints == 1) & (y_new < 0))
                | ((constraints == -1) & (y_new > 0))
                | ((constraints == 2) & (y_new <= 0))
                | ((constraints == -2) & (y_new >= 0))
            )
            constraint_fail = jnp.any(viol)
        else:
            constraint_fail = jnp.asarray(False)

        newton_failed = ~conv
        # If J is stale: refresh J and retry at same h.  Else halve h.
        # (spgmr is matrix-free: linearization is always fresh, so a Newton
        # failure goes straight to step reduction.)
        if use_spgmr:
            refresh_J = jnp.asarray(False)
        else:
            refresh_J = newton_failed & ~c["J_current"]
        halve = newton_failed & c["J_current"]

        if use_spgmr:
            J_new = c["J"]
        else:
            J_new = lax.cond(
                refresh_J,
                lambda _: jac(t_new, y_pred, params),
                lambda _: c["J"],
                None,
            )
        njev = c["njev"] + jnp.where(refresh_J, 1, 0)

        # ----- error test ---------------------------------------------------
        err_norm_tot = err_norm_of(error_const[q] * d_z, w_z)
        if with_sens and bool(options.sens_staggered):
            # the state's OWN error test gates acceptance (the combined
            # block-mean norm could pass while the state block alone fails),
            # and the step-reduction factor must see the state failure too
            # (on a skipped sens corrector the d_z sens block is zero)
            err_y_norm = _wrms(error_const[q] * d_corr, w_z[sl_y])
            err_norm_tot = jnp.maximum(err_norm_tot, err_y_norm)
        err_ok = (err_norm_tot <= 1.0) & state_err_ok
        accept = conv & err_ok & ~constraint_fail
        err_reject = conv & (~err_ok | constraint_fail)

        # ------------------------------------------------------------------
        # Masked accept-path updates (computed unconditionally; selected)
        # ------------------------------------------------------------------
        D_upd = _update_D(D, q, d_z)
        n_equal = jnp.where(accept, c["n_equal"] + 1, 0)
        t_next = jnp.where(accept, t_new, t)

        # ------------------------------------------------------------------
        # rootfinding (CVodeRootInit analog): on an accepted step, check each
        # g component for a sign change over [t, t_new] and localize the
        # leftmost root on the dense output.  cvRootfind uses a secant
        # variant; 64 fixed halvings of one step reach the same 100*uround
        # tolerance deterministically, which is the XLA-shaped choice.
        if with_roots:
            # the whole scan (g eval at t_new + localization) runs only on
            # accepted steps (CVODES evaluates g at accepted steps only);
            # under vmap the cond lowers to a masked select, so batched
            # event solves still pay the scan every step — documented.
            def _scan(_):
                return _root_scan(
                    root_fn,
                    params,
                    rdir,
                    c["g_prev"],
                    t,
                    t_new,
                    h_use,
                    y_new,
                    lambda tt: _interpolate(D_upd, q, t_new, h_use, tt)[sl_y],
                    dtype,
                )

            def _skip(_):
                return (
                    jnp.asarray(False),
                    jnp.asarray(jnp.inf, dtype),
                    jnp.zeros((nrt,), jnp.int32),
                    jnp.zeros((n,), dtype),
                    c["g_prev"],
                )

            root_hit, t_root, root_dirs_now, y_root, g_new = lax.cond(
                accept, _scan, _skip, None
            )
            # record the FIRST root_cap roots; n_roots keeps counting so
            # stats['n_roots'] > root_cap signals truncation (instead of
            # silently overwriting the last slot)
            can_rec = root_hit & (c["n_roots"] < root_cap)
            ridx = jnp.minimum(c["n_roots"], root_cap - 1)
            root_t_buf = jnp.where(
                can_rec, c["root_t"].at[ridx].set(t_root), c["root_t"]
            )
            root_y_buf = jnp.where(
                can_rec, c["root_y"].at[ridx].set(y_root), c["root_y"]
            )
            root_dirs_buf = jnp.where(
                can_rec,
                c["root_dirs"].at[ridx].set(root_dirs_now),
                c["root_dirs"],
            )
            n_roots_new = c["n_roots"] + jnp.where(root_hit, 1, 0)
            g_prev_new = jnp.where(accept, g_new, c["g_prev"])
            if root_terminal:
                # stop emitting past the root; outputs there stay NaN
                t_stop = jnp.where(root_hit, t_root, jnp.asarray(jnp.inf, dtype))
            else:
                t_stop = jnp.asarray(jnp.inf, dtype)
        else:
            t_stop = None

        # emit outputs for all tvals in (t_old, t_new]   (accept-gated)
        def emit_cond(st):
            i_out = st[0]
            ok = (
                accept
                & (i_out < n_t)
                & (
                    tvals[jnp.minimum(i_out, n_t - 1)]
                    <= t_new + 1e-14 * jnp.abs(t_new)
                )
            )
            if t_stop is not None:
                ok = ok & (tvals[jnp.minimum(i_out, n_t - 1)] <= t_stop)
            return ok

        def emit_body(st):
            i_out, zs = st
            te = tvals[jnp.minimum(i_out, n_t - 1)]
            zi = _interpolate(D_upd, q, t_new, h_use, te)
            zs = zs.at[i_out].set(zi)
            return i_out + 1, zs

        i_out, zs = lax.while_loop(emit_cond, emit_body, (c["i_out"], c["zs"]))

        # record accepted step for adjoint checkpointing (one packed scatter;
        # bounded-buffer thinning in ops/_recording.py)
        if save_steps > 0:
            from sunode_tpu.ops._recording import fdot, record_step_single

            f_acc = rhs(t_new, y_new, params)
            row_parts_r = [t_new[None], y_new, f_acc]
            if rec_fd:
                row_parts_r.append(fdot(rhs, t_new, y_new, f_acc, params))
                row_parts_r.append(_lip_norm(c["J"])[None])
            row = jnp.concatenate(row_parts_r)
            sv = record_step_single(c["saved"], accept, row, save_steps, thinning)
        else:
            sv = c["saved"]

        # ----- order & step adaptation (accept path, after q+1 equal steps)
        can_adapt = n_equal >= q + 1
        err_m = jnp.where(
            q > 1,
            err_norm_of(error_const[jnp.maximum(q - 1, 0)] * D_upd[q], w_z),
            jnp.inf,
        )
        err_p = jnp.where(
            q < max_order,
            err_norm_of(error_const[jnp.minimum(q + 1, MAX_ORDER)] * D_upd[q + 2], w_z),
            jnp.inf,
        )

        # step factor for candidate order qq (LTE ~ h^(qq+1)):
        # NOTE: keep inf out of ** — a software-emulated f64 yielded nan for
        # inf**negative (CPU gives 0), so clamp before exponentiating.
        def fac(e, qq):
            unavailable = ~jnp.isfinite(e)
            e_safe = jnp.clip(e, 1e-30, 1e30)
            f = 0.9 * e_safe ** (-1.0 / (qq + 1.0))
            return jnp.where(unavailable, 0.0, f)

        f_m = fac(err_m, q - 1)
        f_0 = fac(err_norm_tot, q)
        f_p = fac(err_p, q + 1)
        facs = jnp.stack([f_m, f_0, f_p])
        best = jnp.argmax(facs)
        dq = best.astype(jnp.int32) - 1
        factor_best = jnp.clip(facs[best], MIN_FACTOR, MAX_FACTOR)

        do_change = can_adapt & ((factor_best >= THRESH) | (factor_best < 1.0) | (dq != 0))
        q_acc = jnp.where(do_change, jnp.clip(q + dq, 1, max_order), q)
        factor_acc = jnp.where(do_change, factor_best, 1.0)
        factor_acc = jnp.minimum(factor_acc, options.max_step / jnp.maximum(h_use, 1e-300))
        n_equal = jnp.where(do_change & accept, 0, n_equal)

        # ----- reject-path step factor -------------------------------------
        factor_rej = jnp.clip(
            0.9 * jnp.clip(err_norm_tot, 1e-30, 1e30) ** (-1.0 / (q + 1.0)),
            MIN_FACTOR,
            0.9,
        )
        factor_rej = jnp.where(constraint_fail & err_ok, 0.25, factor_rej)
        factor_fail = jnp.where(refresh_J, 1.0, jnp.where(halve, 0.5, factor_rej))

        # ----- merge: next h target; D spacing stays h_use (lazy rescale) --
        # breakdown detector (see ops/adams.py): marginal accepts keep the
        # failure counter; 4 accumulated failures trigger a history RESET
        # (keep y and the first difference only) and an order-1 restart.
        cef_fail = c["consec_err_fails"] + 1
        reset = ~accept & err_reject & (cef_fail >= 4)
        factor_next = jnp.where(
            accept, factor_acc, jnp.where(reset, 0.25, factor_fail)
        )
        h_next = h_use * factor_next
        q_next = jnp.where(accept, q_acc, jnp.where(reset, 1, q))
        # rebuild the reset history from scratch: D[0] = z at the last
        # accepted point (exact), D[1] = h * dz/dt evaluated there (a kept
        # D[1] may itself be corrupted, leaving an h-independent error
        # estimate that collapses h)
        row0_mask = (jnp.arange(KD) == 0).astype(dtype).reshape(
            (KD,) + (1,) * (D.ndim - 1)
        )

        def reset_D(_):
            z_last = D[0]
            fz_parts_r = [rhs(t, z_last[sl_y], params)]
            if with_sens:
                fz_parts_r.append(
                    sens_rhs(
                        t, z_last[sl_y], z_last[sl_S].reshape(k_sens, n), params
                    ).reshape(-1)
                )
            if with_quad:
                fz_parts_r.append(quad_rhs(t, z_last[sl_y], params))
            fz_last = (
                jnp.concatenate(fz_parts_r)
                if len(fz_parts_r) > 1
                else fz_parts_r[0]
            )
            return (D * row0_mask).at[1].set(h_use * fz_last)

        D_reset = lax.cond(reset, reset_D, lambda _: D, None)
        D_next = jnp.where(accept, D_upd, jnp.where(reset, D_reset, D))

        # decay counter: clean accepts decrement, marginal accepts
        # (err in (0.9, 1]) hold, rejections increment — tolerates the
        # alternating shrink-accept/fail pattern of a genuine breakdown
        # without firing on hysteresis-held steps
        cef = jnp.where(
            accept,
            jnp.where(
                err_norm_tot <= 0.9,
                jnp.maximum(c["consec_err_fails"] - 1, 0),
                c["consec_err_fails"],
            ),
            jnp.where(reset, 0, c["consec_err_fails"] + jnp.where(err_reject, 1, 0)),
        )
        ccf = jnp.where(
            accept,
            0,
            c["consec_conv_fails"] + jnp.where(newton_failed & ~refresh_J, 1, 0),
        )
        too_many = (cef >= MAX_CONSECUTIVE_FAILS) | (ccf >= MAX_CONSECUTIVE_FAILS)

        status = c["status"]
        status = jnp.where(
            (status == -1) & too_many & ~accept, STATUS["REPEATED_FAILURES"], status
        )
        status = jnp.where(
            (status == -1) & (c["nsteps"] + jnp.where(accept, 1, 0) >= options.max_steps),
            STATUS["MAX_STEPS"],
            status,
        )
        status = jnp.where((status == -1) & underflow, STATUS["STEP_UNDERFLOW"], status)
        root_ret_now = jnp.asarray(False)
        if with_roots and root_terminal:
            root_ret_now = (status == -1) & root_hit
            status = jnp.where(root_ret_now, STATUS["ROOT_RETURN"], status)

        # post-mortem: on the attempt where the status turns fatal, snapshot
        # where the integration died — (t, attempted h, order, worst state).
        # Worst state = largest weighted local-error component on an error
        # rejection, largest weighted Newton correction on a convergence
        # failure (ref symode/problem.py:150-158 error_* analog).
        fatal_now = (c["status"] == -1) & (status != -1) & ~root_ret_now
        e_err = jnp.abs(error_const[q] * d_z[sl_y]) * w_z[sl_y]
        e_newt = jnp.abs(d_corr) * w_z[sl_y]
        worst = jnp.argmax(jnp.where(conv, e_err, e_newt)).astype(jnp.int32)
        pm_t = jnp.where(fatal_now, t, c["pm_t"])
        pm_h = jnp.where(fatal_now, h_use, c["pm_h"])
        pm_q = jnp.where(fatal_now, q, c["pm_q"]).astype(jnp.int32)
        pm_worst = jnp.where(fatal_now, worst, c["pm_worst"]).astype(jnp.int32)

        new_c = dict(
            t=t_next,
            h=h_next,
            h_D=h_use,
            q=q_next,
            D=D_next,
            n_equal=n_equal.astype(jnp.int32),
            J=J_new,
            # J goes stale as soon as the state advances
            J_current=jnp.where(accept, False, c["J_current"] | refresh_J),
            factors=factors,
            c_factored=c_factored,
            need_factor=jnp.where(accept, False, refresh_J),
            i_out=i_out,
            zs=zs,
            status=status.astype(jnp.int32),
            consec_err_fails=cef.astype(jnp.int32),
            consec_conv_fails=ccf.astype(jnp.int32),
            nsteps=c["nsteps"] + jnp.where(accept, 1, 0),
            nfev=c["nfev"]
            + nfev_n
            + (jnp.where(accept, 1, 0) if save_steps > 0 else 0),
            njev=njev,
            nfactor=nfactor,
            nniters=c["nniters"] + n_iters,
            nfevS=c["nfevS"] + nfevS_n,
            n_err_fails=c["n_err_fails"] + jnp.where(err_reject, 1, 0),
            n_conv_fails=c["n_conv_fails"]
            + jnp.where(newton_failed & ~refresh_J, 1, 0),
            pm_t=pm_t,
            pm_h=pm_h,
            pm_q=pm_q,
            pm_worst=pm_worst,
            saved=sv,
        )
        if with_roots:
            new_c.update(
                g_prev=g_prev_new,
                root_t=root_t_buf,
                root_y=root_y_buf,
                root_dirs=root_dirs_buf,
                n_roots=n_roots_new.astype(jnp.int32),
            )
        return new_c

    final = lax.while_loop(cond, body, carry0)

    status = jnp.where(
        final["status"] == -1, STATUS["SUCCESS"], final["status"]
    ).astype(jnp.int32)

    stats = dict(
        n_steps=final["nsteps"],
        n_rhs_evals=final["nfev"],
        n_jac_evals=final["njev"],
        n_factorizations=final["nfactor"],
        n_newton_iters=final["nniters"],
        n_error_test_fails=final["n_err_fails"],
        n_conv_fails=final["n_conv_fails"],
        final_order=final["q"],
        final_step_size=final["h"],
        final_time=final["t"],
        # full combined state [y | vec(S) | q] at final_time — enables
        # resume-in-place on MAX_STEPS (CVode-resume semantics,
        # ref solver.py:510-519): restart a fresh solve from here with
        # first_step=final_step_size instead of re-running from t0
        final_state=final["D"][0],
        # where a fatal solve died (NaN / -1 on success); see body()
        error_time=final["pm_t"],
        error_step_size=final["pm_h"],
        error_order=final["pm_q"],
        error_worst_state=final["pm_worst"],
    )
    if with_sens:
        stats["n_sens_rhs_evals"] = final["nfevS"]
    if with_roots:
        # CVodeGetRootInfo analog: per-root times (+inf padding), states at
        # the roots, and per-component crossing directions
        stats["n_roots"] = final["n_roots"]
        stats["roots_t"] = final["root_t"]
        stats["roots_y"] = final["root_y"]
        stats["roots_found"] = final["root_dirs"]
    if save_steps > 0:
        from sunode_tpu.ops._recording import finalize_saved_single

        # surface silent degradation: >0 means the checkpoint buffer filled
        # and the recording was compacted (interpolation spacing grew
        # 2^levels; cubic-Hermite error ~16x per level — see ops/_recording)
        stats["checkpoint_thinning_levels"] = (
            final["saved"]["shift"] if thinning else jnp.asarray(0, jnp.int32)
        )
        buf, n_saved, overflow = finalize_saved_single(final["saved"], thinning)
        saved_out = {
            "t": buf[:, 0],
            "y": buf[:, 1 : n + 1],
            "f": buf[:, n + 1 : 2 * n + 1],
            "n_saved": n_saved,
            "overflow": overflow,
        }
        if rec_fd:
            saved_out["fd"] = buf[:, 2 * n + 1 : 3 * n + 1]
            saved_out["L"] = buf[:, 3 * n + 1]
    else:
        saved_out = None
    zs = final["zs"]
    return BDFResult(
        ys=zs[:, sl_y],
        status=status,
        stats=stats,
        saved=saved_out,
        sens=zs[:, sl_S].reshape(n_t, k_sens, n) if with_sens else None,
        quad=zs[:, sl_Q] if with_quad else None,
    )
