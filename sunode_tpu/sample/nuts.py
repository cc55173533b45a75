"""Batch-native No-U-Turn Sampler (NUTS) in pure JAX.

This is the missing end of BASELINE config 4 ("LV adjoint gradients inside
PyMC NUTS"): the reference hands its PyTensor Op to PyMC's NUTS
(/root/reference/README.md "Usage in PyMC"; one OS process per chain,
README.md:233-238).  Here the sampler itself is JAX, and — unlike a
vmap-of-single-chain sampler — it is written with the chain axis explicit so
that EVERY gradient evaluation is one call of the *batched* logp across all
chains: with ``make_batched_solve_fn`` as the likelihood, each leapfrog step
runs one batched forward ODE solve + one batched adjoint solve for all
chains together on the device (the accelerator replacement for
fork-per-chain).

Algorithm: multinomial NUTS (trajectory sampled proportionally to
exp(-H)) with biased progressive doubling, the iterative O(log L)-memory
U-turn bookkeeping (a power-of-two checkpoint stack instead of recursion —
recursion cannot jit), dual-averaging step-size adaptation and windowed
diagonal mass-matrix adaptation.  Design choices for lockstep batching:

  * the doubling depth is the SHARED outer loop counter, so all still-active
    chains always build the same-size subtree -> the checkpoint-stack slots
    are shared scalars and every inner loop is one ``lax.fori_loop`` over
    2^depth leapfrog steps with per-chain masks;
  * the step size is adapted SHARED across chains (from the across-chain
    mean acceptance statistic): per-chain step sizes would desynchronize
    tree sizes and serialize the batch to the deepest lane;
  * a failed ODE solve NaN-poisons logp (the wrapper contract,
    ref as_pytensor.py:244-247); NaN energies are classified divergent
    (leaf weight exp(-inf) = 0), so the proposal is rejected exactly the
    way PyMC NUTS rejects a failed sunode solve.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["nuts_sample", "NUTSResult"]

DIVERGENCE_THRESHOLD = 1000.0


class NUTSResult(NamedTuple):
    samples: jnp.ndarray  # (C, S, d)
    logp: jnp.ndarray  # (C, S)
    diverging: jnp.ndarray  # (C, S) bool
    tree_depth: jnp.ndarray  # (C, S) int32
    accept_prob: jnp.ndarray  # (C, S)
    step_size: float
    inv_mass: jnp.ndarray  # (d,)


def _value_and_grad_batched(logp_fn, q):
    """(C, d) -> logp (C,), grad (C, d) with ONE batched evaluation."""
    logp, pullback = jax.vjp(logp_fn, q)
    (grad,) = pullback(jnp.ones_like(logp))
    return logp, grad


def _popcount(i, nbits):
    c = jnp.zeros((), jnp.int32)
    for k in range(nbits):
        c = c + ((i >> k) & 1)
    return c


def _trailing_zeros(i, nbits):
    """Number of trailing zero bits of i (i > 0)."""
    c = jnp.zeros((), jnp.int32)
    for k in range(nbits):
        c = c + jnp.where((i & ((1 << (k + 1)) - 1)) == 0, 1, 0)
    return c


def _transition(logp_fn, q0, logp0, grad0, eps, inv_mass, key, max_treedepth):
    """One batched NUTS transition for all chains.

    Returns (q, logp, grad, accept_stat (C,), diverged (C,), depth (C,)).
    """
    C, d = q0.shape
    D = max_treedepth
    sqrt_mass = 1.0 / jnp.sqrt(inv_mass)

    key, k_mom = jax.random.split(key)
    p0 = jax.random.normal(k_mom, (C, d), q0.dtype) * sqrt_mass[None, :]
    H0 = -logp0 + 0.5 * jnp.sum(p0 * p0 * inv_mass[None, :], axis=1)

    def leapfrog(q, p, grad, eps_signed):
        p_half = p + 0.5 * eps_signed[:, None] * grad
        q_new = q + eps_signed[:, None] * (inv_mass[None, :] * p_half)
        logp_new, grad_new = _value_and_grad_batched(logp_fn, q_new)
        p_new = p_half + 0.5 * eps_signed[:, None] * grad_new
        return q_new, p_new, logp_new, grad_new

    def turn(psum, v_a, v_b):
        return (jnp.sum(psum * v_a, axis=1) <= 0) | (
            jnp.sum(psum * v_b, axis=1) <= 0
        )

    # doubling-loop carry
    carry = dict(
        qL=q0, pL=p0, gL=grad0,
        qR=q0, pR=p0, gR=grad0,
        lpR=logp0, lpL=logp0,
        psum=p0,
        prop_q=q0, prop_lp=logp0, prop_g=grad0,
        logw=jnp.zeros((C,), q0.dtype),
        going=jnp.ones((C,), bool),
        diverged=jnp.zeros((C,), bool),
        depth_reached=jnp.zeros((C,), jnp.int32),
        sum_alpha=jnp.zeros((C,), q0.dtype),
        n_alpha=jnp.zeros((C,), q0.dtype),
        depth=jnp.zeros((), jnp.int32),
        key=key,
    )

    def doubling_cond(c):
        return jnp.any(c["going"]) & (c["depth"] < D)

    def doubling_body(c):
        key, k_dir, k_take, k_sub = jax.random.split(c["key"], 4)
        going = c["going"]
        direction = jnp.where(
            jax.random.bernoulli(k_dir, 0.5, (C,)), 1.0, -1.0
        ).astype(q0.dtype)
        eps_signed = eps * direction

        # subtree start: the tree edge in the chosen direction
        fwd = direction > 0
        q = jnp.where(fwd[:, None], c["qR"], c["qL"])
        p = jnp.where(fwd[:, None], c["pR"], c["pL"])
        g = jnp.where(fwd[:, None], c["gR"], c["gL"])
        lp = jnp.where(fwd, c["lpR"], c["lpL"])

        n_steps = jnp.left_shift(jnp.asarray(1, jnp.int32), c["depth"])

        sub = dict(
            q=q, p=p, g=g, lp=lp,
            psum=jnp.zeros((C, d), q0.dtype),
            logw=jnp.full((C,), -jnp.inf, q0.dtype),
            prop_q=q, prop_lp=lp, prop_g=g,
            turning=jnp.zeros((C,), bool),
            diverged=jnp.zeros((C,), bool),
            # U-turn checkpoint stack: per-slot (v, cumulative psum before)
            ckpt_v=jnp.zeros((D + 1, C, d), q0.dtype),
            ckpt_psum=jnp.zeros((D + 1, C, d), q0.dtype),
            sum_alpha=jnp.zeros((C,), q0.dtype),
            n_alpha=jnp.zeros((C,), q0.dtype),
        )

        def substep(i, s):
            active = going & ~s["turning"] & ~s["diverged"]
            q_new, p_new, lp_new, g_new = leapfrog(
                s["q"], s["p"], s["g"], eps_signed
            )
            H_new = -lp_new + 0.5 * jnp.sum(
                p_new * p_new * inv_mass[None, :], axis=1
            )
            dH = H0 - H_new  # log leaf weight (0 at the start point)
            # NaN-safe divergence: anything not provably small is divergent
            div_new = ~(dH > -DIVERGENCE_THRESHOLD)
            dH_safe = jnp.where(div_new, -jnp.inf, dH)

            # multinomial within the subtree (progressive)
            logw_new = jnp.logaddexp(s["logw"], dH_safe)
            u = jax.random.uniform(
                jax.random.fold_in(k_sub, i), (C,), q0.dtype
            )
            take = active & (
                jnp.log(u) < dH_safe - jnp.where(
                    jnp.isfinite(logw_new), logw_new, dH_safe
                )
            )
            psum_before = s["psum"]
            psum_incl = psum_before + p_new
            v_new = inv_mass[None, :] * p_new

            # ---- iterative U-turn bookkeeping ------------------------------
            # even leaf i starts aligned subintervals: store at slot pc(i);
            # odd leaf i closes subintervals of sizes 2^m, m = 1..tz(i+1),
            # whose start states live in slots [pc(i+1)-1, pc(i+1)-2+tz].
            pc_i = _popcount(i, D + 1)
            is_even = (i & 1) == 0
            ck_v = lax.cond(
                is_even,
                lambda _: lax.dynamic_update_index_in_dim(
                    s["ckpt_v"], v_new, pc_i, 0
                ),
                lambda _: s["ckpt_v"],
                None,
            )
            ck_ps = lax.cond(
                is_even,
                lambda _: lax.dynamic_update_index_in_dim(
                    s["ckpt_psum"], psum_before, pc_i, 0
                ),
                lambda _: s["ckpt_psum"],
                None,
            )
            idx_min = _popcount(i + 1, D + 1) - 1
            idx_max = idx_min + _trailing_zeros(i + 1, D + 2) - 1
            turning_new = jnp.zeros((C,), bool)
            for slot in range(D + 1):
                in_range = (slot >= idx_min) & (slot <= idx_max) & ~is_even
                seg = psum_incl - ck_ps[slot]
                t_slot = turn(seg, ck_v[slot], v_new)
                turning_new = turning_new | (in_range & t_slot)

            alpha = jnp.where(
                jnp.isfinite(dH), jnp.minimum(1.0, jnp.exp(dH_safe)), 0.0
            )
            upd = lambda new, old, m=active: jnp.where(m[:, None], new, old)
            return dict(
                q=upd(q_new, s["q"]),
                p=upd(p_new, s["p"]),
                g=upd(g_new, s["g"]),
                lp=jnp.where(active, lp_new, s["lp"]),
                psum=upd(psum_incl, s["psum"]),
                logw=jnp.where(active, logw_new, s["logw"]),
                prop_q=upd(q_new, s["prop_q"], take),
                prop_lp=jnp.where(take, lp_new, s["prop_lp"]),
                prop_g=upd(g_new, s["prop_g"], take),
                turning=s["turning"] | (active & turning_new),
                diverged=s["diverged"] | (active & div_new),
                ckpt_v=ck_v,
                ckpt_psum=ck_ps,
                sum_alpha=s["sum_alpha"] + jnp.where(active, alpha, 0.0),
                n_alpha=s["n_alpha"] + active.astype(q0.dtype),
            )

        sub = lax.fori_loop(0, n_steps, substep, sub)

        # ---- merge subtree into tree (biased progressive doubling) --------
        complete = going & ~sub["turning"] & ~sub["diverged"]
        # biased: take the new half with prob min(1, w_sub / w_tree)
        u = jax.random.uniform(k_take, (C,), q0.dtype)
        take = complete & (jnp.log(u) < sub["logw"] - c["logw"])
        sel = lambda new, old, m: jnp.where(m[:, None], new, old)

        qR = sel(sub["q"], c["qR"], complete & fwd)
        pR = sel(sub["p"], c["pR"], complete & fwd)
        gR = sel(sub["g"], c["gR"], complete & fwd)
        lpR = jnp.where(complete & fwd, sub["lp"], c["lpR"])
        qL = sel(sub["q"], c["qL"], complete & ~fwd)
        pL = sel(sub["p"], c["pL"], complete & ~fwd)
        gL = sel(sub["g"], c["gL"], complete & ~fwd)
        lpL = jnp.where(complete & ~fwd, sub["lp"], c["lpL"])

        psum = jnp.where(complete[:, None], c["psum"] + sub["psum"], c["psum"])
        turn_glob = turn(psum, inv_mass[None, :] * pL, inv_mass[None, :] * pR)
        logw = jnp.where(complete, jnp.logaddexp(c["logw"], sub["logw"]), c["logw"])

        going_new = complete & ~turn_glob
        return dict(
            qL=qL, pL=pL, gL=gL, lpL=lpL,
            qR=qR, pR=pR, gR=gR, lpR=lpR,
            psum=psum,
            prop_q=sel(sub["prop_q"], c["prop_q"], take),
            prop_lp=jnp.where(take, sub["prop_lp"], c["prop_lp"]),
            prop_g=sel(sub["prop_g"], c["prop_g"], take),
            logw=logw,
            going=going_new,
            diverged=c["diverged"] | sub["diverged"],
            depth_reached=c["depth_reached"] + complete.astype(jnp.int32),
            sum_alpha=c["sum_alpha"] + sub["sum_alpha"],
            n_alpha=c["n_alpha"] + sub["n_alpha"],
            depth=c["depth"] + 1,
            key=key,
        )

    final = lax.while_loop(doubling_cond, doubling_body, carry)
    accept_stat = final["sum_alpha"] / jnp.maximum(final["n_alpha"], 1.0)
    return (
        final["prop_q"],
        final["prop_lp"],
        final["prop_g"],
        accept_stat,
        final["diverged"],
        final["depth_reached"],
    )


class _DAState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_stat: jnp.ndarray
    mu: jnp.ndarray
    t: jnp.ndarray


def _da_init(eps0, dtype=None):
    """dtype must follow the chain dtype: a default-f64 scalar here would
    promote eps -> q through the leapfrog and break the f32 speed mode
    (lax.mul dtype mismatch inside the solve's custom_vjp)."""
    eps0 = jnp.asarray(eps0, dtype)
    return _DAState(
        log_eps=jnp.log(eps0),
        log_eps_avg=jnp.log(eps0),
        h_stat=jnp.zeros((), eps0.dtype),
        mu=jnp.log(10.0 * eps0),
        t=jnp.zeros((), eps0.dtype),
    )


def _da_update(da: _DAState, accept_mean, target):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    t = da.t + 1.0
    w = 1.0 / (t + t0)
    h_stat = (1 - w) * da.h_stat + w * (target - accept_mean)
    log_eps = da.mu - jnp.sqrt(t) / gamma * h_stat
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * da.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_stat, da.mu, t)


def _find_reasonable_step_size(logp_fn, q, logp, grad, inv_mass, key, eps0):
    """Crude doubling/halving search for eps with joint accept prob ~ 0.5
    (mean over chains), bounded to 30 iterations."""
    C, d = q.shape
    sqrt_mass = 1.0 / jnp.sqrt(inv_mass)
    p = jax.random.normal(key, (C, d), q.dtype) * sqrt_mass[None, :]
    H0 = -logp + 0.5 * jnp.sum(p * p * inv_mass[None, :], axis=1)

    def accept_mean(eps):
        p_half = p + 0.5 * eps * grad
        q1 = q + eps * inv_mass[None, :] * p_half
        lp1, g1 = _value_and_grad_batched(logp_fn, q1)
        p1 = p_half + 0.5 * eps * g1
        H1 = -lp1 + 0.5 * jnp.sum(p1 * p1 * inv_mass[None, :], axis=1)
        a = jnp.exp(jnp.minimum(H0 - H1, 0.0))
        return jnp.mean(jnp.where(jnp.isfinite(a), a, 0.0))

    a0 = accept_mean(eps0)
    direction = jnp.where(a0 > 0.5, 1.0, -1.0)

    def cond(st):
        eps, it = st
        a = accept_mean(eps)
        keep = jnp.where(direction > 0, a > 0.5, a < 0.5)
        return keep & (it < 30) & (eps > 1e-10) & (eps < 1e10)

    def body(st):
        eps, it = st
        return eps * jnp.where(direction > 0, 2.0, 0.5), it + 1

    eps, _ = lax.while_loop(
        cond, body, (jnp.asarray(eps0, q.dtype), jnp.asarray(0))
    )
    return eps


def nuts_sample(
    logp_fn: Callable,
    key,
    init: jnp.ndarray,  # (C, d) initial positions, one row per chain
    *,
    num_warmup: int = 400,
    num_samples: int = 400,
    max_treedepth: int = 8,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    adapt_mass: bool = True,
    inv_mass: Optional[jnp.ndarray] = None,
    dispatch_chunk: Optional[int] = None,
) -> NUTSResult:
    """Sample with multinomial NUTS; all chains advance in lockstep and every
    gradient is one batched ``logp_fn`` evaluation.

    ``logp_fn``: (C, d) -> (C,) batched log density, differentiable (e.g. a
    closure over ``make_batched_solve_fn``).  Returns draws AFTER warmup.
    Warmup schedule: dual-averaging throughout; with ``adapt_mass`` the
    diagonal mass matrix is re-estimated from the middle warmup window
    [0.25, 0.75] (Welford, pooled across chains) and dual averaging restarts
    at the window end — a compact version of Stan's windowed scheme.

    ``dispatch_chunk``: split the warmup/sampling scans into chunks of at
    most this many iterations, each dispatched as its own device program.
    By default the whole run is ONE ``lax.scan`` — for expensive logp
    (thousands of ODE-solve chains) that is minutes-to-hours of
    uninterrupted device execution, which a device watchdog (e.g. on a
    display-attached GPU) may kill.  Chunking bounds the
    per-dispatch runtime at negligible overhead (one host round-trip per
    chunk); results are bitwise identical to the unchunked run.
    """
    init = jnp.asarray(init)
    C, d = init.shape
    dtype = init.dtype
    if inv_mass is None:
        inv_mass = jnp.ones((d,), dtype)
    else:
        inv_mass = jnp.asarray(inv_mass, dtype)

    logp0, grad0 = _value_and_grad_batched(logp_fn, init)

    key, k_eps = jax.random.split(jax.random.PRNGKey(key) if np.isscalar(key) else key)
    eps0 = _find_reasonable_step_size(
        logp_fn, init, logp0, grad0, inv_mass, k_eps, initial_step_size
    )

    w_lo = int(0.25 * num_warmup)
    w_hi = int(0.75 * num_warmup)

    def warmup_step(carry, i):
        q, lp, g, da, im, welford, key = carry
        key, k_t = jax.random.split(key)
        eps = jnp.exp(da.log_eps)
        q, lp, g, acc, div, depth = _transition(
            logp_fn, q, lp, g, eps, im, k_t, max_treedepth
        )
        acc_mean = jnp.mean(jnp.where(jnp.isfinite(acc), acc, 0.0))
        da = _da_update(da, acc_mean, target_accept)

        # Welford over the adaptation window, pooled across chains
        w_n, w_mean, w_m2 = welford
        in_window = (i >= w_lo) & (i < w_hi)

        def wf_update(args):
            n, mean, m2 = args
            n_new = n + C
            delta = q - mean[None, :]
            mean_new = mean + jnp.sum(delta, axis=0) / n_new
            m2_new = m2 + jnp.sum(delta * (q - mean_new[None, :]), axis=0)
            return n_new, mean_new, m2_new

        welford = lax.cond(
            in_window, wf_update, lambda a: a, (w_n, w_mean, w_m2)
        )

        # window end: swap in the estimated mass, restart dual averaging
        def apply_mass(args):
            da, im = args
            n, _, m2 = welford
            var = m2 / jnp.maximum(n - 1, 1)
            # Stan-style regularization toward unit; an (effectively) empty
            # window (n < 2, e.g. a tiny num_warmup) must leave the mass
            # matrix untouched rather than install the bare regularizer
            var_reg = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
            im_new = jnp.where((n >= 2) & (var_reg > 0), var_reg, im)
            da_new = _da_init(jnp.exp(da.log_eps))
            return da_new, im_new

        if adapt_mass:
            da, im = lax.cond(
                i == w_hi, apply_mass, lambda a: a, (da, im)
            )
        return (q, lp, g, da, im, welford, key), None

    welford0 = (
        jnp.zeros((), dtype),
        jnp.zeros((d,), dtype),
        jnp.zeros((d,), dtype),
    )
    chunk = dispatch_chunk if dispatch_chunk and dispatch_chunk > 0 else None

    def chunked_scan(f, carry, idx):
        """lax.scan over idx, dispatched in bounded chunks (see docstring)."""
        if chunk is None or idx.shape[0] <= chunk:
            return lax.scan(f, carry, idx)
        outs = []
        for s in range(0, int(idx.shape[0]), chunk):
            carry, out = lax.scan(f, carry, idx[s : s + chunk])
            outs.append(out)
        if outs[0] is None:
            return carry, None
        return carry, jax.tree.map(lambda *o: jnp.concatenate(o, axis=0), *outs)

    carry = (init, logp0, grad0, _da_init(eps0), inv_mass, welford0, key)
    carry, _ = chunked_scan(warmup_step, carry, jnp.arange(num_warmup))
    q, lp, g, da, inv_mass_f, _, key = carry
    eps_final = jnp.exp(da.log_eps_avg)

    def sample_step(carry, _i):
        q, lp, g, key = carry
        key, k_t = jax.random.split(key)
        q, lp, g, acc, div, depth = _transition(
            logp_fn, q, lp, g, eps_final, inv_mass_f, k_t, max_treedepth
        )
        return (q, lp, g, key), (q, lp, div, depth, acc)

    (_, _, _, _), (qs, lps, divs, depths, accs) = chunked_scan(
        sample_step, (q, lp, g, key), jnp.arange(num_samples)
    )
    # scan stacks on the leading (draw) axis; reorder to (C, S, ...)
    return NUTSResult(
        samples=jnp.swapaxes(qs, 0, 1),
        logp=jnp.swapaxes(lps, 0, 1),
        diverging=jnp.swapaxes(divs, 0, 1),
        tree_depth=jnp.swapaxes(depths, 0, 1),
        accept_prob=jnp.swapaxes(accs, 0, 1),
        step_size=eps_final,
        inv_mass=inv_mass_f,
    )
