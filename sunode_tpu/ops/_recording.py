"""Checkpoint recording with automatic thinning (CVODEA-bounded-buffer analog).

CVODES's adjoint module re-integrates between checkpoints when the buffer is
bounded (``CVodeAdjInit(ode, steps, ...)``, reference solver.py:530-588;
include/cvodes/16_cvodes.h:365-439) so a long integration never fails.  A
functional re-integration-during-backward is a nested adaptive solve per
interpolation point — hopeless under jit — so the JAX-native equivalent is
**in-loop thinning**: when the fixed recording buffer fills, compact it by
keeping every second row and double the recording stride.  Interpolation
spacing doubles per level (cubic-Hermite error grows ~16x per level), error
that the gradient tolerance absorbs for realistic levels; after ``MAX_THIN``
levels (capacity = save_steps * 2^MAX_THIN steps, far past any max_steps)
recording stops and the lane is flagged ``overflow`` -> NaN by contract.

A strided recording would leave the FINAL accepted steps (those after the
last stride-aligned record) unrepresented, and the Hermite evaluator would
hold y constant over that tail — exactly where the backward solve starts.
So each lane also carries a rolling ``tail`` row holding its most recent
accepted-but-unrecorded step; the finalizers append it, so the recording
always ends at the last accepted step.

Two layouts:
  batched  — tyf (S, W, B), shared attempt-counter slots, +inf pads for
             rejected attempts, sorted by t afterwards.
  single   — tyf (S, W), per-instance write pointer, accepted steps only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

MAX_THIN = 10


def fdot(rhs, t, y, f, params):
    """Total time derivative of the RHS along the trajectory:
    d f(t, y(t)) / dt = J f + f_t, via one jvp.  Used for quintic Hermite
    checkpoint rows (hermite_order=5); works for both single-instance
    (t scalar, y (n,)) and trailing-batch (t (B,), y (n, B)) signatures."""
    return jax.jvp(
        lambda tt, yy: rhs(tt, yy, params), (t, y), (jnp.ones_like(t), f)
    )[1]


def init_saved_batched(buf0, thinning: bool):
    sv = {
        "tyf": buf0,
        "n_saved": jnp.ones((buf0.shape[-1],), jnp.int32),
        "overflow": jnp.zeros((buf0.shape[-1],), bool),
    }
    if thinning:
        sv["w_ptr"] = jnp.asarray(1, jnp.int32)
        sv["shift"] = jnp.asarray(0, jnp.int32)
        # rolling most-recent accepted-but-unrecorded row per lane
        pad = jnp.full(buf0.shape[1:], jnp.inf, buf0.dtype)
        sv["tail"] = pad.at[1:].set(0.0)
    return sv


def record_step_batched(sv, it, accept, row, save_steps: int, thinning: bool):
    """One recording update for the batched cores.

    ``row`` (W, B) already holds the +inf pad for rejected lanes.
    ``it`` is the shared attempt counter (this attempt's index).
    """
    if not thinning:
        # legacy clamp semantics: once the shared counter clamps to the last
        # slot, a REJECTED attempt must not pad over a previously-valid row,
        # and any clamped VALID write flags overflow
        slot = jnp.minimum(it + 1, save_steps - 1)
        clamped = it + 1 >= save_steps
        old_row = lax.dynamic_index_in_dim(sv["tyf"], slot, 0, keepdims=False)
        row = jnp.where((clamped & ~accept)[None, :], old_row, row)
        buf = lax.dynamic_update_index_in_dim(sv["tyf"], row, slot, 0)
        return dict(
            tyf=buf,
            n_saved=sv["n_saved"] + accept.astype(jnp.int32),
            overflow=sv["overflow"] | (accept & clamped),
        )

    shift, w_ptr = sv["shift"], sv["w_ptr"]
    mask = jnp.left_shift(jnp.int32(1), shift) - 1
    rec = ((it + 1) & mask) == 0  # shared: record this attempt?
    need_compact = rec & (w_ptr >= save_steps) & (shift < MAX_THIN)

    kept = (save_steps + 1) // 2

    def compact(args):
        buf, w_ptr, shift = args
        half = buf[::2]
        pad_rows = jnp.full(
            (save_steps - kept,) + buf.shape[1:], jnp.inf, buf.dtype
        )
        return (
            jnp.concatenate([half, pad_rows], axis=0),
            jnp.asarray(kept, jnp.int32),
            shift + 1,
        )

    buf, w_ptr, shift = lax.cond(
        need_compact, compact, lambda a: a, (sv["tyf"], w_ptr, shift)
    )
    # the stride may have doubled: re-test this attempt against the new mask
    mask = jnp.left_shift(jnp.int32(1), shift) - 1
    rec = ((it + 1) & mask) == 0
    full = w_ptr >= save_steps  # only when shift hit MAX_THIN
    do_write = rec & ~full

    slot = jnp.minimum(w_ptr, save_steps - 1)
    old_row = lax.dynamic_index_in_dim(buf, slot, 0, keepdims=False)
    # Per-lane candidate at a record event: an accepted lane records its new
    # step; a lane that REJECTED this attempt records its fresh rolling tail
    # (its most recent accepted-but-unrecorded step) instead of losing the
    # record opportunity to a +inf pad.  Without this, desynchronized lanes
    # see effective checkpoint spacing well beyond the nominal 2^shift.
    tail_fresh = jnp.isfinite(sv["tail"][0])  # (B,)
    cand = jnp.where(
        accept[None, :], row, jnp.where(tail_fresh[None, :], sv["tail"], row)
    )
    wrow = jnp.where(do_write, cand, old_row)
    buf = lax.dynamic_update_index_in_dim(buf, wrow, slot, 0)
    # rolling tail: an accepted step that was NOT regularly recorded becomes
    # the lane's tail; a recorded row (new step or old tail) clears it (the
    # recording now ends at that lane's latest accepted step)
    recorded = do_write & (accept | tail_fresh)
    pad = jnp.full(row.shape, jnp.inf, row.dtype).at[1:].set(0.0)
    tail = jnp.where(
        (accept & ~do_write)[None, :],
        row,
        jnp.where(recorded[None, :], pad, sv["tail"]),
    )
    return dict(
        tyf=buf,
        n_saved=sv["n_saved"] + accept.astype(jnp.int32),
        # a step that SHOULD record at the current stride but cannot (stride
        # already at MAX_THIN and the buffer is full) is silently lost ->
        # poison by contract.  `full` between fills is normal (compaction
        # happens lazily at the next recording attempt), not overflow.
        overflow=sv["overflow"] | (accept & rec & full),
        w_ptr=w_ptr + jnp.int32(do_write),
        shift=shift,
        tail=tail,
    )


def finalize_saved_batched(sv, n: int, thinning: bool):
    """Sort rows by time (pads go last) and build the saved dict the Hermite
    evaluator consumes.  Under thinning, n_saved = per-lane finite-row count
    (recorded rows), not the accepted-step count."""
    buf = sv["tyf"]
    if thinning:
        # append each lane's rolling tail so the recording ends at the last
        # accepted step (sorted into place below; stale pads sort last)
        buf = jnp.concatenate([buf, sv["tail"][None]], axis=0)
    order = jnp.argsort(buf[:, 0, :], axis=0)
    buf = jnp.take_along_axis(buf, order[:, None, :], axis=0)
    n_rows = (
        jnp.sum(jnp.isfinite(buf[:, 0, :]), axis=0).astype(jnp.int32)
        if thinning
        else sv["n_saved"]
    )
    # quintic rows carry fdot; BDF quintic rows additionally carry a
    # trailing per-lane L ~ ||J|| scalar for the evaluator's stiffness gate
    has_L = buf.shape[1] == 2 + 3 * n
    yf_end = 1 + 3 * n if (has_L or buf.shape[1] == 1 + 3 * n) else 1 + 2 * n
    out = {
        "t": buf[:, 0, :],
        "y": buf[:, 1 : n + 1, :],
        "f": buf[:, n + 1 : 2 * n + 1, :],
        # (S, 2n|3n, B) y|f[|fd] table: fast Hermite row gathers
        "yf": buf[:, 1:yf_end, :],
        "n_saved": n_rows,
        "overflow": sv["overflow"],
    }
    if yf_end == 1 + 3 * n:
        out["fd"] = buf[:, 2 * n + 1 : 3 * n + 1, :]
    if has_L:
        out["L"] = buf[:, 1 + 3 * n, :]
    return out


def init_saved_single(buf0, thinning: bool):
    sv = {
        "tyf": buf0,
        "n_saved": jnp.asarray(1, jnp.int32),
        "overflow": jnp.asarray(False),
    }
    if thinning:
        sv["shift"] = jnp.asarray(0, jnp.int32)
        sv["k"] = jnp.asarray(0, jnp.int32)  # accepted-step counter
        sv["tail"] = jnp.full(buf0.shape[1:], jnp.inf, buf0.dtype).at[1:].set(0.0)
    return sv


def record_step_single(sv, accept, row, save_steps: int, thinning: bool):
    """One recording update for the single-instance cores.  ``row`` (W,)."""
    if not thinning:
        ns = sv["n_saved"]
        slot = jnp.minimum(ns, save_steps - 1)
        buf = sv["tyf"].at[slot].set(jnp.where(accept, row, sv["tyf"][slot]))
        return dict(
            tyf=buf,
            n_saved=jnp.where(
                accept, jnp.minimum(ns + 1, save_steps), ns
            ).astype(jnp.int32),
            overflow=sv["overflow"] | (accept & (ns >= save_steps)),
        )

    shift, k, ns = sv["shift"], sv["k"], sv["n_saved"]
    k_new = jnp.where(accept, k + 1, k)
    mask = jnp.left_shift(jnp.int32(1), shift) - 1
    rec = accept & ((k_new & mask) == 0)
    need_compact = rec & (ns >= save_steps) & (shift < MAX_THIN)

    kept = (save_steps + 1) // 2

    def compact(args):
        buf, ns, shift = args
        half = buf[::2]
        pad_rows = jnp.full(
            (save_steps - kept,) + buf.shape[1:], jnp.inf, buf.dtype
        )
        return (
            jnp.concatenate([half, pad_rows], axis=0),
            jnp.asarray(kept, jnp.int32),
            shift + 1,
        )

    buf, ns, shift = lax.cond(
        need_compact, compact, lambda a: a, (sv["tyf"], ns, shift)
    )
    mask = jnp.left_shift(jnp.int32(1), shift) - 1
    rec = accept & ((k_new & mask) == 0)
    full = ns >= save_steps
    do_write = rec & ~full
    slot = jnp.minimum(ns, save_steps - 1)
    buf = buf.at[slot].set(jnp.where(do_write, row, buf[slot]))
    pad = jnp.full(row.shape, jnp.inf, row.dtype).at[1:].set(0.0)
    tail = jnp.where(
        accept & ~do_write, row, jnp.where(do_write, pad, sv["tail"])
    )
    return dict(
        tyf=buf,
        n_saved=(ns + jnp.int32(do_write)).astype(jnp.int32),
        overflow=sv["overflow"] | (rec & full),
        shift=shift,
        k=k_new,
        tail=tail,
    )


def finalize_saved_single(sv, thinning: bool):
    """(tyf, n_saved, overflow) with the rolling tail appended (thinning).

    The returned buffer has one extra row of capacity so the tail always
    fits; rows stay strictly time-ordered (the tail, when present, is more
    recent than every recorded row by construction)."""
    buf, ns = sv["tyf"], sv["n_saved"]
    if not thinning:
        return buf, ns, sv["overflow"]
    pad = jnp.full((1,) + buf.shape[1:], jnp.inf, buf.dtype).at[:, 1:].set(0.0)
    buf = jnp.concatenate([buf, pad], axis=0)
    tail = sv["tail"]
    fresh = jnp.isfinite(tail[0])
    slot = jnp.minimum(ns, buf.shape[0] - 1)
    buf = buf.at[slot].set(jnp.where(fresh, tail, buf[slot]))
    return buf, ns + fresh.astype(jnp.int32), sv["overflow"]
