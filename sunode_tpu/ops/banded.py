"""Banded LU with partial pivoting in banded storage — O(n*(l+u)^2).

The reference links SUNDIALS ``sunlinsol_band`` / ``sunlinsol_lapackband``
(ref build_cvodes.py:45-72); this is the JAX-native equivalent: LAPACK
``gbtrf``/``gbtrs`` re-derived as a ``lax.fori_loop`` over columns with
static-shape windows, so it jits cleanly, vmaps over lanes, and never
materializes the dense matrix.  Newton matrices M = I - c*J keep the
Jacobian's bandwidths, so a bandwidth-w system costs O(n*w^2) per
factorization instead of the dense O(n^3).

Storage convention (scipy ``solve_banded`` style):
    ab[u + i - j, j] = A[i, j]   for -u <= i - j <= l, shape (l+u+1, n)
Factored form adds l fill-in superdiagonals (partial pivoting can push a
row up to l columns right), stored in rows on top:
    lu[(u+l) + i - j, j], shape (2l+u+1, n); L multipliers live below the
    diagonal row (u+l), pivot indices (offsets 0..l) in piv (n,).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "dense_to_banded",
    "banded_to_dense",
    "banded_factor",
    "banded_solve",
    "banded_factor_b",
    "banded_solve_b",
]

_TINY = 1e-300


def dense_to_banded(A: jnp.ndarray, lower: int, upper: int) -> jnp.ndarray:
    """Pack a dense (n, n) matrix into (l+u+1, n) banded storage."""
    n = A.shape[0]
    rows = []
    for r in range(lower + upper + 1):
        # row r holds diagonal d = u - r (d = j - i)
        d = upper - r
        diag = jnp.diagonal(A, offset=d)
        # entry for column j sits at ab[r, j]; diagonal k-th element has
        # j = k + max(d, 0)
        pad_left = max(d, 0)
        row = jnp.zeros((n,), A.dtype)
        row = lax.dynamic_update_slice(row, diag, (pad_left,))
        rows.append(row)
    return jnp.stack(rows)


def banded_to_dense(ab: jnp.ndarray, lower: int, upper: int) -> jnp.ndarray:
    n = ab.shape[1]
    i = jnp.arange(n)[:, None]
    j = jnp.arange(n)[None, :]
    r = upper + i - j
    valid = (r >= 0) & (r <= lower + upper)
    return jnp.where(valid, ab[jnp.clip(r, 0, lower + upper), j], 0.0)


def banded_factor(ab: jnp.ndarray, lower: int, upper: int):
    """Partial-pivoted LU of banded A.  Returns (lu, piv, sing).

    lu: (2l+u+1, n + l + u) working storage (right-padded columns), piv: (n,)
    int32 pivot offsets in [0, l], sing: scalar bool — True when some pivot
    was (near-)zero, i.e. the matrix is numerically singular.  A singular
    factorization must not yield enormous-but-finite garbage corrections
    that only the Newton convergence-rate test can catch, so
    ``banded_solve`` poisons its solution with NaN when ``sing`` is set and
    the Newton loop's isfinite check rejects the step deterministically.
    """
    l, u = lower, upper
    w = l + u  # combined off-diagonal width of the factored U
    n = ab.shape[1]
    dtype = ab.dtype
    nw = n + w
    # expanded + right-padded storage; padding columns get unit diagonal so
    # window arithmetic at the right edge stays benign
    abe = jnp.zeros((2 * l + u + 1, nw), dtype)
    abe = abe.at[l:, :n].set(ab)
    pad_cols = jnp.arange(nw) >= n
    abe = abe.at[w].set(jnp.where(pad_cols, 1.0, abe[w]))

    c_idx = jnp.arange(w + 1)  # window columns 0..w
    d_idx = jnp.arange(1, l + 1)  # subdiagonal offsets
    # static gather maps inside the (2l+u+1, w+1) window
    row_k = w - c_idx  # row k of A at window column c
    tgt_rows = w + d_idx[:, None] - c_idx[None, :]  # (l, w+1) rows k+d

    def col_step(k, state):
        abe, piv, sing = state
        W = lax.dynamic_slice(abe, (0, k), (2 * l + u + 1, w + 1))

        # ---- pivot selection over rows k..k+l of column k ----------------
        col_entries = lax.dynamic_slice_in_dim(W[:, 0], w, l + 1)  # d=0..l
        valid = k + jnp.arange(l + 1) < n
        p = jnp.argmax(jnp.where(valid, jnp.abs(col_entries), -1.0)).astype(
            jnp.int32
        )

        # ---- swap rows k and k+p across window columns -------------------
        i1 = row_k[None, :]  # (1, w+1)
        i2 = (w + p - c_idx)[None, :]
        v1 = jnp.take_along_axis(W, i1, axis=0)
        v2 = jnp.take_along_axis(W, i2, axis=0)
        W = W.at[i1[0], c_idx].set(v2[0])
        W = W.at[i2[0], c_idx].set(v1[0])

        # ---- eliminate ----------------------------------------------------
        pivot = W[w, 0]
        sing = sing | (jnp.abs(pivot) <= _TINY)
        pivot = jnp.where(jnp.abs(pivot) > _TINY, pivot, _TINY)
        mult = W[w + d_idx, 0] / pivot  # (l,)
        urow = W[row_k, c_idx]  # (w+1,) pivot row of U
        T = W[tgt_rows, c_idx[None, :]]  # (l, w+1)
        T_new = T - mult[:, None] * urow[None, :]
        # column 0 stores the L multipliers in place
        T_new = T_new.at[:, 0].set(mult)
        W = W.at[tgt_rows, jnp.broadcast_to(c_idx[None, :], tgt_rows.shape)].set(
            T_new
        )

        abe = lax.dynamic_update_slice(abe, W, (0, k))
        return abe, piv.at[k].set(p), sing

    piv0 = jnp.zeros((n,), jnp.int32)
    lu, piv, sing = lax.fori_loop(
        0, n, col_step, (abe, piv0, jnp.asarray(False))
    )
    return lu, piv, sing


def banded_solve(factors, b: jnp.ndarray, lower: int, upper: int) -> jnp.ndarray:
    """Solve A x = b given banded_factor output (NaN when singular)."""
    lu, piv, sing = factors
    l, u = lower, upper
    w = l + u
    n = b.shape[0]
    d_idx = jnp.arange(1, l + 1)
    c_idx = jnp.arange(1, w + 1)

    # forward: apply row swaps + L (right-padded so windows stay in range)
    bp = jnp.concatenate([b, jnp.zeros((l,), b.dtype)])

    def fwd(k, bp):
        seg = lax.dynamic_slice_in_dim(bp, k, l + 1)
        p = piv[k]
        bk = seg[p]
        seg = seg.at[p].set(seg[0]).at[0].set(bk)
        mult = lax.dynamic_slice(lu, (w + 1, k), (l, 1))[:, 0]
        seg = seg.at[d_idx].add(-mult * bk)
        return lax.dynamic_update_slice_in_dim(bp, seg, k, 0)

    bp = lax.fori_loop(0, n, fwd, bp)

    # backward: U x = y, U row k spans columns k..k+w
    xp = jnp.concatenate([bp[:n], jnp.zeros((w,), b.dtype)])

    def bwd(i, xp):
        k = n - 1 - i
        Wk = lax.dynamic_slice(lu, (0, k), (w + 1, w + 1))
        urow = Wk[w - jnp.arange(w + 1), jnp.arange(w + 1)]  # U[k, k..k+w]
        xs = lax.dynamic_slice_in_dim(xp, k, w + 1)
        s = xs[0] - jnp.sum(urow[c_idx] * xs[c_idx])
        diag = jnp.where(jnp.abs(urow[0]) > _TINY, urow[0], _TINY)
        return xp.at[k].set(s / diag)

    xp = lax.fori_loop(0, n, bwd, xp)
    return jnp.where(sing, jnp.nan, xp[:n])


def banded_factor_b(ab_b: jnp.ndarray, lower: int, upper: int):
    """Batched variant: ab_b (B, l+u+1, n) -> (lu_b, piv_b)."""
    return jax.vmap(lambda ab: banded_factor(ab, lower, upper))(ab_b)


def banded_solve_b(factors_b, b_b: jnp.ndarray, lower: int, upper: int):
    """Batched variant: b_b (B, n)."""
    return jax.vmap(
        lambda f0, f1, f2, bb: banded_solve((f0, f1, f2), bb, lower, upper)
    )(factors_b[0], factors_b[1], factors_b[2], b_b)
