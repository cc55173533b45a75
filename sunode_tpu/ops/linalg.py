"""Dense & banded linear solves in plain jnp, f64-safe and vmappable.

This module implements LU with partial pivoting out of elementwise/gather
primitives, plus closed-form solves for the tiny systems (n <= 3) that
dominate the vmapped-chains workloads — for a 2-state Lotka-Volterra batch
the Newton solve is pure elementwise arithmetic with no loops at all.  It was
written for a backend whose ``LuDecomposition`` was f32-only; on the GPU,
XLA factors f64 through cuSOLVER, and whether this hand-written LU still pays
is for the ledger to decide.

This is the JAX-native replacement for the reference's SUNLinearSolver layer
(reference sunode/linear_solver_wrapper.py:17-122 wrapping
sunlinsol_dense/lapackdense/klu): "factor once, solve many" maps to
``lu_factor``/``lu_solve``; the tiny-n fast path replaces the LAPACK call
entirely.

All functions take/return plain jnp arrays, are jit/vmap-compatible, and make
no data-dependent control flow (singular pivots yield inf/nan which the step
controller treats as a rejected step — the same recoverable-error contract as
reference symode/problem.py:266-269).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "lu_factor",
    "lu_solve",
    "solve_dense",
    "factor_newton",
    "solve_factored",
]


def lu_factor(A: jnp.ndarray):
    """LU factorization with partial pivoting, Doolittle form.

    Returns (LU, piv) where LU packs unit-lower L below the diagonal and U on
    and above it; piv[k] is the row swapped into position k at step k.
    Pure jnp (fori_loop + masked rank-1 updates).
    """
    n = A.shape[-1]
    idx = jnp.arange(n)

    def body(k, state):
        LU, piv = state
        col = jnp.abs(LU[:, k])
        col = jnp.where(idx >= k, col, -jnp.inf)
        p = jnp.argmax(col).astype(jnp.int32)
        piv = piv.at[k].set(p)
        # swap rows k <-> p
        rk = LU[k]
        rp = LU[p]
        LU = LU.at[k].set(rp).at[p].set(rk)
        pivval = LU[k, k]
        below = idx > k
        mult = jnp.where(below, LU[:, k] / pivval, LU[:, k])
        LU = LU.at[:, k].set(mult)
        row_k = jnp.where(idx > k, LU[k], 0.0)
        mult_below = jnp.where(below, mult, 0.0)
        LU = LU - jnp.outer(mult_below, row_k)
        return LU, piv

    LU, piv = lax.fori_loop(0, n, body, (A, jnp.zeros(n, dtype=jnp.int32)))
    return LU, piv


def lu_solve(LU: jnp.ndarray, piv: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given lu_factor output.  O(n^2) sequential; fine for the
    moderate n of ODE Newton systems."""
    n = LU.shape[-1]
    idx = jnp.arange(n)

    def swap(k, b):
        p = piv[k]
        bk = b[k]
        bp = b[p]
        return b.at[k].set(bp).at[p].set(bk)

    b = lax.fori_loop(0, n, swap, b)

    def fwd(i, b):
        li = jnp.where(idx < i, LU[i], 0.0)
        return b.at[i].add(-jnp.dot(li, b))

    b = lax.fori_loop(1, n, fwd, b)

    def bwd(j, b):
        i = n - 1 - j
        ui = jnp.where(idx > i, LU[i], 0.0)
        val = (b[i] - jnp.dot(ui, b)) / LU[i, i]
        return b.at[i].set(val)

    b = lax.fori_loop(0, n, bwd, b)
    return b


# ---------------------------------------------------------------------------
# Closed forms for tiny systems (the vmapped-chains hot path)
# ---------------------------------------------------------------------------
def _solve1(A, b):
    return b / A[..., 0, 0:1]


def _solve2(A, b):
    a, c = A[..., 0, 0], A[..., 0, 1]
    d, e = A[..., 1, 0], A[..., 1, 1]
    det = a * e - c * d
    x0 = (e * b[..., 0] - c * b[..., 1]) / det
    x1 = (a * b[..., 1] - d * b[..., 0]) / det
    return jnp.stack([x0, x1], axis=-1)


def _solve3(A, b):
    # Cramer's rule via adjugate; 3x3 is still cheap and branch-free.
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) / det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) / det
    return jnp.stack([x0, x1, x2], axis=-1)


_TINY_SOLVERS = {1: _solve1, 2: _solve2, 3: _solve3}

# Below this size, refactoring costs about as much as a closed-form solve, so
# Newton just stores M and solves directly each iteration.
TINY_N = 3


def solve_dense(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """One-shot dense solve, dispatching on static size."""
    n = A.shape[-1]
    if n in _TINY_SOLVERS:
        return _TINY_SOLVERS[n](A, b)
    LU, piv = lu_factor(A)
    return lu_solve(LU, piv, b)


# ---------------------------------------------------------------------------
# Newton-matrix interface: prepare once per (J, c), solve per iteration.
# factors are a fixed-structure pytree so they can live in a while_loop carry.
# ---------------------------------------------------------------------------
def factor_newton(M: jnp.ndarray):
    """Prepare factors of the Newton matrix M = I - c J.

    For tiny n the "factors" are M itself (closed-form solve); otherwise LU.
    Returns a pytree with static structure given static n.
    """
    n = M.shape[-1]
    if n <= TINY_N:
        return (M,)
    return lu_factor(M)

def solve_factored(factors, b: jnp.ndarray) -> jnp.ndarray:
    if len(factors) == 1:
        return solve_dense(factors[0], b)
    LU, piv = factors
    return lu_solve(LU, piv, b)


# ---------------------------------------------------------------------------
# Trailing-batch ("structure of arrays") variants for the batch-native
# integrator: matrices are (n, n, B), vectors (n, B).  The batch axis is the
# minor one, so the tiny closed forms are pure fused elementwise arithmetic
# across all chains at once.
# ---------------------------------------------------------------------------
def _solve1_t(A, b):
    return b / A[0, 0][None]


def _solve2_t(A, b):
    a, c = A[0, 0], A[0, 1]
    d, e = A[1, 0], A[1, 1]
    det = a * e - c * d
    x0 = (e * b[0] - c * b[1]) / det
    x1 = (a * b[1] - d * b[0]) / det
    return jnp.stack([x0, x1])


def _solve3_t(A, b):
    a00, a01, a02 = A[0, 0], A[0, 1], A[0, 2]
    a10, a11, a12 = A[1, 0], A[1, 1], A[1, 2]
    a20, a21, a22 = A[2, 0], A[2, 1], A[2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    b0, b1, b2 = b[0], b[1], b[2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) / det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) / det
    return jnp.stack([x0, x1, x2])


_TINY_SOLVERS_T = {1: _solve1_t, 2: _solve2_t, 3: _solve3_t}


def lu_factor_b(A: jnp.ndarray):
    """Batched LU with partial pivoting on (n, n, B) arrays.

    Row swaps use full-array masked selects (per-lane pivot rows), which is
    O(n^3 B) — the same order as the elimination itself."""
    n, _, B = A.shape
    idx = jnp.arange(n)

    def body(k, state):
        LU, piv = state
        col = jnp.abs(LU[:, k])  # (n, B)
        col = jnp.where((idx >= k)[:, None], col, -jnp.inf)
        p = jnp.argmax(col, axis=0).astype(jnp.int32)  # (B,)
        piv = piv.at[k].set(p)
        rk = LU[k]  # (n, B)
        rp = jnp.take_along_axis(LU, p[None, None, :], axis=0)[0]  # (n, B)
        # row k <- rp; row p <- rk (masked select)
        is_p = (idx[:, None] == p[None, :])[:, None, :]  # (n, 1, B)
        LU = jnp.where(is_p, rk[None, :, :], LU)
        LU = LU.at[k].set(rp)
        pivval = LU[k, k]  # (B,)
        below = (idx > k)[:, None]
        mult = jnp.where(below, LU[:, k] / pivval[None], LU[:, k])
        LU = LU.at[:, k].set(mult)
        row_k = jnp.where((idx > k)[:, None], LU[k], 0.0)  # (n, B)
        mult_below = jnp.where(below, mult, 0.0)
        LU = LU - mult_below[:, None, :] * row_k[None, :, :]
        return LU, piv

    LU, piv = lax.fori_loop(0, n, body, (A, jnp.zeros((n, B), jnp.int32)))
    return LU, piv


def lu_solve_b(LU: jnp.ndarray, piv: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve with lu_factor_b output; b is (n, B)."""
    n, B = b.shape
    idx = jnp.arange(n)

    def swap(k, b):
        p = piv[k]  # (B,)
        bk = b[k]
        bp = jnp.take_along_axis(b, p[None, :], axis=0)[0]
        is_p = idx[:, None] == p[None, :]
        b = jnp.where(is_p, bk[None, :], b)
        b = b.at[k].set(bp)
        return b

    b = lax.fori_loop(0, n, swap, b)

    def fwd(i, b):
        li = jnp.where((idx < i)[:, None], LU[i], 0.0)
        return b.at[i].add(-jnp.sum(li * b, axis=0))

    b = lax.fori_loop(1, n, fwd, b)

    def bwd(j, b):
        i = n - 1 - j
        ui = jnp.where((idx > i)[:, None], LU[i], 0.0)
        val = (b[i] - jnp.sum(ui * b, axis=0)) / LU[i, i]
        return b.at[i].set(val)

    b = lax.fori_loop(0, n, bwd, b)
    return b


def factor_newton_b(M: jnp.ndarray):
    """Batched Newton-matrix preparation on (n, n, B)."""
    n = M.shape[0]
    if n <= TINY_N:
        return (M,)
    return lu_factor_b(M)


def solve_factored_b(factors, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve on (n, B) right-hand sides."""
    if len(factors) == 1:
        M = factors[0]
        n = M.shape[0]
        if n in _TINY_SOLVERS_T:
            return _TINY_SOLVERS_T[n](M, b)
        LU, piv = lu_factor_b(M)
        return lu_solve_b(LU, piv, b)
    LU, piv = factors
    return lu_solve_b(LU, piv, b)
