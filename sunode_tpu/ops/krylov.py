"""Matrix-free GMRES for the Newton systems (SPGMR analog).

Replaces the reference's ``sunlinsol_spgmr`` path (linear_solver='spgmr',
reference sunode/solver.py:326-358): solves (I - c J) x = b using only
Jacobian-vector products (jvp), no materialized Jacobian.

Hand-rolled (rather than jax.scipy.sparse.linalg.gmres) because the Newton
loop needs a fixed-structure implementation: the least-squares solve uses
Givens rotations and explicit back-substitution in pure elementwise jnp
(written where XLA's f64 TriangularSolve was unavailable; whether XLA's own
triangular solve beats it on the GPU is for the ledger to decide).
Restart-free GMRES(m) with CVODES's default Krylov
depth (maxl=5)."""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["gmres_solve", "gmres_solve_batched", "DEFAULT_MAXL"]

DEFAULT_MAXL = 5


def gmres_solve(matvec: Callable, b: jnp.ndarray, maxl: int = DEFAULT_MAXL):
    """Approximately solve A x = b via GMRES(maxl) from x0 = 0.

    Statically unrolled over the (small) Krylov dimension; returns the
    least-squares solution in the Krylov space.  Breakdown-safe: zero
    residual or lucky breakdown yield the exact solution so far.
    """
    n = b.shape[0]
    dtype = b.dtype
    m = min(maxl, n)

    beta = jnp.sqrt(jnp.sum(b * b))
    safe_beta = jnp.where(beta == 0, 1.0, beta)
    V = [b / safe_beta]  # Krylov basis vectors
    H = np.zeros((m + 1, m), dtype=object)  # entries are traced scalars
    for i in range(m + 1):
        for j in range(m):
            H[i, j] = jnp.asarray(0.0, dtype)

    # Arnoldi (modified Gram-Schmidt), statically unrolled
    for j in range(m):
        w = matvec(V[j])
        for i in range(j + 1):
            hij = jnp.sum(w * V[i])
            H[i, j] = hij
            w = w - hij * V[i]
        hnext = jnp.sqrt(jnp.sum(w * w))
        H[j + 1, j] = hnext
        safe_h = jnp.where(hnext == 0, 1.0, hnext)
        V.append(w / safe_h)

    # Givens rotations to triangularize H, transforming g = beta e1
    g = [beta] + [jnp.asarray(0.0, dtype) for _ in range(m)]
    R = H.copy()
    rots: list = []
    for j in range(m):
        for i in range(j):
            # apply previous rotation i to column j
            c_i, s_i = rots[i]
            tmp = c_i * R[i, j] + s_i * R[i + 1, j]
            R[i + 1, j] = -s_i * R[i, j] + c_i * R[i + 1, j]
            R[i, j] = tmp
        # new rotation to zero R[j+1, j]
        a, bb = R[j, j], R[j + 1, j]
        r = jnp.sqrt(a * a + bb * bb)
        safe_r = jnp.where(r == 0, 1.0, r)
        c_j = jnp.where(r == 0, 1.0, a / safe_r)
        s_j = jnp.where(r == 0, 0.0, bb / safe_r)
        rots.append((c_j, s_j))
        R[j, j] = c_j * a + s_j * bb
        R[j + 1, j] = jnp.asarray(0.0, dtype)
        tmp = c_j * g[j] + s_j * g[j + 1]
        g[j + 1] = -s_j * g[j] + c_j * g[j + 1]
        g[j] = tmp

    # back substitution R y = g (upper triangular, m x m)
    y = [jnp.asarray(0.0, dtype) for _ in range(m)]
    for i in range(m - 1, -1, -1):
        acc = g[i]
        for j in range(i + 1, m):
            acc = acc - R[i, j] * y[j]
        denom = jnp.where(R[i, i] == 0, 1.0, R[i, i])
        y[i] = jnp.where(R[i, i] == 0, 0.0, acc / denom)

    x = jnp.zeros_like(b)
    for j in range(m):
        x = x + y[j] * V[j]
    return x


def gmres_solve_batched(
    matvec: Callable, b: jnp.ndarray, maxl: int = DEFAULT_MAXL
):
    """Structure-of-arrays GMRES(maxl): solve A_l x_l = b_l for B lanes in
    lockstep.

    ``b`` is (n, B); ``matvec`` maps (n, B) -> (n, B) applying each lane's
    operator to its own column.  The scalar recurrences of ``gmres_solve``
    (Arnoldi coefficients, Givens rotations, back-substitution) become
    (B,)-vector elementwise ops — one static unroll over the Krylov
    dimension whose body is fused elementwise arithmetic over all lanes, the same
    SoA pattern as the batched banded LU (ops/bdf_batched.py).  Per-lane
    inner products are sums over axis 0 only.
    """
    n, B = b.shape
    dtype = b.dtype
    m = min(maxl, n)

    def dot(u, v):
        return jnp.sum(u * v, axis=0)  # (B,)

    beta = jnp.sqrt(dot(b, b))
    safe_beta = jnp.where(beta == 0, 1.0, beta)
    V = [b / safe_beta[None, :]]
    H = np.zeros((m + 1, m), dtype=object)
    for i in range(m + 1):
        for j in range(m):
            H[i, j] = jnp.zeros((B,), dtype)

    # Arnoldi (modified Gram-Schmidt), statically unrolled
    for j in range(m):
        w = matvec(V[j])
        for i in range(j + 1):
            hij = dot(w, V[i])
            H[i, j] = hij
            w = w - hij[None, :] * V[i]
        hnext = jnp.sqrt(dot(w, w))
        H[j + 1, j] = hnext
        safe_h = jnp.where(hnext == 0, 1.0, hnext)
        V.append(w / safe_h[None, :])

    # Givens rotations, per-lane
    g = [beta] + [jnp.zeros((B,), dtype) for _ in range(m)]
    R = H.copy()
    rots: list = []
    for j in range(m):
        for i in range(j):
            c_i, s_i = rots[i]
            tmp = c_i * R[i, j] + s_i * R[i + 1, j]
            R[i + 1, j] = -s_i * R[i, j] + c_i * R[i + 1, j]
            R[i, j] = tmp
        a, bb = R[j, j], R[j + 1, j]
        r = jnp.sqrt(a * a + bb * bb)
        safe_r = jnp.where(r == 0, 1.0, r)
        c_j = jnp.where(r == 0, 1.0, a / safe_r)
        s_j = jnp.where(r == 0, 0.0, bb / safe_r)
        rots.append((c_j, s_j))
        R[j, j] = c_j * a + s_j * bb
        R[j + 1, j] = jnp.zeros((B,), dtype)
        tmp = c_j * g[j] + s_j * g[j + 1]
        g[j + 1] = -s_j * g[j] + c_j * g[j + 1]
        g[j] = tmp

    # back substitution, per-lane
    y = [jnp.zeros((B,), dtype) for _ in range(m)]
    for i in range(m - 1, -1, -1):
        acc = g[i]
        for j in range(i + 1, m):
            acc = acc - R[i, j] * y[j]
        denom = jnp.where(R[i, i] == 0, 1.0, R[i, i])
        y[i] = jnp.where(R[i, i] == 0, 0.0, acc / denom)

    x = jnp.zeros_like(b)
    for j in range(m):
        x = x + y[j][None, :] * V[j]
    return x
