"""Small-matrix linear algebra in closed or fixed-iteration form.

For the tiny batched systems this pipeline needs (3x3/4x4 inverses,
smallest eigenvectors of 4x4/12x12 normal matrices, SO(3) projection) the
formulations below are plain elementwise arithmetic that XLA fuses, instead
of the library solvers' iterative sweeps or custom calls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3x3(A: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Batched closed-form (adjugate) inverse of (...,3,3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps, eps, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def det3x3(A: jnp.ndarray) -> jnp.ndarray:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def polar3x3(M: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Closest rotation to (...,3,3) M via scaled Newton polar iteration:
    X <- 0.5 (X / s + s X^-T), with s the geometric scale. det<0 inputs are
    reflected to the det>0 branch (returns a proper rotation).

    Replaces SVD-based orthogonalization (se3.orthogonalize) on the hot
    path."""
    det = det3x3(M)
    sign = jnp.where(det < 0, -1.0, 1.0)
    X = M * sign[..., None, None]

    # statically unrolled: each update is a handful of fused elementwise ops
    for _ in range(iters):
        Xinv_T = jnp.swapaxes(inv3x3(X), -1, -2)
        # scale for fast convergence: s = sqrt(|X^-1| / |X|) (Frobenius)
        nx = jnp.sqrt(jnp.sum(X * X, axis=(-1, -2)) + 1e-20)
        ni = jnp.sqrt(jnp.sum(Xinv_T * Xinv_T, axis=(-1, -2)) + 1e-20)
        s = jnp.sqrt(ni / nx)[..., None, None]
        X = 0.5 * (X * s + Xinv_T / s)
    return X


def cholesky_unrolled(B: jnp.ndarray) -> jnp.ndarray:
    """Batched Cholesky of small PD (..., n, n) matrices, fully unrolled.

    n<=12 unrolled column steps are a few hundred fused elementwise ops, in
    place of the library factorization's per-matrix custom call. No
    pivoting — callers pass shifted PD matrices."""
    n = B.shape[-1]
    L = jnp.zeros_like(B)
    for j in range(n):
        # L[j,j] = sqrt(B[j,j] - sum_k<j L[j,k]^2)
        s = B[..., j, j]
        if j:
            s = s - jnp.sum(L[..., j, :j] * L[..., j, :j], axis=-1)
        djj = jnp.sqrt(jnp.maximum(s, 1e-20))
        L = L.at[..., j, j].set(djj)
        if j + 1 < n:
            r = B[..., j + 1:, j]
            if j:
                r = r - jnp.einsum(
                    "...ik,...k->...i", L[..., j + 1:, :j], L[..., j, :j]
                )
            L = L.at[..., j + 1:, j].set(r / djj[..., None])
    return L


def cho_solve_unrolled(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve (L L^T) x = b for small unrolled-Cholesky factors (..., n, n)."""
    n = L.shape[-1]
    # forward: L y = b
    y = jnp.zeros_like(b)
    for i in range(n):
        s = b[..., i]
        if i:
            s = s - jnp.sum(L[..., i, :i] * y[..., :i], axis=-1)
        y = y.at[..., i].set(s / L[..., i, i])
    # backward: L^T x = y
    x = jnp.zeros_like(b)
    for i in range(n - 1, -1, -1):
        s = y[..., i]
        if i + 1 < n:
            s = s - jnp.sum(L[..., i + 1:, i] * x[..., i + 1:], axis=-1)
        x = x.at[..., i].set(s / L[..., i, i])
    return x


def smallest_eigvec_psd(
    A: jnp.ndarray, shift: float = 1e-6, iters: int = 8
) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of a symmetric PSD (..., n, n)
    matrix via inverse iteration: x <- (A + shift*tr(A)/n*I)^-1 x, normalized.

    The shifted matrix is factored once with the unrolled Cholesky (fused
    elementwise work in place of jnp.linalg.inv's per-matrix LU); each
    iteration is then two unrolled triangular solves. Replaces eigh on the RANSAC/DLT hot path."""
    n = A.shape[-1]
    tr = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None] / n
    B = A + (shift * tr + 1e-12) * jnp.eye(n, dtype=A.dtype)
    L = cholesky_unrolled(B)

    x = jnp.ones(A.shape[:-1], A.dtype)
    for _ in range(iters):
        y = cho_solve_unrolled(L, x)
        x = y / (jnp.linalg.norm(y, axis=-1, keepdims=True) + 1e-20)
    return x


def solve_spd(A: jnp.ndarray, b: jnp.ndarray, damp: float = 0.0) -> jnp.ndarray:
    """Solve small SPD systems (...,n,n) @ x = (...,n). Uses closed-form for
    n=3, jnp.linalg.solve otherwise."""
    n = A.shape[-1]
    if damp:
        A = A + damp * jnp.eye(n, dtype=A.dtype)
    if n == 3:
        return (inv3x3(A) @ b[..., None])[..., 0]
    return jnp.linalg.solve(A, b)
