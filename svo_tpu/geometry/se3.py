"""SE(3) rigid transforms as (..., 4, 4) homogeneous matrices.

Replacement for the reference's Sophus::SE3d usage
(reference: include/frame.h:24, src/tracking.cpp:214-215): composition,
inverse, and the exp/log maps needed for the Gauss-Newton / LM retraction in
PnP refinement and bundle adjustment.

All functions are batched over leading dimensions and safe at the small-angle
limit (Taylor fallbacks), f32-friendly.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def from_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Build (...,4,4) from rotation (...,3,3) and translation (...,3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B (apply B first, then A)."""
    return A @ B


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Analytic inverse: [R t]^-1 = [R^T  -R^T t]."""
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return from_rt(Rt, -(Rt @ t[..., None])[..., 0])


def transform(T: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Apply (...,4,4) to points (...,N,3) or (...,3)."""
    R = rotation(T)
    t = translation(T)
    if X.ndim == T.ndim - 1:  # (...,3)
        return (R @ X[..., None])[..., 0] + t
    return X @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    # Taylor-safe coefficients
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """(...,3,3) rotation -> (...,3) axis-angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # vee of the antisymmetric part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sin(theta)
    small = theta < 1e-4
    # w = theta / (2 sin(theta)) * v  ; near 0: 1/2 * (1 + theta^2/6)
    scale = jnp.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * jnp.where(small, 1.0, sin_theta) + _EPS),
    )
    # Note: theta near pi needs special handling; the VO pipeline only sees
    # small inter-frame rotations, and BA retractions are local. Clamp for
    # numerical sanity.
    return scale[..., None] * v


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential: (...,6) twist [v, w] -> (...,4,4).

    Convention: xi = [v(3), w(3)], T = exp([w]^ , V v)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = I + A[..., None, None] * W + B[..., None, None] * (W @ W)
    V = I + B[..., None, None] * W + C[..., None, None] * (W @ W)
    t = (V @ v[..., None])[..., 0]
    return from_rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """(...,4,4) -> (...,6) twist [v, w], inverse of exp."""
    R = rotation(T)
    t = translation(T)
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    # V^-1 = I - 1/2 W + (1/theta^2)(1 - A/(2B)) W^2
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / jnp.where(small, 1.0, theta2),
    )
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = I - 0.5 * W + coef[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def orthogonalize(R: jnp.ndarray) -> jnp.ndarray:
    """Project (...,3,3) onto SO(3) via SVD (det +1 branch)."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.ones(R.shape[:-2] + (3,), dtype=R.dtype).at[..., 2].set(det)
    return (U * D[..., None, :]) @ Vt
