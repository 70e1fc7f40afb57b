"""Batched DLT triangulation with cheirality masking.

Replacement for cv::triangulatePoints + convertPointsFromHomogeneous
+ the z>0 cheirality filter (reference: src/tracking.cpp:120-152). The whole
feature set is triangulated as one batched 4x4 eigenproblem; invalid/filtered
points are masked, never compacted (static shapes under jit).
"""

from __future__ import annotations

import jax.numpy as jnp


def triangulate_dlt(
    P_left: jnp.ndarray,
    P_right: jnp.ndarray,
    uv_left: jnp.ndarray,
    uv_right: jnp.ndarray,
) -> jnp.ndarray:
    """Linear (DLT) triangulation.

    Args:
        P_left, P_right: (3,4) projection matrices.
        uv_left, uv_right: (...,2) pixel coordinates.
    Returns:
        (...,3) points in the projection frame (left camera = world here,
        matching cv::triangulatePoints semantics used by the reference).
    """
    # Rows of A: u*P[2] - P[0],  v*P[2] - P[1]  for each view. A is (...,4,4).
    rows = []
    for P, uv in ((P_left, uv_left), (P_right, uv_right)):
        rows.append(uv[..., 0:1] * P[2] - P[0])
        rows.append(uv[..., 1:2] * P[2] - P[1])
    A = jnp.stack(rows, axis=-2)
    # Row-normalize for conditioning (scale-invariant in exact arithmetic,
    # stabilizes f32 eigh).
    A = A / (jnp.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    # Smallest eigenvector of A^T A (symmetric 4x4) = null direction.
    AtA = jnp.swapaxes(A, -1, -2) @ A
    _, V = jnp.linalg.eigh(AtA)  # ascending eigenvalues
    Xh = V[..., :, 0]
    w = Xh[..., 3:4]
    return Xh[..., :3] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)


def triangulate_rectified(
    fx: jnp.ndarray,
    baseline: jnp.ndarray,
    uv_left: jnp.ndarray,
    uv_right: jnp.ndarray,
    K: jnp.ndarray,
) -> jnp.ndarray:
    """Closed-form triangulation for a rectified rig (disparity route).

    Faster than DLT; valid when images are rectified (KITTI is). Kept as an
    alternative backend; the default pipeline uses DLT for parity with the
    reference (src/tracking.cpp:125-129)."""
    disparity = uv_left[..., 0] - uv_right[..., 0]
    z = fx * baseline / jnp.where(jnp.abs(disparity) < 1e-6, 1e-6, disparity)
    cx, cy = K[0, 2], K[1, 2]
    fy = K[1, 1]
    x = (uv_left[..., 0] - cx) / fx * z
    y = (uv_left[..., 1] - cy) / fy * z
    return jnp.stack([x, y, z], axis=-1)
