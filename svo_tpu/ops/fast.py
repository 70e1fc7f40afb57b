"""Dense FAST-9/16 corner detection.

Replacement for cv::FastFeatureDetector (reference:
src/tracking.cpp:54-57, threshold=20, NMS on). Instead of the reference's
per-pixel branchy ring test, the whole image is processed densely:
the 16-pixel Bresenham ring becomes 16 shifted copies of the image, the
contiguous-arc test becomes 16 windowed ANDs, and the corner score is computed
in closed form as the largest threshold at which the pixel remains a corner
(the same definition cv2's score uses).
"""

from __future__ import annotations

import jax.numpy as jnp

# OpenCV's 16-point Bresenham circle of radius 3, clockwise from 12 o'clock.
# (dx, dy) offsets.
RING = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

ARC = 9  # FAST-9: at least 9 contiguous ring pixels brighter/darker


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST corner score map.

    Args:
        img: (H, W) float32 grayscale in [0, 255].
        threshold: detection threshold t.
    Returns:
        (H, W) float32 score map; score > 0 exactly where the FAST-9 test at
        `threshold` passes. Score is the margin above threshold of the best
        contiguous arc (max over arcs of min over arc of |ring - p| - t).
        A 3-pixel border is always zero.
    """
    H, W = img.shape
    p = img
    # Ring values via rolls: ring_k[y, x] = img[y + dy, x + dx].
    # jnp.roll(img, (-dy, -dx)) places img[y+dy, x+dx] at [y, x].
    diffs = []
    for dx, dy in RING:
        shifted = jnp.roll(img, (-dy, -dx), axis=(0, 1))
        diffs.append(shifted - p)
    d = jnp.stack(diffs)  # (16, H, W): ring minus center

    # Circular windows of length ARC: wrap by concatenating the first ARC-1.
    d_ext = jnp.concatenate([d, d[: ARC - 1]], axis=0)  # (24, H, W)

    # bright arc margin: min over window of (ring - p); dark: min of (p - ring)
    bright_best = jnp.full((H, W), -jnp.inf, img.dtype)
    dark_best = jnp.full((H, W), -jnp.inf, img.dtype)
    for s in range(16):
        w = d_ext[s : s + ARC]  # (9, H, W)
        bright_best = jnp.maximum(bright_best, jnp.min(w, axis=0))
        dark_best = jnp.maximum(dark_best, jnp.min(-w, axis=0))

    score = jnp.maximum(bright_best, dark_best) - threshold
    score = jnp.maximum(score, 0.0)

    # zero the 3px border (ring would wrap around the image via roll)
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return jnp.where(interior, score, 0.0)
