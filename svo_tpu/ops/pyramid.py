"""Image pyramids.

Two pyramid flavors, matching the reference's two consumers:
- KLT pyramid: successive 5x5 Gaussian blur + 2x decimation, the cv2
  pyrDown/buildOpticalFlowPyramid scheme used by cv::calcOpticalFlowPyrLK
  (reference call sites: src/tracking.cpp:98-105, 157-164).
- Detection pyramid: geometric rescale chain (factor 1.2) for the ORB-style
  multi-scale detector (reference: src/tracking.cpp:42-52).

Every filter here is expressed as shifted adds over the full image, which
XLA fuses into a handful of bandwidth-bound passes, instead of a
single-channel convolution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# pyrDown kernel [1,4,6,4,1]/16, separable.
_PYR_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _shift(img: jnp.ndarray, off: int, axis: int) -> jnp.ndarray:
    """img shifted so result[i] = img[i + off], edge-clamped (replicate
    border — within 2px of cv2's reflect border, irrelevant for tracking)."""
    if off == 0:
        return img
    n = img.shape[axis]
    sl = [slice(None)] * img.ndim
    if off > 0:
        sl[axis] = slice(off, n)
        core = img[tuple(sl)]
        edge_sl = [slice(None)] * img.ndim
        edge_sl[axis] = slice(n - 1, n)
        edge = img[tuple(edge_sl)]
        reps = [1] * img.ndim
        reps[axis] = off
        return jnp.concatenate([core, jnp.tile(edge, reps)], axis=axis)
    off = -off
    sl[axis] = slice(0, n - off)
    core = img[tuple(sl)]
    edge_sl = [slice(None)] * img.ndim
    edge_sl[axis] = slice(0, 1)
    edge = img[tuple(edge_sl)]
    reps = [1] * img.ndim
    reps[axis] = off
    return jnp.concatenate([jnp.tile(edge, reps), core], axis=axis)


def _tap_filter(img: jnp.ndarray, taps, axis: int) -> jnp.ndarray:
    """1D FIR along an axis as shifted adds."""
    r = len(taps) // 2
    out = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        term = _shift(img, i - r, axis) * t
        out = term if out is None else out + term
    return out


def _sep_filter(img: jnp.ndarray, taps) -> jnp.ndarray:
    """Separable 2D filter with replicate border."""
    return _tap_filter(_tap_filter(img, taps, 0), taps, 1)


import functools


@functools.lru_cache(maxsize=None)
def _decim_matrix(n_in: int):
    """(ceil(n/2), n) matrix folding the 5-tap blur and the stride-2
    decimation into one banded operator: out[i] = sum_k taps[k] *
    x[clip(2i + k - 2, 0, n-1)] — exactly blur-with-replicate-border then
    take every 2nd sample. Cached as a HOST array (a cached jnp array traced
    once would leak the tracer); jnp ops consume it as a constant."""
    import numpy as np

    n_out = -(-n_in // 2)
    M = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        for k, t in enumerate(_PYR_TAPS):
            M[i, min(max(2 * i + k - 2, 0), n_in - 1)] += t
    return M


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """cv2-style pyrDown: 5x5 Gaussian blur then take every 2nd pixel.
    Output shape: ceil(H/2) x ceil(W/2).

    Blur+decimate per axis as one banded matmul (a stride-2 slice after a
    separate blur is the plain alternative; on the GPU the two have not been
    compared)."""
    h, w = img.shape[-2:]
    Dh = jnp.asarray(_decim_matrix(h))   # (h2, h)
    Dw = jnp.asarray(_decim_matrix(w))   # (w2, w)
    return (Dh @ img) @ Dw.T


def klt_pyramid(img: jnp.ndarray, max_level: int) -> list[jnp.ndarray]:
    """Levels 0..max_level (cv2 maxLevel semantics: max_level+1 images)."""
    levels = [img]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels


def _resize_matrix(n_in: int, n_out: int):
    """(n_in, n_out) linear-interpolation matrix (align_corners=False, the
    cv2/jax 'linear' convention), built host-side as a dense constant."""
    import numpy as np

    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    src = np.clip(src, 0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = (src - i0).astype(np.float32)
    M = np.zeros((n_in, n_out), np.float32)
    M[i0, np.arange(n_out)] += 1.0 - f
    M[i1, np.arange(n_out)] += f
    return jnp.asarray(M)


def resize_linear(img: jnp.ndarray, nh: int, nw: int) -> jnp.ndarray:
    """Bilinear resize as two matmuls with dense interpolation matrices."""
    h, w = img.shape
    Mh = _resize_matrix(h, nh)  # (h, nh)
    Mw = _resize_matrix(w, nw)  # (w, nw)
    return (Mh.T @ img) @ Mw


def scale_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float) -> list[jnp.ndarray]:
    """Geometric pyramid for multi-scale detection (ORB scale_factor chain)."""
    h, w = img.shape
    levels = [img]
    for l in range(1, n_levels):
        s = scale_factor ** l
        nh, nw = max(int(round(h / s)), 16), max(int(round(w / s)), 16)
        levels.append(resize_linear(img, nh, nw))
    return levels


def sobel_gradients(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Sobel dx, dy (cv2 kernel, no scaling)."""
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    ix = _tap_filter(_tap_filter(img, smooth, 0), diff, 1)
    iy = _tap_filter(_tap_filter(img, diff, 0), smooth, 1)
    return ix, iy


def scharr_gradients(img: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Scharr dx, dy with cv2's 1/32 normalization — the gradient filter
    cv::calcOpticalFlowPyrLK uses internally for the spatial derivative."""
    smooth = (3.0 / 32, 10.0 / 32, 3.0 / 32)
    diff = (-1.0, 0.0, 1.0)
    ix = _tap_filter(_tap_filter(img, smooth, 0), diff, 1)
    iy = _tap_filter(_tap_filter(img, diff, 0), smooth, 1)
    return ix, iy


def box_filter(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """Sliding-window sum (not mean) with zero padding, separable.

    Uses a prefix-sum (integral image) per axis: O(1) per pixel regardless of
    window size — the 7/21-tap windows this pipeline needs would otherwise be
    7-21 shifted adds each."""
    pad = size // 2
    for axis in (0, 1):
        n = img.shape[axis]
        c = jnp.cumsum(img, axis=axis)
        zero_shape = list(img.shape)
        zero_shape[axis] = 1
        c = jnp.concatenate([jnp.zeros(zero_shape, img.dtype), c], axis=axis)
        # windowed sum over [i-pad, i+size-pad-1] with zero padding
        hi = jnp.clip(jnp.arange(n) + (size - pad), 0, n)
        lo = jnp.clip(jnp.arange(n) - pad, 0, n)
        img = jnp.take(c, hi, axis=axis) - jnp.take(c, lo, axis=axis)
    return img
