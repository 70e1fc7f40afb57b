"""Batched pyramidal Lucas-Kanade optical flow.

Replacement for cv::calcOpticalFlowPyrLK at both reference call
sites: stereo left->right matching (src/tracking.cpp:98-105, 11x11 window,
maxLevel 3, 30 iters, eps 1e-3) and temporal prev->curr tracking
(src/tracking.cpp:157-164, 21x21, maxLevel 3, 50 iters, eps 1e-3,
OPTFLOW_LK_GET_MIN_EIGENVALS -> min-eigenvalue rejection).

Design (no per-pixel pointer chasing):
- Per pyramid level, one rectangular PATCH per feature is extracted per
  image (template + its two gradients at the feature's integer corner;
  current image at the flow-predicted corner) with a vmapped
  dynamic_slice, which XLA emits as one gather.
- All LK iterations then run DENSE inside these (N, PY, PX) arrays:
  fractional sampling is a pair of one-hot blend contractions, so the
  inner loop has no gathers.
- Template gradients and the 2x2 normal matrix G are computed once per level
  (cv2 does the same); each iteration only recomputes the image difference
  and the right-hand side b. Iterations run a fixed budget with a
  convergence mask (eps semantics preserved; converged features stop
  moving — same result as cv2's early exit).
- Features whose window would leave the valid patch area or the image are
  marked lost, matching cv2's border behavior.

Min-eigenvalue rejection: cv2 (with OPTFLOW_LK_GET_MIN_EIGENVALS) kills
features whose min eigenvalue of G / window_area falls below minEigThreshold;
same rule implemented here (also applied without the flag, as cv2 does for
G's invertibility check).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from svo_tpu.config import KltParams
from svo_tpu.ops.pyramid import klt_pyramid, scharr_gradients


class KltResult(NamedTuple):
    pos: jnp.ndarray     # (N, 2) tracked positions (x, y) in the new image
    status: jnp.ndarray  # (N,) bool — survived tracking
    err: jnp.ndarray     # (N,) min eigenvalue (flag semantics) at level 0


# Pyramid levels are edge-replicate padded at build time (cv2's
# buildOpticalFlowPyramid does the same with BORDER_REFLECT_101) so that a
# feature anywhere in the true image always has a full patch around it —
# without padding, features near borders of small levels lose their patch
# slot to the corner clamp and die (~25% of tracks on 240x320 test images).
_PAD_Y = 24
_PAD_X = 32


# Margin-based patch geometry: the window's top-left sits at a fixed small
# margin inside the patch instead of at its center. Round-2 centered patches
# were 48x64 to cover centering + alignment + travel; the margins shrink
# them to 40x40 (temporal), cutting extraction writes ~2x and every blend
# contraction ~40% for the same iteration semantics (features needing more
# than the travel budget freeze and fail the patch check, as before — only
# the budget is tighter, ~±12 px/level vs ~±21).
_MY = 6  # rows of upward iteration travel before the patch clamp binds


def _patch_rows(window: int) -> int:
    """Patch rows, rounded to 8. Budget: window + the y margin + up to 7
    rows of corner alignment shift (see _corners) + 1 bilinear slack +
    downward travel absorbed by the round-up."""
    return ((window + _MY + 9 + 7) // 8) * 8


def _level_rows(window: int, H: int) -> int:
    """Patch rows for a level of height H: the full budget when it fits,
    else the largest multiple of 8 that still holds a valid template.
    Returns 0 if the level is too small (caller skips it, like cv2 clamping
    maxLevel by window size)."""
    py = _patch_rows(window)
    while py > H - 1:
        py -= 8
    if py < window + _MY + 9:
        return 0
    return py


def _patch_cols(window: int, margin_x: int) -> int:
    """Patch cols: window + left margin (negative-x travel budget) + ~12 px
    of positive-x travel + bilinear slack, rounded to 8. x corners are
    exact, so no alignment allowance is needed."""
    return ((window + margin_x + 13 + 7) // 8) * 8


def _extract_patches_xla(img, corners, py: int, px: int):
    """(N,2) i32 (y0, x0) corners -> (N,py,px) windows via dynamic_slice
    (corners pre-clamped/aligned by the caller, see _corners)."""

    def one(c):
        return jax.lax.dynamic_slice(img, (c[0], c[1]), (py, px))

    return jax.vmap(one)(corners)


def _corners(pos, guess, H: int, W: int, py: int, px: int, w: int, mx: int):
    """Integer patch corners for the template (at pos) and current (at
    pos+guess) patches: the WINDOW top-left minus a small margin (not the
    patch center). y corners are additionally aligned DOWN to a multiple of
    8; _patch_rows budgets for that shift and the fractional offsets
    downstream account for it exactly. x corners are exact."""
    hw = (w - 1) // 2  # integral for odd windows: floor(p - half) = floor(p) - hw

    def corner(p):
        y0 = jnp.clip(
            jnp.floor(p[:, 1]).astype(jnp.int32) - hw - _MY, 0, max(H - py, 0)
        )
        y0 = (y0 // 8) * 8
        x0 = jnp.clip(
            jnp.floor(p[:, 0]).astype(jnp.int32) - hw - mx, 0, max(W - px, 0)
        )
        return y0, x0

    ty0, tx0 = corner(pos)
    cy0, cx0 = corner(pos + guess)
    return ty0, tx0, cy0, cx0


def _blend(patches, offset, window: int):
    """Sample (N, window, window) at fractional offset inside (N, PY, PX)
    patches. offset is (N, 2) (x, y) of the window's top-left relative to
    the patch's top-left; must be within [0, P* - window - 1].

    Bilinear sampling as two one-hot blend contractions,
    S_y @ patch @ S_x^T, where S_y[n, r, p] = (p == iy+r)(1-fy)
    + (p == iy+r+1) fy."""
    N, PY, PX = patches.shape
    w = window
    ox, oy = offset[:, 0], offset[:, 1]
    ix = jnp.floor(ox).astype(jnp.int32)
    iy = jnp.floor(oy).astype(jnp.int32)
    fx = (ox - ix)[:, None]
    fy = (oy - iy)[:, None]

    def sel(base, frac, P):
        rows = jax.lax.broadcasted_iota(jnp.int32, (w, P), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (w, P), 1)
        b = base[:, None, None] + rows[None]
        eq0 = (cols[None] == b).astype(patches.dtype)
        eq1 = (cols[None] == b + 1).astype(patches.dtype)
        return eq0 * (1.0 - frac[..., None]) + eq1 * frac[..., None]

    Sy = sel(iy, fy, PY)  # (N, w, PY)
    Sx = sel(ix, fx, PX)  # (N, w, PX)
    tmp = jnp.einsum("nrp,npq->nrq", Sy, patches)  # (N, w, PX)
    return jnp.einsum("nrq,ncq->nrc", tmp, Sx)     # (N, w, w)


@partial(
    jax.jit,
    static_argnames=(
        "window", "max_level", "max_iters", "eps", "min_eig_threshold",
        "margin_x", "level_iters",
    ),
)
def _track_impl(
    prev_levels: tuple[jnp.ndarray, ...],
    curr_levels: tuple[jnp.ndarray, ...],
    prev_grad_levels: tuple[tuple[jnp.ndarray, jnp.ndarray], ...],
    pos: jnp.ndarray,
    valid: jnp.ndarray,
    init: jnp.ndarray,
    window: int,
    max_level: int,
    max_iters: int,
    eps: float,
    min_eig_threshold: float,
    margin_x: int = 6,
    level_iters: tuple | None = None,
):
    N = pos.shape[0]
    w = window
    half = (w - 1) / 2.0
    px = _patch_cols(w, margin_x)
    eps2 = eps * eps
    win_area = float(w * w)
    max_off_x = px - w - 1.0

    guess = init / (2.0 ** (max_level + 1))  # will be doubled entering top level
    status = valid
    min_eig_out = jnp.zeros((N,), jnp.float32)

    for level in range(max_level, -1, -1):
        # per-level iteration budget (KltParams.level_iters): levels above 0
        # start from a coarse-to-fine seed and converge in a handful of
        # damped steps. min() keeps caller overrides (the fb-check's 8)
        # binding.
        if level_iters is not None:
            iters_l = min(
                max_iters, level_iters[min(level, len(level_iters) - 1)]
            )
        else:
            iters_l = max_iters
        img_prev = prev_levels[level]
        img_curr = curr_levels[level]
        gx, gy = prev_grad_levels[level]
        H, W = img_prev.shape          # PADDED dims (see build_pyramid)
        Ht, Wt = H - 2 * _PAD_Y, W - 2 * _PAD_X  # true level dims

        p_lvl = pos / (2.0 ** level)
        guess = guess * 2.0

        # Level too small for the patch (cv2 likewise clamps maxLevel by
        # window size): skip it, keeping the guess-doubling chain intact.
        py = _level_rows(w, H)
        if py == 0 or W < px + 1:
            continue
        max_off_y = py - w - 1.0

        # positions in padded-image coordinates: thanks to the padding a
        # feature anywhere inside the true image never hits the corner clamp
        p_pad = p_lvl + jnp.asarray([_PAD_X, _PAD_Y], p_lvl.dtype)

        ty0, tx0, cy0, cx0 = _corners(p_pad, guess, H, W, py, px, w, margin_x)
        with jax.named_scope(f"klt_extract_L{level}"):
            tc = jnp.stack([ty0, tx0], -1)
            cc = jnp.stack([cy0, cx0], -1)
            t_patch = _extract_patches_xla(img_prev, tc, py, px)
            gx_patch = _extract_patches_xla(gx, tc, py, px)
            gy_patch = _extract_patches_xla(gy, tc, py, px)
            c_patch = _extract_patches_xla(img_curr, cc, py, px)

        # fractional window offsets inside the patches
        t_base = jnp.stack([tx0, ty0], -1).astype(jnp.float32)
        c_base = jnp.stack([cx0, cy0], -1).astype(jnp.float32)
        t_off = p_pad - half - t_base  # (N,2) (x, y)
        t_in = (
            (t_off[:, 0] >= 0.0)
            & (t_off[:, 0] <= max_off_x)
            & (t_off[:, 1] >= 0.0)
            & (t_off[:, 1] <= max_off_y)
        )
        t_off_cl = jnp.stack(
            [
                jnp.clip(t_off[:, 0], 0.0, max_off_x),
                jnp.clip(t_off[:, 1], 0.0, max_off_y),
            ],
            axis=-1,
        )

        T = _blend(t_patch, t_off_cl, w)   # (N,w,w) template
        Tx = _blend(gx_patch, t_off_cl, w)
        Ty = _blend(gy_patch, t_off_cl, w)

        # 2x2 normal matrix (computed once per level, like cv2)
        a11 = jnp.sum(Tx * Tx, axis=(1, 2))
        a12 = jnp.sum(Tx * Ty, axis=(1, 2))
        a22 = jnp.sum(Ty * Ty, axis=(1, 2))
        tr_half = (a11 + a22) * 0.5
        disc = jnp.sqrt(jnp.maximum(tr_half * tr_half - (a11 * a22 - a12 * a12), 0.0))
        min_eig = (tr_half - disc) / win_area
        det = a11 * a22 - a12 * a12
        solvable = (min_eig > min_eig_threshold) & (det > 1e-12)

        status = status & t_in & solvable
        min_eig_out = jnp.where(level == 0, min_eig, min_eig_out)

        inv_det = 1.0 / jnp.where(det > 1e-12, det, 1.0)
        i11 = a22 * inv_det
        i12 = -a12 * inv_det
        i22 = a11 * inv_det

        # ---- iterate: current window at p_lvl + d. Converged features are
        # frozen by the mask, matching cv2's per-feature eps exit. ----
        def lk_update(carry):
            d, conv = carry
            c_off = p_pad + d - half - c_base
            in_patch = (
                (c_off[:, 0] >= 0.0)
                & (c_off[:, 0] <= max_off_x)
                & (c_off[:, 1] >= 0.0)
                & (c_off[:, 1] <= max_off_y)
            )
            c_off_cl = jnp.stack(
                [
                    jnp.clip(c_off[:, 0], 0.0, max_off_x),
                    jnp.clip(c_off[:, 1], 0.0, max_off_y),
                ],
                axis=-1,
            )
            Iw = _blend(c_patch, c_off_cl, w)
            diff = Iw - T
            b1 = jnp.sum(diff * Tx, axis=(1, 2))
            b2 = jnp.sum(diff * Ty, axis=(1, 2))
            du = -(i11 * b1 + i12 * b2)
            dv = -(i12 * b1 + i22 * b2)
            step = jnp.stack([du, dv], axis=-1)
            active = (~conv) & in_patch
            d = jnp.where(active[:, None], d + step, d)
            conv = conv | (du * du + dv * dv < eps2) | (~in_patch)
            return d, conv

        with jax.named_scope(f"klt_lk_L{level}"):
            d, _ = jax.lax.fori_loop(
                0, iters_l, lambda _, c: lk_update(c),
                (guess, jnp.zeros((N,), bool)),
            )

        # lost if final window is outside patch (~left the search region) or
        # outside the TRUE image at this level
        final_pt = p_lvl + d
        inside_img = (
            (final_pt[:, 0] >= 0)
            & (final_pt[:, 0] < Wt)
            & (final_pt[:, 1] >= 0)
            & (final_pt[:, 1] < Ht)
        )
        c_off_f = p_pad + d - half - c_base
        inside_patch = (
            (c_off_f[:, 0] >= -1.0)
            & (c_off_f[:, 0] <= max_off_x + 1.0)
            & (c_off_f[:, 1] >= -1.0)
            & (c_off_f[:, 1] <= max_off_y + 1.0)
        )
        status = status & inside_img & inside_patch
        guess = d

    new_pos = pos + guess
    # final position must lie inside the level-0 image (cv2 kills these)
    H0 = prev_levels[0].shape[0] - 2 * _PAD_Y
    W0 = prev_levels[0].shape[1] - 2 * _PAD_X
    inside0 = (
        (new_pos[:, 0] >= 0)
        & (new_pos[:, 0] <= W0 - 1)
        & (new_pos[:, 1] >= 0)
        & (new_pos[:, 1] <= H0 - 1)
    )
    status = status & inside0
    return KltResult(pos=new_pos, status=status, err=min_eig_out)


class KltTracker:
    """Pyramid-caching KLT front. Build pyramids once per image, reuse for
    both stereo matching and temporal tracking (the reference recomputes
    OpenCV pyramids inside every calcOpticalFlowPyrLK call)."""

    @staticmethod
    def build_pyramid(img: jnp.ndarray, max_level: int):
        levels = klt_pyramid(img, max_level)
        levels = [
            jnp.pad(l, ((_PAD_Y, _PAD_Y), (_PAD_X, _PAD_X)), mode="edge")
            for l in levels
        ]
        grads = [scharr_gradients(l) for l in levels]
        return tuple(levels), tuple(grads)

    @staticmethod
    def track(
        prev_pyr,
        curr_pyr,
        pos: jnp.ndarray,
        valid: jnp.ndarray,
        params: KltParams,
        init_flow: jnp.ndarray | None = None,
    ) -> KltResult:
        """Track features from prev to curr.

        Args:
            prev_pyr: (levels, grads) from build_pyramid on the prev image.
            curr_pyr: same for the curr image (grads unused).
            pos: (N,2) feature positions in prev.
            valid: (N,) mask.
            params: window/iters/eps/min_eig.
            init_flow: optional (N,2) initial displacement at level 0.
        """
        prev_levels, prev_grads = prev_pyr
        curr_levels, _ = curr_pyr
        if init_flow is None:
            init_flow = jnp.zeros_like(pos)
        return _track_impl(
            prev_levels,
            curr_levels,
            prev_grads,
            pos,
            valid,
            init_flow,
            window=params.window,
            max_level=params.max_level,
            max_iters=params.max_iters,
            level_iters=params.level_iters,
            eps=params.eps,
            min_eig_threshold=params.min_eig_threshold,
            margin_x=params.margin_x,
        )
