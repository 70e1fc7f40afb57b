"""The XLA KLT path: patch extraction at the padded KITTI widths and single
LK levels against shifts rendered independently with scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from svo_tpu.config import KltParams
from svo_tpu.ops import klt
from svo_tpu.ops.klt import KltTracker

# Padded pyramid level shapes of a 376x1241 KITTI frame (ceil-halving, then
# _PAD_Y/_PAD_X edge padding on each side): no width is a multiple of 128.
KITTI_LEVELS = [
    (h + 2 * klt._PAD_Y, w + 2 * klt._PAD_X)
    for h, w in [(376, 1241), (188, 621), (94, 311), (47, 156)]
]


def texture(rng, h, w):
    """Random texture on a 0-255 scale with structure at 2, 6 and 16 px, so
    every pyramid level has gradient."""
    img = sum(
        s * ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), s)
        for s in (2.0, 6.0, 16.0)
    )
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return img.astype(np.float32)


def shifted(img, dx, dy):
    """img translated by (dx, dy): out(x, y) = img(x - dx, y - dy),
    bilinear, edge-replicated."""
    yy, xx = np.mgrid[0 : img.shape[0], 0 : img.shape[1]].astype(np.float64)
    return ndimage.map_coordinates(
        img, [yy - dy, xx - dx], order=1, mode="nearest"
    ).astype(np.float32)


def grid_points(h, w, margin, step):
    ys, xs = np.mgrid[margin : h - margin : step, margin : w - margin : step]
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32) + 0.37


@pytest.mark.parametrize("level", range(4))
def test_extract_patches_matches_numpy_slicing(level):
    """Vmapped dynamic_slice == numpy slicing at each padded KITTI level,
    with corners pinned to both borders of both axes."""
    H, W = KITTI_LEVELS[level]
    py, px = klt._level_rows(21, H), klt._patch_cols(21, 6)
    assert py > 0 and W % 128 != 0
    rng = np.random.default_rng(level)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    n = 37
    ys = rng.integers(0, H - py + 1, n)
    xs = rng.integers(0, W - px + 1, n)
    ys[:4] = [0, H - py, 0, H - py]
    xs[:4] = [0, 0, W - px, W - px]
    corners = np.stack([ys, xs], -1).astype(np.int32)
    got = np.asarray(klt._extract_patches_xla(jnp.asarray(img), jnp.asarray(corners), py, px))
    want = np.stack([img[y : y + py, x : x + px] for y, x in corners])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [21, 11])
def test_lk_level_recovers_subpixel_shift(window):
    """One LK level (max_level=0) recovers a sub-pixel translation rendered
    by scipy's bilinear map_coordinates."""
    rng = np.random.default_rng(window)
    img0 = texture(rng, 120, 200)
    dx, dy = 0.63, -0.41
    img1 = shifted(img0, dx, dy)
    pts = grid_points(120, 200, margin=24, step=17)
    params = KltParams(window=window, max_level=0, max_iters=20)
    res = KltTracker.track(
        KltTracker.build_pyramid(jnp.asarray(img0), 0),
        KltTracker.build_pyramid(jnp.asarray(img1), 0),
        jnp.asarray(pts), jnp.ones(len(pts), bool), params,
    )
    st = np.asarray(res.status)
    err = np.linalg.norm(np.asarray(res.pos)[st] - pts[st] - [dx, dy], axis=-1)
    assert st.mean() > 0.9
    assert np.median(err) < 0.03, np.median(err)


def test_dead_slots_stay_dead_and_finite():
    """valid=False slots come back with status False and finite positions,
    even under a nonzero initial flow."""
    rng = np.random.default_rng(3)
    img0 = texture(rng, 120, 200)
    img1 = shifted(img0, 2.5, 1.0)
    pts = grid_points(120, 200, margin=24, step=19)
    valid = np.arange(len(pts)) % 3 != 0
    guess = np.tile([[2.0, 1.5]], (len(pts), 1)).astype(np.float32)
    res = KltTracker.track(
        KltTracker.build_pyramid(jnp.asarray(img0), 2),
        KltTracker.build_pyramid(jnp.asarray(img1), 2),
        jnp.asarray(pts), jnp.asarray(valid),
        KltParams(window=21, max_level=2, max_iters=8),
        init_flow=jnp.asarray(guess),
    )
    st = np.asarray(res.status)
    assert not st[~valid].any()
    assert np.isfinite(np.asarray(res.pos)).all()
    assert np.isfinite(np.asarray(res.err)).all()
    assert st[valid].mean() > 0.8


def test_border_features_killed_not_returned_wrong():
    """Under a large shift, features carried out of the image are lost and
    every feature reported tracked is at the right place."""
    rng = np.random.default_rng(4)
    H, W = 200, 320
    img0 = texture(rng, H, W)
    dx, dy = 9.3, -4.2
    img1 = shifted(img0, dx, dy)
    pts = grid_points(H, W, margin=2, step=9)
    res = KltTracker.track(
        KltTracker.build_pyramid(jnp.asarray(img0), 3),
        KltTracker.build_pyramid(jnp.asarray(img1), 3),
        jnp.asarray(pts), jnp.ones(len(pts), bool),
        KltParams(window=21, max_level=3, max_iters=8),
    )
    st = np.asarray(res.status)
    pos = np.asarray(res.pos)
    target = pts + [dx, dy]
    leaves = (target[:, 0] > W - 1) | (target[:, 1] < 0)
    assert leaves.sum() > 10 and not st[leaves].any()
    # where the window sees only truly shifted content (not the replicated
    # edge the shift uncovers), a tracked feature must be exact
    clean = (
        (target[:, 0] - 11 >= np.ceil(dx))
        & (target[:, 0] + 11 <= W - 1)
        & (target[:, 1] - 11 >= 0)
        & (target[:, 1] + 11 <= H - 1 + np.floor(dy))
    )
    ok = st & clean
    err = np.linalg.norm(pos[ok] - target[ok], axis=-1)
    assert ok.sum() > 50 and err.max() < 0.1, err.max()


def test_stereo_margin_recovers_large_disparity():
    """The stereo call site (window 11, 4 levels, margin_x=16) recovers a
    purely horizontal disparity of ~30 px from a zero initial guess."""
    rng = np.random.default_rng(5)
    H, W = 120, 320
    left = texture(rng, H, W)
    disparity = 31.4
    right = shifted(left, -disparity, 0.0)
    pts = grid_points(H, W, margin=20, step=13)
    pts = pts[pts[:, 0] > disparity + 12]
    params = KltParams(window=11, max_level=3, max_iters=8, margin_x=16)
    res = KltTracker.track(
        KltTracker.build_pyramid(jnp.asarray(left), 3),
        KltTracker.build_pyramid(jnp.asarray(right), 3),
        jnp.asarray(pts), jnp.ones(len(pts), bool), params,
    )
    st = np.asarray(res.status)
    flow = np.asarray(res.pos)[st] - pts[st]
    assert st.mean() > 0.8, st.mean()
    assert np.median(np.abs(flow[:, 0] + disparity)) < 0.05
    assert np.median(np.abs(flow[:, 1])) < 0.05


def test_vmapped_track_matches_per_stream_loop():
    """jax.vmap of KltTracker.track over 3 streams equals 3 separate calls
    (the fleet path vmaps the whole frame step)."""
    rng = np.random.default_rng(6)
    params = KltParams(window=21, max_level=2, max_iters=8)
    imgs0, imgs1, ptss, valids = [], [], [], []
    for s in range(3):
        img0 = texture(rng, 96, 160)
        imgs0.append(img0)
        imgs1.append(shifted(img0, 1.5 + s, -0.5 * s))
        ptss.append(grid_points(96, 160, margin=10, step=15)[:24])
        valids.append(np.arange(24) % (s + 2) != 0)

    def track(i0, i1, p, v):
        return KltTracker.track(
            KltTracker.build_pyramid(i0, 2), KltTracker.build_pyramid(i1, 2),
            p, v, params,
        )

    batched = jax.vmap(track)(*(jnp.asarray(np.stack(x)) for x in (imgs0, imgs1, ptss, valids)))
    for s in range(3):
        one = track(*(jnp.asarray(x[s]) for x in (imgs0, imgs1, ptss, valids)))
        np.testing.assert_array_equal(np.asarray(batched.status[s]), np.asarray(one.status))
        np.testing.assert_allclose(np.asarray(batched.pos[s]), np.asarray(one.pos), atol=1e-4)
