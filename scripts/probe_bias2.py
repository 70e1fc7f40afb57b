"""Isolate the constant ~-0.03 px KLT measurement bias (probe_bias.py).

Tracks a feature grid between CONTROLLED image pairs where the true flow is
known exactly by construction (no geometry, no renderer pose chain):

  self   — track an image against itself: any nonzero flow is pure artifact
  int    — integer-shifted copy: interpolation plays no role
  frac   — fractionally shifted copy (scipy map_coordinates, order-3):
           isolates interpolation/gradient bias as a function of subpixel
           phase
  cv2    — same pairs through cv2.calcOpticalFlowPyrLK for comparison

    python scripts/probe_bias2.py --cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.ndimage import shift as ndshift  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from svo_tpu.ops.klt import KltTracker  # noqa: E402

shape = (376, 1241)
seq = SyntheticSequence(n_frames=3, shape=shape, fx=718.856, speed=0.3)
l0, _ = seq.frame(0)
cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])

H, W = shape
gx_, gy_ = np.meshgrid(np.arange(60, W - 60, 24), np.arange(30, H - 30, 16))
uv0 = np.stack([gx_.ravel(), gy_.ravel()], -1).astype(np.float32)
N = len(uv0)
valid = np.ones(N, bool)


def track_ours(img0, img1):
    p0 = KltTracker.build_pyramid(jnp.asarray(img0, jnp.float32),
                                  cfg.temporal_klt.max_level)
    p1 = KltTracker.build_pyramid(jnp.asarray(img1, jnp.float32),
                                  cfg.temporal_klt.max_level)
    res = KltTracker.track(p0, p1, jnp.asarray(uv0), jnp.asarray(valid),
                           cfg.temporal_klt)
    return np.asarray(res.pos) - uv0, np.asarray(res.status)


def track_cv2(img0, img1):
    import cv2

    p1, st, _ = cv2.calcOpticalFlowPyrLK(
        np.clip(img0, 0, 255).astype(np.uint8),
        np.clip(img1, 0, 255).astype(np.uint8),
        uv0.reshape(-1, 1, 2), None,
        winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 50, 1e-3),
    )
    return p1.reshape(-1, 2) - uv0, st.ravel() > 0


def report(name, flow, ok, true_flow):
    e = flow[ok] - np.asarray(true_flow)
    print(f"  {name:28s} n={ok.sum():5d} mean=({e[:, 0].mean():+.4f},"
          f"{e[:, 1].mean():+.4f}) std=({e[:, 0].std():.3f},"
          f"{e[:, 1].std():.3f}) max|e|={np.abs(e).max():.3f}")


for tname, track in [("ours", track_ours), ("cv2", track_cv2)]:
    print(f"== {tname} ==")
    f, ok = track(l0, l0)
    report("self (true 0,0)", f, ok, [0, 0])
    f, ok = track(l0, np.roll(l0, (2, 3), (0, 1)))
    report("int shift (3,2)", f, ok, [3, 2])
    for sh in ([0.5, 0.0], [0.0, 0.5], [0.25, 0.25], [0.75, 0.75],
               [1.3, -0.8]):
        img1 = ndshift(l0, (sh[1], sh[0]), order=3, mode="nearest")
        f, ok = track(l0, img1)
        report(f"frac shift ({sh[0]},{sh[1]})", f, ok, sh)

    # EXPANSION: the flow field of forward motion. img1(p) = img0(c + (p-c)/s)
    # => true flow for a feature at p0 is (s-1) * (p0 - c). Radial model
    # mismatch inside the window is where translation-only LK biases.
    from scipy.ndimage import affine_transform

    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    for s in (1.01, 1.03):
        # affine_transform maps output->input: in = (out - c)/s + c
        mat = np.array([[1.0 / s, 0], [0, 1.0 / s]])
        off = c[::-1] - mat @ c[::-1]
        img1 = affine_transform(l0, mat, offset=off, order=3, mode="nearest")
        true_flow = (s - 1.0) * (uv0 - c)
        f, ok = track(l0, img1)
        e = (f - true_flow)[ok]
        r = uv0[ok] - c
        rn = np.linalg.norm(r, axis=1) + 1e-9
        radial = np.sum(e * r, axis=1) / rn  # px along the radial direction
        print(f"  expansion s={s}: n={ok.sum():5d} "
              f"mean_radial_err={radial.mean():+.4f} px "
              f"(negative = flow magnitude underestimated) "
              f"mean_dv={e[:, 1].mean():+.4f}")
