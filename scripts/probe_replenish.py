"""Probe the keyframe-replenish stages on raw frames of a cached world:
detect on frame A, stereo-match A.L->A.R, temporal-track A->B.
Reports survivor counts per stage to find which stage starves.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--world", default="box-fine-fast")
parser.add_argument("--a", type=int, default=127)
parser.add_argument("--b", type=int, default=128)
args = parser.parse_args()

import jax

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.ops import detect as detect_mod  # noqa: E402
from svo_tpu.ops.klt import KltTracker  # noqa: E402

SHAPE = (376, 1241)
H, W = SHAPE
FX = 718.856

d = f"/tmp/svo_cache/worlds/{args.world}_f241"
ls = np.memmap(os.path.join(d, "l.u8"), np.uint8, "r", shape=(241, H, W))
rs = np.memmap(os.path.join(d, "r.u8"), np.uint8, "r", shape=(241, H, W))
gt = np.load(os.path.join(d, "gt.npy"))

A = jnp.asarray(ls[args.a].astype(np.float32))
Ar = jnp.asarray(rs[args.a].astype(np.float32))
B = jnp.asarray(ls[args.b].astype(np.float32))

cfg = Config(use_orb=False, image_height=H, image_width=W)
N = cfg.capacity.max_features

det_pos, det_score, det_valid = detect_mod.detect(
    A, jnp.zeros((N, 2), jnp.float32), jnp.zeros((N,), bool), cfg
)
print(f"detect: {int(det_valid.sum())}")

pyr_l = KltTracker.build_pyramid(A, cfg.temporal_klt.max_level)
pyr_r = KltTracker.build_pyramid(Ar, cfg.stereo_klt.max_level)
sres = KltTracker.track(pyr_l[:2] if False else pyr_l, pyr_r, det_pos, det_valid, cfg.stereo_klt)
y_ok = jnp.abs(sres.pos[:, 1] - det_pos[:, 1]) < cfg.tracking.y_threshold
s_valid = det_valid & sres.status & y_ok
disp = det_pos[:, 0] - sres.pos[:, 0]
print(f"stereo: status {int((det_valid & sres.status).sum())}, "
      f"+ygate {int(s_valid.sum())}")
sv = np.asarray(s_valid)
dd = np.asarray(disp)[sv]
print(f"  disparity of survivors: median {np.median(dd):.1f}px "
      f"p10 {np.percentile(dd,10):.1f} p90 {np.percentile(dd,90):.1f} "
      f"(depth median {FX*0.5372/max(np.median(dd),1e-6):.1f} m)")
# depth gate
z = FX * 0.5372 / np.maximum(dd, 1e-6)
cap = cfg.tracking.max_depth_baselines * 0.5372
print(f"  depth gate (< {cap:.0f} m): {(z < cap).sum()} pass, "
      f"neg-disp {(dd <= 0).sum()}")

pyr_b = KltTracker.build_pyramid(B, cfg.temporal_klt.max_level)
tres = KltTracker.track(pyr_l, pyr_b, det_pos, det_valid, cfg.temporal_klt)
t_ok = det_valid & tres.status
print(f"temporal A->B: {int(t_ok.sum())}")
flow = np.asarray(tres.pos - det_pos)[np.asarray(t_ok)]
if len(flow):
    print(f"  median flow {np.median(flow, axis=0)}, "
          f"p90 |flow| {np.percentile(np.linalg.norm(flow, axis=1), 90):.1f} px")

# GT expected flow for a far point (pure yaw approx)
Ra, Rb = gt[args.a][:3, :3], gt[args.b][:3, :3]
dR = Ra.T @ Rb
yaw = np.degrees(np.arctan2(dR[0, 2], dR[2, 2]))
print(f"GT yaw delta: {yaw:.3f} deg (~{FX*abs(np.radians(yaw)):.1f} px), "
      f"trans {np.linalg.norm(gt[args.b][:3,3]-gt[args.a][:3,3]):.2f} m")

# cv2 comparison for both stages
try:
    import cv2

    p0 = np.asarray(det_pos)[np.asarray(det_valid)].astype(np.float32).reshape(-1, 1, 2)
    for name, img2, win in (("stereo", np.asarray(Ar), 11), ("temporal", np.asarray(B), 21)):
        p1, st, err = cv2.calcOpticalFlowPyrLK(
            np.asarray(A).astype(np.uint8), img2.astype(np.uint8), p0, None,
            winSize=(win, win), maxLevel=3,
            criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 50, 1e-3),
        )
        st = st.ravel().astype(bool)
        print(f"cv2 {name}: {st.sum()}/{len(st)}")
except ImportError:
    pass
