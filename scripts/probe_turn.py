"""Probe the KLT tracker on the box-turns failure frames (85->88).

Detects features on frame A, tracks to frame B with the pipeline's
temporal-KLT config, and reports the status breakdown vs cv2 on the same
pair. Run on the accelerator (default) or CPU (--cpu).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--world", default="box-turns")
parser.add_argument("--a", type=int, default=85)
parser.add_argument("--b", type=int, default=86)
parser.add_argument("--cpu", action="store_true")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

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
gt = np.load(os.path.join(d, "gt.npy"))

A = ls[args.a].astype(np.float32)
B = ls[args.b].astype(np.float32)

cfg = Config(use_orb=False, image_height=H, image_width=W)

# detect on A
N = cfg.capacity.max_features
empty_pos = jnp.zeros((N, 2), jnp.float32)
empty_valid = jnp.zeros((N,), bool)
det_pos, det_score, det_valid = detect_mod.detect(
    jnp.asarray(A), empty_pos, empty_valid, cfg
)
det_pos = np.asarray(det_pos)
det_valid = np.asarray(det_valid)
print(f"detected {det_valid.sum()} features on frame {args.a}")

# expected flow from GT: project points... just estimate from yaw delta
Ra = gt[args.a][:3, :3]
Rb = gt[args.b][:3, :3]
dR = Ra.T @ Rb
yaw = np.degrees(np.arctan2(dR[0, 2], dR[2, 2]))
print(f"GT yaw delta {args.a}->{args.b}: {yaw:.3f} deg "
      f"(~{FX * np.radians(abs(yaw)):.1f} px horizontal flow)")

pa = KltTracker.build_pyramid(jnp.asarray(A), cfg.temporal_klt.max_level)
pb = KltTracker.build_pyramid(jnp.asarray(B), cfg.temporal_klt.max_level)
res = KltTracker.track(pa, pb, jnp.asarray(det_pos), jnp.asarray(det_valid),
                       cfg.temporal_klt)
status = np.asarray(res.status)
pos_out = np.asarray(res.pos)
flow = pos_out - det_pos
print(f"svo_tpu: tracked {status[det_valid].sum()}/{det_valid.sum()}")
ok = status & det_valid
if ok.any():
    print(f"  median flow of survivors: {np.median(flow[ok], axis=0)}")

# cv2 comparison
try:
    import cv2

    p0 = det_pos[det_valid].astype(np.float32).reshape(-1, 1, 2)
    p1, st, err = cv2.calcOpticalFlowPyrLK(
        A.astype(np.uint8), B.astype(np.uint8), p0, None,
        winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 50, 1e-3),
    )
    st = st.ravel().astype(bool)
    cfl = (p1.reshape(-1, 2) - p0.reshape(-1, 2))
    print(f"cv2: tracked {st.sum()}/{len(st)}")
    if st.any():
        print(f"  median flow of survivors: {np.median(cfl[st], axis=0)}")
    # agreement on common survivors
    sv = status[det_valid] & st
    if sv.any():
        dd = np.linalg.norm(flow[det_valid][sv] - cfl[sv], axis=1)
        print(f"  common {sv.sum()}: flow agreement median {np.median(dd):.3f} px,"
              f" p95 {np.percentile(dd, 95):.3f}")
except ImportError:
    print("cv2 not available")
