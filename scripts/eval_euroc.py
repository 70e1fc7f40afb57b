"""EuRoC sequence-level evaluation artifact (VERDICT r04 item 6).

Runs the ASL-layout pipeline end-to-end — sensor.yaml parse, Bouguet
rectification, stereo VO, GT csv matching — and writes EUROC_r{N}.json.
Defaults to the checked-in euroc_mini fixture (synthetic, unrectified +
radtan-distorted); pass --root for a real EuRoC sequence directory.

    python scripts/eval_euroc.py --out EUROC_r05.json
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--root", default="")
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--start", type=int, default=0)
parser.add_argument("--end", type=int, default=None)
parser.add_argument("--out", default="")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import numpy as np  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse, rpe  # noqa: E402
from svo_tpu.io.euroc import EurocSequence  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
root = args.root or os.path.join(REPO, "tests", "fixtures", "euroc_mini")

seq = EurocSequence(root, args.start, args.end)
H, W = seq.rectifier.size
cfg = Config(use_orb=False, image_height=H, image_width=W)
vo = StereoVO(cfg, seq.camera)
frames = list(iter(seq))
t0 = time.perf_counter()
res = vo.run(frames)
wall = time.perf_counter() - t0

gt = seq.gt_cam_poses()
n = min(res.n_frames, len(gt))
traveled = float(np.linalg.norm(np.diff(gt[:n, :3, 3], axis=0), axis=1).sum())
ate = ate_rmse(res.poses[:n], gt[:n])
rpe_t, rpe_r = rpe(res.poses[:n], gt[:n])

out = {
    "metric": "euroc_ate",
    "root": os.path.basename(os.path.abspath(root)),
    "frames": int(res.n_frames),
    "image": f"{H}x{W}",
    "rectified_baseline_m": round(float(seq.rectifier.baseline), 4),
    "ate_m": round(ate, 4),
    "ate_pct_of_traveled": round(100.0 * ate / max(traveled, 1e-9), 3),
    "traveled_m": round(traveled, 2),
    "rpe_trans_m": round(float(rpe_t), 4),
    "rpe_rot_deg": round(float(np.rad2deg(rpe_r)), 4),
    "fps_incl_compile": round(res.fps, 1),
    "mean_inlier_ratio": round(float(res.metrics[1:n, 1].mean()), 3),
    "mean_features": round(float(res.metrics[1:n, 2].mean()), 1),
    "keyframes": int(res.kf_flags[:n].sum()),
    "backend": jax.default_backend(),
    "resolved_config": dataclasses.asdict(cfg),
}
dest = args.out or os.path.join(REPO, "EUROC_r05.json")
with open(dest, "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps({k: out[k] for k in
                  ("metric", "frames", "ate_m", "ate_pct_of_traveled")}))
print(f"wrote {dest}", file=sys.stderr)
