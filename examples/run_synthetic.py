"""Run the full VO pipeline end-to-end on a synthetic stereo sequence and
report ATE/RPE against the exact ground truth plus throughput.

Usage: python examples/run_synthetic.py [--frames N] [--cpu] [--small] [--verbose]
"""

import argparse
import os
import sys
import time

parser = argparse.ArgumentParser()
parser.add_argument("--frames", type=int, default=40)
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--small", action="store_true", help="use a small image for fast iteration")
parser.add_argument("--verbose", action="store_true")
parser.add_argument("--fast", action="store_true", help="FAST detector instead of ORB")
parser.add_argument("--ba", action="store_true", help="enable sliding-window bundle adjustment")
parser.add_argument("--chunk", type=int, default=0, help="frames per device dispatch")
parser.add_argument("--cadence", type=int, default=0,
                    help="static keyframe cadence for the chunked path")
args = parser.parse_args()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_dev = jax.devices()[0]
print(f"device: {_dev.platform} ({_dev.device_kind})", flush=True)

import numpy as np  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse, rpe  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

shape = (184, 320) if args.small else (376, 1241)
fx = 200.0 if args.small else 718.856

t0 = time.time()
seq = SyntheticSequence(n_frames=args.frames, shape=shape, fx=fx)
frames = list(seq)
print(f"rendered {len(frames)} synthetic frames in {time.time()-t0:.1f}s", flush=True)

from svo_tpu.config import BaParams  # noqa: E402

cfg = Config(
    use_orb=not args.fast,
    image_height=shape[0],
    image_width=shape[1],
    end_frame=args.frames,
    ba=BaParams(enabled=args.ba),
)
camera = cam_mod.from_intrinsics(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)

chunk = getattr(args, "chunk", 0)
cadence = getattr(args, "cadence", 0)
vo = StereoVO(cfg, camera, chunk=chunk, kf_cadence=cadence)
t0 = time.time()
if chunk:
    res = vo.run_chunked(frames)
else:
    res = vo.run(frames, verbose=args.verbose)
wall = time.time() - t0

ate = ate_rmse(res.poses, seq.gt_poses[: res.n_frames])
rpe_t, rpe_r = rpe(res.poses, seq.gt_poses[: res.n_frames])
traveled = np.linalg.norm(np.diff(seq.gt_poses[: res.n_frames, :3, 3], axis=0), axis=1).sum()

print(f"frames:        {res.n_frames}")
print(f"wall:          {wall:.2f}s  ({res.fps:.2f} fps incl. compile)")
print(f"ATE RMSE:      {ate:.4f} m over {traveled:.1f} m traveled")
print(f"RPE:           {rpe_t:.4f} m / {np.rad2deg(rpe_r):.4f} deg per frame")
print(f"map points:    {int(res.metrics[-1, 4])}")
print(f"keyframes:     {int(res.kf_flags.sum())}")
print(f"mean features: {res.metrics[1:, 2].mean():.1f}")
print(f"mean inlier%:  {res.metrics[1:, 1].mean() * 100:.1f}")
