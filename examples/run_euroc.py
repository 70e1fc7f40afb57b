"""EuRoC MAV runner: ASL sequence -> rectified stereo VO -> ATE/RPE.

Usage:
    python examples/run_euroc.py --root MH_01_easy [--ba] [--end N]
        [--out traj.txt] [--plot traj.png] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--root", required=True, help="EuRoC sequence dir (contains mav0/)")
parser.add_argument("--start", type=int, default=0)
parser.add_argument("--end", type=int, default=None)
parser.add_argument("--ba", action="store_true")
parser.add_argument("--fast", action="store_true")
parser.add_argument("--out", default="")
parser.add_argument("--plot", default="")
parser.add_argument("--cpu", action="store_true")
args = parser.parse_args()

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_dev = jax.devices()[0]
print(f"device: {_dev.platform} ({_dev.device_kind})", flush=True)

import numpy as np  # noqa: E402

from svo_tpu.config import BaParams, Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse, rpe  # noqa: E402
from svo_tpu.io.euroc import EurocSequence  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

seq = EurocSequence(args.root, args.start, args.end)
H, W = seq.rectifier.size
cfg = Config(
    use_orb=not args.fast,
    image_height=H,
    image_width=W,
    ba=BaParams(enabled=args.ba),
)
vo = StereoVO(cfg, seq.camera)
t0 = time.time()
res = vo.run(seq)
wall = time.time() - t0

print(f"frames:       {res.n_frames}")
print(f"wall:         {wall:.2f}s  ({res.fps:.2f} fps)")
print(f"map points:   {int(res.metrics[-1, 4])}")
print(f"keyframes:    {int(res.kf_flags.sum())}")
print(f"mean feats:   {res.metrics[1:, 2].mean():.1f}")
print(f"mean inlier%: {res.metrics[1:, 1].mean() * 100:.1f}")

gt = seq.gt_cam_poses()
if len(gt):
    n = min(res.n_frames, len(gt))
    ate = ate_rmse(res.poses[:n], gt[:n])
    rpe_t, rpe_r = rpe(res.poses[:n], gt[:n])
    print(f"ATE RMSE:     {ate:.4f} m")
    print(f"RPE:          {rpe_t:.4f} m / {np.rad2deg(rpe_r):.4f} deg per frame")
if args.out:
    from svo_tpu.viz.dump import save_trajectory_kitti

    save_trajectory_kitti(args.out, res.poses)
if args.plot:
    from svo_tpu.viz.dump import plot_trajectory

    plot_trajectory(args.plot, res.poses, gt if len(gt) else None)
