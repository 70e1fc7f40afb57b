"""Back-end evaluation: does optimization actually improve a long drifting
trajectory? (VERDICT round-1: the BA stack existed but was never shown to
help beyond a smoke test.)

Runs the VO front-end over a long synthetic sequence, then sweeps the
keyframe-block BA + pose-graph refinement (svo_tpu/parallel/global_opt.py)
across the trajectory in consecutive spans, and reports ATE before/after
plus BA solver throughput.

    python scripts/eval_ba.py --cpu --small --frames 121   # quick check
    python scripts/eval_ba.py --frames 505                 # on the GPU, full size
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--small", action="store_true")
parser.add_argument("--frames", type=int, default=505)
parser.add_argument("--chunk", type=int, default=12)
parser.add_argument("--cadence", type=int, default=6)
parser.add_argument("--blocks", type=int, default=4)
parser.add_argument("--cams-per-block", type=int, default=7)
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from svo_tpu.parallel import global_opt  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

shape = (184, 320) if args.small else (376, 1241)
fx = 200.0 if args.small else 718.856
t0 = time.perf_counter()
print(f"rendering {args.frames} frames...", file=sys.stderr, flush=True)
seq = SyntheticSequence(n_frames=args.frames, shape=shape, fx=fx, speed=0.3)
frames = list(seq)
print(f"render done (+{time.perf_counter()-t0:.0f}s)", file=sys.stderr, flush=True)

cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
camera = cam_mod.from_intrinsics(
    seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
)
vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence)
res = vo.run_chunked(frames)
gt = seq.gt_poses[: res.n_frames]
ate_before = ate_rmse(res.poses, gt)
print(f"VO done: {res.n_frames} frames, {res.fps:.1f} fps incl compile",
      file=sys.stderr, flush=True)

# --- sweep block-BA + pose-graph consensus across the trajectory ---
span = global_opt.block_span(args.blocks, args.cams_per_block)
state = vo.state
poses = state.poses
mp_state = state.map
bfx = jnp.float32(camera.K[0, 0] * camera.baseline)
n = res.n_frames
his = list(range(span - 1, n, span - 1))
if his and his[-1] != n - 1:
    his.append(n - 1)
t0 = time.perf_counter()
n_ba_iters = 0
for hi in his:
    out = global_opt.refine_global(
        mp_state, poses, jnp.int32(hi), camera.K, bfx,
        n_blocks=args.blocks, cams_per_block=args.cams_per_block,
        n_points=512, n_obs=2048, ba_iterations=10, pg_iterations=8,
    )
    mp_state, poses = out.map, out.poses
    n_ba_iters += args.blocks * 10
jax.block_until_ready(poses)
wall = time.perf_counter() - t0
ate_after = ate_rmse(np.asarray(poses[:n]), gt)

traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
print(
    f"frames {n} | traveled {traveled:.1f} m | "
    f"ATE {ate_before:.4f} m -> {ate_after:.4f} m "
    f"({100*ate_before/traveled:.2f}% -> {100*ate_after/traveled:.2f}%) | "
    f"{len(his)} refine sweeps, {n_ba_iters} block-LM iters in {wall:.1f}s "
    f"(incl compile)"
)
