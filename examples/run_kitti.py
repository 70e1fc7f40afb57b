"""KITTI odometry runner — the reference's main.cpp equivalent.

Wires config + calib parsing + the native async prefetcher + the device
pipeline + trajectory/metric output (reference: src/main.cpp:38-53, with the
per-frame log of src/tracking.cpp:261-266 and the end-of-run summary of
:271-275), plus what the reference never had: saved trajectory (KITTI poses
format) and numeric ATE/RPE against ground truth.

Usage:
    python examples/run_kitti.py --config configs/kitti00.yaml
    python examples/run_kitti.py --path <seq_dir> --calib <calib.txt> \
        --gt <poses.txt> [--ba] [--chunk 16] [--out traj.txt]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402 — must initialize before cv2/PIL heavy imports

parser = argparse.ArgumentParser()
parser.add_argument("--config", help="YAML config (reference format accepted)")
parser.add_argument("--path", help="sequence dir containing image_2/ image_3/")
parser.add_argument("--calib", help="KITTI calib.txt (P2/P3)")
parser.add_argument("--gt", help="ground-truth poses txt", default="")
parser.add_argument("--start", type=int, default=None)
parser.add_argument("--end", type=int, default=None)
parser.add_argument("--ba", action="store_true", help="enable windowed BA")
parser.add_argument("--refine", action="store_true",
                    help="global refinement sweep (keyframe-block BA + "
                         "pose-graph consensus) over the finished trajectory")
parser.add_argument("--refine-blocks", type=int, default=4)
parser.add_argument("--refine-cams", type=int, default=7,
                    help="cameras per refinement block")
parser.add_argument("--fast", action="store_true", help="FAST detector (default ORB)")
parser.add_argument("--chunk", type=int, default=0, help="frames per device dispatch")
parser.add_argument("--cadence", type=int, default=0,
                    help="static keyframe cadence for the chunked path "
                         "(0 = the reference's dynamic rule)")
parser.add_argument("--out", default="", help="write estimated trajectory (KITTI format)")
parser.add_argument("--ply", default="", help="dump map point cloud to PLY")
parser.add_argument("--metrics-out", default="", help="write per-frame JSONL + summary")
parser.add_argument("--plot", default="", help="write top-down trajectory PNG")
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--verbose", action="store_true")
args = parser.parse_args()

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_dev = jax.devices()[0]
print(f"device: {_dev.platform} ({_dev.device_kind})", flush=True)

import numpy as np  # noqa: E402

from svo_tpu.config import BaParams, Config, load_config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse, rpe  # noqa: E402
from svo_tpu.geometry.camera import parse_kitti_calib  # noqa: E402
from svo_tpu.io import kitti  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402
from svo_tpu.runtime import loader as native_loader  # noqa: E402
from svo_tpu.viz.dump import save_ply, save_trajectory_kitti  # noqa: E402

# --- config (reference: main.cpp:40-43) ---
if args.config:
    cfg = load_config(args.config)
else:
    cfg = Config()
updates = {}
if args.path:
    updates["path"] = args.path
if args.calib:
    updates["calib_path"] = args.calib
if args.gt:
    updates["gt_path"] = args.gt
if args.start is not None:
    updates["start_frame"] = args.start
if args.end is not None:
    updates["end_frame"] = args.end
if args.fast:
    updates["use_orb"] = False
if args.ba:
    updates["ba"] = BaParams(enabled=True)
if updates:
    import dataclasses

    cfg = dataclasses.replace(cfg, **updates)

camera = parse_kitti_calib(cfg.calib_path)
gt = kitti.parse_ground_truth(cfg.gt_path) if cfg.gt_path else np.zeros((0, 4, 4))

# --- frames: native async prefetcher, Python fallback ---
H, W = cfg.image_height, cfg.image_width
if native_loader.available():
    frames = native_loader.AsyncStereoLoader(
        cfg.path, cfg.start_frame, cfg.end_frame, H, W, threads=2
    )
else:
    frames = kitti.SequenceReader(cfg.path, cfg.start_frame, cfg.end_frame)

vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence)
t0 = time.time()
if args.chunk:
    res = vo.run_chunked(list(frames))
else:
    res = vo.run(frames, verbose=args.verbose)
wall = time.time() - t0

if args.refine:
    # Sweep the block-BA + pose-graph refiner (parallel/global_opt) across
    # the trajectory in consecutive spans — the back-end pass the reference
    # declared and never built (src/map.cpp:84-88). Updates res.poses in
    # place so every output below (trajectory file, ATE, plot) is refined.
    import jax.numpy as jnp  # noqa: E402

    from svo_tpu.parallel import global_opt  # noqa: E402

    bfx = jnp.float32(camera.K[0, 0] * camera.baseline)
    span = global_opt.block_span(args.refine_blocks, args.refine_cams)
    state = vo.state
    mp_state, poses = state.map, state.poses
    n = res.n_frames
    his = list(range(span - 1, n, span - 1)) or [n - 1]
    if his[-1] != n - 1:
        his.append(n - 1)
    t_r = time.time()
    n_acc = 0
    for hi in his:
        out = global_opt.refine_global(
            mp_state, poses, jnp.int32(hi), jnp.asarray(camera.K), bfx,
            n_blocks=args.refine_blocks, cams_per_block=args.refine_cams,
        )
        mp_state, poses = out.map, out.poses
        n_acc += int(out.accepted)
    refined = np.asarray(poses[:n])
    print(f"refine:       {len(his)} sweeps ({n_acc} accepted) over "
          f"{n} frames in {time.time() - t_r:.2f}s")
    if len(gt):
        before = ate_rmse(res.poses, gt[cfg.start_frame : cfg.start_frame + n])
        after = ate_rmse(refined, gt[cfg.start_frame : cfg.start_frame + n])
        print(f"refine ATE:   {before:.4f} m -> {after:.4f} m")
    res.poses = refined

print(f"frames:       {res.n_frames}")
print(f"wall:         {wall:.2f}s  ({res.fps:.2f} fps)")
print(f"map points:   {int(res.metrics[-1, 4])}")
print(f"keyframes:    {int(res.kf_flags.sum())}")
print(f"mean feats:   {res.metrics[1:, 2].mean():.1f}")
print(f"mean inlier%: {res.metrics[1:, 1].mean() * 100:.1f}")
if len(gt):
    n = res.n_frames
    ate = ate_rmse(res.poses, gt[cfg.start_frame : cfg.start_frame + n])
    rpe_t, rpe_r = rpe(res.poses, gt[cfg.start_frame : cfg.start_frame + n])
    print(f"ATE RMSE:     {ate:.4f} m")
    print(f"RPE:          {rpe_t:.4f} m / {np.rad2deg(rpe_r):.4f} deg per frame")
if args.out:
    save_trajectory_kitti(args.out, res.poses)
    print(f"trajectory -> {args.out}")
if args.ply and res.map_points is not None:
    save_ply(args.ply, res.map_points)
    print(f"map -> {args.ply}")
if args.metrics_out:
    import json

    from svo_tpu.utils import metrics as metrics_mod

    metrics_mod.write_frame_records(args.metrics_out, res)
    summary = metrics_mod.summarize(res)
    with open(args.metrics_out + ".summary.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(f"metrics -> {args.metrics_out} (+ .summary.json)")
if args.plot:
    from svo_tpu.viz.dump import plot_trajectory

    plot_trajectory(args.plot, res.poses, gt if len(gt) else None)
    print(f"plot -> {args.plot}")
