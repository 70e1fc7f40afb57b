"""Back-end A/B experiment harness: front-end only vs in-pipeline window BA
vs global refinement, on cached synthetic frames.

Drives the cadenced chunk path over N frames from the render cache
(scripts/render_cache.py) and reports ATE / drift-at-end / rot drift for the
chosen back-end configuration. The iteration loop for VERDICT r03 items 1-2
(make the back-end actually improve a live trajectory).

    python scripts/exp_ba.py --frames 601 --mode off
    python scripts/exp_ba.py --frames 601 --mode ba
    python scripts/exp_ba.py --frames 601 --mode refine --refine-every 8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from render_cache import open_cache  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--frames", type=int, default=601)
parser.add_argument("--chunk", type=int, default=12)
parser.add_argument("--cadence", type=int, default=6)
parser.add_argument("--mode", type=str, default="off",
                    choices=["off", "ba", "refine", "ba+refine"])
parser.add_argument("--refine-every", type=int, default=8,
                    help="refine every N chunks")
parser.add_argument("--ba-window", type=int, default=8)
parser.add_argument("--ba-interval", type=int, default=4)
parser.add_argument("--ba-iters", type=int, default=10)
parser.add_argument("--ba-reject", type=float, default=20.0)
parser.add_argument("--cache-frames", type=int, default=2401,
                    help="cache sequence length (frames must be <= this)")
parser.add_argument("--klt-iters", type=int, default=0,
                    help="override temporal KLT max_iters (0 = default)")
parser.add_argument("--stereo-iters", type=int, default=0,
                    help="override stereo KLT max_iters (0 = default)")
parser.add_argument("--max-age", type=int, default=-1,
                    help="override max_track_age (-1 = default)")
parser.add_argument("--fb-threshold", type=float, default=0.0,
                    help="override fb_threshold (0 = default)")
parser.add_argument("--hypotheses", type=int, default=0,
                    help="override RANSAC num_hypotheses (0 = default)")
parser.add_argument("--max-depth", type=float, default=0.0,
                    help="override max_depth_baselines (0 = default)")
parser.add_argument("--anchored", action="store_true",
                    help="enable keyframe-anchored KLT")
parser.add_argument("--speed", type=float, default=0.3)
parser.add_argument("--seed", type=int, default=7)
parser.add_argument("--tag", type=str, default="")
args = parser.parse_args()

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from svo_tpu.config import Config, BaParams  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse, rpe  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

t_start = time.perf_counter()


def log(msg):
    print(f"[exp +{time.perf_counter() - t_start:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


shape = (376, 1241)
cache = open_cache(args.cache_frames, shape, 718.856, args.speed, args.seed)
assert cache is not None, "render cache missing — run scripts/render_cache.py"
lefts_all, rights_all, gt = cache
assert args.frames <= args.cache_frames

ba = BaParams(
    enabled=args.mode in ("ba", "ba+refine"),
    window=args.ba_window,
    interval=args.ba_interval,
    iterations=args.ba_iters,
    reject_threshold=args.ba_reject,
)
cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1], ba=ba)
if args.klt_iters:
    cfg = dataclasses.replace(
        cfg, temporal_klt=dataclasses.replace(
            cfg.temporal_klt, max_iters=args.klt_iters)
    )
if args.stereo_iters:
    cfg = dataclasses.replace(
        cfg, stereo_klt=dataclasses.replace(
            cfg.stereo_klt, max_iters=args.stereo_iters)
    )
if args.max_age >= 0:
    cfg = dataclasses.replace(
        cfg, tracking=dataclasses.replace(
            cfg.tracking, max_track_age=args.max_age)
    )
if args.fb_threshold:
    cfg = dataclasses.replace(
        cfg, tracking=dataclasses.replace(
            cfg.tracking, fb_threshold=args.fb_threshold)
    )
if args.hypotheses:
    cfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(
            cfg.ransac, num_hypotheses=args.hypotheses)
    )
if args.max_depth:
    cfg = dataclasses.replace(
        cfg, tracking=dataclasses.replace(
            cfg.tracking, max_depth_baselines=args.max_depth)
    )
if args.anchored:
    cfg = dataclasses.replace(
        cfg, tracking=dataclasses.replace(cfg.tracking, anchored_klt=True)
    )
K = np.array([[718.856, 0, shape[1] / 2],
              [0, 718.856, shape[0] / 2],
              [0, 0, 1]])
baseline = 0.5372
camera = cam_mod.from_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], baseline)

CH = args.chunk
n_chunks = (args.frames - 1) // CH

refiner = None
if args.mode in ("refine", "ba+refine"):
    from svo_tpu.parallel.global_opt import refine_global

    K_mat = jnp.asarray(camera.K)
    bfx = jnp.float32(camera.K[0, 0] * camera.baseline)

    @jax.jit
    def _refine(mp, poses, fid):
        res = refine_global(mp, poses, fid, K_mat, bfx)
        return res.map, res.poses, res.poses[fid], res.accepted

    def refiner(state):
        mp, poses, pose, acc = _refine(state.map, state.poses, state.frame_id)
        return state._replace(
            map=state.map._replace(points=mp.points), poses=poses, pose=pose
        ), acc


vo = StereoVO(cfg, camera, chunk=CH, kf_cadence=args.cadence)
vo.start(lefts_all[0].astype(np.float32), rights_all[0].astype(np.float32))
log(f"start mode={args.mode} frames={args.frames} ba={ba.enabled} "
    f"refine_every={args.refine_every if refiner else 0}")

refine_calls = refine_accepts = 0
t0 = time.perf_counter()
for c in range(n_chunks):
    sl = slice(1 + c * CH, 1 + (c + 1) * CH)
    vo.state = vo._chunk_step(
        vo.state, np.ascontiguousarray(lefts_all[sl]),
        np.ascontiguousarray(rights_all[sl])
    )
    if refiner is not None and (c + 1) % args.refine_every == 0:
        vo.state, acc = refiner(vo.state)
        refine_calls += 1
        refine_accepts += int(np.asarray(acc))
jax.block_until_ready(vo.state.pose)
dt = time.perf_counter() - t0

n = 1 + n_chunks * CH
est = np.asarray(vo.state.poses[:n])
ate = ate_rmse(est, gt[:n])
rpe_t, rpe_r = rpe(est, gt[:n])
traveled = float(np.linalg.norm(np.diff(gt[:n, :3, 3], axis=0), axis=1).sum())
end_err = float(np.linalg.norm(est[n - 1, :3, 3] - gt[n - 1, :3, 3]))
Rerr = est[n - 1, :3, :3] @ gt[n - 1, :3, :3].T
rot_end = float(np.degrees(np.arccos(np.clip((np.trace(Rerr) - 1) / 2, -1, 1))))

# systematic-bias diagnostics: signed per-frame relative yaw error and
# translation scale ratio — where does linear drift come from?
dyaws, dpitches, scales = [], [], []
for i in range(n - 1):
    de = np.linalg.inv(est[i]) @ est[i + 1]
    dg = np.linalg.inv(gt[i]) @ gt[i + 1]
    # yaw about camera y axis / pitch about x, from the forward column
    yaw_e = np.arctan2(de[0, 2], de[2, 2])
    yaw_g = np.arctan2(dg[0, 2], dg[2, 2])
    dyaws.append(yaw_e - yaw_g)
    dpitches.append(np.arctan2(-de[1, 2], de[2, 2])
                    - np.arctan2(-dg[1, 2], dg[2, 2]))
    ng = np.linalg.norm(dg[:3, 3])
    if ng > 1e-6:
        scales.append(np.linalg.norm(de[:3, 3]) / ng)
mean_dyaw = float(np.degrees(np.mean(dyaws)))
mean_dpitch = float(np.degrees(np.mean(dpitches)))
mean_scale = float(np.mean(scales))

out = {
    "tag": args.tag or args.mode,
    "mode": args.mode,
    "frames": n,
    "ate_m": round(ate, 4),
    "ate_pct": round(100 * ate / traveled, 4),
    "end_pos_err_m": round(end_err, 3),
    "end_rot_err_deg": round(rot_end, 3),
    "rpe_trans_m": round(rpe_t, 4),
    "rpe_rot_deg": round(float(np.degrees(rpe_r)), 5),
    "mean_dyaw_deg_per_frame": round(mean_dyaw, 6),
    "mean_dpitch_deg_per_frame": round(mean_dpitch, 6),
    "mean_scale_ratio": round(mean_scale, 6),
    "fps": round((n - 1) / dt, 1),
    "refine_calls": refine_calls,
    "refine_accepts": refine_accepts,
    "ba": {"window": ba.window, "interval": ba.interval,
           "iters": ba.iterations, "reject": ba.reject_threshold}
    if ba.enabled else None,
}
print(json.dumps(out))
