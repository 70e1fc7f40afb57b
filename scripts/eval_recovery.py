"""Aggressive-recovery regime validation artifact (VERDICT r04 item 9).

The Schur-LM block-BA engine's surviving in-pipeline role is recovering
BROKEN spans (parallel/global_opt.py aggressive regime). This script shows
it on live pipeline state instead of unit fixtures:

1. run the pipeline healthily to a mid-run chunk boundary;
2. inject accumulating drift over the trailing span — each frame's pose is
   progressively rotated/translated and every map point BORN in that span
   moves with its birth frame's error (what a real front-end failure leaves
   behind: a self-consistent-per-frame but cross-frame-inconsistent map);
3. arm A continues with no back-end; arm B runs one global refinement
   sweep (which must classify the span as aggressive and correct it), then
   continues with refinement every 2 chunks;
4. record the trajectory error of both arms over the post-injection run.

    python scripts/eval_recovery.py --out RECOVERY_r05.json
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--frames", type=int, default=241)
parser.add_argument("--chunk", type=int, default=12)
parser.add_argument("--cadence", type=int, default=6)
parser.add_argument("--inject-at", type=int, default=121,
                    help="frame (chunk boundary) of the injection")
parser.add_argument("--span", type=int, default=22,
                    help="trailing frames carrying the injected drift")
parser.add_argument("--rot-deg", type=float, default=4.0,
                    help="total injected rotation at the newest frame")
parser.add_argument("--trans-m", type=float, default=0.8)
parser.add_argument("--out", default="")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from svo_tpu.parallel.global_opt import refine_global  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

SHAPE = (376, 1241)
H, W = SHAPE
FX = 718.856
t_start = time.perf_counter()


def log(m):
    print(f"[recovery +{time.perf_counter() - t_start:6.1f}s] {m}",
          file=sys.stderr, flush=True)


# frames from the (round-5 keyed) multi-world cache
name, world, traj, speed, seed = "corridor-base", "corridor", "wobble", 0.3, 7
d = f"/tmp/svo_cache/worlds/{name}_{world}_{traj}_s{speed}_seed{seed}_f{args.frames}"
os.makedirs(d, exist_ok=True)
lf, rf = os.path.join(d, "l.u8"), os.path.join(d, "r.u8")
gtf = os.path.join(d, "gt.npy")
seq = SyntheticSequence(n_frames=args.frames, shape=SHAPE, fx=FX, speed=speed,
                        world=world, traj=traj, seed=seed)
if not (os.path.exists(gtf) and os.path.getsize(lf) == args.frames * H * W):
    ls = np.memmap(lf, np.uint8, "w+", shape=(args.frames, H, W))
    rs = np.memmap(rf, np.uint8, "w+", shape=(args.frames, H, W))
    for i in range(args.frames):
        l, r = seq.frame(i)
        ls[i] = np.clip(l, 0, 255).astype(np.uint8)
        rs[i] = np.clip(r, 0, 255).astype(np.uint8)
    ls.flush(); rs.flush()
    np.save(gtf, seq.gt_poses)
ls = np.memmap(lf, np.uint8, "r", shape=(args.frames, H, W))
rs = np.memmap(rf, np.uint8, "r", shape=(args.frames, H, W))
gt = np.load(gtf)

camera = cam_mod.from_intrinsics(FX, FX, W / 2, H / 2, seq.baseline)
cfg = Config(use_orb=False, image_height=H, image_width=W)

assert (args.inject_at - 1) % args.chunk == 0, "inject at a chunk boundary"

vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence)
vo.start(ls[0].astype(np.float32), rs[0].astype(np.float32))
for c in range((args.inject_at - 1) // args.chunk):
    sl = slice(1 + c * args.chunk, 1 + (c + 1) * args.chunk)
    vo.state = vo._chunk_step(
        vo.state, np.ascontiguousarray(ls[sl]), np.ascontiguousarray(rs[sl])
    )
jax.block_until_ready(vo.state.pose)
log(f"healthy run to frame {args.inject_at - 1}")

# ---- inject accumulating drift over the trailing span ----
st = jax.tree.map(jnp.copy, vo.state)
hi = args.inject_at - 1
lo = hi - args.span + 1
poses = np.asarray(st.poses)


def _err_T(alpha):
    a = np.radians(args.rot_deg) * alpha
    c, s = np.cos(a), np.sin(a)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[:3, 3] = np.array([1.0, 0.15, 0.4]) * (args.trans_m * alpha)
    return T


# birth frame of each point = min obs fid (no ring wrap at this scale)
obs_pid = np.asarray(st.map.obs_pid)
obs_fid = np.asarray(st.map.obs_fid)
M = st.map.points.shape[0]
birth = np.full(M, 1 << 20, np.int64)
okobs = obs_pid >= 0
np.minimum.at(birth, obs_pid[okobs], obs_fid[okobs])
pts = np.asarray(st.map.points)

new_poses = poses.copy()
new_pts = pts.copy()
for f in range(lo, hi + 1):
    alpha = (f - lo + 1) / float(args.span)
    T = _err_T(alpha)
    new_poses[f] = T @ poses[f]
    born = birth == f
    if born.any():
        new_pts[born] = (new_pts[born] @ T[:3, :3].T) + T[:3, 3]

corrupt = st._replace(
    poses=jnp.asarray(new_poses),
    pose=jnp.asarray(new_poses[hi]),
    map=st.map._replace(points=jnp.asarray(new_pts)),
)
pose_err_inj = float(np.linalg.norm(new_poses[hi][:3, 3] - gt[hi][:3, 3]))
log(f"injected drift: newest-frame pose error {pose_err_inj:.2f} m "
    f"/ {args.rot_deg:.1f} deg over frames {lo}-{hi}")

# ---- one refinement sweep on the corrupted state ----
K_mat = jnp.asarray(camera.K)
bfx = jnp.float32(camera.K[0, 0] * camera.baseline)


@jax.jit
def _refine(mp, poses_wc, fid):
    return refine_global(mp, poses_wc, fid, K_mat, bfx)

res = _refine(corrupt.map, corrupt.poses, corrupt.frame_id)
cost_per_obs = float(res.cost_per_obs)
accepted = bool(res.accepted)
refined = corrupt._replace(
    map=corrupt.map._replace(points=res.map.points),
    poses=res.poses,
    pose=res.poses[hi],
)
err_before = ate_rmse(np.asarray(corrupt.poses[lo:hi + 1]), gt[lo:hi + 1],
                      align=False)
err_after = ate_rmse(np.asarray(refined.poses[lo:hi + 1]), gt[lo:hi + 1],
                     align=False)
log(f"refine sweep: cost/obs {cost_per_obs:.1f} px, accepted={accepted}, "
    f"span abs err {err_before:.3f} -> {err_after:.3f} m")


def continue_run(state, refine_every):
    vo.state = state
    n = 1 + ((args.frames - 1) // args.chunk) * args.chunk
    for c in range((args.inject_at - 1) // args.chunk, (n - 1) // args.chunk):
        sl = slice(1 + c * args.chunk, 1 + (c + 1) * args.chunk)
        vo.state = vo._chunk_step(
            vo.state, np.ascontiguousarray(ls[sl]), np.ascontiguousarray(rs[sl])
        )
        if refine_every and (c + 1) % refine_every == 0:
            r = _refine(vo.state.map, vo.state.poses, vo.state.frame_id)
            vo.state = vo.state._replace(
                map=vo.state.map._replace(points=r.map.points),
                poses=r.poses, pose=r.poses[vo.state.frame_id],
            )
    jax.block_until_ready(vo.state.pose)
    return np.asarray(vo.state.poses[:n]), n


est_a, n = continue_run(jax.tree.map(jnp.copy, corrupt), 0)
ate_a = ate_rmse(est_a[args.inject_at:], gt[args.inject_at:n], align=False)
log(f"arm A (no back-end): post-injection abs err {ate_a:.3f} m")

est_b, _ = continue_run(refined, 2)
ate_b = ate_rmse(est_b[args.inject_at:], gt[args.inject_at:n], align=False)
log(f"arm B (recovered + refine): post-injection abs err {ate_b:.3f} m")

out = {
    "metric": "aggressive_recovery",
    "world": name,
    "frames": args.frames,
    "inject_at": args.inject_at,
    "span": args.span,
    "injected_rot_deg": args.rot_deg,
    "injected_trans_m": args.trans_m,
    "newest_pose_err_m": round(pose_err_inj, 3),
    "refine_cost_per_obs_px": round(cost_per_obs, 2),
    "aggressive_fired": cost_per_obs > 10.0,
    "accepted": accepted,
    "span_abs_err_before_m": round(err_before, 3),
    "span_abs_err_after_m": round(err_after, 3),
    "post_abs_err_no_backend_m": round(ate_a, 3),
    "post_abs_err_recovered_m": round(ate_b, 3),
    "recovered": bool(ate_b < 0.5 * ate_a),
    "resolved_config": dataclasses.asdict(cfg),
}
dest = args.out or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "RECOVERY_r05.json")
with open(dest, "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps({k: out[k] for k in (
    "metric", "span_abs_err_before_m", "span_abs_err_after_m",
    "post_abs_err_no_backend_m", "post_abs_err_recovered_m", "recovered")}))
log(f"wrote {dest}")
