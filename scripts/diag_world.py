"""Per-frame diagnosis of a multi-world run: where does the error enter?

Runs the pipeline on a cached world (scripts/eval_worlds.py cache) and
prints, per frame: rotation error vs GT (deg), translation error (m),
per-frame RELATIVE pose error (the frame where drift is injected), tracked
count, inlier ratio, live features, KF flag.

    python scripts/diag_world.py --world box-turns
    python scripts/diag_world.py --world box-turns --ref   # reference CPU
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--world", default="box-turns")
parser.add_argument("--frames", type=int, default=241)
parser.add_argument("--chunk", type=int, default=12)
parser.add_argument("--cadence", type=int, default=6)
parser.add_argument("--rev", action="store_true")
parser.add_argument("--ref", action="store_true", help="run reference CPU instead")
parser.add_argument("--dynamic", action="store_true",
                    help="use the dynamic keyframe rule (single-frame steps)")
parser.add_argument("--every", type=int, default=1, help="print every N frames")
parser.add_argument("--anneal", default="", help="override lo_anneal, e.g. 4,2,1")
parser.add_argument("--no-metrics", action="store_true")
args = parser.parse_args()

import jax

import numpy as np  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

SHAPE = (376, 1241)
H, W = SHAPE
FX = 718.856

from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402

# mirror of scripts/eval_worlds.py (that module parses args at import time)
WORLDS = {
    "corridor-base": ("corridor", "wobble", 0.3),
    "corridor-narrow-coarse": ("corridor-narrow", "wobble", 0.45),
    "box-turns": ("box", "turns", 0.3),
    "box-loop": ("box", "loop", 0.3),
    "box-fine-fast": ("box-fine", "turns", 0.6),
    "corridor-lowtex": ("corridor-lowtex", "wobble", 0.3),
}


def render_world(name, world, traj, speed, n):
    d = f"/tmp/svo_cache/worlds/{name}_f{n}"
    os.makedirs(d, exist_ok=True)
    lf, rf = os.path.join(d, "l.u8"), os.path.join(d, "r.u8")
    gtf = os.path.join(d, "gt.npy")
    seq = SyntheticSequence(n_frames=n, shape=SHAPE, fx=FX, speed=speed,
                            world=world, traj=traj)
    if os.path.exists(gtf) and os.path.getsize(lf) == n * H * W:
        lsm = np.memmap(lf, np.uint8, "r", shape=(n, H, W))
        rsm = np.memmap(rf, np.uint8, "r", shape=(n, H, W))
        return lsm, rsm, np.load(gtf), seq
    lsm = np.memmap(lf, np.uint8, "w+", shape=(n, H, W))
    rsm = np.memmap(rf, np.uint8, "w+", shape=(n, H, W))
    for i in range(n):
        l, r = seq.frame(i)
        lsm[i] = np.clip(l, 0, 255).astype(np.uint8)
        rsm[i] = np.clip(r, 0, 255).astype(np.uint8)
    lsm.flush(); rsm.flush()
    np.save(gtf, seq.gt_poses)
    return lsm, rsm, seq.gt_poses, seq


world, traj, speed = WORLDS[args.world]
ls, rs, gt, seq = render_world(args.world, world, traj, speed, args.frames)
if args.rev:
    ls, rs, gt = ls[::-1], rs[::-1], gt[::-1]

camera = cam_mod.from_intrinsics(
    seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
)
cfg = Config(use_orb=False, image_height=H, image_width=W)
if args.anneal:
    import dataclasses as _dc
    sched = tuple(float(x) for x in args.anneal.split(","))
    cfg = _dc.replace(cfg, ransac=_dc.replace(cfg.ransac, lo_anneal=sched))

n = args.frames


def pose_errors(est, gt_poses):
    """Align first pose, then per-frame rot (deg) / trans (m) error, plus
    per-frame relative-pose error (rot deg per frame step)."""
    A = np.linalg.inv(est[0]) @ gt_poses[0]
    rot = np.zeros(len(est))
    tr = np.zeros(len(est))
    rel_rot = np.zeros(len(est))
    rel_tr = np.zeros(len(est))
    for i in range(len(est)):
        E = np.linalg.inv(gt_poses[i]) @ (est[i] @ A)
        c = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        rot[i] = np.degrees(np.arccos(c))
        tr[i] = np.linalg.norm(E[:3, 3])
        if i:
            dg = np.linalg.inv(gt_poses[i - 1]) @ gt_poses[i]
            de = np.linalg.inv(est[i - 1]) @ est[i]
            R = np.linalg.inv(dg) @ de
            c = np.clip((np.trace(R[:3, :3]) - 1) / 2, -1, 1)
            rel_rot[i] = np.degrees(np.arccos(c))
            rel_tr[i] = np.linalg.norm(R[:3, 3] - 0)
    return rot, tr, rel_rot, rel_tr


if args.ref:
    from svo_tpu.eval.reference_cpu import ReferenceCpuPipeline

    frames = [(i, ls[i].astype(np.float32), rs[i].astype(np.float32))
              for i in range(n)]
    ref = ReferenceCpuPipeline(
        cfg, np.asarray(camera.K), np.asarray(camera.P_left),
        np.asarray(camera.P_right),
    )
    poses, metrics, fps = ref.run(frames)
    est = poses
    met = None
else:
    if args.dynamic:
        vo = StereoVO(cfg, camera)
        vo.start(ls[0].astype(np.float32), rs[0].astype(np.float32))
        for i in range(1, n):
            vo.process(ls[i].astype(np.float32), rs[i].astype(np.float32))
    else:
        n = 1 + ((args.frames - 1) // args.chunk) * args.chunk
        vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence)
        vo.start(ls[0].astype(np.float32), rs[0].astype(np.float32))
        for c in range((n - 1) // args.chunk):
            sl = slice(1 + c * args.chunk, 1 + (c + 1) * args.chunk)
            vo.state = vo._chunk_step(
                vo.state, np.ascontiguousarray(ls[sl]), np.ascontiguousarray(rs[sl])
            )
    jax.block_until_ready(vo.state.pose)
    est = np.asarray(vo.state.poses[:n])
    met = np.asarray(vo.state.metrics[:n])

rot, tr, rel_rot, rel_tr = pose_errors(est, gt[:n])
print(f"ATE {ate_rmse(est, gt[:n]):.3f} m")
print(" frame | rot(deg) | trans(m) | drel_rot | drel_tr | trk |  IR%  | live | KF")
for i in range(0, n, args.every):
    m = met[i] if met is not None else [0, 0, 0, 0, 0]
    print(
        f"{i:6d} | {rot[i]:8.3f} | {tr[i]:8.3f} | {rel_rot[i]:8.4f} |"
        f" {rel_tr[i]:7.4f} | {int(m[0]):3d} | {m[1]*100:5.1f} | {int(m[2]):4d} |"
        f" {int(m[3])}"
    )
