"""Fleet evaluation: per-sequence ATE/RPE table.

With a KITTI odometry root mounted (--kitti <root> with sequences/<NN>/ and
poses/<NN>.txt), evaluates the requested sequences on real data. Without it,
evaluates a fleet of synthetic sequences (distinct seeds/speeds) so the
harness itself always runs — BASELINE.json configs #3/#4 name seq 00-10;
this produces that table the moment the data is mounted.

    python scripts/eval_fleet.py                         # synthetic fleet
    python scripts/eval_fleet.py --kitti /data/kitti --seqs 00,01,02
    python scripts/eval_fleet.py --cpu --small           # quick CI-ish run
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--kitti", default="", help="KITTI odometry root (dataset/)")
parser.add_argument("--seqs", default="00,01,02,03,04,05,06,07,08,09,10")
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--small", action="store_true", help="small synthetic images")
parser.add_argument("--frames", type=int, default=0, help="cap frames per sequence")
parser.add_argument("--chunk", type=int, default=12)
parser.add_argument("--cadence", type=int, default=6)
parser.add_argument("--out", default="", help="write the table as JSON")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import numpy as np  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse, rpe  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402


def run_sequence(name, frames, camera, gt, shape):
    cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
    n_use = len(frames)
    if args.chunk:
        n_use = 1 + ((len(frames) - 1) // args.chunk) * args.chunk
        frames = frames[:n_use]
    vo = StereoVO(cfg, camera, chunk=args.chunk, kf_cadence=args.cadence)
    t0 = time.perf_counter()
    res = vo.run_chunked(frames)
    wall = time.perf_counter() - t0
    gt = gt[: res.n_frames]
    ate = ate_rmse(res.poses, gt)
    t_err, r_err = rpe(res.poses, gt)
    traveled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    row = {
        "seq": name,
        "frames": res.n_frames,
        "ate_m": round(float(ate), 4),
        "ate_pct": round(100 * float(ate) / max(traveled, 1e-9), 3),
        "rpe_t_m": round(float(t_err), 4),
        "rpe_r_deg": round(float(r_err), 4),
        "traveled_m": round(traveled, 1),
        "fps_incl_compile": round((res.n_frames - 1) / wall, 1),
    }
    print(
        f"{name:>9s} | {row['frames']:5d} fr | ATE {row['ate_m']:7.3f} m "
        f"({row['ate_pct']:5.2f}%) | RPE {row['rpe_t_m']:.3f} m "
        f"/ {row['rpe_r_deg']:.3f} deg | {row['fps_incl_compile']:6.1f} fps",
        flush=True,
    )
    return row


rows = []
if args.kitti:
    from svo_tpu.geometry.camera import parse_kitti_calib
    from svo_tpu.io import kitti

    for s in args.seqs.split(","):
        s = s.strip()
        seq_dir = os.path.join(args.kitti, "sequences", s)
        if not os.path.isdir(seq_dir):
            print(f"{s:>9s} | missing ({seq_dir})", flush=True)
            continue
        camera = parse_kitti_calib(os.path.join(seq_dir, "calib.txt"))
        gt = kitti.parse_ground_truth(
            os.path.join(args.kitti, "poses", f"{s}.txt")
        )
        end = args.frames or None
        frames = list(kitti.SequenceReader(seq_dir, 0, end))
        h, w = frames[0][1].shape
        rows.append(run_sequence(s, frames, camera, gt, (h, w)))
else:
    from svo_tpu.io.synthetic import SyntheticSequence

    shape = (184, 320) if args.small else (376, 1241)
    n = args.frames or (49 if args.small else 97)
    for i, s in enumerate(args.seqs.split(",")):
        s = s.strip()
        seq = SyntheticSequence(
            n_frames=n, shape=shape, fx=200.0 if args.small else 718.856,
            seed=i, speed=0.25 + 0.03 * i,
        )
        camera = cam_mod.from_intrinsics(
            seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
        )
        rows.append(
            run_sequence(f"synth-{s}", list(seq), camera, seq.gt_poses, shape)
        )

if rows:
    mean_pct = float(np.mean([r["ate_pct"] for r in rows]))
    print(f"{'mean':>9s} | ATE {mean_pct:.2f}% of distance traveled", flush=True)
if args.out:
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
