"""Time the cadenced chunk step precisely (device->host fetch per repeat),
optionally comparing trajectories against a second engine variant.

    python scripts/time_chunk.py --streams 8 --chunk 12 --cadence 6
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--streams", type=int, default=8)
parser.add_argument("--chunk", type=int, default=12)
parser.add_argument("--cadence", type=int, default=6)
parser.add_argument("--frames", type=int, default=49)
parser.add_argument("--reps", type=int, default=3)
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import numpy as np

from svo_tpu.config import Config
from svo_tpu.eval.trajectory import ate_rmse
from svo_tpu.geometry import camera as cam_mod
from svo_tpu.parallel.batched import BatchedStereoVO

N = args.frames
SHAPE = (376, 1241)
CACHE = f"/tmp/synth_cache_{N}_{SHAPE[0]}x{SHAPE[1]}.npz"
T0 = time.perf_counter()


def log(m):
    print(f"[+{time.perf_counter() - T0:6.1f}s] {m}", file=sys.stderr, flush=True)


if os.path.exists(CACHE):
    z = np.load(CACHE)
    frames = [(i, z[f"l{i}"], z[f"r{i}"]) for i in range(N)]
    baseline, K, gt = float(z["baseline"]), z["K"], z["gt"]
else:
    from svo_tpu.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=N, shape=SHAPE, fx=718.856)
    frames = list(seq)
    data = {f"l{i}": l for i, l, _ in frames}
    data.update({f"r{i}": r for i, _, r in frames})
    np.savez(CACHE, gt=seq.gt_poses, baseline=seq.baseline, K=seq.K, **data)
    baseline, K, gt = float(seq.baseline), seq.K, seq.gt_poses
log(f"{N} frames ready")

cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
camera = cam_mod.from_intrinsics(K[0, 0], K[1, 1], K[0, 2], K[1, 2], baseline)
S, CH = args.streams, args.chunk

streams = [frames if s % 2 == 0 else frames[::-1] for s in range(S)]
l0 = np.stack([st[0][1] for st in streams])
r0 = np.stack([st[0][2] for st in streams])


def u8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


n_chunks = (N - 1) // CH
chunks = []
for c0 in range(n_chunks):
    ts = range(1 + c0 * CH, 1 + (c0 + 1) * CH)
    chunks.append((
        jax.device_put(np.stack(
            [np.stack([u8(st[t][1]) for st in streams]) for t in ts])),
        jax.device_put(np.stack(
            [np.stack([u8(st[t][2]) for st in streams]) for t in ts])),
    ))
jax.block_until_ready(chunks)

bvo = BatchedStereoVO(cfg, camera, S, chunk=CH, kf_cadence=args.cadence)
bvo.start(l0, r0)
_ = np.asarray(bvo.state.pose)
log("bootstrap ready")
bvo.process_chunk(*chunks[0])
_ = np.asarray(bvo.state.pose)  # force full execution via host fetch
log("chunk step compiled")

times = []
for r in range(args.reps):
    bvo.start(l0, r0)
    _ = np.asarray(bvo.state.pose)
    t0 = time.perf_counter()
    for c in chunks:
        bvo.process_chunk(*c)
    _ = np.asarray(bvo.state.pose)
    dt = time.perf_counter() - t0
    times.append(dt)
    log(f"rep {r}: {dt * 1e3:.1f} ms for {n_chunks} chunks "
        f"({dt / (n_chunks * CH) * 1e3:.2f} ms/step, "
        f"{S * n_chunks * CH / dt:.1f} fps agg)")

n = 1 + n_chunks * CH
trajs = bvo.trajectories(n)
ates = []
for s in range(S):
    g = gt if s % 2 == 0 else gt[::-1]
    ates.append(round(ate_rmse(trajs[s], g[:n]), 4))
best = min(times)
print(f"best {best*1e3:.1f} ms  agg_fps {S*n_chunks*CH/best:.1f}  ate {ates}")
