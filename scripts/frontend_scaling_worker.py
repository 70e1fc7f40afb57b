"""Worker for the FRONTEND scaling measurement (scripts/scaling_eff.py).

Strong scaling of the data-parallel multi-sequence frontend
(parallel/multi_seq.py): a fixed fleet of 2 VO streams runs either on one
process (2 virtual CPU devices, 1 pinned core) or on two processes (1
device + 1 pinned core each, jax.distributed over localhost). Per frame
step the only cross-process traffic is the fleet-health psum — the same
program a multi-GPU host runs per-stream-per-card over NVLink.

    python scripts/frontend_scaling_worker.py --rank 0 --nprocs 2 \
        --port 19788 --out /tmp/fscale_0.json
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--rank", type=int, required=True)
parser.add_argument("--nprocs", type=int, required=True)
parser.add_argument("--port", type=int, default=19788)
parser.add_argument("--out", type=str, required=True)
parser.add_argument("--frames", type=int, default=31)
args = parser.parse_args()

from svo_tpu.parallel import multihost  # noqa: E402

STREAMS = 2
multihost.init(
    coordinator_address=f"localhost:{args.port}",
    num_processes=args.nprocs,
    process_id=args.rank,
    local_cpu_devices=STREAMS // args.nprocs,
)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from svo_tpu.config import Capacity, Config, RansacParams  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from svo_tpu.parallel.multi_seq import MultiStereoVO  # noqa: E402

assert len(jax.devices()) == STREAMS

shape = (184, 320)
cfg = Config(
    use_orb=False, image_height=shape[0], image_width=shape[1],
    capacity=Capacity(max_features=96, max_points=1 << 14, max_frames=256,
                      max_detections=128),
    ransac=RansacParams(num_hypotheses=64),
)
# identical frames on every process (same seeds -> same bytes); stream s
# runs sequence seed 7+s
seqs = [SyntheticSequence(n_frames=args.frames, shape=shape, fx=200.0,
                          speed=0.3, seed=7 + s) for s in range(STREAMS)]
camera = cam_mod.from_intrinsics(
    seqs[0].K[0, 0], seqs[0].K[1, 1], seqs[0].K[0, 2], seqs[0].K[1, 2],
    seqs[0].baseline,
)
frames = [
    np.stack([np.clip(seqs[s].frame(i)[j], 0, 255) for s in range(STREAMS)])
    for i in range(args.frames) for j in (0, 1)
]
lefts = frames[0::2]
rights = frames[1::2]

vo = MultiStereoVO(cfg, camera, n_streams=STREAMS)
vo.start(lefts[0], rights[0])
# warm-up: compile + a few steps
for i in range(1, 6):
    vo.process(lefts[i], rights[i])
jax.block_until_ready(vo.state.pose)

t0 = time.perf_counter()
for i in range(6, args.frames):
    vo.process(lefts[i], rights[i])
jax.block_until_ready(vo.state.pose)
wall = time.perf_counter() - t0
n_steps = args.frames - 6

out = {
    "rank": args.rank,
    "nprocs": args.nprocs,
    "wall_s": wall,
    "frames_per_s_aggregate": STREAMS * n_steps / wall,
    "steps": n_steps,
    "streams": STREAMS,
    "health_finite": bool(np.isfinite(vo.fleet_health).all()),
}
with open(args.out, "w") as f:
    json.dump(out, f)
print(f"rank {args.rank}/{args.nprocs}: "
      f"{out['frames_per_s_aggregate']:.2f} frames/s aggregate", flush=True)
