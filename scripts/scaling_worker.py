"""Worker process for the scaling-efficiency harness (scripts/scaling_eff.py).

Strong-scaling measurement of the distributed BA solve: a FIXED global
problem is partitioned into `nprocs` point blocks (one virtual CPU device
per process, pinned to one core by the driver), and each process times the
same jitted shard_map program over its shard — per LM iteration the only
cross-process traffic is the psum of the Schur-reduced camera system, the
identical program a multi-GPU host runs over NVLink (SURVEY.md §2.3).

    python scripts/scaling_worker.py --rank 0 --nprocs 2 --port 19777 \
        --out /tmp/scale_0.json
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
parser.add_argument("--port", type=int, default=19777)
parser.add_argument("--out", type=str, required=True)
parser.add_argument("--cams", type=int, default=12)
parser.add_argument("--pts", type=int, default=4096)
parser.add_argument("--iters", type=int, default=20)
parser.add_argument("--reps", type=int, default=6)
args = parser.parse_args()

from svo_tpu.parallel import multihost  # noqa: E402

multihost.init(
    coordinator_address=f"localhost:{args.port}",
    num_processes=args.nprocs,
    process_id=args.rank,
    local_cpu_devices=1,
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from svo_tpu.parallel import ba as dist  # noqa: E402
from tests.test_ba import BASELINE, FX, K_MAT, make_problem  # noqa: E402

assert len(jax.devices()) == args.nprocs

# identical problem on every process (same seed -> same bytes)
rng = np.random.default_rng(42)
problem, _, _ = make_problem(rng, n_cams=args.cams, n_pts=args.pts, noise_px=0.4)
K_j = jnp.asarray(K_MAT)
bfx = jnp.float32(FX * BASELINE)

sharded = dist.shard_problem(problem, args.nprocs)
mesh = multihost.global_mesh()
global_problem = multihost.put_sharded(sharded, mesh)
fn = dist.solve_ba_on_mesh(
    global_problem, K_j, bfx, mesh, iterations=args.iters
)

res = fn(global_problem)  # compile + warm
local_cost = res.cost.addressable_shards[0].data
jax.block_until_ready(local_cost)

t0 = time.perf_counter()
for _ in range(args.reps):
    res = fn(global_problem)
jax.block_until_ready(res.cost.addressable_shards[0].data)
wall = time.perf_counter() - t0

n_obs = int(np.asarray(problem.obs_valid).sum())
out = {
    "rank": args.rank,
    "nprocs": args.nprocs,
    "wall_s": wall,
    "lm_iters_per_s": args.iters * args.reps / wall,
    "iters": args.iters,
    "reps": args.reps,
    "cams": args.cams,
    "pts": args.pts,
    "n_obs": n_obs,
    "final_cost": float(np.asarray(res.cost.addressable_shards[0].data)[0]),
}
with open(args.out, "w") as f:
    json.dump(out, f)
print(f"rank {args.rank}/{args.nprocs}: {out['lm_iters_per_s']:.2f} LM it/s "
      f"({n_obs} obs)", flush=True)
