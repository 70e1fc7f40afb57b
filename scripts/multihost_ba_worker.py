"""Worker process for the 2-process localhost distributed-BA test.

Each process owns half of an 8-shard BA problem (4 virtual CPU devices per
process); the global mesh spans both processes and the Schur-reduced camera
system psum crosses the process boundary — the same program a multi-host GPU
cluster runs (SURVEY.md §4: "jax.distributed multi-process on localhost,
asserting distributed BA matches the single-host solution").

    python scripts/multihost_ba_worker.py --rank R --nprocs 2 \
        --port 12345 --out /tmp/mh_R.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--rank", type=int, required=True)
parser.add_argument("--nprocs", type=int, default=2)
parser.add_argument("--port", type=int, default=19666)
parser.add_argument("--devices-per-proc", type=int, default=4)
parser.add_argument("--out", type=str, required=True)
args = parser.parse_args()

from svo_tpu.parallel import multihost

multihost.init(
    coordinator_address=f"localhost:{args.port}",
    num_processes=args.nprocs,
    process_id=args.rank,
    local_cpu_devices=args.devices_per_proc,
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from svo_tpu.ba.solver import solve_ba  # noqa: E402
from svo_tpu.parallel import ba as dist  # noqa: E402
from tests.test_ba import BASELINE, FX, K_MAT, make_problem  # noqa: E402

n_shards = args.nprocs * args.devices_per_proc
assert len(jax.devices()) == n_shards, (
    f"global devices {len(jax.devices())} != {n_shards}"
)

# identical problem on every process (same seed -> same bytes)
rng = np.random.default_rng(42)
problem, T_true, pts_true = make_problem(rng, n_cams=6, n_pts=128, noise_px=0.3)
K_j = jnp.asarray(K_MAT)
bfx = jnp.float32(FX * BASELINE)

# single-device reference solution, computed locally by each process
single = solve_ba(problem, K_j, bfx, iterations=12)

# global-mesh distributed solve; this process feeds only its local shards
sharded = dist.shard_problem(problem, n_shards)
mesh = multihost.global_mesh()
res = multihost.solve_ba_multihost(sharded, K_j, bfx, mesh, iterations=12)

# pull only addressable shards (cameras are replicated content-wise)
local_T = np.stack([np.asarray(s.data)[0] for s in res.T_cw.addressable_shards])
local_cost = np.stack(
    [np.asarray(s.data)[0] for s in res.cost.addressable_shards]
)

cam_err = float(np.abs(local_T - np.asarray(single.T_cw)[None]).max())
cost_dev = float(np.abs(local_cost - float(single.cost)).max())

with open(args.out, "w") as f:
    json.dump(
        {
            "rank": args.rank,
            "n_global_devices": len(jax.devices()),
            "n_local_shards": int(local_T.shape[0]),
            "cam_err_vs_single": cam_err,
            "cost_dev_vs_single": cost_dev,
            "single_cost": float(single.cost),
            "ok": bool(cam_err < 5e-4 and cost_dev < 1e-3 * float(single.cost)),
        },
        f,
    )
print(f"rank {args.rank}: cam_err={cam_err:.2e} cost_dev={cost_dev:.2e}")
