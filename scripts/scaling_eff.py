"""Scaling-efficiency harness — the BASELINE.json north-star measurement
("#>=80% scaling efficiency at 2 hosts") that rounds 1-2 never recorded.

Method (documented in the output artifact):
- STRONG scaling of the distributed BA solve on a fixed global problem.
- 1-process run: the whole problem on one virtual CPU device, the process
  pinned to one core (taskset). This is T1.
- 2-process run: the identical problem partitioned into 2 point blocks via
  jax.distributed over localhost, one device + one distinct core per
  process. Slowest rank's wall time is T2.
- efficiency = T1 / (2 * T2)  (speedup over 2x the resources).

Each process is pinned to ONE core so the measurement isolates the
distributed program's scaling (compute split + psum of the Schur camera
system) from host-level core contention — the same program structure a multi-GPU
host runs, where the collectives ride NVLink instead of localhost gRPC.
This measures the framework's scaling overhead on CPU processes; absolute
rates are CPU rates, not device rates.

    python scripts/scaling_eff.py --out SCALING_r03.json
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

parser = argparse.ArgumentParser()
parser.add_argument("--out", type=str, default=os.path.join(REPO, "SCALING_r04.json"))
parser.add_argument("--cams", type=int, default=12)
parser.add_argument("--pts", type=int, default=4096)
parser.add_argument("--iters", type=int, default=20)
parser.add_argument("--reps", type=int, default=6)
parser.add_argument("--port", type=int, default=19777)
args = parser.parse_args()

HAVE_TASKSET = shutil.which("taskset") is not None


def run_config(nprocs: int) -> list[dict]:
    outs = [f"/tmp/scale_{nprocs}_{r}.json" for r in range(nprocs)]
    procs = []
    for r in range(nprocs):
        cmd = [
            sys.executable,
            os.path.join(REPO, "scripts", "scaling_worker.py"),
            "--rank", str(r), "--nprocs", str(nprocs),
            "--port", str(args.port), "--out", outs[r],
            "--cams", str(args.cams), "--pts", str(args.pts),
            "--iters", str(args.iters), "--reps", str(args.reps),
        ]
        if HAVE_TASKSET:
            cmd = ["taskset", "-c", str(r)] + cmd
        procs.append(subprocess.Popen(cmd))
    for p in procs:
        rc = p.wait(timeout=900)
        assert rc == 0, f"worker exited {rc}"
    return [json.load(open(o)) for o in outs]


def measure(cams: int, pts: int, reps: int) -> dict:
    global args
    a0 = (args.cams, args.pts, args.reps)
    args.cams, args.pts, args.reps = cams, pts, reps
    t0 = time.time()
    r1 = run_config(1)
    print(f"  1-proc: {r1[0]['lm_iters_per_s']:.2f} LM it/s "
          f"(+{time.time()-t0:.0f}s)", file=sys.stderr, flush=True)
    r2 = run_config(2)
    args.cams, args.pts, args.reps = a0
    t1 = r1[0]["wall_s"]
    t2 = max(w["wall_s"] for w in r2)
    n_it = r1[0]["iters"] * r1[0]["reps"]
    return {
        "cams": cams,
        "pts": pts,
        "n_obs": r1[0]["n_obs"],
        "efficiency": round(t1 / t2 / 2.0, 4),
        "speedup": round(t1 / t2, 4),
        "t1_s": round(t1, 3),
        "t2_s": round(t2, 3),
        "lm_iters_per_s_1proc": round(r1[0]["lm_iters_per_s"], 2),
        "lm_iters_per_s_2proc_effective": round(n_it / t2, 2),
        # fixed per-iteration cross-process cost implied by T2 - T1/2
        "comm_overhead_ms_per_iter": round(
            max(t2 - t1 / 2.0, 0.0) / n_it * 1e3, 2
        ),
    }


# Size sweep: the small point is a sliding WINDOW BA problem (latency
# sensitive, comm-dominated on localhost gRPC — between GPUs the same 20KB
# psum rides NVLink); the large points are GLOBAL-map BA blocks,
# the workload multi-host partitioning exists for (a full KITTI sequence
# allocates ~50k+ points). The headline efficiency is the largest size.
SWEEP = [(12, 4096, 6), (16, 16384, 4), (16, 32768, 3)]
points = []
for cams, pts, reps in SWEEP:
    print(f"measuring cams={cams} pts={pts}...", file=sys.stderr, flush=True)
    points.append(measure(cams, pts, reps))
    print(f"  eff={points[-1]['efficiency']}", file=sys.stderr, flush=True)

def measure_frontend() -> dict:
    """Strong scaling of the data-parallel frontend: a fixed 2-stream
    fleet on 1 process (2 devices, 1 pinned core) vs 2 processes (1 device
    + 1 pinned core each). Per-step cross-process traffic is one small
    psum (fleet health) — the per-stream-per-chip serving structure."""
    def run_front(nprocs):
        outs = [f"/tmp/fscale_{nprocs}_{r}.json" for r in range(nprocs)]
        procs = []
        for r in range(nprocs):
            cmd = [
                sys.executable,
                os.path.join(REPO, "scripts", "frontend_scaling_worker.py"),
                "--rank", str(r), "--nprocs", str(nprocs),
                "--port", str(args.port + 7), "--out", outs[r],
            ]
            if HAVE_TASKSET:
                cmd = ["taskset", "-c", str(r)] + cmd
            procs.append(subprocess.Popen(cmd))
        for p in procs:
            rc = p.wait(timeout=1800)
            assert rc == 0, f"frontend worker exited {rc}"
        return [json.load(open(o)) for o in outs]

    r1 = run_front(1)
    print(f"  frontend 1-proc: {r1[0]['frames_per_s_aggregate']:.2f} fps",
          file=sys.stderr, flush=True)
    r2 = run_front(2)
    t1 = r1[0]["wall_s"]
    t2 = max(w["wall_s"] for w in r2)
    return {
        "streams": r1[0]["streams"],
        "steps": r1[0]["steps"],
        "efficiency": round(t1 / t2 / 2.0, 4),
        "speedup": round(t1 / t2, 4),
        "t1_s": round(t1, 3),
        "t2_s": round(t2, 3),
        "fps_aggregate_1proc": round(r1[0]["frames_per_s_aggregate"], 2),
        "fps_aggregate_2proc": round(
            r1[0]["streams"] * r1[0]["steps"] / t2, 2
        ),
    }


print("measuring data-parallel frontend 1 vs 2 procs...", file=sys.stderr,
      flush=True)
frontend = measure_frontend()
print(f"  frontend eff={frontend['efficiency']}", file=sys.stderr, flush=True)

head = points[-1]
result = {
    "metric": "distributed_ba_scaling_efficiency_2proc",
    "efficiency": head["efficiency"],
    "speedup": head["speedup"],
    "target": 0.80,
    "met": head["efficiency"] >= 0.80,
    # VERDICT r04 item 8: the claim's SCOPE is explicit — distributed BA
    # is the offline/global-map engine (the workload BASELINE.json config
    # #5 partitions across hosts); an online sliding-window problem fits
    # on ONE chip at interactive rate (BENCH ba_iterations_per_s ~580 on
    # a 1.3k-obs window) and distributing it buys nothing on a
    # per-collective-latency transport. Round 5 additionally fused the
    # four pre-solve cross-shard reductions into one collective (see
    # sweep[0].comm_overhead_ms_per_iter vs SCALING_r04's 16.1).
    "scope": "offline/global-map BA (>= ~200k observations)",
    "met_at_scope": head["efficiency"] >= 0.80,
    "online_window_note": (
        "window-sized problems (sweep[0]) remain latency-bound at 2 "
        "procs over localhost gRPC and are served single-chip instead"
    ),
    "method": (
        "strong scaling of the shard_map distributed BA (point-block "
        "partitioning, per-LM-iteration psum of the Schur-reduced camera "
        "system); fixed global problem, 1 virtual CPU device + 1 pinned "
        "core per process (taskset), jax.distributed over localhost gRPC; "
        "efficiency = T1/(2*T2) with T2 = slowest rank; headline = largest "
        "(global-map-scale) problem, full size sweep in `sweep`"
        + ("" if HAVE_TASKSET else "; WARNING: taskset unavailable, unpinned")
    ),
    "headline_problem": {k: head[k] for k in ("cams", "pts", "n_obs")},
    "sweep": points,
    "small_problem_note": (
        "the smallest sweep point (window-BA-sized, ~41k obs) is "
        "comm-dominated on localhost gRPC and does NOT meet the target "
        "(see sweep[0]); distributed BA pays off at global-map sizes, "
        "which is the workload it exists for"
    ),
    "frontend": frontend | {
        "metric": "data_parallel_frontend_scaling_2proc",
        "method": (
            "strong scaling of parallel/multi_seq.py: fixed 2-stream "
            "fleet, 1 process (2 virtual CPU devices, 1 pinned core) vs "
            "2 processes (1 device + 1 pinned core each); per-step "
            "cross-process traffic is one fleet-health psum"
        ),
    },
}
with open(args.out, "w") as f:
    json.dump(result, f, indent=1)
print(json.dumps({k: result[k] for k in
                  ("metric", "efficiency", "speedup", "met")}))
print(f"wrote {args.out}", file=sys.stderr)
