"""Smoke test of the stereo VO main path on one GPU.

Drives the system through its normal entry points (StereoVO,
BatchedStereoVO, the BA solver) at KITTI odometry seq 00 geometry:
376x1241 stereo, fx 718.856, ~0.54 m baseline, 10 Hz, with frames rendered
from a seed by svo_tpu/io/synthetic.py and the default capacities (128
feature slots, 131,072 map points, 4,608 pose slots and a 32,768-slot
observation ring per stream). Nothing is downloaded.

Phases, all in one process; any failure exits non-zero before the last
line is printed:

0. device: jax.devices() must be GPUs (no CPU fallback);
1. single stream: StereoVO.run_chunked over 97 frames, gated on ATE,
   inliers, live features and finiteness;
2. fleet: BatchedStereoVO with 8 streams (odd streams reversed) and a
   refine() every 2 chunks, gated per stream the same way;
3. BA: solve_ba on a window extracted from the live fleet map, gated on
   a finite cost that does not rise;
4. parity: pyramid, one temporal KLT track and one frame step computed on
   the CPU backend and on the GPU in this process, within stated
   tolerances.

The last stdout line is {"ok": true, "device": {...}}.

    python chip_smoke.py             # phases 0-4 on one card
    python chip_smoke.py --multi 4   # only the multi-card path and what it
                                     # is compared with, on 4 cards
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

SHAPE = (376, 1241)        # KITTI seq 00
FX = 718.856
CHUNK, CADENCE = 12, 6
N_FRAMES = 1 + 8 * CHUNK   # bootstrap frame + 8 full chunks: no tail path
STREAMS = 8
REFINE_EVERY = 2           # chunks
BA_ITERS = 10

# Health limits (.claude/skills/verify/SKILL.md): ATE under 1% of the
# distance travelled, inliers over 95%, features not collapsing: the mean
# live-feature count over the run and over its last chunk stays in the
# healthy band (a single frame may dip when a cohort of tracks retires).
MAX_ATE_PCT = 1.0
MIN_INLIER_PCT = 95.0
MIN_MEAN_FEATURES = 60.0

# Parity tolerances, CPU backend vs GPU on identical inputs. Sums run in
# another order on the GPU (and its scatter-add order is not deterministic),
# so nothing is asked to be bitwise equal.
# - pyramid levels and Scharr gradients, 0-255 scale: a 5-tap banded matmul
#   per axis in f32 at "highest" precision differs by a few ulps of 255
#   (~1e-5); 1e-3 leaves two orders of margin and still catches TF32
#   (~255 * 2^-11 = 0.12).
PYR_TOL = 1e-3
# - tracked positions: each LK update solves a 2x2 system from window sums;
#   reordered f32 sums move the converged position by far less than 0.01 px.
#   A feature whose convergence or border test sits on a threshold may flip
#   status, so agreement is asked over 99% of slots, not all.
TRACK_MEDIAN_TOL_PX = 0.01
TRACK_STATUS_AGREE = 0.99
# - one frame step's pose: same RANSAC draws (threefry is backend
#   independent) and a refined solution; 1 mm and 0.01 deg are well under
#   one frame's motion (0.35 m) yet far above f32 reordering noise.
POSE_TOL_M = 1e-3
POSE_TOL_DEG = 0.01
# --multi: sharded vs single-card solutions. The psum of the reduced camera
# system sums in another order than the single-card segment_sum (f32).
MULTI_BA_COST_RTOL = 1e-3
MULTI_BA_CAM_TOL = 5e-4
MULTI_REFINE_COST_RTOL = 1e-3
MULTI_REFINE_POSE_TOL_M = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_name() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip() if out else "unknown card"


def device_phase(n_required: int = 1):
    """Phase 0: return the GPU devices, or raise. No CPU fallback."""
    import jax

    devs = jax.devices()
    if not devs or any(d.platform != "gpu" for d in devs):
        raise SmokeFailure(
            f"no GPU: jax.devices() is {[d.platform for d in devs]}")
    check(len(devs) >= n_required,
          f"need {n_required} GPUs, JAX sees {len(devs)}")
    return devs


def render(seq, n_threads: int = 8):
    """All frames of a SyntheticSequence as (idx, left, right), rendered on
    host threads (numpy releases the interpreter lock in the ray casts)."""
    with ThreadPoolExecutor(n_threads) as ex:
        pairs = list(ex.map(seq.frame, range(seq.n_frames)))
    return [(i, l, r) for i, (l, r) in enumerate(pairs)]


def travelled(gt_poses) -> float:
    import numpy as np

    return float(np.linalg.norm(np.diff(gt_poses[:, :3, 3], axis=0), axis=1).sum())


def health(label, poses, gt, metrics, kf_flags, card):
    """Print and gate one trajectory's health against the limits above."""
    import numpy as np

    from svo_tpu.eval.trajectory import ate_rmse

    check(np.isfinite(poses).all() and np.isfinite(metrics).all(),
          f"{label}: non-finite pose or metric")
    ate = ate_rmse(poses, gt[: len(poses)])
    dist = travelled(gt[: len(poses)])
    ate_pct = 100.0 * ate / dist
    inl = 100.0 * float(metrics[1:, 1].mean())
    feats = metrics[1:, 2]
    print(f"{label}: ATE {ate:.4f} m = {ate_pct:.4f}% of "
          f"{dist:.1f} m travelled, mean inliers "
          f"{inl:.2f}%, live features mean {feats.mean():.1f} min "
          f"{int(feats.min())}, keyframes {int(np.sum(kf_flags))} [{card}]",
          flush=True)
    check(ate_pct < MAX_ATE_PCT, f"{label}: ATE {ate_pct:.3f}% >= {MAX_ATE_PCT}%")
    check(inl > MIN_INLIER_PCT, f"{label}: inliers {inl:.2f}% <= {MIN_INLIER_PCT}%")
    tail = feats[-CHUNK:].mean()
    check(feats.mean() >= MIN_MEAN_FEATURES and tail >= MIN_MEAN_FEATURES,
          f"{label}: features collapsed (mean {feats.mean():.1f}, last "
          f"{CHUNK} frames {tail:.1f})")


def kitti_config(shape):
    from svo_tpu.config import Config

    return Config(use_orb=False, image_height=shape[0], image_width=shape[1])


def camera_of(seq):
    from svo_tpu.geometry import camera as cam_mod

    return cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline)


def single_stream_phase(cfg, camera, frames, gt, card):
    """Phase 1: StereoVO.run_chunked, cold compile then a warm pass."""
    from svo_tpu.pipeline.odometry import StereoVO

    vo = StereoVO(cfg, camera, chunk=CHUNK, kf_cadence=CADENCE)
    t0 = time.perf_counter()
    vo.run_chunked(frames[: CHUNK + 1], preload=True)
    compile_s = time.perf_counter() - t0
    res = vo.run_chunked(frames, preload=True)
    print(f"single stream: compile {compile_s:.2f} s (cold, bootstrap + one "
          f"chunk), warm {res.fps:.2f} frames/s over {res.n_frames - 1} "
          f"frames [{card}]", flush=True)
    health("single stream", res.poses, gt, res.metrics, res.kf_flags, card)


def fleet_phase(cfg, camera, frames, gt, n_streams, card):
    """Phase 2: BatchedStereoVO, odd streams reversed, refine every
    REFINE_EVERY chunks."""
    import jax
    import numpy as np

    from svo_tpu.parallel.batched import BatchedStereoVO

    def u8(x):
        return np.clip(x, 0, 255).astype(np.uint8)

    streams = [frames if s % 2 == 0 else frames[::-1] for s in range(n_streams)]
    l0 = np.stack([st[0][1] for st in streams])
    r0 = np.stack([st[0][2] for st in streams])
    n_chunks = (len(frames) - 1) // CHUNK
    chunks = []
    for c in range(n_chunks):
        ts = range(1 + c * CHUNK, 1 + (c + 1) * CHUNK)
        chunks.append((
            jax.device_put(np.stack([np.stack([u8(st[t][1]) for st in streams]) for t in ts])),
            jax.device_put(np.stack([np.stack([u8(st[t][2]) for st in streams]) for t in ts])),
        ))
    jax.block_until_ready(chunks)

    bvo = BatchedStereoVO(cfg, camera, n_streams, chunk=CHUNK, kf_cadence=CADENCE)
    bvo.make_refiner()
    t0 = time.perf_counter()
    bvo.start(l0, r0)
    bvo.process_chunk(*chunks[0])
    bvo.refine()
    jax.block_until_ready(bvo.state.pose)
    compile_s = time.perf_counter() - t0

    bvo.start(l0, r0)
    jax.block_until_ready(bvo.state.pose)
    t0 = time.perf_counter()
    for i, c in enumerate(chunks):
        bvo.process_chunk(*c)
        if (i + 1) % REFINE_EVERY == 0:
            bvo.refine()
    jax.block_until_ready(bvo.state.pose)
    wall = time.perf_counter() - t0
    n = 1 + n_chunks * CHUNK
    print(f"fleet: {n_streams} streams, compile {compile_s:.2f} s (cold, "
          f"bootstrap + chunk + refiner), warm "
          f"{n_streams * (n - 1) / wall:.2f} frames/s aggregate with refine "
          f"every {REFINE_EVERY} chunks [{card}]", flush=True)

    trajs = bvo.trajectories(n)
    metrics = np.asarray(bvo.state.metrics[:, :n])
    kf = np.asarray(bvo.state.kf_flags[:, :n])
    for s in range(n_streams):
        g = gt if s % 2 == 0 else gt[::-1]
        health(f"fleet stream {s} ({'fwd' if s % 2 == 0 else 'rev'})",
               trajs[s], g[:n], metrics[s], kf[s], card)

    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    print(f"fleet: peak_bytes_in_use {stats.get('peak_bytes_in_use')} "
          f"[{card}]", flush=True)
    ma = bvo._chunk_step.lower(bvo.state, *chunks[0]).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    print("fleet chunk step memory_analysis: "
          + ", ".join(f"{f} {getattr(ma, f, None)}" for f in fields)
          + f" [{card}]", flush=True)
    return bvo


def ba_phase(bvo, camera, card):
    """Phase 3: solve_ba on a window of the live fleet map."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from svo_tpu.ba.solver import solve_ba
    from svo_tpu.ba.window import extract_window

    st0 = jax.tree.map(lambda x: x[0], bvo.state)
    problem, _ = extract_window(
        st0.map, st0.poses, st0.frame_id, n_cams=10, n_points=1024, n_obs=4096)
    bfx = jnp.float32(camera.K[0, 0] * camera.baseline)
    ba_fn = jax.jit(lambda p: solve_ba(p, camera.K, bfx, iterations=BA_ITERS))
    res = jax.block_until_ready(ba_fn(problem))
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        res = ba_fn(problem)
    jax.block_until_ready(res.cost)
    rate = BA_ITERS * reps / (time.perf_counter() - t0)
    cost0, cost = float(res.cost0), float(res.cost)
    n_obs = int(np.asarray(problem.obs_valid).sum())
    print(f"BA: {n_obs} observations, cost {cost0:.3f} -> {cost:.3f} in "
          f"{BA_ITERS} LM iterations, {rate:.1f} LM iterations/s [{card}]",
          flush=True)
    check(n_obs > 0, "BA: empty window")
    check(np.isfinite(cost0) and np.isfinite(cost), "BA: non-finite cost")
    check(cost <= cost0, f"BA: cost rose {cost0} -> {cost}")


def rot_angle_deg(R) -> float:
    import numpy as np

    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def parity_phase(cfg, camera, frames, card):
    """Phase 4: the same computations on the CPU backend and the GPU."""
    import jax
    import numpy as np

    from svo_tpu.ops.klt import KltTracker
    from svo_tpu.pipeline import frontend

    cpu, gpu = jax.devices("cpu")[0], jax.devices()[0]
    _, l0, r0 = frames[0]
    _, l1, r1 = frames[1]
    L = cfg.temporal_klt.max_level

    pyr_fn = jax.jit(lambda img: KltTracker.build_pyramid(img, L))
    pyr = {d: pyr_fn(jax.device_put(np.asarray(l1, np.float32), d))
           for d in (cpu, gpu)}
    pyr_diff = max(
        float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        for a, b in zip(jax.tree.leaves(pyr[cpu]), jax.tree.leaves(pyr[gpu])))
    print(f"parity pyramid+Scharr (frame 1, {L + 1} levels): max |d| "
          f"{pyr_diff:.3e} (tolerance {PYR_TOL:.0e}) [{card}]", flush=True)
    check(pyr_diff <= PYR_TOL, "parity: pyramid")

    boot = frontend.make_bootstrap(camera, cfg)
    state = boot(jax.device_put(np.asarray(l0, np.float32), gpu),
                 jax.device_put(np.asarray(r0, np.float32), gpu), np.uint32(0))
    pos = np.asarray(state.features.pos)
    valid = np.asarray(state.features.valid)

    @jax.jit
    def track(l_prev, l_curr, p, v):
        return KltTracker.track(
            KltTracker.build_pyramid(l_prev, L),
            KltTracker.build_pyramid(l_curr, L), p, v, cfg.temporal_klt)

    out = {}
    for d in (cpu, gpu):
        res = track(*(jax.device_put(x, d) for x in (
            np.asarray(l0, np.float32), np.asarray(l1, np.float32), pos, valid)))
        out[d] = (np.asarray(res.pos), np.asarray(res.status))
    both = out[cpu][1] & out[gpu][1]
    agree = float(np.mean(out[cpu][1] == out[gpu][1]))
    d_px = np.linalg.norm(out[cpu][0][both] - out[gpu][0][both], axis=-1)
    med = float(np.median(d_px)) if both.any() else float("nan")
    print(f"parity KLT track (frame 0->1, {int(valid.sum())} features, "
          f"{int(both.sum())} tracked on both): median |d| {med:.3e} px "
          f"(tolerance {TRACK_MEDIAN_TOL_PX}), status agreement {agree:.4f} "
          f"(tolerance {TRACK_STATUS_AGREE}) [{card}]", flush=True)
    check(both.sum() > 0 and med <= TRACK_MEDIAN_TOL_PX, "parity: KLT positions")
    check(agree >= TRACK_STATUS_AGREE, "parity: KLT status")

    step = jax.jit(lambda st, l, r: frontend.step_body(st, l, r, camera, cfg))
    poses = {}
    for d in (cpu, gpu):
        st = jax.device_put(state, d)
        new = step(st, jax.device_put(np.asarray(l1, np.float32), d),
                   jax.device_put(np.asarray(r1, np.float32), d))
        poses[d] = np.asarray(new.pose, np.float64)
    dt = float(np.linalg.norm(poses[cpu][:3, 3] - poses[gpu][:3, 3]))
    dr = rot_angle_deg(poses[cpu][:3, :3].T @ poses[gpu][:3, :3])
    print(f"parity frame step pose (frame 1): |dt| {dt:.3e} m (tolerance "
          f"{POSE_TOL_M}), rotation {dr:.3e} deg (tolerance {POSE_TOL_DEG}) "
          f"[{card}]", flush=True)
    check(np.isfinite(dt) and dt <= POSE_TOL_M, "parity: pose translation")
    check(np.isfinite(dr) and dr <= POSE_TOL_DEG, "parity: pose rotation")


def global_map_problem(n_cams: int, n_pts: int, seed: int = 0):
    """A global-map BA problem of stereo observations: n_cams cameras
    driving forward, n_pts points ahead of them, every visible pair
    observed with 0.5 px noise; cameras and points perturbed."""
    import jax.numpy as jnp
    import numpy as np

    from svo_tpu.ba.solver import BAProblem

    rng = np.random.default_rng(seed)
    fx, cx, cy, b, W, H = FX, SHAPE[1] / 2, SHAPE[0] / 2, 0.54, SHAPE[1], SHAPE[0]
    T_cw = np.tile(np.eye(4), (n_cams, 1, 1))
    T_cw[:, 2, 3] = -1.0 * np.arange(n_cams)        # 1 m per camera along +z
    T_cw[:, 0, 3] = -0.05 * np.arange(n_cams)
    pts = np.stack([rng.uniform(-15, 15, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(n_cams + 5, n_cams + 40, n_pts)], -1)
    Xc = np.einsum("kij,pj->kpi", T_cw[:, :3, :3], pts) + T_cw[:, None, :3, 3]
    u = fx * Xc[..., 0] / Xc[..., 2] + cx
    v = fx * Xc[..., 1] / Xc[..., 2] + cy
    ur = u - fx * b / Xc[..., 2]
    vis = (Xc[..., 2] > 1) & (u > 0) & (u < W) & (v > 0) & (v < H) & (ur > 0)
    cam, pnt = np.nonzero(vis)
    n_obs = len(cam)
    noise = rng.normal(0, 0.5, (n_obs, 3))
    uv = np.stack([u[cam, pnt], v[cam, pnt], ur[cam, pnt]], -1) + noise
    O = 1 << int(np.ceil(np.log2(n_obs + 1)))
    pad = O - n_obs
    T_init = T_cw.copy()
    for k in range(1, n_cams):
        T_init[k, :3, 3] += rng.normal(0, 0.03, 3)
    problem = BAProblem(
        T_cw=jnp.asarray(T_init, jnp.float32),
        cam_valid=jnp.ones(n_cams, bool),
        points=jnp.asarray(pts + rng.normal(0, 0.1, pts.shape), jnp.float32),
        pnt_valid=jnp.ones(n_pts, bool),
        obs_cam=jnp.asarray(np.pad(cam, (0, pad)), jnp.int32),
        obs_pnt=jnp.asarray(np.pad(pnt, (0, pad)), jnp.int32),
        obs_uv=jnp.asarray(np.pad(uv, ((0, pad), (0, 0))), jnp.float32),
        obs_valid=jnp.asarray(np.arange(O) < n_obs),
    )
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)
    return problem, K, np.float32(fx * b), n_obs


def multi_phase(cfg, camera, frames, gt, devices, card, ba_cams, ba_pts):
    """The multi-card path: one stream per card (MultiStereoVO), BA sharded
    over the cards against single-card BA, and the sharded global refiner
    against the single-card one."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from svo_tpu.ba.solver import solve_ba
    from svo_tpu.parallel import ba as dist_ba
    from svo_tpu.parallel import global_opt
    from svo_tpu.parallel.multi_seq import MultiStereoVO

    n = len(devices)
    streams = [frames if s % 2 == 0 else frames[::-1] for s in range(n)]
    multi = MultiStereoVO(cfg, camera, n, devices=devices)
    t0 = time.perf_counter()
    multi.start(np.stack([st[0][1] for st in streams]),
                np.stack([st[0][2] for st in streams]))
    for t in range(1, len(frames)):
        multi.process(np.stack([st[t][1] for st in streams]),
                      np.stack([st[t][2] for st in streams]))
    jax.block_until_ready(multi.state.pose)
    wall = time.perf_counter() - t0
    F = len(frames)
    metrics = np.asarray(multi.state.metrics[:, :F])
    kf = np.asarray(multi.state.kf_flags[:, :F])
    trajs = multi.trajectories(F)
    print(f"multi: MultiStereoVO on {n} cards, {F} frames per stream in "
          f"{wall:.2f} s including compile; fleet health "
          f"{np.asarray(multi.fleet_health).round(3).tolist()} [{card}]",
          flush=True)
    for s in range(n):
        tracked = metrics[s, 1:, 0]
        print(f"multi card {s}: tracked features per frame min "
              f"{int(tracked.min())} mean {tracked.mean():.1f} [{card}]",
              flush=True)
        check(tracked.min() > 0, f"multi card {s}: no tracked features")
        g = gt if s % 2 == 0 else gt[::-1]
        health(f"multi stream {s} ({'fwd' if s % 2 == 0 else 'rev'})",
               trajs[s], g[:F], metrics[s], kf[s], card)

    # distributed BA on a global-map problem vs single-card solve_ba
    problem, K, bfx, n_obs = global_map_problem(ba_cams, ba_pts)
    with jax.default_device(devices[0]):
        single = jax.jit(lambda p: solve_ba(p, K, bfx, iterations=BA_ITERS))(problem)
        single = jax.block_until_ready(single)
    sharded = dist_ba.shard_problem(problem, n)
    check(int(jnp.sum(sharded.obs_valid)) == n_obs,
          "multi BA: observations dropped by the repartition")
    mesh = Mesh(np.array(devices), axis_names=(dist_ba.AXIS,))
    res = dist_ba.solve_ba_distributed(sharded, K, bfx, mesh, iterations=BA_ITERS)
    res = jax.block_until_ready(res)
    c_single, c_dist = float(single.cost), float(np.asarray(res.cost)[0])
    rel = abs(c_dist - c_single) / max(abs(c_single), 1e-12)
    cam_d = float(np.max(np.abs(np.asarray(res.T_cw)[0] - np.asarray(single.T_cw))))
    print(f"multi BA: {ba_cams} cameras, {ba_pts} points, {n_obs} "
          f"observations, {BA_ITERS} LM iterations: cost "
          f"{float(single.cost0):.1f} -> single card {c_single:.3f}, "
          f"{n} cards {c_dist:.3f}, relative |d| {rel:.2e} (tolerance "
          f"{MULTI_BA_COST_RTOL:.0e}), camera max |d| {cam_d:.2e} "
          f"(tolerance {MULTI_BA_CAM_TOL:.0e}) [{card}]", flush=True)
    check(np.isfinite(c_dist) and c_dist <= float(single.cost0),
          "multi BA: cost did not fall")
    check(rel <= MULTI_BA_COST_RTOL, "multi BA: cost differs from single card")
    check(cam_d <= MULTI_BA_CAM_TOL, "multi BA: cameras differ from single card")

    # sharded global refinement (one keyframe block per card) vs refine_global
    # host copy: refine_global_sharded mixes its inputs with arrays sharded
    # over the mesh, so they must not be committed to one card
    st0 = jax.tree.map(lambda x: np.asarray(x[0]), multi.state)
    bfx_cam = jnp.float32(camera.K[0, 0] * camera.baseline)
    kw = dict(cams_per_block=7, n_points=512, n_obs=2048,
              ba_iterations=12, pg_iterations=10)
    check(F >= global_opt.block_span(n, kw["cams_per_block"]),
          "multi refine: stream shorter than the refined span")
    ref1 = global_opt.refine_global(
        st0.map, st0.poses, st0.frame_id, camera.K, bfx_cam, n_blocks=n, **kw)
    refn = global_opt.refine_global_sharded(
        st0.map, st0.poses, st0.frame_id, camera.K, bfx_cam,
        Mesh(np.array(devices), axis_names=("ba_block",)), **kw)
    ref1, refn = jax.block_until_ready((ref1, refn))
    s1, sn = float(ref1.span_cost), float(refn.span_cost)
    if np.isfinite(s1):
        rel_r = abs(sn - s1) / max(abs(s1), 1e-12)
    else:
        rel_r = 0.0 if not np.isfinite(sn) else float("inf")
    pose_d = float(np.max(np.abs(np.asarray(ref1.poses[:F, :3, 3])
                                 - np.asarray(refn.poses[:F, :3, 3]))))
    print(f"multi refine: span cost {float(ref1.span_cost0):.3f} -> single "
          f"card {s1:.3f} (accepted {bool(ref1.accepted)}), {n} cards "
          f"{sn:.3f} (accepted {bool(refn.accepted)}), relative |d| "
          f"{rel_r:.2e} (tolerance {MULTI_REFINE_COST_RTOL:.0e}), pose max "
          f"|d| {pose_d:.2e} m (tolerance {MULTI_REFINE_POSE_TOL_M:.0e}) "
          f"[{card}]", flush=True)
    check(bool(ref1.accepted) == bool(refn.accepted),
          "multi refine: acceptance differs")
    check(rel_r <= MULTI_REFINE_COST_RTOL, "multi refine: span cost differs")
    check(pose_d <= MULTI_REFINE_POSE_TOL_M, "multi refine: poses differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", type=int, default=0, metavar="N",
                    help="run only the N-card path and its comparisons")
    args = ap.parse_args(argv)

    # The CPU backend is needed beside the GPU for the parity phase.
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devices = device_phase(max(args.multi, 1))
    card = card_name()
    sys.path.insert(0, REPO)
    import svo_tpu  # noqa: F401  (sets precision and the compile cache)
    from svo_tpu.io.synthetic import SyntheticSequence

    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}, devices {[d.device_kind for d in devices]}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)

    cfg = kitti_config(SHAPE)
    if args.multi:
        n_frames = 1 + 2 * CHUNK
        seq = SyntheticSequence(n_frames=n_frames, shape=SHAPE, fx=FX)
        t0 = time.perf_counter()
        frames = render(seq)
        print(f"rendered {n_frames} frames in {time.perf_counter() - t0:.1f} s",
              flush=True)
        multi_phase(cfg, camera_of(seq), frames, seq.gt_poses,
                    devices[: args.multi], card, ba_cams=16, ba_pts=32768)
    else:
        seq = SyntheticSequence(n_frames=N_FRAMES, shape=SHAPE, fx=FX)
        t0 = time.perf_counter()
        frames = render(seq)
        print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
              flush=True)
        camera = camera_of(seq)
        single_stream_phase(cfg, camera, frames, seq.gt_poses, card)
        bvo = fleet_phase(cfg, camera, frames, seq.gt_poses, STREAMS, card)
        ba_phase(bvo, camera, card)
        parity_phase(cfg, camera, frames, card)

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
