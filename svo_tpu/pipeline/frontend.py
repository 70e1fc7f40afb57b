"""The per-frame VO front-end as pure jitted functions.

Reimplements the reference's hot loop (Tracking::startStereo,
src/tracking.cpp:232-276) as ONE fused device step per frame:

    track (KLT prev->curr)            src/tracking.cpp:154-179
    -> pose (RANSAC-PnP + outliers)   src/tracking.cpp:181-230
    -> keyframe? replenish:           src/tracking.cpp:247-255
         detect (masked)              src/tracking.cpp:74-92
         stereo match (KLT + y-gate)  src/tracking.cpp:94-118
         triangulate + allocate       src/tracking.cpp:120-152
         merge feature sets           src/frame.cpp:29-35

The keyframe decision itself (frame 0, or previous frame not a KF with fewer
than features_to_track live features — src/tracking.cpp:69-71) is computed on
device, so the host never blocks on a scalar: the whole loop is
state -> state with images streaming in.
"""

from __future__ import annotations

import dataclasses

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from svo_tpu.config import Config
from svo_tpu.geometry import se3
from svo_tpu.geometry.camera import Camera, project as camera_project
from svo_tpu.geometry.pnp import ransac_pnp
from svo_tpu.geometry.triangulate import triangulate_dlt, triangulate_rectified
from svo_tpu.ops import detect as detect_mod
from svo_tpu.ops.klt import KltTracker
from svo_tpu.pipeline.state import FeatureSet, MapState, VoState


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _alloc_points(
    mp: MapState, Xw: jnp.ndarray, valid: jnp.ndarray
) -> tuple[jnp.ndarray, MapState]:
    """Allocate map-point slots for valid rows of Xw (monotone cursor,
    Map::createMapPoint semantics, reference src/map.cpp:73-77).
    Returns per-row point ids (-1 where invalid)."""
    M = mp.points.shape[0]
    v = valid.astype(jnp.int32)
    offsets = jnp.cumsum(v) - v  # rank among valid rows
    ids = jnp.where(valid, mp.n_points + offsets, -1)
    ids = jnp.where(ids < M, ids, -1)  # capacity guard
    scatter_idx = jnp.where(ids >= 0, ids, M)  # M = out-of-bounds -> dropped
    points = mp.points.at[scatter_idx].set(Xw, mode="drop")
    n_new = jnp.sum((ids >= 0).astype(jnp.int32))
    return ids, mp._replace(points=points, n_points=mp.n_points + n_new)


def _record_obs(
    mp: MapState,
    uv: jnp.ndarray,
    pid: jnp.ndarray,
    valid: jnp.ndarray,
    frame_id: jnp.ndarray,
    u_right: jnp.ndarray | None = None,
) -> MapState:
    """Append (frame, point, uv[, u_right]) rows to the observation ring (COO
    storage for windowed BA — the reference kept observations in per-point
    hash maps, include/map_point.h:17-19). u_right < 0 marks a mono
    observation; stereo rows pin the BA scale gauge."""
    O = mp.obs_u.shape[0]
    v = valid.astype(jnp.int32)
    offs = jnp.cumsum(v) - v
    slots = jnp.where(valid, (mp.obs_cursor + offs) % O, O)  # O -> dropped
    if u_right is None:
        u_right = jnp.full(pid.shape, -1.0, jnp.float32)
    return mp._replace(
        obs_u=mp.obs_u.at[slots].set(uv[:, 0], mode="drop"),
        obs_v=mp.obs_v.at[slots].set(uv[:, 1], mode="drop"),
        obs_ur=mp.obs_ur.at[slots].set(u_right, mode="drop"),
        obs_pid=mp.obs_pid.at[slots].set(pid, mode="drop"),
        obs_fid=mp.obs_fid.at[slots].set(
            jnp.broadcast_to(frame_id, pid.shape), mode="drop"
        ),
        obs_cursor=mp.obs_cursor + jnp.sum(v),
    )


def _merge_features(
    feats: FeatureSet,
    new_pos: jnp.ndarray,
    new_pid: jnp.ndarray,
    new_score: jnp.ndarray,
    new_valid: jnp.ndarray,
) -> FeatureSet:
    """Merge tracked survivors with fresh detections into the fixed N slots
    (StereoFrame::insertFeatures, reference src/frame.cpp:29-35). Tracked
    features always win a slot; leftovers go to the best-scoring detections."""
    N = feats.pos.shape[0]
    key_tracked = jnp.where(feats.valid, 2e9 + feats.age.astype(jnp.float32), -1.0)
    key_new = jnp.where(new_valid, jnp.maximum(new_score, 0.0), -1.0)
    keys = jnp.concatenate([key_tracked, key_new])
    _, idx = jax.lax.top_k(keys, N)

    pos = jnp.concatenate([feats.pos, new_pos])[idx]
    pid = jnp.concatenate([feats.point_id, new_pid])[idx]
    age = jnp.concatenate([feats.age, jnp.zeros_like(new_pid)])[idx]
    anchor = jnp.concatenate([feats.anchor, new_pos])[idx]
    valid = keys[idx] >= 0.0
    return FeatureSet(pos=pos, valid=valid, point_id=pid, age=age,
                      anchor=anchor)


# --------------------------------------------------------------------------
# replenishment: detect + stereo match + triangulate (the extractFeatures /
# triangulateNewMapPoints pair, reference src/tracking.cpp:74-152)
# --------------------------------------------------------------------------

def _replenish(
    feats: FeatureSet,
    mp: MapState,
    left: jnp.ndarray,
    pyr_l,
    right: jnp.ndarray,
    pose: jnp.ndarray,
    frame_id: jnp.ndarray,
    camera: Camera,
    cfg: Config,
) -> tuple[FeatureSet, MapState]:
    # 1. detect with suppression around current live features
    det_pos, det_score, det_valid = detect_mod.detect(left, feats.pos, feats.valid, cfg)

    # 2. stereo match left->right with KLT + vertical-disparity gate
    #    (reference: src/tracking.cpp:94-118)
    pyr_r = KltTracker.build_pyramid(right, cfg.stereo_klt.max_level)
    sres = KltTracker.track(pyr_l, pyr_r, det_pos, det_valid, cfg.stereo_klt)
    y_ok = jnp.abs(sres.pos[:, 1] - det_pos[:, 1]) < cfg.tracking.y_threshold
    s_valid = det_valid & sres.status & y_ok

    # 3. triangulate, cheirality z > 0, to world via current pose
    #    (reference: src/tracking.cpp:120-152)
    if cfg.triangulator == "rectified":
        Xc = triangulate_rectified(
            camera.fx, camera.baseline, det_pos, sres.pos, camera.K
        )
    else:
        Xc = triangulate_dlt(camera.P_left, camera.P_right, det_pos, sres.pos)
    new_valid = s_valid & (Xc[:, 2] > 0)
    if cfg.tracking.max_depth_baselines > 0:
        new_valid = new_valid & (
            Xc[:, 2] < cfg.tracking.max_depth_baselines * camera.baseline
        )
    Xw = se3.transform(pose, Xc)

    # 4. allocate map points + record the triangulating observation
    #    (stereo: keep the right-image u the reference threw away,
    #    src/tracking.cpp:150-151 / TODO at :146)
    ids, mp = _alloc_points(mp, Xw, new_valid)
    new_valid = new_valid & (ids >= 0)
    u_right = jnp.where(sres.status, sres.pos[:, 0], -1.0)
    mp = _record_obs(mp, det_pos, ids, new_valid, frame_id, u_right=u_right)

    # 5. merge into the frame's feature table. Surviving tracked features
    #    RE-ANCHOR at this keyframe (their template generation rolls over —
    #    see TrackingParams.anchored_klt; harmless when anchoring is off).
    #    New detections compete by SELECTION ORDER, not raw score: the
    #    detector's output is spatially spread (ops/select.py round-robin +
    #    golden-ratio order), and with ~N tracked survivors only a short
    #    prefix of detections wins slots — ranking that prefix by score
    #    would re-concentrate it on the highest-contrast region (round-4
    #    multi-world failure: aliased far wall starving the near ground).
    feats = feats._replace(anchor=feats.pos)
    det_prio = jnp.arange(
        det_pos.shape[0], 0, -1, dtype=jnp.float32
    )
    feats = _merge_features(feats, det_pos, ids, det_prio, new_valid)
    return feats, mp


# --------------------------------------------------------------------------
# per-frame step
# --------------------------------------------------------------------------

def step_body(
    state: VoState,
    left: jnp.ndarray,
    right: jnp.ndarray,
    camera: Camera,
    cfg: Config,
    kf_mode: str = "dynamic",
) -> VoState:
    """One full frame step (pure, un-jitted): track -> PnP -> replenish.

    kf_mode selects the keyframe policy STATICALLY (trace-time):
    - "dynamic": the reference's data-dependent rule (frame 0, or previous
      frame not a KF with too few features — src/tracking.cpp:69-71) plus the
      eager max-interval trigger, as a lax.cond on device. Under vmap the
      cond lowers to both-branches+select, so every stream pays the full
      replenish (dense detect + stereo KLT + triangulation) every frame —
      which is why the throughput paths use the static modes instead.
    - "never": track-only step; the replenish code is not even traced.
    - "always": unconditional replenish (a statically scheduled keyframe).

    The cadenced chunk step (make_cadenced_chunk_step) composes "always" and
    "never" steps on a fixed keyframe cadence, turning the data-dependent
    branch into program structure.
    """
    assert kf_mode in ("dynamic", "never", "always")
    fid = state.frame_id + 1

    # keyframe policy (reference: src/tracking.cpp:69-71) — evaluated on
    # the PREVIOUS frame's state, exactly like nextFrame() does — plus an
    # eager max-interval trigger (see TrackingParams.kf_max_interval).
    if kf_mode == "dynamic":
        cnt_prev = state.features.count()
        is_kf = (~state.prev_is_kf) & (cnt_prev < cfg.tracking.features_to_track)
        if cfg.tracking.kf_max_interval > 0:
            is_kf = is_kf | (
                (~state.prev_is_kf)
                & (fid - state.last_kf_id >= cfg.tracking.kf_max_interval)
            )
    else:
        is_kf = jnp.asarray(kf_mode == "always", dtype=bool)
    last_kf_id = jnp.where(is_kf, fid, state.last_kf_id)

    pyr_l = KltTracker.build_pyramid(left, cfg.temporal_klt.max_level)

    # --- temporal tracking (reference: src/tracking.cpp:154-179) ---
    # Anchored mode (TrackingParams.anchored_klt): state.prev_pyramid holds
    # the ANCHOR KEYFRAME's pyramid and each feature tracks from its anchor
    # position with the accumulated flow as the seed — the tracker's
    # constant measurement bias enters once per keyframe generation instead
    # of once per frame. Chained mode (the reference's structure): template
    # is the previous frame, flow seeds from zero/prior.
    anchored = cfg.tracking.anchored_klt
    track_src = state.features.anchor if anchored else state.features.pos
    base_flow = (
        state.features.pos - state.features.anchor if anchored else None
    )

    # Constant-velocity prior: predict this frame's pose from the stored
    # relative motion (which the reference computes at tracking.cpp:215 and
    # never uses) and seed the KLT flow with the predicted reprojection
    # displacement — fewer LK iterations and longer-lived tracks.
    if cfg.motion_prior:
        # The prior is only trustworthy while PnP has been healthy: a failed
        # pose would otherwise seed every feature into the wrong basin and
        # lock the pipeline into a divergence loop. prior_ok gates both the
        # flow seeding and the pose extrapolation.
        prior_ok = state.prior_ok
        rel = jnp.where(prior_ok, state.rel_motion, jnp.eye(4, dtype=state.pose.dtype))
        T_wc_pred = se3.compose(rel, state.pose)
        T_cw_pred = se3.inverse(T_wc_pred)
        if cfg.flow_seeding:
            # Seeding KLT with the predicted reprojection displacement closes
            # a positive feedback loop (prior -> seeded tracks -> PnP
            # consensus -> prior) on weak texture: tracks that converge at
            # their seed confirm whatever the prior predicted, and the pose
            # error compounds exponentially. Off by default — the prior
            # still enters as a PnP hypothesis below, where it is verified
            # against independently tracked features instead of steering
            # them.
            Xw_prior = state.map.points[jnp.clip(state.features.point_id, 0)]
            uv_pred = camera_project(camera.K, se3.transform(T_cw_pred, Xw_prior))
            delta = uv_pred - state.features.pos
            flow_ok = (
                state.features.valid
                & prior_ok
                & jnp.all(jnp.isfinite(delta), axis=-1)
                & (jnp.sum(delta * delta, axis=-1) < 200.0**2)
            )
            seeded = uv_pred - track_src
            fallback = base_flow if base_flow is not None else jnp.zeros_like(seeded)
            init_flow = jnp.where(flow_ok[:, None], seeded, fallback)
        else:
            init_flow = base_flow
    else:
        T_wc_pred = state.pose
        T_cw_pred = se3.inverse(state.pose)
        init_flow = base_flow

    tres = KltTracker.track(
        state.prev_pyramid, pyr_l, track_src, state.features.valid,
        cfg.temporal_klt, init_flow=init_flow,
    )
    t_status = state.features.valid & tres.status
    if cfg.tracking.fb_check:
        # Forward-backward verification: track curr->prev seeded with the
        # reverse flow and require the round trip to land within
        # fb_threshold px of the start. Kills drifted/dragged tracks (which
        # would otherwise form a self-confirming consensus with the pose).
        # The backward pass starts from an exact seed, so level 0 with a
        # small iteration budget suffices (~1/8 the forward cost).
        fb_params = dataclasses.replace(cfg.temporal_klt, max_level=0, max_iters=8)
        bres = KltTracker.track(
            pyr_l, state.prev_pyramid, tres.pos, t_status,
            fb_params, init_flow=track_src - tres.pos,
        )
        fb_err2 = jnp.sum((bres.pos - track_src) ** 2, axis=-1)
        t_status = t_status & bres.status & (
            fb_err2 < cfg.tracking.fb_threshold ** 2
        )
    tracked = FeatureSet(
        pos=tres.pos,
        valid=t_status,
        point_id=state.features.point_id,
        age=state.features.age + 1,
        anchor=state.features.anchor,
    )
    n_tracked = tracked.count()

    # --- pose (reference: src/tracking.cpp:181-230) ---
    Xw = state.map.points[jnp.clip(tracked.point_id, 0)]
    rng, sub = jax.random.split(state.rng)
    # The PREVIOUS pose enters as an LO-refinement START, judged by final
    # refined consensus (geometry/pnp.py) — this rescues fast rotation
    # where every minimal hypothesis is degenerate (quasi-planar far
    # points) because masked GN converges from tens of px of reprojection
    # error. The constant-velocity EXTRAPOLATION is deliberately NOT a
    # start: even consensus-judged it compounds (each frame's refined
    # prediction revalidates the previous frame's error and the scale
    # error grows ~40% over 600 frames, re-measured round 4); the previous
    # pose contracts error instead.
    pres = ransac_pnp(
        camera.K, Xw, tracked.pos, tracked.valid, sub, cfg.ransac,
        T_init=se3.inverse(state.pose),
    )
    pnp_ok = pres.ok
    if cfg.tracking.max_step_rot_deg > 0:
        # Motion-sanity gate (TrackingParams.max_step_rot_deg): a WEAK
        # consensus must agree with the constant-velocity prediction.
        # On aliased near-textureless stretches (box-fine-fast) a handful
        # of coherently mistracked features votes in physically impossible
        # single-frame rotations OR a false zero-motion lock (repeating
        # texture -> KLT locks each feature one block off / in place ->
        # high-consensus "camera stopped" while moving 0.6 m/frame); both
        # poison the trajectory far beyond the blackout itself. Solutions
        # with strong support (>= sane_min_inliers AND ratio >= 0.5) are
        # always accepted — a genuine stop in a textured scene keeps its
        # abundant inliers.
        rel_step = se3.compose(pres.T_wc, se3.inverse(state.pose))
        rel_pred = jnp.where(
            state.prior_ok, state.rel_motion,
            jnp.eye(4, dtype=state.pose.dtype),
        )
        cos_a = jnp.clip(
            (rel_step[0, 0] + rel_step[1, 1] + rel_step[2, 2] - 1.0) * 0.5,
            -1.0, 1.0,
        )
        step_deg = jnp.degrees(jnp.arccos(cos_a))
        # false-lock signature: near-zero claimed motion while the healthy
        # prediction says we are moving
        not_locked = jnp.linalg.norm(rel_step[:3, 3]) >= 0.3 * jnp.linalg.norm(
            rel_pred[:3, 3]
        )
        n_inl = jnp.sum(pres.inliers.astype(jnp.int32))
        strong = (n_inl >= cfg.tracking.sane_min_inliers) & (
            pres.inlier_ratio >= 0.5
        )
        sane = (step_deg <= cfg.tracking.max_step_rot_deg) & not_locked
        pnp_ok = pnp_ok & (sane | strong)
    pose = jnp.where(pnp_ok, pres.T_wc, T_wc_pred)
    # hard guard: never let a non-finite pose poison the recursive state
    pose = jnp.where(jnp.all(jnp.isfinite(pose)), pose, state.pose)
    rel_motion = se3.compose(pose, se3.inverse(state.pose))
    rel_motion = jnp.where(
        jnp.all(jnp.isfinite(rel_motion)), rel_motion, jnp.eye(4, dtype=pose.dtype)
    )
    pnp_healthy = pnp_ok & (pres.inlier_ratio > 0.5)

    # Purge features whose map point has gone geometrically stale under the
    # new pose (behind the camera / out of view): such points carry amplified
    # triangulation depth error and would bias the next PnP consensus. The
    # reference self-heals only because its tracker loses features faster.
    Xc_now = se3.transform(se3.inverse(pose), Xw)
    uv_now = camera_project(camera.K, Xc_now)
    Hh, Ww = cfg.image_height, cfg.image_width
    geom_ok = (
        (Xc_now[:, 2] > 0.5)
        & (uv_now[:, 0] >= -20)
        & (uv_now[:, 0] < Ww + 20)
        & (uv_now[:, 1] >= -20)
        & (uv_now[:, 1] < Hh + 20)
    )
    if cfg.tracking.max_track_age > 0:
        # Retire old tracks (see TrackingParams.max_track_age): under
        # receding motion features never exit the FOV, so chained-KLT drift
        # and stale triangulations otherwise accumulate without bound.
        # strict < : with the cap a multiple of the keyframe cadence, a
        # keyframe-born track dies exactly IN a keyframe step (post-PnP,
        # pre-replenish), so its slot refills with a fresh detection in the
        # same step instead of idling through a track-only cadence group.
        geom_ok = geom_ok & (tracked.age < cfg.tracking.max_track_age)
    # Outlier purge (reference: src/tracking.cpp:218-229) — but ONLY from an
    # ACCEPTED solve. A failed PnP's inlier mask is near-empty; purging with
    # it wiped every live track and locked the pipeline into a
    # dead-reckoning death spiral until the next keyframe (round-4
    # box-turns collapse, scripts/probe_pnp_turn.py). On failure the tracked
    # set survives intact so the next frame can try again.
    inl_keep = jnp.where(pnp_ok, pres.inliers, tracked.valid)
    feats = tracked._replace(valid=tracked.valid & inl_keep & geom_ok)

    # record tracking observations for BA
    mp = _record_obs(state.map, feats.pos, feats.point_id, feats.valid, fid)

    # --- keyframe replenishment (reference: src/tracking.cpp:247-255) ---
    if kf_mode == "always":
        feats, mp = _replenish(feats, mp, left, pyr_l, right, pose, fid, camera, cfg)
    elif kf_mode == "dynamic":
        def kf_branch(op):
            f, m = op
            return _replenish(f, m, left, pyr_l, right, pose, fid, camera, cfg)

        feats, mp = jax.lax.cond(is_kf, kf_branch, lambda op: op, (feats, mp))
    # kf_mode == "never": no replenish code in the trace at all

    # --- sliding-window bundle adjustment (the reference's empty back-end
    #     thread, src/map.cpp:84-88, realized) ---
    # The window is KEYFRAME-unit (SURVEY.md §6: the back-end is
    # keyframe-centric, like the reference's keyframe-keyed map,
    # include/map.h:46-48): cameras are the last cfg.ba.window keyframes and
    # BA triggers every cfg.ba.interval keyframes. Non-keyframe poses in the
    # span ride their preceding keyframe's rigid correction (write_back_kf).
    # Track-only steps (kf_mode="never") carry no BA code at all — a
    # keyframe-triggered solve can never fire there.
    poses = state.poses.at[fid].set(pose)
    kf_flags = state.kf_flags.at[fid].set(is_kf)
    if cfg.ba.enabled and kf_mode != "never":
        from svo_tpu.ba.solver import solve_ba
        from svo_tpu.ba.window import extract_kf_window, write_back_kf

        def ba_branch(op):
            mp_in, poses_in = op
            problem, mapping = extract_kf_window(
                mp_in, poses_in, kf_flags, fid,
                n_cams=cfg.ba.window,
                n_points=cfg.ba.max_points,
                n_obs=cfg.ba.max_obs,
            )
            res = solve_ba(
                problem,
                camera.K,
                camera.K[0, 0] * camera.baseline,
                iterations=cfg.ba.iterations,
                n_fixed=cfg.ba.n_fixed,
                huber_delta=cfg.ba.huber_delta,
                reject_threshold=cfg.ba.reject_threshold,
                init_lambda=cfg.ba.init_lambda,
            )
            improved = res.cost <= res.cost0
            T_cw_new = jnp.where(improved, res.T_cw, problem.T_cw)
            pts_new = jnp.where(improved, res.points, problem.points)
            mp_out, poses_out = write_back_kf(
                mp_in, poses_in, mapping, fid, T_cw_new, pts_new,
                problem.pnt_valid, problem.cam_valid,
            )
            return mp_out, poses_out

        kf_count = jnp.sum(kf_flags.astype(jnp.int32))
        run_ba = (
            is_kf
            & (kf_count >= cfg.ba.window)
            & (kf_count % cfg.ba.interval == 0)
        )
        mp, poses = jax.lax.cond(run_ba, ba_branch, lambda op: op, (mp, poses))
        pose = poses[fid]

    metrics_row = jnp.stack(
        [
            n_tracked.astype(jnp.float32),
            pres.inlier_ratio,
            feats.count().astype(jnp.float32),
            is_kf.astype(jnp.float32),
            mp.n_points.astype(jnp.float32),
        ]
    )
    # anchored mode keeps the KEYFRAME pyramid as the template source;
    # chained mode carries the current frame's pyramid as before
    if not anchored or kf_mode == "always":
        out_pyr = pyr_l
    elif kf_mode == "never":
        out_pyr = state.prev_pyramid
    else:
        out_pyr = jax.tree.map(
            lambda a, b: jnp.where(is_kf, a, b), pyr_l, state.prev_pyramid
        )
    return VoState(
        features=feats,
        map=mp,
        prev_pyramid=out_pyr,
        frame_id=fid,
        prev_is_kf=is_kf,
        last_kf_id=last_kf_id,
        pose=pose,
        rel_motion=rel_motion,
        prior_ok=pnp_healthy,
        poses=poses,
        kf_flags=kf_flags,
        metrics=state.metrics.at[fid].set(metrics_row),
        rng=rng,
    )




def make_step(camera: Camera, cfg: Config):
    """Jitted single-frame step: (VoState, left f32, right f32) -> VoState,
    donating the state (device buffers update in place)."""

    @partial(jax.jit, donate_argnums=(0,))
    def step(state: VoState, left: jnp.ndarray, right: jnp.ndarray) -> VoState:
        return step_body(state, left, right, camera, cfg)

    return step


def make_chunked_step(camera: Camera, cfg: Config, chunk: int):
    """Jitted multi-frame step: lax.scan of the frame step over a chunk of
    `chunk` stereo pairs shipped as uint8 (4x less host->device traffic),
    amortizing per-dispatch latency (SURVEY.md §7 hard-part #4: sequential
    frame dependency vs device throughput).

    Uses the dynamic (data-dependent) keyframe rule; prefer
    make_cadenced_chunk_step for throughput (the lax.cond in the scan body
    keeps the replenish program resident even on non-KF frames, and under
    vmap executes it for every stream every frame)."""

    @partial(jax.jit, donate_argnums=(0,))
    def run_chunk(
        state: VoState, lefts_u8: jnp.ndarray, rights_u8: jnp.ndarray
    ) -> VoState:
        def body(st, lr):
            l, r = lr
            return (
                step_body(
                    st, l.astype(jnp.float32), r.astype(jnp.float32), camera, cfg
                ),
                None,
            )

        state, _ = jax.lax.scan(body, state, (lefts_u8, rights_u8))
        return state

    return run_chunk


def make_cadenced_chunk_step(
    camera: Camera, cfg: Config, chunk: int, cadence: int, n_streams: int = 0
):
    """Jitted multi-frame step with a STATIC keyframe cadence.

    The reference's keyframe rule is data-dependent (src/tracking.cpp:69-71),
    which on device forces a lax.cond around the replenish stage — and under
    vmap (multi-stream batching) a cond lowers to both-branches + select, so
    every stream pays dense detection + stereo KLT + triangulation on EVERY
    frame. This builder instead fixes the keyframe schedule at trace time:
    each group of `cadence` frames starts with one unconditional-replenish
    step (kf_mode="always") followed by cadence-1 track-only steps
    (kf_mode="never" — the replenish code is absent from their program).
    The data-dependent branch becomes program structure; with the default
    cadence equal to TrackingParams.kf_max_interval the schedule matches the
    eager-keyframing behavior the dynamic rule converges to anyway.

    Args:
        chunk: frames per dispatch; must be a multiple of cadence.
        cadence: keyframe every `cadence` frames (>= 1).
        n_streams: 0 for a single stream ((K,H,W) inputs); S > 0 vmaps the
            step over S independent streams ((K,S,H,W) frame-major inputs).
    Returns:
        jitted (state, lefts_u8, rights_u8) -> state with state donated.
    """
    assert cadence >= 1
    assert chunk % cadence == 0, f"chunk {chunk} not a multiple of cadence {cadence}"
    groups = chunk // cadence

    def kf_step(st, l, r):
        return step_body(
            st, l.astype(jnp.float32), r.astype(jnp.float32), camera, cfg,
            kf_mode="always",
        )

    def track_step(st, l, r):
        return step_body(
            st, l.astype(jnp.float32), r.astype(jnp.float32), camera, cfg,
            kf_mode="never",
        )

    if n_streams:
        kf_step = jax.vmap(kf_step)
        track_step = jax.vmap(track_step)

    @partial(jax.jit, donate_argnums=(0,))
    def run_chunk(
        state: VoState, lefts_u8: jnp.ndarray, rights_u8: jnp.ndarray
    ) -> VoState:
        def tbody(s, xy):
            return track_step(s, xy[0], xy[1]), None

        # Outer lax.scan over cadence groups: the program size is O(1) in
        # chunk/cadence.
        lg = lefts_u8.reshape((groups, cadence) + lefts_u8.shape[1:])
        rg = rights_u8.reshape((groups, cadence) + rights_u8.shape[1:])

        def group_body(s, xy):
            gl, gr = xy
            s = kf_step(s, gl[0], gr[0])
            if cadence > 1:
                s, _ = jax.lax.scan(tbody, s, (gl[1:], gr[1:]))
            return s, None

        state, _ = jax.lax.scan(group_body, state, (lg, rg))
        return state

    return run_chunk


def make_bootstrap(camera: Camera, cfg: Config):
    """Build the jitted bootstrap: frame 0 is always a keyframe — detect,
    stereo-match, triangulate at identity pose (reference:
    src/tracking.cpp:233-235)."""

    @jax.jit
    def bootstrap(left: jnp.ndarray, right: jnp.ndarray, seed: jnp.ndarray) -> VoState:
        N = cfg.capacity.max_features
        F = cfg.capacity.max_frames
        pyr_l = KltTracker.build_pyramid(left, cfg.temporal_klt.max_level)
        pose0 = se3.identity()
        feats, mp = _replenish(
            FeatureSet.empty(N),
            MapState.empty(cfg),
            left,
            pyr_l,
            right,
            pose0,
            jnp.zeros((), jnp.int32),
            camera,
            cfg,
        )
        metrics0 = jnp.zeros((F, 5), jnp.float32)
        metrics0 = metrics0.at[0].set(
            jnp.stack(
                [
                    jnp.float32(0),
                    jnp.float32(0),
                    feats.count().astype(jnp.float32),
                    jnp.float32(1),
                    mp.n_points.astype(jnp.float32),
                ]
            )
        )
        return VoState(
            features=feats,
            map=mp,
            prev_pyramid=pyr_l,
            frame_id=jnp.zeros((), jnp.int32),
            prev_is_kf=jnp.ones((), bool),
            last_kf_id=jnp.zeros((), jnp.int32),
            pose=pose0,
            rel_motion=jnp.eye(4, dtype=jnp.float32),
            prior_ok=jnp.zeros((), bool),
            poses=jnp.tile(jnp.eye(4, dtype=jnp.float32), (F, 1, 1)),
            kf_flags=jnp.zeros((F,), bool).at[0].set(True),
            metrics=metrics0,
            rng=jax.random.PRNGKey(seed),
        )

    return bootstrap
