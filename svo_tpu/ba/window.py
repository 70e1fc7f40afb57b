"""Sliding-window problem extraction from the live map state, and write-back.

Builds a fixed-shape BAProblem from the device-resident observation ring
(MapState.obs_*) for the frame window [frame_hi - K + 1, frame_hi]:

- observation rows are selected by frame id (the ring's overwrite semantics
  make old rows drop out naturally),
- global point ids are remapped to dense window slots with a sort +
  first-occurrence cumsum (a static-shape 'unique'),
- after solve_ba, updated points scatter back into the global map and updated
  poses into the trajectory.

Everything is jittable with static capacities; all variable counts are masks
(SURVEY.md §7 design stance).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from svo_tpu.ba.solver import BAProblem
from svo_tpu.geometry import se3
from svo_tpu.pipeline.state import MapState

_BIG = jnp.int32(2**30)


class WindowMapping(NamedTuple):
    slot_to_pid: jnp.ndarray   # (P,) global point id per window slot (-1 empty)
    frame_lo: jnp.ndarray      # first frame id in the window


class KfWindowMapping(NamedTuple):
    slot_to_pid: jnp.ndarray   # (P,) global point id per window slot (-1 empty)
    cam_fids: jnp.ndarray      # (K,) frame id of each camera slot (-1 empty),
    #                            ascending with the padding slots FIRST


def _compact_and_remap(mp: MapState, sel, row_cam, n_points: int, n_obs: int):
    """Shared core of the window extractors: compact the selected observation
    ring rows into n_obs slots, remap global point ids to dense window slots,
    gate under-constrained points, and gather their world positions.

    Args:
        sel: (O_ring,) bool — ring rows that belong to the window.
        row_cam: (O_ring,) i32 — camera slot of each ring row (only read
            where sel).
    Returns:
        (obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points)
    """
    # --- compact selected rows into n_obs slots ---
    sel_i = sel.astype(jnp.int32)
    rank = jnp.cumsum(sel_i) - sel_i
    row_slot = jnp.where(sel & (rank < n_obs), rank, n_obs)  # n_obs -> dropped

    O = n_obs
    obs_cam = jnp.full((O,), -1, jnp.int32).at[row_slot].set(row_cam, mode="drop")
    obs_pid_g = jnp.full((O,), -1, jnp.int32).at[row_slot].set(mp.obs_pid, mode="drop")
    # assemble the (O,3) problem-side obs_uv from the three 1-D rings
    # (MapState stores them separately for scatter-layout stability)
    obs_uv = jnp.stack(
        [
            jnp.zeros((O,), jnp.float32).at[row_slot].set(mp.obs_u, mode="drop"),
            jnp.zeros((O,), jnp.float32).at[row_slot].set(mp.obs_v, mode="drop"),
            jnp.full((O,), -1.0, jnp.float32).at[row_slot].set(
                mp.obs_ur, mode="drop"
            ),
        ],
        axis=-1,
    )
    obs_ok = obs_cam >= 0

    # --- remap global pids to dense window slots (sorted first-occurrence) ---
    pids_for_sort = jnp.where(obs_ok, obs_pid_g, _BIG)
    order = jnp.argsort(pids_for_sort)
    sorted_pids = pids_for_sort[order]
    prev = jnp.concatenate([jnp.full((1,), -2, jnp.int32), sorted_pids[:-1]])
    first = (sorted_pids != prev) & (sorted_pids < _BIG)
    slot_sorted = jnp.cumsum(first.astype(jnp.int32)) - 1  # slot of each sorted row
    slot_sorted = jnp.where(sorted_pids < _BIG, slot_sorted, n_points)

    # scatter back to original observation order
    obs_pnt = jnp.zeros((O,), jnp.int32).at[order].set(
        jnp.minimum(slot_sorted, n_points).astype(jnp.int32)
    )
    obs_ok = obs_ok & (obs_pnt < n_points)

    # window slot -> global pid table
    slot_to_pid = jnp.full((n_points,), -1, jnp.int32).at[
        jnp.where(first, slot_sorted, n_points)
    ].set(sorted_pids, mode="drop")

    # --- gather window points and cameras ---
    # A point needs >=2 observations in the window (or one stereo row, which
    # constrains depth by itself) to be well-posed; under-constrained points
    # would absorb damped-but-arbitrary updates and corrupt the global map on
    # write-back.
    obs_per_slot = jnp.zeros((n_points + 1,), jnp.int32).at[
        jnp.minimum(obs_pnt, n_points)
    ].add(obs_ok.astype(jnp.int32))[:n_points]
    stereo_per_slot = jnp.zeros((n_points + 1,), jnp.int32).at[
        jnp.minimum(obs_pnt, n_points)
    ].add((obs_ok & (obs_uv[:, 2] >= 0)).astype(jnp.int32))[:n_points]
    constrained = (obs_per_slot >= 2) | (stereo_per_slot >= 1)
    pnt_valid = (slot_to_pid >= 0) & constrained
    points = mp.points[jnp.clip(slot_to_pid, 0)] * pnt_valid[:, None]
    return obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points


@partial(jax.jit, static_argnames=("n_cams", "n_points", "n_obs"))
def extract_window(
    mp: MapState,
    poses_wc: jnp.ndarray,
    frame_hi: jnp.ndarray,
    n_cams: int,
    n_points: int,
    n_obs: int,
) -> tuple[BAProblem, WindowMapping]:
    """Build the BA problem for the FRAME window ending at frame_hi
    (inclusive): cameras are the n_cams consecutive frames up to frame_hi."""
    frame_lo = jnp.maximum(frame_hi - (n_cams - 1), 0)
    sel = (mp.obs_fid >= frame_lo) & (mp.obs_fid <= frame_hi) & (mp.obs_pid >= 0)
    row_cam = jnp.clip(mp.obs_fid - frame_lo, 0, n_cams - 1)

    obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points = (
        _compact_and_remap(mp, sel, row_cam, n_points, n_obs)
    )

    cam_ids = frame_lo + jnp.arange(n_cams)
    T_wc = poses_wc[jnp.clip(cam_ids, 0, poses_wc.shape[0] - 1)]
    T_cw = se3.inverse(T_wc)
    cam_valid = cam_ids <= frame_hi

    problem = BAProblem(
        T_cw=T_cw,
        cam_valid=cam_valid,
        points=points,
        pnt_valid=pnt_valid,
        obs_cam=jnp.clip(obs_cam, 0, n_cams - 1),
        obs_pnt=jnp.clip(obs_pnt, 0, n_points - 1),
        obs_uv=obs_uv,
        obs_valid=obs_ok,
    )
    return problem, WindowMapping(slot_to_pid=slot_to_pid, frame_lo=frame_lo)


@partial(jax.jit, static_argnames=("n_cams", "n_points", "n_obs"))
def extract_kf_window(
    mp: MapState,
    poses_wc: jnp.ndarray,
    kf_flags: jnp.ndarray,
    frame_hi: jnp.ndarray,
    n_cams: int,
    n_points: int,
    n_obs: int,
) -> tuple[BAProblem, KfWindowMapping]:
    """Build the BA problem over the last n_cams KEYFRAMES at or before
    frame_hi (SURVEY.md §6: the back-end window is keyframe-centric — the
    reference's map is keyed by keyframes, include/map.h:46-48). Only
    observations made AT those keyframes enter; with a keyframe cadence of c
    the window spans ~n_cams*c frames of trajectory for the same problem
    size as an n_cams frame window."""
    F = kf_flags.shape[0]
    fr = jnp.arange(F, dtype=jnp.int32)
    is_kf = kf_flags & (fr <= frame_hi)
    total = jnp.sum(is_kf.astype(jnp.int32))
    csum = jnp.cumsum(is_kf.astype(jnp.int32))
    in_win = is_kf & (csum > total - n_cams)

    # camera slots ascending by frame id, empty (-1) slots first
    desc, _ = jax.lax.top_k(jnp.where(in_win, fr, -1), n_cams)
    cam_fids = desc[::-1]
    cam_valid = cam_fids >= 0

    # frame id -> camera slot lookup (F+1 sentinel row absorbs invalid)
    frame_to_cam = (
        jnp.full((F + 1,), -1, jnp.int32)
        .at[jnp.where(cam_valid, cam_fids, F)]
        .set(jnp.arange(n_cams, dtype=jnp.int32), mode="drop")
    )
    row_cam = frame_to_cam[jnp.clip(mp.obs_fid, 0, F)]
    sel = (mp.obs_fid >= 0) & (row_cam >= 0) & (mp.obs_pid >= 0)

    obs_cam, obs_pnt, obs_uv, obs_ok, slot_to_pid, pnt_valid, points = (
        _compact_and_remap(mp, sel, row_cam, n_points, n_obs)
    )

    T_wc = poses_wc[jnp.clip(cam_fids, 0, poses_wc.shape[0] - 1)]
    T_cw = se3.inverse(T_wc)

    problem = BAProblem(
        T_cw=T_cw,
        cam_valid=cam_valid,
        points=points,
        pnt_valid=pnt_valid,
        obs_cam=jnp.clip(obs_cam, 0, n_cams - 1),
        obs_pnt=jnp.clip(obs_pnt, 0, n_points - 1),
        obs_uv=obs_uv,
        obs_valid=obs_ok,
    )
    return problem, KfWindowMapping(slot_to_pid=slot_to_pid, cam_fids=cam_fids)


@jax.jit
def write_back(
    mp: MapState,
    poses_wc: jnp.ndarray,
    mapping: WindowMapping,
    T_cw_opt: jnp.ndarray,
    points_opt: jnp.ndarray,
    pnt_valid: jnp.ndarray,
    cam_valid: jnp.ndarray,
) -> tuple[MapState, jnp.ndarray]:
    """Scatter optimized points into the global map and optimized poses into
    the trajectory. Returns (new MapState, new poses array)."""
    M = mp.points.shape[0]
    pid = jnp.where(pnt_valid & (mapping.slot_to_pid >= 0), mapping.slot_to_pid, M)
    points = mp.points.at[pid].set(points_opt, mode="drop")

    n_cams = T_cw_opt.shape[0]
    cam_ids = mapping.frame_lo + jnp.arange(n_cams)
    fidx = jnp.where(cam_valid, cam_ids, poses_wc.shape[0])
    T_wc_opt = se3.inverse(T_cw_opt)
    poses = poses_wc.at[fidx].set(T_wc_opt, mode="drop")
    return mp._replace(points=points), poses


@jax.jit
def write_back_kf(
    mp: MapState,
    poses_wc: jnp.ndarray,
    mapping: KfWindowMapping,
    frame_hi: jnp.ndarray,
    T_cw_opt: jnp.ndarray,
    points_opt: jnp.ndarray,
    pnt_valid: jnp.ndarray,
    cam_valid: jnp.ndarray,
) -> tuple[MapState, jnp.ndarray]:
    """Write back a keyframe-window solve: optimized points scatter into the
    global map, keyframe poses land exactly, and every non-keyframe pose in
    [first window keyframe, frame_hi] is carried by the RIGID correction of
    its nearest preceding window keyframe (C_k = T_wc_new[k] inv(T_wc_old[k]))
    — the relative pose from that keyframe, which BA did not observe, is
    preserved while the keyframe chain absorbs the drift correction."""
    M = mp.points.shape[0]
    pid = jnp.where(pnt_valid & (mapping.slot_to_pid >= 0), mapping.slot_to_pid, M)
    points = mp.points.at[pid].set(points_opt, mode="drop")

    F = poses_wc.shape[0]
    cam_fids = mapping.cam_fids                       # ascending, -1 pads first
    T_wc_new = se3.inverse(T_cw_opt)                  # (K,4,4)
    T_wc_old = poses_wc[jnp.clip(cam_fids, 0, F - 1)]
    corr = se3.compose(T_wc_new, se3.inverse(T_wc_old))  # (K,4,4)

    # nearest preceding window keyframe for every frame index
    fr = jnp.arange(F, dtype=jnp.int32)
    k_of = jnp.searchsorted(cam_fids, fr, side="right") - 1  # (F,)
    n_pad = jnp.sum((~cam_valid).astype(jnp.int32))
    first_fid = cam_fids[jnp.clip(n_pad, 0, cam_fids.shape[0] - 1)]
    in_span = (k_of >= n_pad) & (fr >= first_fid) & (fr <= frame_hi)

    corr_f = corr[jnp.clip(k_of, 0, corr.shape[0] - 1)]      # (F,4,4)
    corrected = se3.compose(corr_f, poses_wc)
    poses = jnp.where(in_span[:, None, None], corrected, poses_wc)
    # keyframe poses land exactly (corr @ old == new there by construction,
    # up to fp error; set them explicitly to avoid drift of the anchor)
    fidx = jnp.where(cam_valid, cam_fids, F)
    poses = poses.at[fidx].set(T_wc_new, mode="drop")
    return mp._replace(points=points), poses
