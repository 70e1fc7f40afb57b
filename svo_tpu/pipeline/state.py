"""Pipeline state: fixed-capacity struct-of-arrays world model.

Replaces the reference's pointer-soup object model (Frame*/Feature::Ptr/
MapPoint* guarded by a shared_mutex — reference: include/frame.h,
include/feature.h, include/map.h:46-52) with immutable, fixed-shape arrays:

- FeatureSet: the live feature table of the current frame. `pos` (N,2) pixel
  positions, `valid` mask (feature lifetimes are masks, never compaction —
  SURVEY.md §7 hard-part #1), `point_id` the map-point index each feature
  observes (Feature::mapPoint as an index, not a pointer), `age` frames
  tracked (for the bucketing preference the reference's dead code intended).
- MapState: preallocated world-point store with a monotone allocation cursor
  (Map::createMapPoint, reference src/map.cpp:73-77) plus a COO observation
  ring for windowed BA.
- VoState: everything a frame step needs, threaded functionally through the
  jitted per-frame step. The trajectory and per-frame metrics live on device
  and are fetched once at the end of a run (the reference printf's every
  frame from the hot loop, src/tracking.cpp:261-266).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

from svo_tpu.config import Config


class FeatureSet(NamedTuple):
    pos: jnp.ndarray       # (N, 2) f32 (x, y)
    valid: jnp.ndarray     # (N,) bool
    point_id: jnp.ndarray  # (N,) i32 map-point index, -1 if none
    age: jnp.ndarray       # (N,) i32 frames survived
    # Template anchor for keyframe-anchored KLT (TrackingParams.anchored_klt):
    # the feature's position IN THE ANCHOR KEYFRAME. Chained frame-to-frame
    # tracking integrates the tracker's constant measurement bias every
    # frame; anchored tracking re-measures against the keyframe template, so
    # the bias enters once per keyframe GENERATION instead (the dominant
    # long-run pitch/scale drift mechanism — see scripts/probe_bias*.py).
    anchor: jnp.ndarray    # (N, 2) f32 (x, y) position in the anchor KF

    @staticmethod
    def empty(n: int) -> "FeatureSet":
        return FeatureSet(
            pos=jnp.zeros((n, 2), jnp.float32),
            valid=jnp.zeros((n,), bool),
            point_id=jnp.full((n,), -1, jnp.int32),
            age=jnp.zeros((n,), jnp.int32),
            anchor=jnp.zeros((n, 2), jnp.float32),
        )

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


class MapState(NamedTuple):
    points: jnp.ndarray    # (M, 3) f32 world positions
    n_points: jnp.ndarray  # i32 allocation cursor
    # --- observation ring (COO) for windowed BA ---
    # Stored as THREE 1-D rings rather than one (O,3) array: the ring is a
    # scan carry updated by scatter every frame, and XLA assigns an (O,3)
    # array a scatter-friendly layout that differs from the carry layout —
    # costing two full-ring transpose copies per frame step. 1-D scatters
    # update in place in the native layout. The BA problem side still assembles an (O,3) obs_uv at window
    # extraction time (rare), see ba/window.py.
    obs_u: jnp.ndarray     # (O,) f32 u_left
    obs_v: jnp.ndarray     # (O,) f32 v_left
    obs_ur: jnp.ndarray    # (O,) f32 u_right (-1 if mono)
    obs_pid: jnp.ndarray   # (O,) i32 point id
    obs_fid: jnp.ndarray   # (O,) i32 frame id
    obs_cursor: jnp.ndarray  # i32 ring cursor

    @staticmethod
    def empty(cfg: Config) -> "MapState":
        m = cfg.capacity.max_points
        o = cfg.ba.ring_obs
        return MapState(
            points=jnp.zeros((m, 3), jnp.float32),
            n_points=jnp.zeros((), jnp.int32),
            obs_u=jnp.zeros((o,), jnp.float32),
            obs_v=jnp.zeros((o,), jnp.float32),
            obs_ur=jnp.full((o,), -1.0, jnp.float32),
            obs_pid=jnp.full((o,), -1, jnp.int32),
            obs_fid=jnp.full((o,), -1, jnp.int32),
            obs_cursor=jnp.zeros((), jnp.int32),
        )


class VoState(NamedTuple):
    features: FeatureSet
    map: MapState
    prev_pyramid: Any          # ((levels...), (grads...)) of the previous left image
    frame_id: jnp.ndarray      # i32 id of the PREVIOUS processed frame
    prev_is_kf: jnp.ndarray    # bool
    last_kf_id: jnp.ndarray    # i32 id of the most recent keyframe
    pose: jnp.ndarray          # (4,4) T_wc of the previous frame
    rel_motion: jnp.ndarray    # (4,4) T_wc(t) @ inv(T_wc(t-1)) — constant-
    # velocity prior. The reference computes exactly this and never uses it
    # (src/tracking.cpp:215); here it seeds the KLT flow and the PnP pose.
    prior_ok: jnp.ndarray      # bool — last PnP was healthy; gates the prior
    poses: jnp.ndarray         # (F, 4, 4) trajectory (camera-to-world)
    kf_flags: jnp.ndarray      # (F,) bool
    metrics: jnp.ndarray       # (F, 5): n_tracked, inlier_ratio, n_final, is_kf, n_map_pts
    rng: jnp.ndarray           # PRNG key
