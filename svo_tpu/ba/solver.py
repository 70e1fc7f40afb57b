"""Windowed bundle adjustment: Schur-complement Levenberg-Marquardt.

The reference links Ceres but never calls it — its back-end optimization
thread is an empty TODO loop (reference: src/map.cpp:84-88, CMakeLists.txt:23).
This module is that missing capability, built for batched device execution:

- The problem is a fixed-shape COO observation table (obs -> camera slot,
  point slot, pixel measurement, validity mask). Variable counts are masks.
- Residual/Jacobian evaluation is batched over all observations at once.
- Point marginalization (the Schur trick) is segment-sums keyed by point and
  by (camera, point): H_pp and the W_cp cross blocks accumulate with
  scatter-adds; the reduced camera system assembles as one dense einsum over
  point slots — dense arithmetic, not sparse pointer chasing.
- The reduced (6K x 6K) camera system is solved dense via Cholesky (the
  window is small); LM damping with accept/reject runs as a lax.scan.
- Stereo-aware residuals: an observation optionally carries the right-camera
  horizontal coordinate u_r (the reference stored stereo matches then threw
  the right feature away — src/tracking.cpp:150-151, TODO at :146). The
  3rd residual row pins the scale gauge that left-only monocular BA leaves
  free.
- Gauge: the first `n_fixed` cameras in the window are frozen (their updates
  are zeroed), anchoring the free end of the trajectory.

Convention: cameras are parametrized by T_cw (world->camera); updates are
left-multiplicative twists, T_cw <- exp(delta) @ T_cw.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from svo_tpu.geometry import se3


class BAProblem(NamedTuple):
    """Fixed-shape windowed BA problem.

    K cameras, P point slots, O observation slots.
    """

    T_cw: jnp.ndarray      # (K,4,4) world->camera poses
    cam_valid: jnp.ndarray  # (K,) bool
    points: jnp.ndarray    # (P,3) world points
    pnt_valid: jnp.ndarray  # (P,) bool
    obs_cam: jnp.ndarray   # (O,) i32 camera slot
    obs_pnt: jnp.ndarray   # (O,) i32 point slot
    obs_uv: jnp.ndarray    # (O,3) u_left, v_left, u_right (-1 if mono)
    obs_valid: jnp.ndarray  # (O,) bool


class BAResult(NamedTuple):
    T_cw: jnp.ndarray
    points: jnp.ndarray
    cost0: jnp.ndarray     # initial robust cost
    cost: jnp.ndarray      # final robust cost
    n_obs: jnp.ndarray


def _residuals(K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, obs_uv):
    """Residuals (O,3) and Jacobians wrt camera twist (O,3,6) and point
    (O,3,3). Third row is the right-camera u residual (stereo), masked by
    obs_uv[:,2] >= 0."""
    fx, fy = K_mat[0, 0], K_mat[1, 1]
    cx, cy = K_mat[0, 2], K_mat[1, 2]

    T = T_cw[obs_cam]                      # (O,4,4)
    X = points[obs_pnt]                    # (O,3)
    Xc = se3.transform(T, X)               # (O,3)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / zs
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    # right camera of a rectified rig: u_r = u - fx*b/z
    u_r = u - baseline_fx * inv_z

    has_stereo = obs_uv[:, 2] >= 0.0
    r = jnp.stack(
        [
            u - obs_uv[:, 0],
            v - obs_uv[:, 1],
            jnp.where(has_stereo, u_r - obs_uv[:, 2], 0.0),
        ],
        axis=-1,
    )

    zero = jnp.zeros_like(x)
    # d pi / d Xc for the 3 rows
    Jpi = jnp.stack(
        [
            jnp.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], axis=-1),
            jnp.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], axis=-1),
            jnp.stack(
                [
                    fx * inv_z,
                    zero,
                    (-fx * x + baseline_fx) * inv_z * inv_z,
                ],
                axis=-1,
            ),
        ],
        axis=-2,
    )  # (O,3,3)
    Jpi = Jpi * jnp.stack(
        [jnp.ones_like(zero), jnp.ones_like(zero), has_stereo.astype(Jpi.dtype)],
        axis=-1,
    )[..., None]

    # d Xc / d twist = [I | -hat(Xc)], d Xc / d X = R
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape[:-1] + (3, 3))
    Jx = jnp.concatenate([I3, -se3.hat(Xc)], axis=-1)  # (O,3,6)
    J_c = Jpi @ Jx                                     # (O,3,6)
    J_p = Jpi @ T[..., :3, :3]                         # (O,3,3)
    return r, J_c, J_p


def _robust_weights(r, valid, delta, reject):
    """Trimmed-Huber IRLS weights (O,) and the robust cost.

    Huber bounds an outlier's influence but never zeroes it; a constant pull
    from gross outliers (e.g. wrong KLT associations) still biases the window.
    Residuals beyond `reject` get weight 0 — the BA-side analogue of the
    front-end's RANSAC outlier removal (reference: src/tracking.cpp:218-229).
    The cost saturates for rejected rows so accept/reject comparisons stay
    monotone."""
    e = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(e <= delta, 1.0, delta / jnp.maximum(e, 1e-12))
    w = jnp.where(e > reject, 0.0, w)
    w = w * valid.astype(r.dtype)
    rho = jnp.where(e <= delta, 0.5 * e * e, delta * (e - 0.5 * delta))
    rho = jnp.minimum(rho, delta * (reject - 0.5 * delta))
    cost = jnp.sum(rho * valid.astype(r.dtype))
    return w, cost


@partial(jax.jit, static_argnames=("iterations", "n_fixed", "axis_name"))  # noqa: E302
def solve_ba(
    problem: BAProblem,
    K_mat: jnp.ndarray,
    baseline_fx: jnp.ndarray,
    iterations: int = 10,
    n_fixed: int = 1,
    huber_delta: float = 5.0,
    reject_threshold: float = 20.0,
    init_lambda: float = 1e-4,
    axis_name: str | None = None,
) -> BAResult:
    """Run LM with Schur-complement camera reduction on a windowed problem.

    Distributed mode (axis_name set, called under shard_map): observations
    and point slots are SHARDED across the named mesh axis (each shard owns
    all observations of its points — keyframe-block partitioning), cameras
    are REPLICATED. Point marginalization is local to each shard; the reduced
    camera system and the robust cost are the only cross-shard quantities and
    are combined with psum (one (K,K,6,6) + one (K,6) + one scalar per LM
    iteration riding the device interconnect). The camera solve is replicated; point
    back-substitution stays local. See svo_tpu/parallel/ba.py.
    """
    def _allreduce(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x
    Kc = problem.T_cw.shape[0]
    P = problem.points.shape[0]
    obs_cam = jnp.clip(problem.obs_cam, 0, Kc - 1)
    obs_pnt = jnp.clip(problem.obs_pnt, 0, P - 1)
    ov = problem.obs_valid & problem.cam_valid[obs_cam] & problem.pnt_valid[obs_pnt]

    fixed_mask = (
        jnp.arange(Kc) < n_fixed
    ) | (~problem.cam_valid)  # frozen cameras: gauge anchors + invalid slots

    def cost_at(T_cw, points):
        r, _, _ = _residuals(
            K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, problem.obs_uv
        )
        _, c = _robust_weights(r, ov, huber_delta, reject_threshold)
        return _allreduce(c)

    def lm_step(carry, _):
        T_cw, points, lam, cost = carry

        r, J_c, J_p = _residuals(
            K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, problem.obs_uv
        )
        w, _ = _robust_weights(r, ov, huber_delta, reject_threshold)
        wJ_c = J_c * w[:, None, None]
        wJ_p = J_p * w[:, None, None]

        # per-observation blocks
        Hcc_o = jnp.einsum("oik,oil->okl", wJ_c, J_c)      # (O,6,6)
        Hpp_o = jnp.einsum("oik,oil->okl", wJ_p, J_p)      # (O,3,3)
        Wcp_o = jnp.einsum("oik,oil->okl", wJ_c, J_p)      # (O,6,3)
        bc_o = jnp.einsum("oik,oi->ok", wJ_c, r)           # (O,6)
        bp_o = jnp.einsum("oik,oi->ok", wJ_p, r)           # (O,3)

        # segment-sum into dense tables
        Hcc = jnp.zeros((Kc, 6, 6), r.dtype).at[obs_cam].add(Hcc_o)
        Hpp = jnp.zeros((P, 3, 3), r.dtype).at[obs_pnt].add(Hpp_o)
        cp_idx = obs_cam * P + obs_pnt
        Wcp = jnp.zeros((Kc * P, 6, 3), r.dtype).at[cp_idx].add(Wcp_o)
        Wcp = Wcp.reshape(Kc, P, 6, 3)
        bc = jnp.zeros((Kc, 6), r.dtype).at[obs_cam].add(bc_o)
        bp = jnp.zeros((P, 3), r.dtype).at[obs_pnt].add(bp_o)

        # damped point-block inverse
        Hpp_d = Hpp + lam * jnp.eye(3, dtype=r.dtype) * jnp.maximum(
            jnp.einsum("pii->p", Hpp), 1e-6
        )[:, None, None] / 3.0
        Hpp_d = Hpp_d + 1e-8 * jnp.eye(3, dtype=r.dtype)
        from svo_tpu.ops.linalg import inv3x3

        Hpp_inv = inv3x3(Hpp_d)
        Hpp_inv = jnp.where(
            problem.pnt_valid[:, None, None], Hpp_inv, jnp.zeros_like(Hpp_inv)
        )

        # Schur complement S = Hcc - Wcp Hpp^-1 Wcp^T  (dense einsum over P)
        Y = jnp.einsum("apij,pjk->apik", Wcp, Hpp_inv)      # (K,P,6,3)
        S_off = jnp.einsum("apik,bplk->abil", Y, Wcp)       # (K,K,6,6)
        yb = jnp.einsum("apik,pk->ai", Y, bp)               # (K,6)

        # cross-shard reduction of every camera-indexed contribution in ONE
        # collective (round-5: the four separate psums each paid the
        # transport's full per-collective latency — at online window sizes
        # the solve was latency-bound, SCALING_r04 sweep[0]; the reduced
        # payload is small, so one concatenated all-reduce costs the same
        # as any single one of them). Algebraically identical: all four are
        # sums of per-shard local contributions.
        if axis_name is not None:
            flat = jnp.concatenate([
                Hcc.reshape(-1), bc.reshape(-1), S_off.reshape(-1),
                yb.reshape(-1),
            ])
            flat = jax.lax.psum(flat, axis_name)
            o1 = Kc * 36
            o2 = o1 + Kc * 6
            o3 = o2 + Kc * Kc * 36
            Hcc = flat[:o1].reshape(Kc, 6, 6)
            bc = flat[o1:o2].reshape(Kc, 6)
            S_off = flat[o2:o3].reshape(Kc, Kc, 6, 6)
            yb = flat[o3:].reshape(Kc, 6)
        S = -S_off
        S = S.at[jnp.arange(Kc), jnp.arange(Kc)].add(Hcc)
        b_red = bc - yb  # (K,6)

        # flatten to (6K,6K), apply gauge fixing + damping
        Sf = S.transpose(0, 2, 1, 3).reshape(Kc * 6, Kc * 6)
        bf = b_red.reshape(Kc * 6)
        fixed6 = jnp.repeat(fixed_mask, 6)
        Sf = jnp.where(fixed6[:, None] | fixed6[None, :], 0.0, Sf)
        Sf = Sf + jnp.diag(
            jnp.where(fixed6, 1.0, lam * jnp.maximum(jnp.diag(Sf), 1e-6))
        )
        bf = jnp.where(fixed6, 0.0, bf)

        delta_c = -jnp.linalg.solve(Sf, bf).reshape(Kc, 6)
        delta_c = jnp.where(jnp.all(jnp.isfinite(delta_c)), delta_c, 0.0)

        # back-substitute points: dp = -Hpp^-1 (bp + Wcp^T dc)
        rhs_p = bp + jnp.einsum("apik,ai->pk", Wcp, delta_c)
        delta_p = -jnp.einsum("pij,pj->pi", Hpp_inv, rhs_p)
        delta_p = jnp.where(problem.pnt_valid[:, None], delta_p, 0.0)

        T_new = se3.compose(se3.exp(delta_c), T_cw)
        T_new = jnp.where(fixed_mask[:, None, None], T_cw, T_new)
        pts_new = points + delta_p

        new_cost = cost_at(T_new, pts_new)
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        T_cw = jnp.where(accept, T_new, T_cw)
        points = jnp.where(accept, pts_new, points)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-9, 1e4)
        return (T_cw, points, lam, cost), cost

    cost0 = cost_at(problem.T_cw, problem.points)
    (T_cw, points, _, cost), _ = jax.lax.scan(
        lm_step,
        (problem.T_cw, problem.points, jnp.asarray(init_lambda), cost0),
        None,
        length=iterations,
    )
    return BAResult(
        T_cw=T_cw,
        points=points,
        cost0=cost0,
        cost=cost,
        n_obs=_allreduce(jnp.sum(ov.astype(jnp.int32))),
    )


@partial(jax.jit, static_argnames=("rounds", "n_fixed", "points_only"))
def refine_alternate(
    problem: BAProblem,
    K_mat: jnp.ndarray,
    baseline_fx: jnp.ndarray,
    rounds: int = 6,
    n_fixed: int = 1,
    huber_delta: float = 5.0,
    reject_threshold: float = 20.0,
    mono_weight: float = 0.25,
    max_polish_span: int = 8,
    points_only: bool = False,
) -> BAResult:
    """Alternating resection-intersection refinement (round-4 conservative
    back-end path).

    Joint pose+point BA can transport both variable sets coherently along
    weakly observable modes — reprojection cost drops while the trajectory
    walks away from truth (the r03 refined-bench regression). Alternation
    makes that move impossible BY CONSTRUCTION: each half-step optimizes one
    variable set against the other held FIXED, so every accepted update is
    anchored.

    - intersection: per-point damped GN on the 3x3 normal system (points
      against fixed poses) — multi-view re-triangulation, which also removes
      one-shot stereo triangulation depth bias;
    - resection: per-camera damped GN on the 6x6 normal system (poses
      against the fixed map) — each camera is an independent PnP polish.

    Both half-steps are embarrassingly parallel batched small solves (no
    Schur system, no cross-camera coupling) and each is accepted only if the
    shared robust objective decreases, so the sequence is monotone.
    Convergence on long-wavelength modes is deliberately slower than joint
    LM — those are exactly the modes that slide."""
    from svo_tpu.ops.linalg import inv3x3

    Kc = problem.T_cw.shape[0]
    P = problem.points.shape[0]
    obs_cam = jnp.clip(problem.obs_cam, 0, Kc - 1)
    obs_pnt = jnp.clip(problem.obs_pnt, 0, P - 1)
    ov = problem.obs_valid & problem.cam_valid[obs_cam] & problem.pnt_valid[obs_pnt]
    fixed_mask = (jnp.arange(Kc) < n_fixed) | (~problem.cam_valid)

    def cost_at(T_cw, points):
        r, _, _ = _residuals(
            K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, problem.obs_uv
        )
        _, c = _robust_weights(r, ov, huber_delta, reject_threshold)
        return c

    mono_row = problem.obs_uv[:, 2] < 0.0

    # Per-point polish gate by observation SPAN: a point observed across
    # many frames of the window has accumulated chained-KLT drift in its
    # later measurements (coherent, not noise — dominant under receding
    # motion where features never leave the view), and re-fitting it bakes
    # that drift into the map, bending the downstream trajectory. Young
    # points' measurements are noise-dominated and polishing them helps.
    # Points with span > max_polish_span keep their positions.
    big = jnp.int32(1 << 20)
    first_cam = jnp.full((P,), big, jnp.int32).at[obs_pnt].min(
        jnp.where(ov, obs_cam, big)
    )
    last_cam = jnp.full((P,), -1, jnp.int32).at[obs_pnt].max(
        jnp.where(ov, obs_cam, -1)
    )
    obs_span = jnp.maximum(last_cam - first_cam, 0)
    polish_ok = problem.pnt_valid & (obs_span <= max_polish_span)

    def point_step(T_cw, points):
        r, _, J_p = _residuals(
            K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, problem.obs_uv
        )
        w, _ = _robust_weights(r, ov, huber_delta, reject_threshold)
        # Down-weight MONO tracking observations against the birth STEREO
        # row when re-triangulating: chained-track drift (the dominant
        # receding-motion error) lives in the later mono measurements,
        # while the stereo row is drift-free by construction. Without this
        # the intersection step fits accumulated drift into the map and
        # degrades already-good receding trajectories downstream.
        w = w * jnp.where(mono_row, mono_weight, 1.0)
        wJ = J_p * w[:, None, None]
        Hpp = jnp.zeros((P, 3, 3), r.dtype).at[obs_pnt].add(
            jnp.einsum("oik,oil->okl", wJ, J_p)
        )
        bp = jnp.zeros((P, 3), r.dtype).at[obs_pnt].add(
            jnp.einsum("oik,oi->ok", wJ, r)
        )
        Hd = Hpp + 1e-6 * jnp.eye(3, dtype=r.dtype) + 1e-3 * jnp.eye(
            3, dtype=r.dtype
        ) * jnp.einsum("pii->p", Hpp)[:, None, None] / 3.0
        dp = -jnp.einsum("pij,pj->pi", inv3x3(Hd), bp)
        dp = jnp.where(
            polish_ok[:, None] & jnp.all(jnp.isfinite(dp), -1, keepdims=True),
            dp, 0.0,
        )
        return points + dp

    def pose_step(T_cw, points):
        r, J_c, _ = _residuals(
            K_mat, baseline_fx, T_cw, points, obs_cam, obs_pnt, problem.obs_uv
        )
        w, _ = _robust_weights(r, ov, huber_delta, reject_threshold)
        wJ = J_c * w[:, None, None]
        Hcc = jnp.zeros((Kc, 6, 6), r.dtype).at[obs_cam].add(
            jnp.einsum("oik,oil->okl", wJ, J_c)
        )
        bc = jnp.zeros((Kc, 6), r.dtype).at[obs_cam].add(
            jnp.einsum("oik,oi->ok", wJ, r)
        )
        Hd = Hcc + 1e-6 * jnp.eye(6, dtype=r.dtype) + 1e-3 * jnp.eye(
            6, dtype=r.dtype
        ) * jnp.einsum("kii->k", Hcc)[:, None, None] / 6.0
        dc = -jnp.linalg.solve(Hd, bc[..., None])[..., 0]
        dc = jnp.where(
            fixed_mask[:, None] | ~jnp.all(jnp.isfinite(dc), -1, keepdims=True),
            0.0, dc,
        )
        return se3.compose(se3.exp(dc), T_cw)

    def round_body(carry, _):
        T_cw, points, cost = carry
        pts_new = point_step(T_cw, points)
        c1 = cost_at(T_cw, pts_new)
        ok1 = jnp.isfinite(c1) & (c1 <= cost)
        points = jnp.where(ok1, pts_new, points)
        cost = jnp.where(ok1, c1, cost)

        # points_only (the conservative global-refinement path): the caller
        # only ever applies the point half (ADVICE r04: its pose output was
        # dead compute), and intersection against the UNMOVED shipped poses
        # keeps the polished map maximally consistent with the trajectory
        # the front-end will extend.
        if not points_only:
            T_new = pose_step(T_cw, points)
            c2 = cost_at(T_new, points)
            ok2 = jnp.isfinite(c2) & (c2 <= cost)
            T_cw = jnp.where(ok2, T_new, T_cw)
            cost = jnp.where(ok2, c2, cost)
        return (T_cw, points, cost), None

    cost0 = cost_at(problem.T_cw, problem.points)
    (T_cw, points, cost), _ = jax.lax.scan(
        round_body, (problem.T_cw, problem.points, cost0), None, length=rounds
    )
    return BAResult(
        T_cw=T_cw, points=points, cost0=cost0, cost=cost,
        n_obs=jnp.sum(ov.astype(jnp.int32)),
    )
