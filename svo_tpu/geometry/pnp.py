"""RANSAC-PnP: batched-hypothesis robust 3D->2D pose estimation.

Replacement for cv::solvePnPRansac(SQPNP) + cv::Rodrigues + pose
inversion (reference: src/tracking.cpp:181-230). OpenCV's adaptive-iteration
RANSAC (100 iters, 8 px, 0.999 confidence) becomes a fixed batch of parallel
minimal-solver hypotheses (static shapes under jit):

1. Sample H index sets of 6 valid correspondences (Gumbel top-k, no
   replacement within a hypothesis).
2. Solve each with a 6-point DLT for [R|t] in normalized image coordinates
   (12x12 symmetric eigenproblem, batched over hypotheses).
3. Score all hypotheses by masked inlier count at the reprojection threshold.
4. Refine the winner with masked Gauss-Newton on its inliers (the role
   OpenCV's final SQPNP-on-inliers solve plays), then recompute inliers.

Returns the camera-to-world pose T_wc (the reference stores the inverted
[R|t], src/tracking.cpp:197-214), the inlier mask, and the inlier ratio.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from svo_tpu.config import RansacParams
from svo_tpu.geometry import se3
from svo_tpu.ops import linalg


class PnPResult(NamedTuple):
    T_wc: jnp.ndarray        # (4,4) camera-to-world pose
    inliers: jnp.ndarray     # (N,) bool, subset of `valid`
    inlier_ratio: jnp.ndarray  # scalar, |inliers| / |valid| (reference: tracking.cpp:195)
    ok: jnp.ndarray          # scalar bool, solution sanity


def _normalize_pixels(K: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """K^-1 applied to pixels: (...,2) -> (...,2) normalized image coords."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)


def _dlt6(Xw: jnp.ndarray, xn: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Minimal 6-point DLT pose from world points (6,3) and normalized image
    points (6,2). Returns (R (3,3), t (3,)).

    The 12x12 null vector comes from fixed-count inverse iteration and the
    SO(3) projection from a Newton polar iteration, in place of eigh/svd
    (svo_tpu.ops.linalg)."""
    from svo_tpu.ops import linalg

    ones = jnp.ones_like(Xw[..., :1])
    Xh = jnp.concatenate([Xw, ones], axis=-1)  # (6,4)
    z = jnp.zeros_like(Xh)
    # rows: [X 0 -u X ; 0 X -v X] for P stacked as 12-vector (row-major)
    r1 = jnp.concatenate([Xh, z, -xn[..., 0:1] * Xh], axis=-1)  # (6,12)
    r2 = jnp.concatenate([z, Xh, -xn[..., 1:2] * Xh], axis=-1)  # (6,12)
    A = jnp.concatenate([r1, r2], axis=-2)  # (12,12)
    A = A / (jnp.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    p = linalg.smallest_eigvec_psd(A.T @ A)
    P = p.reshape(3, 4)
    # Cheirality/sign: make depths positive for the sample points.
    depths = Xh @ P[2]
    P = P * jnp.where(jnp.sum(jnp.sign(depths)) < 0, -1.0, 1.0)
    M = P[:, :3]
    R = linalg.polar3x3(M)
    # scale: |M| projected onto R (trace(R^T M) / 3); sign already fixed
    scale = jnp.einsum("ij,ij->", R, M) / 3.0
    t = P[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    return R, t


def _reproj_errors(K, T_cw, Xw, uv):
    """Squared pixel reprojection errors (N,) and camera-frame depth (N,)."""
    Xc = se3.transform(T_cw, Xw)
    z = Xc[..., 2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * Xc[..., 0] / zs + cx
    v = fy * Xc[..., 1] / zs + cy
    err2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    return err2, z


def _gn_refine(K, T_cw, Xw, uv, weight, iters: int):
    """Masked Gauss-Newton on reprojection error over se(3).

    weight: (N,) 0/1 inlier mask (or robust weights). Left-multiplicative
    twist update: T <- exp(delta) @ T."""
    fx, fy = K[0, 0], K[1, 1]

    def body(T):
        Xc = se3.transform(T, Xw)  # (N,3)
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        inv_z = 1.0 / zs
        u = fx * x * inv_z + K[0, 2]
        v = fy * y * inv_z + K[1, 2]
        r = jnp.stack([u - uv[..., 0], v - uv[..., 1]], axis=-1)  # (N,2)
        # d pi / d Xc
        zero = jnp.zeros_like(x)
        Jpi = jnp.stack(
            [
                jnp.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], axis=-1),
                jnp.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], axis=-1),
            ],
            axis=-2,
        )  # (N,2,3)
        # d Xc / d xi = [I | -hat(Xc)] for left update
        Jx = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape[:-1] + (3, 3)), -se3.hat(Xc)],
            axis=-1,
        )  # (N,3,6)
        J = Jpi @ Jx  # (N,2,6)
        w = weight[..., None, None]
        H = jnp.sum(jnp.swapaxes(J, -1, -2) @ (J * w), axis=0)  # (6,6)
        g = jnp.sum(jnp.swapaxes(J, -1, -2) @ (r[..., None] * w), axis=0)[..., 0]  # (6,)
        H = H + 1e-6 * jnp.eye(6, dtype=H.dtype)
        # unrolled Cholesky in place of jnp.linalg.solve (see ops/linalg.py)
        delta = -linalg.cho_solve_unrolled(linalg.cholesky_unrolled(H), g)
        # Guard against divergent steps on degenerate systems.
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros_like(delta))
        return se3.compose(se3.exp(delta), T)

    # statically unrolled: a handful of small (N,2,6) updates
    T = T_cw
    for _ in range(iters):
        T = body(T)
    return T


def ransac_pnp(
    K: jnp.ndarray,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    params: RansacParams,
    T_init: jnp.ndarray | None = None,
) -> PnPResult:
    """Robust pose from N (masked) 3D->2D correspondences.

    Args:
        K: (3,3) intrinsics.
        Xw: (N,3) world points.
        uv: (N,2) observed pixels in the current left image.
        valid: (N,) bool mask of live correspondences.
        key: PRNG key for hypothesis sampling.
        params: RansacParams.
        T_init: optional (4,4) prior world-to-camera pose, added to the
            hypothesis pool (motion-prior seeding; cheap robustness win the
            reference lacks).
    Returns:
        PnPResult with T_wc (camera-to-world, as the reference stores it).
    """
    N = Xw.shape[0]
    H = params.num_hypotheses
    validf = valid.astype(jnp.float32)

    # --- 1. sample hypothesis index sets (Gumbel top-6 over valid slots) ---
    g = jax.random.gumbel(key, (H, N))
    scores = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(scores, 6)  # (H,6)

    xn = _normalize_pixels(K, uv)
    Xs = Xw[idx]          # (H,6,3)
    xs = xn[idx]          # (H,6,2)

    # --- 2. batched minimal solves ---
    Rs, ts = jax.vmap(_dlt6)(Xs, xs)  # (H,3,3), (H,3)
    T_h = se3.from_rt(Rs, ts)         # (H,4,4) world->camera
    if T_init is not None:
        T_init = jnp.asarray(T_init)
        if T_init.ndim == 2:
            T_init = T_init[None]
        T_h = jnp.concatenate([T_h, T_init], axis=0)
        H = H + T_init.shape[0]

    # --- 3. score all hypotheses ---
    thr2 = params.reproj_threshold ** 2
    err2, z = jax.vmap(lambda T: _reproj_errors(K, T, Xw, uv))(T_h)  # (H,N)
    finite = jnp.all(jnp.isfinite(T_h.reshape(H, -1)), axis=-1)
    inl = (err2 < thr2) & (z > 0) & valid[None, :]  # (H,N)
    counts = jnp.sum(inl, axis=-1) * finite.astype(jnp.int32)
    # MSAC score: truncated squared residual (cheirality failures saturate).
    # Unlike a pure inlier count this breaks ties between hypotheses that
    # both capture all points (e.g. the two branches of the planar PnP
    # ambiguity) in favor of the lower-residual one.
    res2 = jnp.where((z > 0), jnp.minimum(err2, thr2), thr2)
    msac = jnp.sum(jnp.where(valid[None, :], res2, 0.0), axis=-1)
    msac = jnp.where(finite, msac, jnp.inf)
    best = jnp.argmin(msac)
    T_best = T_h[best]
    inliers0 = inl[best]

    # --- 4. locally-optimized refinement (LO-RANSAC) from MULTIPLE starts:
    # the MSAC winner AND every provided prior pose. On degenerate geometry
    # (quasi-planar far points during fast yaw — round-4 multi-world suite)
    # every minimal DLT hypothesis is garbage, and a one-frame-stale prior
    # is all-outlier at the threshold so it loses the raw MSAC vote — but
    # masked GN converges from tens of px of reprojection error, so
    # refining each candidate and judging by FINAL consensus recovers the
    # pose that exists. The winner needs the largest refined inlier set
    # (ties break toward lower truncated residual), so a drifted prior can
    # only win after it has re-fit the actual measurements — the round-3
    # failure mode (accepting the raw extrapolation, compounding its error)
    # cannot recur. ---
    def inliers_of(T, mult: float = 1.0):
        err2_f, z_f = _reproj_errors(K, T, Xw, uv)
        t2 = thr2 * (mult * mult)
        inl_f = (err2_f < t2) & (z_f > 0) & valid
        res2_f = jnp.where(z_f > 0, jnp.minimum(err2_f, thr2), thr2)
        score = jnp.sum(jnp.where(valid, res2_f, 0.0))
        return inl_f, score

    def lo_from(T0, schedule):
        """Local optimization with a threshold-multiplier schedule: each
        round selects inliers at schedule[r] * threshold, runs GN on the
        selection, re-selects. schedule == (1,)*lo_rounds is classic strict
        LO-RANSAC; a descending schedule (lo_anneal) is the wide-gate rescue
        (see RansacParams.lo_anneal). The returned inlier set is always
        judged at the strict threshold."""
        T_ref = T0
        for mult in schedule:
            sel, _ = inliers_of(T_ref, mult)
            T_ref = _gn_refine(
                K, T_ref, Xw, uv, sel.astype(jnp.float32),
                params.refine_iters,
            )
        inl, _ = inliers_of(T_ref)
        return T_ref, inl

    strict = (1.0,) * params.lo_rounds
    # Candidate pool: the unrefined MSAC winner (fallback), strict LO from
    # the MSAC winner and from each prior (the round-4 shipping design), and
    # an ANNEALED-gate LO from each prior as a RESCUE. The annealed rescue
    # handles fast rotation (prior ~20 px out -> strict seed mask empty ->
    # GN frozen -> PnP success was a Gumbel-draw lottery over degenerate DLT
    # hypotheses; scripts/probe_pnp_turn.py). It is adopted ONLY when its
    # final strict consensus beats the best strict candidate by a clear
    # margin: on weak texture the wide gate admits coherently-drifted tracks
    # and the dragged pose wins strict-count TIES via the residual
    # tie-break (corridor-lowtex 0.15 -> 0.47 m when annealed candidates
    # competed as equals), while in a genuine tracking collapse the margin
    # is enormous (strict best ~2-16 inliers, rescue ~90).
    finals = [(T_best, inliers0), lo_from(T_best, strict)]
    rescues = []
    if T_init is not None:
        for i in range(T_init.shape[0]):
            finals.append(lo_from(T_init[i], strict))
            rescues.append(lo_from(T_init[i], tuple(params.lo_anneal)))

    T_final, inliers = finals[0]
    best_count = jnp.sum(inliers)
    _, best_score = inliers_of(T_final)
    for T_c, inl_c in finals[1:]:
        cnt = jnp.sum(inl_c)
        _, score = inliers_of(T_c)
        fin = jnp.all(jnp.isfinite(T_c))
        better = fin & (
            (cnt > best_count) | ((cnt == best_count) & (score < best_score))
        )
        T_final = jnp.where(better, T_c, T_final)
        inliers = jnp.where(better, inl_c, inliers)
        best_count = jnp.where(better, cnt, best_count)
        best_score = jnp.where(better, score, best_score)

    for T_c, inl_c in rescues:
        cnt = jnp.sum(inl_c)
        fin = jnp.all(jnp.isfinite(T_c))
        better = fin & (
            cnt.astype(jnp.float32)
            >= params.rescue_margin * best_count.astype(jnp.float32) + 2.0
        )
        T_final = jnp.where(better, T_c, T_final)
        inliers = jnp.where(better, inl_c, inliers)
        best_count = jnp.where(better, cnt, best_count)

    n_valid = jnp.maximum(jnp.sum(validf), 1.0)
    ratio = jnp.sum(inliers.astype(jnp.float32)) / n_valid
    # Judge the FINAL consensus, not the selected minimal hypothesis's
    # initial count: on degenerate geometry (e.g. quasi-planar far points
    # during fast yaw) every 6-point DLT hypothesis can fall below 6
    # inliers while LO refinement still converges to a pose with a large
    # consensus — discarding that pose froze the pipeline into
    # dead-reckoning and cascaded (round-4 multi-world suite, box-turns).
    # The floor scales with the live correspondence count (ADVICE r04): a
    # GN-polished pose fitting 6 of hundreds is a mistrack, not a solution.
    n_inl = jnp.sum(inliers)
    floor = jnp.maximum(6.0, 0.1 * jnp.sum(validf))
    ok = (n_inl.astype(jnp.float32) >= floor) & jnp.all(jnp.isfinite(T_final))
    return PnPResult(
        T_wc=se3.inverse(T_final),
        inliers=inliers,
        inlier_ratio=ratio,
        ok=ok,
    )
