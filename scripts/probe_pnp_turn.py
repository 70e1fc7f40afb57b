"""Capture the PnP problem at the box-turns collapse frame and dissect it.

Drives the jitted single-frame step (dynamic KF rule) to frame A-1, then
runs frame A's track stage manually and decomposes ransac_pnp: DLT
hypothesis quality, MSAC winner, LO candidates, inlier counts, vs the
ground-truth pose.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--world", default="box-turns")
parser.add_argument("--upto", type=int, default=90)
args = parser.parse_args()

import jax

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.geometry import camera as cam_mod, se3  # noqa: E402
from svo_tpu.geometry.pnp import ransac_pnp, _reproj_errors  # noqa: E402
from svo_tpu.ops.klt import KltTracker  # noqa: E402
from svo_tpu.pipeline.odometry import StereoVO  # noqa: E402

SHAPE = (376, 1241)
H, W = SHAPE
FX = 718.856

d = f"/tmp/svo_cache/worlds/{args.world}_f241"
ls = np.memmap(os.path.join(d, "l.u8"), np.uint8, "r", shape=(241, H, W))
rs = np.memmap(os.path.join(d, "r.u8"), np.uint8, "r", shape=(241, H, W))
gt = np.load(os.path.join(d, "gt.npy"))

cfg = Config(use_orb=False, image_height=H, image_width=W)
camera = cam_mod.from_intrinsics(FX, FX, W / 2, H / 2, 0.5372)

vo = StereoVO(cfg, camera)
vo.start(ls[0].astype(np.float32), rs[0].astype(np.float32))
prev = None
for i in range(1, args.upto + 1):
    # snapshot BEFORE stepping (the step donates/invalidates the state)
    snap = jax.tree.map(jnp.copy, vo.state)
    vo.process(ls[i].astype(np.float32), rs[i].astype(np.float32))
    m = np.asarray(vo.state.metrics[i])
    # find the first collapse frame: tracked fine but inlier ratio tiny
    if m[0] > 50 and m[1] < 0.2:
        print(f"collapse at frame {i}: tracked {int(m[0])}, IR {m[1]*100:.1f}%")
        prev = snap
        break
else:
    print("no collapse found up to", args.upto)
    sys.exit(0)

A = i  # collapse frame; `prev` is the state after frame A-1
left = jnp.asarray(ls[A].astype(np.float32))

# redo the tracking stage exactly as step_body does (no flow seeding default)
pyr_l = KltTracker.build_pyramid(left, cfg.temporal_klt.max_level)
tres = KltTracker.track(prev.prev_pyramid, pyr_l, prev.features.pos,
                        prev.features.valid, cfg.temporal_klt)
t_status = np.asarray(prev.features.valid & tres.status)
import dataclasses  # noqa: E402
fb_params = dataclasses.replace(cfg.temporal_klt, max_level=0, max_iters=8)
bres = KltTracker.track(pyr_l, prev.prev_pyramid, tres.pos,
                        jnp.asarray(t_status), fb_params,
                        init_flow=prev.features.pos - tres.pos)
fb_err2 = np.asarray(jnp.sum((bres.pos - prev.features.pos) ** 2, axis=-1))
t_status = t_status & np.asarray(bres.status) & (
    fb_err2 < cfg.tracking.fb_threshold ** 2)
print(f"tracked: {t_status.sum()}")

Xw = np.asarray(prev.map.points)[np.clip(np.asarray(prev.features.point_id), 0, None)]
uv = np.asarray(tres.pos)
valid = t_status

# ground truth pose for frame A (world->camera)
T_wc_gt = gt[A]
T_cw_gt = np.linalg.inv(T_wc_gt)

err2_gt, z_gt = _reproj_errors(jnp.asarray(camera.K), jnp.asarray(T_cw_gt),
                               jnp.asarray(Xw), jnp.asarray(uv))
err_gt = np.sqrt(np.asarray(err2_gt))[valid]
print(f"reproj err at GT pose: median {np.median(err_gt):.2f} px, "
      f"p90 {np.percentile(err_gt, 90):.2f}, inliers@8px "
      f"{(err_gt < 8).sum()}/{valid.sum()}")
print(f"depth stats of valid Xw (camera frame at GT): "
      f"median {np.median(np.asarray(z_gt)[valid]):.1f} m, "
      f"p10 {np.percentile(np.asarray(z_gt)[valid], 10):.1f}, "
      f"p90 {np.percentile(np.asarray(z_gt)[valid], 90):.1f}")

# err at prev pose (the LO start)
T_cw_prev = np.linalg.inv(np.asarray(prev.pose))
err2_pp, z_pp = _reproj_errors(jnp.asarray(camera.K), jnp.asarray(T_cw_prev),
                               jnp.asarray(Xw), jnp.asarray(uv))
err_pp = np.sqrt(np.asarray(err2_pp))[valid]
print(f"reproj err at prev pose: median {np.median(err_pp):.2f} px, "
      f"inliers@8px {(err_pp < 8).sum()}/{valid.sum()}")

# run the shipped ransac_pnp
rng = jax.random.PRNGKey(1234)
pres = ransac_pnp(jnp.asarray(camera.K), jnp.asarray(Xw), jnp.asarray(uv),
                  jnp.asarray(valid), rng, cfg.ransac,
                  T_init=jnp.asarray(T_cw_prev))
print(f"ransac_pnp: ok={bool(pres.ok)}, inliers={int(np.asarray(pres.inliers).sum())}, "
      f"ratio={float(pres.inlier_ratio)*100:.1f}%")
T_est = np.asarray(pres.T_wc)
E = np.linalg.inv(T_wc_gt) @ T_est
c = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
print(f"  pose err vs GT: rot {np.degrees(np.arccos(c)):.3f} deg, "
      f"trans {np.linalg.norm(E[:3, 3]):.3f} m")

# decompose: run the DLT-hypothesis stage manually
from svo_tpu.geometry.pnp import _dlt6, _normalize_pixels  # noqa: E402

g = jax.random.gumbel(jax.random.split(rng)[1], (cfg.ransac.num_hypotheses, len(Xw)))
scores = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
_, idx = jax.lax.top_k(scores, 6)
xn = _normalize_pixels(jnp.asarray(camera.K), jnp.asarray(uv))
Rs, ts = jax.vmap(_dlt6)(jnp.asarray(Xw)[idx], xn[idx])
T_h = np.asarray(se3.from_rt(Rs, ts))
best_rot = np.inf
counts = []
for h in range(len(T_h)):
    e2, z = _reproj_errors(jnp.asarray(camera.K), jnp.asarray(T_h[h]),
                           jnp.asarray(Xw), jnp.asarray(uv))
    inl = (np.asarray(e2) < cfg.ransac.reproj_threshold ** 2) & (np.asarray(z) > 0) & valid
    counts.append(inl.sum())
    E = T_cw_gt @ np.linalg.inv(T_h[h])
    c = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
    best_rot = min(best_rot, np.degrees(np.arccos(c)))
counts = np.array(counts)
print(f"DLT hypotheses: max inliers {counts.max()}, median {np.median(counts):.0f}, "
      f"n>=20: {(counts >= 20).sum()}/{len(counts)}, best rot err {best_rot:.3f} deg")
