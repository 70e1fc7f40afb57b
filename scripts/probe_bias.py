"""Direct measurement of front-end measurement bias against analytic GT.

The soak drifts with a constant pitch bias (~-0.003 deg/frame) and a scale
bias (~+0.6%) that survive every config knob — so measure the raw signals
instead of tuning blind. The synthetic world is 3 planes: every pixel's GT
depth (and hence GT temporal flow and GT disparity) has a closed form.
This probe renders consecutive frames, runs the real trackers, and reports
flow / disparity error statistics split by image region.

    python scripts/probe_bias.py             # accelerator
    python scripts/probe_bias.py --cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--frame", type=int, default=100)
parser.add_argument("--n", type=int, default=40, help="frame pairs to average")
parser.add_argument("--tracker", type=str, default="ours",
                    choices=["ours", "cv2"])
parser.add_argument("--gap", type=int, default=1,
                    help="frame gap: 1 = chained-style step, 6 = one "
                         "anchored generation")
parser.add_argument("--seeded", action="store_true",
                    help="seed tracking with GT flow + U(-0.5,0.5) px — "
                         "the anchored pipeline's accumulated-flow seed")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence, default_world  # noqa: E402
from svo_tpu.ops.klt import KltTracker  # noqa: E402

shape = (376, 1241)
seq = SyntheticSequence(n_frames=args.frame + args.n + args.gap + 2, shape=shape,
                        fx=718.856, speed=0.3)
cfg = Config(use_orb=False, image_height=shape[0], image_width=shape[1])
K = seq.K
fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
b = seq.baseline


def gt_depth_points(T_wc, uv):
    """Closed-form GT 3-D points (world) for pixels uv under pose T_wc."""
    dirs_cam = np.stack(
        [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, np.ones(len(uv))], -1
    )
    R = T_wc[:3, :3]
    o = T_wc[:3, 3]
    dirs = dirs_cam @ R.T
    best_t = np.full(len(uv), np.inf)
    for pl in seq.planes:
        denom = dirs @ pl.n
        num = (pl.p - o) @ pl.n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        hit = (t > 0.1) & (t < best_t) & (np.abs(denom) > 1e-9)
        best_t = np.where(hit, t, best_t)
    return o + dirs * best_t[:, None], best_t


def project(T_wc, X):
    T_cw = np.linalg.inv(T_wc)
    Xc = X @ T_cw[:3, :3].T + T_cw[:3, 3]
    return np.stack(
        [fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], -1
    ), Xc[:, 2]


# feature grid over the image (margin away from borders)
H, W = shape
gx_, gy_ = np.meshgrid(np.arange(60, W - 60, 40), np.arange(30, H - 30, 20))
uv0 = np.stack([gx_.ravel(), gy_.ravel()], -1).astype(np.float32)
N = len(uv0)
print(f"{N} grid features, averaging {args.n} frame pairs", file=sys.stderr)

terr = np.zeros((0, 2))
tmask = np.zeros((0,), bool)
tuv = np.zeros((0, 2))
tgtf = np.zeros((0, 2))
tz = np.zeros((0,))
derr_all, dmask, duv, dz = (np.zeros((0,)), np.zeros((0,), bool),
                            np.zeros((0, 2)), np.zeros((0,)))
for k in range(args.n):
    f0 = args.frame + k
    T0, T1 = seq.gt_poses[f0], seq.gt_poses[f0 + args.gap]
    l0, r0 = seq.frame(f0)
    l1, _ = seq.frame(f0 + args.gap)

    X, depth = gt_depth_points(T0, uv0)
    finite = np.isfinite(depth)
    uv1_gt, z1 = project(T1, X)
    gt_flow = uv1_gt - uv0

    if args.tracker == "cv2":
        import cv2

        def cvt(p0i, p1i, pts, win, lvl, iters):
            p1o, st, _ = cv2.calcOpticalFlowPyrLK(
                np.clip(p0i, 0, 255).astype(np.uint8),
                np.clip(p1i, 0, 255).astype(np.uint8),
                pts.reshape(-1, 1, 2), None, winSize=(win, win),
                maxLevel=lvl,
                criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                          iters, 1e-3),
            )
            return p1o.reshape(-1, 2), st.ravel() > 0

        pos_t, st_t = cvt(l0, l1, uv0, 21, 3, 50)
        flow = pos_t - uv0
        ok = st_t & finite & (np.abs(gt_flow) < 30).all(-1)
    else:
        seed_rng = np.random.default_rng(1000 + k)
        init = None
        if args.seeded:
            init = jnp.asarray(
                np.nan_to_num(gt_flow)
                + seed_rng.uniform(-0.5, 0.5, gt_flow.shape),
                jnp.float32,
            )
        p0 = KltTracker.build_pyramid(jnp.asarray(l0, jnp.float32),
                                      cfg.temporal_klt.max_level)
        p1 = KltTracker.build_pyramid(jnp.asarray(l1, jnp.float32),
                                      cfg.temporal_klt.max_level)
        res = KltTracker.track(p0, p1, jnp.asarray(uv0), jnp.asarray(finite),
                               cfg.temporal_klt, init_flow=init)
        flow = np.asarray(res.pos) - uv0
        ok = np.asarray(res.status) & finite & (np.abs(gt_flow) < 30).all(-1)
        if args.seeded:
            # fb-style sanity: kill tracks that ran away from the seed
            ok = ok & (np.abs(flow - np.nan_to_num(gt_flow)).max(-1) < 3.0)
    terr = np.concatenate([terr, (flow - gt_flow)[ok]])
    tuv = np.concatenate([tuv, uv0[ok]])
    tgtf = np.concatenate([tgtf, gt_flow[ok]])
    tz = np.concatenate([tz, z1[ok]])

    # stereo disparity
    if args.tracker == "cv2":
        pos_s, st_s = cvt(l0, r0, uv0, 11, 3, 30)
        spos = pos_s
        sst = st_s
    else:
        pr = KltTracker.build_pyramid(jnp.asarray(r0, jnp.float32),
                                      cfg.stereo_klt.max_level)
        sres = KltTracker.track(p0, pr, jnp.asarray(uv0),
                                jnp.asarray(finite), cfg.stereo_klt)
        spos = np.asarray(sres.pos)
        sst = np.asarray(sres.status)
    T_cw0 = np.linalg.inv(T0)
    z0 = (X @ T_cw0[:3, :3].T + T_cw0[:3, 3])[:, 2]
    gt_disp = fx * b / z0
    disp = uv0[:, 0] - spos[:, 0]
    sok = sst & finite & (gt_disp > 0.5)
    derr_all = np.concatenate([derr_all, (disp - gt_disp)[sok]])
    duv = np.concatenate([duv, uv0[sok]])
    dz = np.concatenate([dz, z0[sok]])


def region_stats(uv, err, name):
    rows = []
    for rname, m in [
        ("ground (v>cy+40)", uv[:, 1] > cy + 40),
        ("mid band", np.abs(uv[:, 1] - cy) <= 40),
        ("sky/top (v<cy-40)", uv[:, 1] < cy - 40),
        ("all", np.ones(len(uv), bool)),
    ]:
        if m.sum() == 0:
            continue
        e = err[m]
        if e.ndim == 2:
            rows.append(f"  {name} {rname:18s} n={m.sum():5d} "
                        f"mean_du={e[:, 0].mean():+.4f} "
                        f"mean_dv={e[:, 1].mean():+.4f} "
                        f"std=({e[:, 0].std():.3f},{e[:, 1].std():.3f})")
        else:
            rows.append(f"  {name} {rname:18s} n={m.sum():5d} "
                        f"mean={e.mean():+.4f} std={e.std():.3f}")
    print("\n".join(rows))


print(f"TEMPORAL flow error (px), {len(terr)} tracks:")
region_stats(tuv, terr, "flow")
# v-flow error vs gt v-flow magnitude (is the bias proportional to flow?)
for lo, hi in [(0, 1), (1, 3), (3, 8), (8, 30)]:
    m = (np.abs(tgtf[:, 1]) >= lo) & (np.abs(tgtf[:, 1]) < hi)
    if m.sum():
        print(f"  |gt_dv| in [{lo},{hi}): n={m.sum():5d} "
              f"mean_dv_err={terr[m, 1].mean():+.4f} "
              f"rel={terr[m, 1].mean() / max(np.abs(tgtf[m, 1]).mean(), 1e-9):+.4f}")

# radial flow error about the FOE (pure-forward approx: FOE ~ principal pt)
c2 = np.array([cx, cy])
rvec = tuv - c2
rn = np.linalg.norm(rvec, axis=1) + 1e-9
radial = np.sum(terr * rvec, axis=1) / rn
for lo, hi in [(0, 10), (10, 20), (20, 40), (40, 100)]:
    m = (tz >= lo) & (tz < hi)
    if m.sum():
        print(f"  temporal radial err, depth [{lo},{hi}): n={m.sum():5d} "
              f"mean={radial[m].mean():+.4f} px dv={terr[m,1].mean():+.4f}")

print(f"STEREO disparity error (px), {len(derr_all)} matches "
      f"(positive = disparity overestimated = depth underestimated):")
region_stats(duv, derr_all, "disp")
for lo, hi in [(0, 10), (10, 20), (20, 40), (40, 100)]:
    m = (dz >= lo) & (dz < hi)
    if m.sum():
        print(f"  depth [{lo},{hi}) m: n={m.sum():5d} "
              f"mean_disp_err={derr_all[m].mean():+.4f} px "
              f"-> depth bias {-(derr_all[m].mean()) / (fx * b / np.maximum(dz[m].mean(), 1e-9)) * 100:+.2f}%")
