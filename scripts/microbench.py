"""Per-stage microbenchmarks on the current JAX backend.

Times each pipeline stage in isolation (warm, block_until_ready) to locate
the hot spots. Run on the accelerator (default) or --cpu.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
parser.add_argument("--reps", type=int, default=10)
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import jax.numpy as jnp
import numpy as np

from svo_tpu.config import Config, KltParams, RansacParams
from svo_tpu.geometry import camera as cam_mod
from svo_tpu.geometry.pnp import ransac_pnp
from svo_tpu.geometry.triangulate import triangulate_dlt, triangulate_rectified
from svo_tpu.ops import detect as detect_mod
from svo_tpu.ops.fast import fast_score
from svo_tpu.ops.klt import KltTracker
from svo_tpu.ops.nms import nms3x3, suppression_mask

H, W = 376, 1241
N = 256
rng = np.random.default_rng(0)
img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
img2 = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
pos = jnp.asarray(
    np.stack(
        [rng.uniform(30, W - 30, N), rng.uniform(30, H - 30, N)], -1
    ).astype(np.float32)
)
valid = jnp.ones((N,), bool)
camera = cam_mod.from_intrinsics(718.0, 718.0, W / 2, H / 2, 0.54)
Xw = jnp.asarray(
    np.stack(
        [rng.uniform(-10, 10, N), rng.uniform(-3, 3, N), rng.uniform(5, 40, N)], -1
    ).astype(np.float32)
)
uv = jnp.asarray(rng.uniform(0, 300, (N, 2)).astype(np.float32))
uv_r = uv - 10.0
key = jax.random.PRNGKey(0)
cfg = Config(use_orb=False)
tkl = KltParams(window=21, max_level=3, max_iters=12)
skl = KltParams(window=11, max_level=3, max_iters=12)


def bench(name, fn, *a, reps=args.reps):
    out = fn(*a)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*a)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps * 1e3
    print(f"{name:38s} {dt:9.2f} ms")
    return dt


pyr_f = jax.jit(lambda im: KltTracker.build_pyramid(im, 3))
pyr1 = pyr_f(img)
pyr2 = pyr_f(img2)

bench("pyramid+grads (4 levels)", pyr_f, img)
bench(
    "KLT temporal (256 feats, 21x21, 50it)",
    jax.jit(lambda a, b, p, v: KltTracker.track(a, b, p, v, tkl)),
    pyr1, pyr2, pos, valid,
)
bench(
    "KLT stereo (256 feats, 11x11, 30it)",
    jax.jit(lambda a, b, p, v: KltTracker.track(a, b, p, v, skl)),
    pyr1, pyr2, pos, valid,
)
bench("FAST score map", jax.jit(lambda im: fast_score(im, 20.0)), img)
bench("FAST+NMS+suppress+bucket (detect)", jax.jit(
    lambda im, p, v: detect_mod.detect(im, p, v, cfg)
), img, pos, valid)
cfg_orb = Config(use_orb=True)
bench("ORB detect (8 levels)", jax.jit(
    lambda im, p, v: detect_mod.detect(im, p, v, cfg_orb)
), img, pos, valid)
bench("triangulate DLT (256)", jax.jit(
    lambda ul, ur: triangulate_dlt(camera.P_left, camera.P_right, ul, ur)
), uv, uv_r)
bench("triangulate rectified (256)", jax.jit(
    lambda ul, ur: triangulate_rectified(camera.fx, camera.baseline, ul, ur, camera.K)
), uv, uv_r)
bench("RANSAC-PnP (256 pts, 128 hyp)", jax.jit(
    lambda x, u, v, k: ransac_pnp(camera.K, x, u, v, k, RansacParams())
), Xw, uv, valid, key)

# full step
from svo_tpu.pipeline import frontend
from svo_tpu.pipeline.state import VoState
import __graft_entry__ as ge

cfg_full = Config(use_orb=False, image_height=H, image_width=W)
state = ge._example_state(cfg_full, camera)
step = jax.jit(lambda s, l, r: frontend.step_body(s, l, r, camera, cfg_full))
state = step(state, img, img2)  # compile + make state realistic-ish
bench("FULL STEP (non-KF path)", step, state, img, img2, reps=5)
