"""Reconcile the reference-CPU fps spread (VERDICT r04 item 10).

BENCH_r04 recorded ref_cpu_fps_single = 92.6 (97 frames) while
SOAK_REF_r04 recorded 151.3 fps (2401 frames) — the denominator of the
headline vs_baseline. This measures the same ReferenceCpuPipeline on the
same cached sequence at several lengths in one process, isolating run
length (cv2 warm-up + per-run setup amortization + keyframe-phase mix)
from machine conditions.

    python scripts/probe_ref_fps.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402  (jax must init before cv2 in this env)

jax.config.update("jax_platforms", "cpu")
_ = jax.devices()

import numpy as np  # noqa: E402

from svo_tpu.config import Config  # noqa: E402
from svo_tpu.eval.reference_cpu import ReferenceCpuPipeline  # noqa: E402
from svo_tpu.geometry import camera as cam_mod  # noqa: E402
from svo_tpu.io.synthetic import SyntheticSequence  # noqa: E402

SHAPE = (376, 1241)
H, W = SHAPE
FX = 718.856
N = 961

d = f"/tmp/svo_cache/soak_{N}"
os.makedirs(d, exist_ok=True)
lf, rf = os.path.join(d, "l.u8"), os.path.join(d, "r.u8")
seq = SyntheticSequence(n_frames=N, shape=SHAPE, fx=FX, speed=0.3)
if not os.path.exists(rf) or os.path.getsize(lf) != N * H * W:
    ls = np.memmap(lf, np.uint8, "w+", shape=(N, H, W))
    rs = np.memmap(rf, np.uint8, "w+", shape=(N, H, W))
    t0 = time.perf_counter()
    for i in range(N):
        l, r = seq.frame(i)
        ls[i] = np.clip(l, 0, 255)
        rs[i] = np.clip(r, 0, 255)
    ls.flush(); rs.flush()
    print(f"rendered {N} frames in {time.perf_counter()-t0:.0f}s",
          file=sys.stderr)
ls = np.memmap(lf, np.uint8, "r", shape=(N, H, W))
rs = np.memmap(rf, np.uint8, "r", shape=(N, H, W))

cfg = Config(use_orb=False, image_height=H, image_width=W)
camera = cam_mod.from_intrinsics(FX, FX, W / 2, H / 2, seq.baseline)

for n in (97, 97, 481, 961):  # first 97 twice: cold vs warm cv2
    frames = [(i, ls[i].astype(np.float32), rs[i].astype(np.float32))
              for i in range(n)]
    ref = ReferenceCpuPipeline(
        cfg, np.asarray(camera.K), np.asarray(camera.P_left),
        np.asarray(camera.P_right),
    )
    _, wall, fps = ref.run(frames)
    print(f"n={n:4d}: {fps:7.2f} fps  ({wall:.2f}s)", flush=True)
