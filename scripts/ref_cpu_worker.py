"""Standalone reference-CPU pipeline worker for bench.py's matched-aggregate
measurement.

Runs in a FRESH interpreter (bench.py cannot fork: the device client's
threads make fork unsafe): loads the u8 frame stack from an .npz, runs the
OpenCV reference-equivalent pipeline once, prints
"<n_frames> <wall_seconds>". It computes nothing with jax; bench.py starts
it with JAX_PLATFORMS=cpu so that the package import never opens the
accelerator.
"""

import sys

import numpy as np


def main():
    path = sys.argv[1]
    import cv2

    cv2.setNumThreads(1)
    z = np.load(path)
    lefts, rights = z["lefts"], z["rights"]
    K, P_left, P_right = z["K"], z["P_left"], z["P_right"]

    sys.path.insert(0, z["repo"].item())
    from svo_tpu.config import Config
    from svo_tpu.eval.reference_cpu import ReferenceCpuPipeline

    cfg = Config(
        use_orb=bool(z["use_orb"]),
        image_height=lefts.shape[1],
        image_width=lefts.shape[2],
    )
    ref = ReferenceCpuPipeline(cfg, K, P_left, P_right)
    frames = [
        (i, lefts[i].astype(np.float32), rights[i].astype(np.float32))
        for i in range(lefts.shape[0])
    ]
    poses, wall, fps = ref.run(frames)
    print(f"{len(poses)} {wall:.6f}")


if __name__ == "__main__":
    main()
