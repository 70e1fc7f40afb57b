"""Headless visualization artifacts.

The reference renders live via Pangolin + OpenCV windows (reference:
src/drawer.cpp, src/utils.cpp:19-28) — not an option on a headless accelerator host. The
equivalents here are offline artifacts: trajectory files (KITTI poses
format, plottable and eval-able), PLY point clouds of the map, and a
matplotlib top-down trajectory plot.
"""

from __future__ import annotations

import numpy as np


def save_trajectory_kitti(path: str, poses: np.ndarray) -> None:
    """Write (F,4,4) camera-to-world poses in the KITTI poses format (12
    floats per line, row-major top 3x4 — the same format parseGroundTruth
    reads, reference src/map.cpp:15-43)."""
    flat = np.asarray(poses)[:, :3, :].reshape(len(poses), 12)
    np.savetxt(path, flat, fmt="%.9e")


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write a point cloud as ASCII PLY (the reference drew map points live,
    src/drawer.cpp:29-40; this is the offline artifact)."""
    points = np.asarray(points)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            x, y, z = points[i]
            if colors is not None:
                r, g, b = colors[i]
                f.write(f"{x:.4f} {y:.4f} {z:.4f} {int(r)} {int(g)} {int(b)}\n")
            else:
                f.write(f"{x:.4f} {y:.4f} {z:.4f}\n")


def save_feature_overlay(
    path: str,
    image: np.ndarray,
    positions: np.ndarray,
    valid: np.ndarray | None = None,
    radius: int = 3,
) -> None:
    """Draw tracked features as green circles on the frame and save a PNG —
    the offline equivalent of the reference's displayPoints/imshow in the hot
    loop (src/utils.cpp:19-28, called from src/tracking.cpp:178)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(img)
    pos = np.asarray(positions)
    v = np.ones(len(pos), bool) if valid is None else np.asarray(valid)
    for (x, y), ok in zip(pos, v):
        if not ok:
            continue
        draw.ellipse(
            [x - radius, y - radius, x + radius, y + radius],
            outline=(0, 255, 0),
            width=1,
        )
    img.save(path)


def plot_trajectory(
    out_path: str,
    est_poses: np.ndarray,
    gt_poses: np.ndarray | None = None,
    title: str = "trajectory",
) -> None:
    """Top-down (x,z) trajectory plot — the offline version of the
    reference's GT-vs-estimate overlay (src/drawer.cpp:114-120)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    est = np.asarray(est_poses)[:, :3, 3]
    ax.plot(est[:, 0], est[:, 2], "b-", label="estimate", linewidth=1)
    if gt_poses is not None and len(gt_poses):
        gt = np.asarray(gt_poses)[:, :3, 3]
        ax.plot(gt[:, 0], gt[:, 2], "g-", label="ground truth", linewidth=1)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
