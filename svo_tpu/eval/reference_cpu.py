"""Reference-equivalent CPU pipeline (OpenCV), used ONLY as the benchmark
baseline and accuracy bound.

The reference publishes no numbers (BASELINE.md), so the 5x frames/s target
needs a measured denominator: this is a faithful Python re-statement of the
reference's algorithm with the same OpenCV kernels and parameters it calls —
ORB/FAST detect with rectangle mask (src/tracking.cpp:34-92), PyrLK stereo
match with y-gate (src/tracking.cpp:94-118), cv2.triangulatePoints + z>0
(src/tracking.cpp:120-152), PyrLK temporal tracking (src/tracking.cpp:154-179),
solvePnPRansac(SQPNP) + inversion + outlier removal (src/tracking.cpp:181-230),
and the keyframe policy (src/tracking.cpp:61-72). Not part of the
framework's device compute path.
"""

from __future__ import annotations

import time

import numpy as np

from svo_tpu.config import Config


class ReferenceCpuPipeline:
    def __init__(self, cfg: Config, K: np.ndarray, P_left: np.ndarray, P_right: np.ndarray):
        import cv2  # deferred: jax must initialize before cv2 in this env

        self.cv2 = cv2
        self.cfg = cfg
        self.K = np.asarray(K, np.float64)
        self.P_left = np.asarray(P_left, np.float64)
        self.P_right = np.asarray(P_right, np.float64)
        if cfg.use_orb:
            op = cfg.orb_params
            self.detector = cv2.ORB_create(
                nfeatures=op.nfeatures,
                scaleFactor=op.scale_factor,
                nlevels=op.pyr_levels,
                edgeThreshold=op.patch_size,
                firstLevel=0,
                WTA_K=4,
                scoreType=cv2.ORB_HARRIS_SCORE,
                patchSize=op.patch_size,
                fastThreshold=op.fast_treshold,
            )
        else:
            self.detector = cv2.FastFeatureDetector_create(
                cfg.fast_params.threshold, cfg.fast_params.nonMaxSuppression
            )
        # state
        self.prev_left: np.ndarray | None = None
        self.prev_pts: np.ndarray = np.zeros((0, 2), np.float32)
        self.prev_world: np.ndarray = np.zeros((0, 3), np.float64)
        self.prev_is_kf = False
        self.pose = np.eye(4)
        self.poses: list[np.ndarray] = []
        self.n_map_points = 0

    # -- extractFeatures + findLeftFeaturesInRight + triangulateNewMapPoints --
    def _replenish(self, left: np.ndarray, right: np.ndarray, pose: np.ndarray):
        cv2 = self.cv2
        mask = np.full(left.shape, 255, np.uint8)
        for x, y in self.prev_pts:
            cv2.rectangle(
                mask,
                (int(x) - 10, int(y) - 10),
                (int(x) + 10, int(y) + 10),
                0,
                cv2.FILLED,
            )
        kps = self.detector.detect(left, mask)
        if not kps:
            return np.zeros((0, 2), np.float32), np.zeros((0, 3), np.float64)
        pts = np.array([kp.pt for kp in kps], np.float32)

        rpts, st, _ = cv2.calcOpticalFlowPyrLK(
            left, right, pts, None,
            winSize=(11, 11), maxLevel=3,
            criteria=(cv2.TERM_CRITERIA_COUNT + cv2.TERM_CRITERIA_EPS, 30, 0.001),
        )
        st = st[:, 0].astype(bool)
        st &= np.abs(rpts[:, 1] - pts[:, 1]) < self.cfg.tracking.y_threshold
        pts, rpts = pts[st], rpts[st]
        if len(pts) == 0:
            return np.zeros((0, 2), np.float32), np.zeros((0, 3), np.float64)

        Xh = cv2.triangulatePoints(self.P_left, self.P_right, pts.T, rpts.T)
        Xc = (Xh[:3] / Xh[3]).T
        keep = Xc[:, 2] > 0
        pts, Xc = pts[keep], Xc[keep]
        Xw = (pose[:3, :3] @ Xc.T).T + pose[:3, 3]
        self.n_map_points += len(Xw)
        return pts, Xw

    def process(self, left: np.ndarray, right: np.ndarray):
        cv2 = self.cv2
        left = left.astype(np.uint8)
        right = right.astype(np.uint8)
        if self.prev_left is None:  # bootstrap (tracking.cpp:233-235)
            pts, Xw = self._replenish(left, right, self.pose)
            self.prev_pts, self.prev_world = pts, Xw
            self.prev_is_kf = True
            self.prev_left = left
            self.poses.append(self.pose.copy())
            return

        is_kf = (not self.prev_is_kf) and (
            len(self.prev_pts) < self.cfg.tracking.features_to_track
        )

        # temporal tracking
        if len(self.prev_pts) >= 6:
            cpts, st, _ = cv2.calcOpticalFlowPyrLK(
                self.prev_left, left, self.prev_pts, None,
                winSize=(21, 21), maxLevel=3,
                criteria=(cv2.TERM_CRITERIA_COUNT + cv2.TERM_CRITERIA_EPS, 50, 0.001),
                flags=cv2.OPTFLOW_LK_GET_MIN_EIGENVALS,
            )
            st = st[:, 0].astype(bool)
            pts, Xw = cpts[st], self.prev_world[st]
        else:
            pts, Xw = np.zeros((0, 2), np.float32), np.zeros((0, 3), np.float64)

        # PnP
        if len(pts) >= 6:
            ok, rvec, tvec, inl = cv2.solvePnPRansac(
                Xw, pts.astype(np.float64), self.K, np.zeros(4),
                iterationsCount=100, reprojectionError=8.0, confidence=0.999,
                flags=cv2.SOLVEPNP_SQPNP,
            )
            if ok and inl is not None and len(inl) >= 6:
                R, _ = cv2.Rodrigues(rvec)
                T = np.eye(4)
                T[:3, :3] = R
                T[:3, 3] = tvec[:, 0]
                self.pose = np.linalg.inv(T)
                keep = np.zeros(len(pts), bool)
                keep[inl[:, 0]] = True
                pts, Xw = pts[keep], Xw[keep]

        if is_kf:
            npts, nXw = self._replenish(left, right, self.pose)
            if len(npts):
                pts = np.concatenate([pts, npts])
                Xw = np.concatenate([Xw, nXw])

        self.prev_pts, self.prev_world = pts, Xw
        self.prev_is_kf = is_kf
        self.prev_left = left
        self.poses.append(self.pose.copy())

    def run(self, frames) -> tuple[np.ndarray, float, float]:
        """Returns (poses (F,4,4), wall seconds, fps)."""
        t0 = time.perf_counter()
        for _, left, right in frames:
            self.process(left, right)
        wall = time.perf_counter() - t0
        n = len(self.poses)
        return np.stack(self.poses), wall, (n / wall if wall > 0 else 0.0)
