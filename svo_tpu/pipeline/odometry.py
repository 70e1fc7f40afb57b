"""Host-side odometry driver: the sequential frame loop.

The reference drives the loop from Tracking::startStereo
(src/tracking.cpp:232-276) with 4 host threads; here the host only streams
images to the device and the whole per-frame computation is one jitted call
(latency-bound by design — SURVEY.md §7 hard-part #4 — so the host work per
frame is just an async dispatch; device_put of frame t+1 overlaps the device
compute of frame t).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from svo_tpu.config import Config
from svo_tpu.geometry.camera import Camera
from svo_tpu.pipeline import frontend
from svo_tpu.pipeline.state import VoState


@dataclass
class RunResult:
    poses: np.ndarray       # (F, 4, 4) camera-to-world trajectory
    kf_flags: np.ndarray    # (F,) bool
    metrics: np.ndarray     # (F, 5)
    n_frames: int
    total_time_s: float
    fps: float
    map_points: np.ndarray | None = None
    per_frame_ms: list = field(default_factory=list)


class StereoVO:
    """Stereo visual odometry engine (the Tracking+Map pair of the
    reference, as one functional pipeline)."""

    def __init__(
        self,
        config: Config,
        camera: Camera,
        seed: int = 0,
        chunk: int = 0,
        kf_cadence: int = 0,
    ):
        """kf_cadence > 0 switches the chunked path to the static keyframe
        cadence (frontend.make_cadenced_chunk_step): replenish every
        `kf_cadence` frames as program structure instead of a data-dependent
        lax.cond. 0 keeps the reference's dynamic rule in the chunk scan."""
        self.cfg = config
        self.camera = camera
        self.seed = seed
        self.chunk = chunk
        self.kf_cadence = kf_cadence
        self._step = frontend.make_step(camera, config)
        self._bootstrap = frontend.make_bootstrap(camera, config)
        if chunk and kf_cadence:
            assert chunk % kf_cadence == 0, "chunk must be a multiple of kf_cadence"
            self._chunk_step = frontend.make_cadenced_chunk_step(
                camera, config, chunk, kf_cadence
            )
        elif chunk:
            self._chunk_step = frontend.make_chunked_step(camera, config, chunk)
        else:
            self._chunk_step = None
        self.state: VoState | None = None

    def _prep(self, img: np.ndarray) -> jnp.ndarray:
        """Pad/crop to the configured static shape and move to device."""
        H, W = self.cfg.image_height, self.cfg.image_width
        h, w = img.shape
        if (h, w) != (H, W):
            out = np.zeros((H, W), np.float32)
            out[: min(h, H), : min(w, W)] = img[:H, :W]
            img = out
        return jax.device_put(jnp.asarray(img, jnp.float32))

    def start(self, left: np.ndarray, right: np.ndarray) -> None:
        self.state = self._bootstrap(
            self._prep(left), self._prep(right), jnp.uint32(self.seed)
        )

    def process(self, left: np.ndarray, right: np.ndarray) -> None:
        assert self.state is not None, "call start() first"
        self.state = self._step(self.state, self._prep(left), self._prep(right))

    def run(
        self,
        frames: Iterable[tuple[int, np.ndarray, np.ndarray]],
        verbose: bool = False,
        time_per_frame: bool = False,
    ) -> RunResult:
        """Drive a whole sequence. `frames` yields (idx, left, right).

        With verbose=True, prints the reference's per-frame log line
        (id | MPs | time | features | inlier ratio | KF —
        reference src/tracking.cpp:261-266); this forces a device sync per
        frame and slows the run, exactly like the reference's in-loop GUI+
        printf did."""
        it = iter(frames)
        try:
            _, left, right = next(it)
        except StopIteration:
            raise ValueError("empty sequence")
        self.start(left, right)
        n = 1
        per_frame_ms = []
        t0 = time.perf_counter()
        for _, left, right in it:
            if time_per_frame:
                ts = time.perf_counter()
            self.process(left, right)
            if verbose or time_per_frame:
                jax.block_until_ready(self.state.pose)
            if time_per_frame:
                per_frame_ms.append((time.perf_counter() - ts) * 1e3)
            if verbose:
                m = np.asarray(self.state.metrics[n])
                print(
                    f"{n:4d} | MPs: {int(m[4]):6d} | Features: {int(m[2]):4d} "
                    f"| IR: {m[1] * 100:.2f}% |{' KF' if m[3] else ''}"
                )
            n += 1
        jax.block_until_ready(self.state.pose)
        total = time.perf_counter() - t0
        return self.finish(n, total, per_frame_ms)

    def run_chunked(
        self,
        frames: list[tuple[int, np.ndarray, np.ndarray]],
        preload: bool = False,
    ) -> RunResult:
        """Drive a sequence in device-resident chunks: one jitted
        scan-over-frames dispatch per `chunk` frames, images shipped as uint8.
        Amortizes host->device dispatch latency (the whole point of the
        device-resident design — no per-frame host sync).

        preload=True stages every chunk on device before the timed loop —
        isolates device compute from transfer (bench mode; in production the
        async loader overlaps transfer with compute the same way)."""
        assert self._chunk_step is not None, "construct with chunk>0"
        K = self.chunk
        H, W = self.cfg.image_height, self.cfg.image_width

        def to_u8(img):
            h, w = img.shape
            if (h, w) != (H, W):
                out = np.zeros((H, W), np.uint8)
                out[: min(h, H), : min(w, W)] = img[:H, :W].astype(np.uint8)
                return out
            return np.clip(img, 0, 255).astype(np.uint8)

        _, l0, r0 = frames[0]
        rest = frames[1:]
        n_chunks = len(rest) // K
        chunks = []
        for c0 in range(0, n_chunks * K, K):
            chunk = rest[c0 : c0 + K]
            lefts = np.stack([to_u8(l) for _, l, _ in chunk])
            rights = np.stack([to_u8(r) for _, _, r in chunk])
            if preload:
                chunks.append(
                    (jax.device_put(lefts), jax.device_put(rights))
                )
            else:
                chunks.append((lefts, rights))
        if preload:
            jax.block_until_ready(chunks)

        self.start(l0, r0)
        jax.block_until_ready(self.state.pose)
        t0 = time.perf_counter()
        for lefts, rights in chunks:
            self.state = self._chunk_step(
                self.state, jnp.asarray(lefts), jnp.asarray(rights)
            )
        # Tail frames one by one. NOTE: the single-frame step is a separate
        # program — the FIRST tail frame ever processed triggers one extra
        # jit compile (subsequent runs reuse it). Size sequences as
        # 1 + k*chunk to avoid the tail entirely in latency-sensitive runs.
        tail = rest[n_chunks * K:]
        if tail and not getattr(self, "_tail_warned", False):
            self._tail_warned = True
            import sys
            print(
                f"[svo_tpu] run_chunked: {len(tail)} tail frame(s) fall back "
                f"to the single-frame step (one-time extra compile)",
                file=sys.stderr,
            )
        for _, left, right in tail:
            self.process(left, right)
        jax.block_until_ready(self.state.pose)
        total = time.perf_counter() - t0
        return self.finish(len(frames), total)

    def finish(self, n: int, total_s: float, per_frame_ms=None) -> RunResult:
        st = self.state
        return RunResult(
            poses=np.asarray(st.poses[:n]),
            kf_flags=np.asarray(st.kf_flags[:n]),
            metrics=np.asarray(st.metrics[:n]),
            n_frames=n,
            total_time_s=total_s,
            fps=(n - 1) / total_s if total_s > 0 else 0.0,
            map_points=np.asarray(st.map.points[: int(st.map.n_points)]),
            per_frame_ms=per_frame_ms or [],
        )
