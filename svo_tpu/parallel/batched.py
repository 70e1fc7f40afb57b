"""Single-chip multi-stream VO: vmap the whole frame step over S streams.

The VO frame loop is latency-bound (SURVEY.md §7 hard-part #4): one stream
leaves the device idle between tiny kernels. The answer to throughput is
batching, not threads — `jax.vmap` of the full per-frame step over S
independent sequences turns every per-feature op into an (S*N)-row op (the
KLT normal equations, bilinear-blend matmuls, PnP hypothesis scoring all get
wider and fill the device), while `lax.scan` over a chunk of frames
amortizes dispatch. This is the one-chip analogue of parallel/multi_seq.py
(which gives each device of a mesh its own stream); production serving runs
batched streams per chip x streams per device mesh-wide.

Keyframing in the chunked path is STATICALLY CADENCED
(frontend.make_cadenced_chunk_step): under vmap a data-dependent keyframe
`lax.cond` lowers to both-branches + select, so every stream would pay dense
detection + stereo KLT + triangulation on every frame — the round-1 batched
mode lost to a single stream exactly this way. With the static cadence the
replenish program exists only in 1-in-cadence steps and the track-only steps
carry no detection code at all. The per-frame `process` path keeps the
reference's dynamic rule for parity testing.

Reference mapping: this subsumes running S copies of the reference binary
(src/main.cpp:38-53) — one process per KITTI sequence — on S cores; here the
streams share one compiled program and one chip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from svo_tpu.config import Config
from svo_tpu.geometry.camera import Camera
from svo_tpu.pipeline import frontend


class BatchedStereoVO:
    """S independent VO streams on ONE device, stepped in lockstep.

    All streams share one static Config and one camera (KITTI sequences of
    the same image geometry); state is a pytree with a leading (S,) axis.

    Args:
        chunk: frames per chunked dispatch (process_chunk input length);
            must be a multiple of kf_cadence. 0 picks 2 cadences.
        kf_cadence: static keyframe period for the chunked path (must divide
            chunk). 0 picks cfg.tracking.kf_max_interval (or 4 if that is 0).
    """

    def __init__(
        self,
        cfg: Config,
        camera: Camera,
        n_streams: int,
        chunk: int = 0,
        kf_cadence: int = 0,
    ):
        self.cfg = cfg
        self.camera = camera
        self.S = n_streams
        if kf_cadence <= 0:
            kf_cadence = cfg.tracking.kf_max_interval or 4
        if chunk <= 0:
            chunk = 2 * kf_cadence
        if chunk % kf_cadence != 0:
            raise ValueError(
                f"chunk ({chunk}) must be a multiple of kf_cadence "
                f"({kf_cadence}) — callers pre-slice frames to the chunk "
                f"size, so silently adjusting it would surface later as a "
                f"confusing shape error in process_chunk"
            )
        self.chunk = chunk
        self.kf_cadence = kf_cadence
        self.state = None

        boot = frontend.make_bootstrap(camera, cfg)
        self._boot = jax.jit(jax.vmap(boot))

        self._chunk_step = frontend.make_cadenced_chunk_step(
            camera, cfg, chunk, kf_cadence, n_streams=n_streams
        )

        # per-frame dynamic-rule step (parity with the reference policy;
        # slow under vmap — both cond branches execute)
        def step_one(st, l, r):
            return frontend.step_body(
                st, l.astype(jnp.float32), r.astype(jnp.float32), camera, cfg
            )

        @partial(jax.jit, donate_argnums=(0,))
        def step(state, lefts, rights):
            return jax.vmap(step_one)(state, lefts, rights)

        self._step = step

    # -- driving --------------------------------------------------------

    def _check_shape(self, arr, name, frame_major: bool):
        H, W = self.cfg.image_height, self.cfg.image_width
        want = (self.chunk, self.S, H, W) if frame_major else (self.S, H, W)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"{name}: expected shape {want} "
                f"({'(K,S,H,W) frame-major' if frame_major else '(S,H,W)'}), "
                f"got {tuple(arr.shape)}"
            )

    def start(self, lefts: np.ndarray, rights: np.ndarray, seed: int = 0):
        """lefts/rights: (S, H, W) first frame of each stream."""
        self._check_shape(lefts, "lefts", False)
        self._check_shape(rights, "rights", False)
        seeds = jnp.arange(self.S, dtype=jnp.uint32) + jnp.uint32(seed)
        self.state = self._boot(
            jnp.asarray(lefts, jnp.float32), jnp.asarray(rights, jnp.float32), seeds
        )

    def process(self, lefts: np.ndarray, rights: np.ndarray):
        """One frame for every stream: (S, H, W). Dynamic keyframe rule."""
        self._check_shape(lefts, "lefts", False)
        self._check_shape(rights, "rights", False)
        self.state = self._step(
            self.state,
            jnp.asarray(lefts, jnp.float32),
            jnp.asarray(rights, jnp.float32),
        )

    def process_chunk(self, lefts_u8, rights_u8):
        """A chunk of frames for every stream: (chunk, S, H, W) uint8 arrays
        (device-resident or host; uint8 keeps host->device traffic 4x down).
        Keyframes on the static cadence (see class docstring)."""
        self._check_shape(lefts_u8, "lefts_u8", True)
        self._check_shape(rights_u8, "rights_u8", True)
        self.state = self._chunk_step(
            self.state, jnp.asarray(lefts_u8), jnp.asarray(rights_u8)
        )

    def trajectories(self, n_frames: int) -> np.ndarray:
        """(S, n_frames, 4, 4) camera-to-world trajectories."""
        return np.asarray(self.state.poses[:, :n_frames])

    # -- global refinement (the reference's empty back-end thread,
    #    src/map.cpp:84-88, run periodically between chunks) --------------

    def make_refiner(
        self,
        n_blocks: int = 4,
        cams_per_block: int = 7,
        n_points: int = 512,
        n_obs: int = 2048,
        ba_iterations: int = 12,
        pg_iterations: int = 10,
    ):
        # defaults match refine_global's (span 22, 8 alternation rounds):
        # validated by the r04/r05 soak artifacts (SOAK_r04: 0.120% of
        # traveled with refine vs 0.128% without, at these defaults) — the
        # previous wider-span/fewer-iterations combination degraded short
        # spans
        """Build the jitted per-stream global refiner: keyframe-block BA +
        pose-graph consensus (parallel/global_opt.refine_global) vmapped over
        the S streams, updating poses, map points, AND the recursive current
        pose so the correction feeds back into subsequent tracking. Call
        refine() every few chunks; the span covered is
        (n_blocks-1)*(cams_per_block-2)+cams_per_block frames."""
        from svo_tpu.parallel.global_opt import refine_global

        K_mat = jnp.asarray(self.camera.K)
        bfx = jnp.float32(self.camera.K[0, 0] * self.camera.baseline)

        def one(mp, poses, fid):
            return refine_global(
                mp, poses, fid, K_mat, bfx,
                n_blocks=n_blocks, cams_per_block=cams_per_block,
                n_points=n_points, n_obs=n_obs,
                ba_iterations=ba_iterations, pg_iterations=pg_iterations,
            )

        # lax.map, not vmap: under vmap the refine's lax.cond(aggressive)
        # lowers to both-branches+select, so every stream pays the block-BA
        # recovery machinery on every sweep even when all spans are
        # healthy. lax.map runs the streams sequentially and each stream's
        # cond actually SKIPS the aggressive branch. SVO_TPU_REFINE_VMAP=1
        # restores vmap.
        import os as _os

        _mapper = (
            jax.vmap if _os.environ.get("SVO_TPU_REFINE_VMAP") else
            (lambda f: (lambda *a: jax.lax.map(lambda t: f(*t), a)))
        )

        @partial(jax.jit, donate_argnums=(0,))
        def _refine(state):
            res = _mapper(one)(state.map, state.poses, state.frame_id)
            pose = jax.vmap(lambda P, f: P[f])(res.poses, state.frame_id)
            new_state = state._replace(
                map=state.map._replace(points=res.map.points),
                poses=res.poses,
                pose=pose,
            )
            return new_state, res.accepted

        self._refine = _refine
        return _refine

    def refine(self) -> np.ndarray:
        """Run one global-refinement sweep on every stream's trailing span.
        Returns the per-stream acceptance verdicts (the span-cost gate)."""
        if not hasattr(self, "_refine"):
            self.make_refiner()
        self.state, accepted = self._refine(self.state)
        return np.asarray(accepted)
