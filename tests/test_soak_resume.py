"""Long-run semantics: observation-ring wraparound and chunked-path
checkpoint/resume equivalence (VERDICT round-2 items 5 / §5 failure
recovery).

The full KITTI-scale soak (2000+ frames, capacity high-water marks) runs on
the accelerator via scripts/soak.py; these tests force the same lifecycle events at CPU
scale — a deliberately tiny observation ring that wraps several times, and a
mid-run checkpoint restored into a FRESH engine instance (fresh jit
closures, the in-process equivalent of a new process) that must continue
bit-compatibly with the uninterrupted run.
"""

import jax
import numpy as np

from svo_tpu.ba.window import extract_window
from svo_tpu.config import BaParams, Config
from svo_tpu.eval.trajectory import ate_rmse
from svo_tpu.geometry import camera as cam_mod
from svo_tpu.io.synthetic import SyntheticSequence
from svo_tpu.pipeline.odometry import StereoVO
from svo_tpu.utils import checkpoint

SHAPE = (184, 320)


def _setup(n_frames, ring_obs=32768):
    seq = SyntheticSequence(n_frames=n_frames, shape=SHAPE, fx=200.0, speed=0.25)
    cfg = Config(
        use_orb=False, image_height=SHAPE[0], image_width=SHAPE[1],
        ba=BaParams(ring_obs=ring_obs),
    )
    camera = cam_mod.from_intrinsics(
        seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], seq.baseline
    )
    return seq, cfg, camera


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def _chunks(frames, chunk):
    rest = frames[1:]
    for c0 in range(0, (len(rest) // chunk) * chunk, chunk):
        ch = rest[c0 : c0 + chunk]
        yield (
            np.stack([_u8(l) for _, l, _ in ch]),
            np.stack([_u8(r) for _, _, r in ch]),
        )


def test_obs_ring_wraparound_keeps_window_consistent():
    """Run enough frames that the COO observation ring wraps several times;
    the window extraction must still return only in-window rows and the
    trajectory must stay within the accuracy band."""
    n = 25
    seq, cfg, camera = _setup(n, ring_obs=1024)
    vo = StereoVO(cfg, camera)
    frames = list(seq)
    vo.start(frames[0][1], frames[0][2])
    for _, l, r in frames[1:]:
        vo.process(l, r)
    st = vo.state
    cursor = int(st.map.obs_cursor)
    assert cursor > 2 * 1024, f"ring did not wrap: cursor={cursor}"

    fid = int(st.frame_id)
    problem, mapping = extract_window(
        st.map, st.poses, st.frame_id, n_cams=6, n_points=512, n_obs=1024
    )
    ov = np.asarray(problem.obs_valid)
    assert ov.any(), "window extraction found nothing after wraparound"
    # every selected row's frame id must be inside [fid-5, fid]
    cams = np.asarray(problem.obs_cam)[ov]
    lo = int(mapping.frame_lo)
    assert lo == fid - 5
    assert cams.min() >= 0 and cams.max() <= 5
    # the wrapped ring must not have destroyed tracking accuracy
    traveled = np.linalg.norm(
        np.diff(seq.gt_poses[:n, :3, 3], axis=0), axis=1
    ).sum()
    ate = ate_rmse(np.asarray(st.poses[:n]), seq.gt_poses[:n])
    assert ate < 0.05 * traveled, f"ATE {ate:.3f} over {traveled:.1f} m"


def test_chunked_resume_equivalence(tmp_path):
    """Save after the 2nd chunk, restore into a FRESH engine, continue with
    the remaining chunks: the trajectory must match the uninterrupted
    chunked run exactly (the checkpoint carries the full recursive state
    including pyramids and the RNG key)."""
    n, chunk, cadence = 13, 4, 2
    seq, cfg, camera = _setup(n)
    frames = list(seq)
    chunks = list(_chunks(frames, chunk))

    vo1 = StereoVO(cfg, camera, chunk=chunk, kf_cadence=cadence)
    vo1.start(frames[0][1], frames[0][2])
    for i, (ls, rs) in enumerate(chunks):
        if i == 2:
            ckpt = str(tmp_path / "soak.npz")
            checkpoint.save_state(ckpt, vo1.state)
        vo1.state = vo1._chunk_step(vo1.state, ls, rs)
    poses_full = np.asarray(vo1.state.poses[:n])

    vo2 = StereoVO(cfg, camera, chunk=chunk, kf_cadence=cadence)
    vo2.start(frames[0][1], frames[0][2])  # builds the pytree structure
    vo2.state = checkpoint.load_state(ckpt, vo2.state)
    for ls, rs in chunks[2:]:
        vo2.state = vo2._chunk_step(vo2.state, ls, rs)
    poses_resumed = np.asarray(vo2.state.poses[:n])

    np.testing.assert_allclose(poses_resumed, poses_full, atol=1e-6)
    # sanity: the continuation actually moved (not a frozen state)
    assert not np.allclose(poses_full[4], poses_full[n - 1], atol=1e-3)
