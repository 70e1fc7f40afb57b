"""Closed-form small linear algebra vs numpy oracles."""

import jax.numpy as jnp
import numpy as np

from svo_tpu.ops import linalg


def test_inv3x3(rng):
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A + 3 * np.eye(3)  # keep well-conditioned
    inv = np.asarray(linalg.inv3x3(jnp.asarray(A)))
    np.testing.assert_allclose(
        np.einsum("nij,njk->nik", A, inv), np.tile(np.eye(3), (64, 1, 1)), atol=1e-4
    )


def test_det3x3(rng):
    A = rng.normal(size=(32, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(linalg.det3x3(jnp.asarray(A))), np.linalg.det(A), rtol=1e-4, atol=1e-5
    )


def test_polar3x3_recovers_rotation(rng):
    from scipy.spatial.transform import Rotation

    R = Rotation.random(32, random_state=1).as_matrix().astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (32, 1, 1)).astype(np.float32)
    noise = rng.normal(0, 0.02, (32, 3, 3)).astype(np.float32)
    M = R * scale + noise
    Rp = np.asarray(linalg.polar3x3(jnp.asarray(M)))
    # orthonormal with det +1
    np.testing.assert_allclose(
        np.einsum("nij,nkj->nik", Rp, Rp), np.tile(np.eye(3), (32, 1, 1)), atol=1e-4
    )
    assert np.all(np.linalg.det(Rp) > 0.99)
    # close to the true rotation
    # nearest rotation to a noisy matrix legitimately deviates ~noise/scale
    ang = np.array(
        [Rotation.from_matrix(a @ b.T).magnitude() for a, b in zip(Rp, R)]
    )
    assert ang.max() < 0.15


def test_polar3x3_negative_det(rng):
    from scipy.spatial.transform import Rotation

    R = Rotation.random(8, random_state=2).as_matrix().astype(np.float32)
    M = -R  # det < 0 inputs
    Rp = np.asarray(linalg.polar3x3(jnp.asarray(M)))
    assert np.all(np.linalg.det(Rp) > 0.99)


def test_smallest_eigvec(rng):
    # construct PSD with known small eigenvector
    for n in (4, 12):
        Q, _ = np.linalg.qr(rng.normal(size=(16, n, n)))
        vals = rng.uniform(1.0, 10.0, (16, n)).astype(np.float64)
        vals[:, 0] = rng.uniform(1e-4, 1e-2, 16)  # distinct smallest
        A = np.einsum("nij,nj,nkj->nik", Q, vals, Q).astype(np.float32)
        v = np.asarray(linalg.smallest_eigvec_psd(jnp.asarray(A)))
        v_true = Q[:, :, 0]
        dot = np.abs(np.einsum("ni,ni->n", v, v_true))
        assert dot.min() > 0.999, f"n={n}: min align {dot.min()}"


def test_solve_spd(rng):
    A = rng.normal(size=(16, 3, 3)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    x = np.asarray(linalg.solve_spd(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(
        np.einsum("nij,nj->ni", A, x), b, atol=1e-3, rtol=1e-3
    )
