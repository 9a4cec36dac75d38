"""PyTorch port, geometry: rotations and Procrustes against the JAX package
on the same seeded numpy inputs (CPU, float32)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu import geometry as jgeo
from inbed_pose_estimation_tpu_torch import geometry as tgeo
from torch_threads import one_torch_thread  # noqa: F401

# float32 elementwise math in two frameworks: rounding-level differences.
ATOL = 1e-6


def test_rot6d_to_rotmat_matches_jax():
    x = np.random.default_rng(0).normal(0, 1, (4, 144)).astype(np.float32)
    ref = np.asarray(jgeo.rot6d_to_rotmat(jnp.asarray(x)))
    got = tgeo.rot6d_to_rotmat(torch.from_numpy(x)).numpy()
    assert got.shape == (96, 3, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_batch_rodrigues_matches_jax_including_zero():
    aa = np.random.default_rng(1).normal(0, 0.8, (16, 24, 3)).astype(np.float32)
    aa[0, 0] = 0.0  # theta == 0 goes through the +1e-8 guard
    ref = np.asarray(jgeo.batch_rodrigues(jnp.asarray(aa)))
    got = tgeo.batch_rodrigues(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(got[0, 0], np.eye(3), atol=ATOL)


def test_quat_to_rotmat_matches_jax():
    q = np.random.default_rng(2).normal(0, 1, (32, 4)).astype(np.float32)
    ref = np.asarray(jgeo.quat_to_rotmat(jnp.asarray(q)))
    got = tgeo.quat_to_rotmat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _point_sets(seed):
    rng = np.random.default_rng(seed)
    S2 = rng.normal(0, 0.3, (6, 17, 3)).astype(np.float32)
    aa = rng.normal(0, 1.0, (6, 3)).astype(np.float32)
    R = np.asarray(jgeo.batch_rodrigues(jnp.asarray(aa)))
    S1 = 1.3 * np.einsum("bmn,bjn->bjm", R, S2) + 0.2 + rng.normal(0, 0.02, S2.shape)
    S1[0] = S1[0] * np.array([-1.0, 1.0, 1.0])  # a reflected set exercises the det fix
    return S1.astype(np.float32), S2


def test_compute_similarity_transform_matches_jax():
    S1, S2 = _point_sets(3)
    ref = np.asarray(jgeo.compute_similarity_transform(jnp.asarray(S1), jnp.asarray(S2)))
    got = tgeo.compute_similarity_transform(torch.from_numpy(S1), torch.from_numpy(S2)).numpy()
    # A 3x3 SVD in two LAPACK paths: agreement to a few float32 ulps of 1.
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("reduction", [None, "mean", "sum"])
def test_reconstruction_error_matches_jax(reduction):
    S1, S2 = _point_sets(4)
    ref = np.asarray(jgeo.reconstruction_error(jnp.asarray(S1), jnp.asarray(S2), reduction=reduction))
    got = tgeo.reconstruction_error(torch.from_numpy(S1), torch.from_numpy(S2), reduction=reduction).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _rotations(seed, n):
    """Random rotations plus a rotation of about pi about each axis, so that
    every branch of the Shepperd extraction is taken."""
    aa = np.random.default_rng(seed).normal(0, 1.0, (n, 3)).astype(np.float32)
    aa[:3] = np.eye(3, dtype=np.float32) * 3.1
    return np.array(jgeo.batch_rodrigues(jnp.asarray(aa)))


def test_rotmat_to_rot6d_matches_jax():
    R = _rotations(5, 8)
    np.testing.assert_array_equal(tgeo.rotmat_to_rot6d(torch.from_numpy(R)).numpy(),
                                  np.asarray(jgeo.rotmat_to_rot6d(jnp.asarray(R))))


def test_rotmat_to_quat_matches_jax():
    R = _rotations(6, 32)
    ref = np.asarray(jgeo.rotmat_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(tgeo.rotmat_to_quat(torch.from_numpy(R)).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("case", ["identity", "near_identity", "random"])
def test_rotmat_to_aa_matches_jax(case):
    if case == "identity":
        R = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    elif case == "near_identity":
        aa = np.random.default_rng(7).normal(0, 1e-4, (16, 3)).astype(np.float32)
        R = np.array(jgeo.batch_rodrigues(jnp.asarray(aa)))
    else:
        R = _rotations(8, 32)
    ref = np.asarray(jgeo.rotmat_to_aa(jnp.asarray(R)))
    got = tgeo.rotmat_to_aa(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if case == "identity":
        assert np.all(got == 0.0)
    # The canonical form: the angle lies in [0, pi].
    assert np.all(np.linalg.norm(got, axis=-1) <= np.pi + 1e-5)


def test_aa_rotate_z_matches_jax():
    rng = np.random.default_rng(9)
    aa = rng.normal(0, 0.8, (6, 3)).astype(np.float32)
    rot = np.array([0.0, 10.0, -20.0, 45.0, 90.0, -170.0], np.float32)
    ref = np.asarray(jgeo.aa_rotate_z(jnp.asarray(aa), jnp.asarray(rot)))
    got = tgeo.aa_rotate_z(torch.from_numpy(aa), torch.from_numpy(rot)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_flip_pose_matches_jax():
    from inbed_pose_estimation_tpu import constants as jconst
    from inbed_pose_estimation_tpu_torch import constants as tconst

    assert tconst.SMPL_POSE_FLIP_PERM == list(jconst.SMPL_POSE_FLIP_PERM)
    assert tconst.JOINT_IDS == jconst.JOINT_IDS
    pose = np.random.default_rng(10).normal(0, 0.5, (3, 72)).astype(np.float32)
    perm = np.asarray(tconst.SMPL_POSE_FLIP_PERM)
    ref = np.asarray(jgeo.flip_pose(jnp.asarray(pose), jnp.asarray(perm)))
    got = tgeo.flip_pose(torch.from_numpy(pose), torch.from_numpy(perm)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_perspective_projection_matches_jax():
    rng = np.random.default_rng(11)
    pts = rng.normal(0, 0.5, (3, 49, 3)).astype(np.float32)
    R = _rotations(12, 3)
    t = np.concatenate([rng.normal(0, 0.2, (3, 2)), rng.uniform(4, 60, (3, 1))], -1).astype(np.float32)
    cc = rng.uniform(20, 200, (3, 2)).astype(np.float32)
    ref = np.asarray(jgeo.perspective_projection(*(jnp.asarray(a) for a in (pts, R, t)), 5000.0, jnp.asarray(cc)))
    got = tgeo.perspective_projection(*(torch.from_numpy(a) for a in (pts, R, t)), 5000.0, torch.from_numpy(cc))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_weak_perspective_to_cam_t_matches_jax():
    cam = np.random.default_rng(13).normal(0, 0.5, (5, 3)).astype(np.float32)
    cam[0, 0] = 0.0  # s == 0 meets the 1e-9 guard
    ref = np.asarray(jgeo.weak_perspective_to_cam_t(jnp.asarray(cam), 5000.0, 64))
    got = tgeo.weak_perspective_to_cam_t(torch.from_numpy(cam), 5000.0, 64).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_estimate_translation_matches_jax():
    rng = np.random.default_rng(14)
    B, res = 4, 224
    S = rng.normal(0, 0.4, (B, 49, 3)).astype(np.float32)
    j2d = np.concatenate([rng.uniform(0, res, (B, 49, 2)), rng.uniform(0, 1, (B, 49, 1))], -1).astype(np.float32)
    j2d[1, :, 2] = 0.0  # no confident joint: the ridge keeps the solve finite
    ref = np.asarray(jgeo.estimate_translation(jnp.asarray(S), jnp.asarray(j2d), 5000.0, res))
    got = tgeo.estimate_translation(torch.from_numpy(S), torch.from_numpy(j2d), 5000.0, res).numpy()
    assert np.all(np.isfinite(got))
    # A 3x3 solve whose normal matrix holds f^2 = 2.5e7 beside O(1) terms.
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
