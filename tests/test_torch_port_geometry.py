"""PyTorch port, geometry: rotations and Procrustes against the JAX package
on the same seeded numpy inputs (CPU, float32)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu import geometry as jgeo
from inbed_pose_estimation_tpu_torch import geometry as tgeo

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
