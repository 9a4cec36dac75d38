"""PyTorch port, K2 (`ops/mask_raster.py`) against the JAX package on the
CPU: the point splat exactly (truncation toward zero, the dilation margin,
points past it), and the body mask of SMPL vertices with and without the
bilinear upsample to 1e-6."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu.ops.mask_raster import render_body_mask as j_render_body_mask
from inbed_pose_estimation_tpu.ops.mask_raster import splat_points_to_mask as j_splat
from inbed_pose_estimation_tpu_torch.geometry import batch_rodrigues
from inbed_pose_estimation_tpu_torch.ops.mask_raster import render_body_mask, splat_points_to_mask
from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model
from torch_threads import one_torch_thread  # noqa: F401


def _points(height, width, seed):
    """[2, N, 2] points (x, y): inside, negative fractional (truncated
    toward zero onto row / column 0), in the 2-pixel margin on every side,
    just past it, far away, and on pixel edges."""
    r = np.random.default_rng(seed)
    inside = np.stack([r.uniform(0, width, 40), r.uniform(0, height, 40)], -1)
    special = np.array([
        [-0.7, 3.2], [4.5, -0.2], [-0.99, -0.01],              # truncate to 0
        [-1.5, 5.0], [-2.0, 6.0], [7.0, -1.2], [8.0, -2.9],    # margin, left / top
        [width + 0.5, 3.0], [width + 1.9, 4.0], [2.0, height + 1.0], [3.0, height + 1.99],  # margin, right / bottom
        [-3.0, 5.0], [-3.5, 5.0], [width + 2.0, 3.0], [4.0, height + 2.5],  # past the margin
        [-1e9, 2.0], [3.0, 1e9], [1e12, -1e12],                 # far away
        [float(width - 1), float(height - 1)], [0.0, 0.0], [width / 2.0, height / 2.0],  # on edges
    ])
    a = np.concatenate([inside, special])
    b = np.concatenate([special[::-1], r.uniform(-4, max(height, width) + 4, (40, 2))])
    return np.stack([a, b]).astype(np.float32)


@pytest.mark.parametrize("height,width,dilation", [(16, 16, 5), (15, 21, 5), (16, 16, 3), (12, 9, 1)])
def test_splat_matches_jax_exactly(height, width, dilation):
    xy = _points(height, width, height + width + dilation)
    want = np.asarray(j_splat(jnp.asarray(xy), height, width, dilation=dilation))[..., 0]
    got = splat_points_to_mask(torch.from_numpy(xy), height, width, dilation=dilation)
    assert got.shape == (2, 1, height, width) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    assert 0 < want.mean() < 1


def test_splat_truncates_toward_zero_and_keeps_the_margin():
    # -0.7 truncates to column 0 (floor would drop it to -1, in the margin);
    # a point at x = -2 (margin) dilates into columns 0..0 of a 5x5 box;
    # x = -3 is past the margin and sets nothing.
    xy = torch.tensor([[[-0.7, 5.0]], [[-2.0, 5.0]], [[-3.0, 5.0]]])
    m = splat_points_to_mask(xy, 11, 11, dilation=5)[:, 0]
    assert m[0, 3:8, 0:3].eq(1).all() and m[0].sum() == 15
    assert m[1, 3:8, 0].eq(1).all() and m[1].sum() == 5
    assert m[2].sum() == 0


@pytest.fixture(scope="module")
def meshes():
    """Vertices of a posed synthetic SMPL mesh and weak-perspective cameras
    that put part of the body outside the frame."""
    smpl = synthetic_smpl_model(0, device="cpu")
    r = np.random.default_rng(0)
    rot = batch_rodrigues(torch.from_numpy(r.normal(0, 0.3, (2 * 24, 3)).astype(np.float32))).reshape(2, 24, 3, 3)
    betas = torch.from_numpy(r.normal(0, 0.5, (2, 10)).astype(np.float32))
    verts, _ = lbs(smpl, betas, rot)
    cam = np.array([[0.9, 0.0, 0.1], [1.6, 0.3, -0.2]], np.float32)
    return verts.numpy(), cam


@pytest.mark.parametrize("img_res,upsample", [(64, True), (224, True), (65, True), (64, False)])
def test_render_body_mask_matches_jax(meshes, img_res, upsample):
    verts, cam = meshes
    want = np.asarray(j_render_body_mask(jnp.asarray(verts), jnp.asarray(cam), img_res=img_res, upsample=upsample))
    got = render_body_mask(torch.from_numpy(verts), torch.from_numpy(cam), img_res=img_res, upsample=upsample)
    res = img_res if upsample else img_res // 2
    assert got.shape == (2, 1, res, res)
    np.testing.assert_allclose(got[:, 0].numpy(), want[..., 0], rtol=0, atol=1e-6)
    assert (want == 0).any() and (want == 1).any()  # the body and the background
    if upsample:
        assert ((want > 0) & (want < 1)).any()  # the bilinear edge
