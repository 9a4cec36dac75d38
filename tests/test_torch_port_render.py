"""PyTorch port, the host renderers and the artifact dumps against the JAX
package on the CPU, on the same seeded numpy inputs (no model compiled):
the painter's overlay and `visualize_tb` bit for bit, the Debugger's
drawings bit for bit, `_stretch_depth` over every uint8 value,
`_save_artifacts`' files byte for byte, and K4 (`ops/vert2map.py`)."""

import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu.evaluation.evaluate import _save_artifacts as j_save_artifacts
from inbed_pose_estimation_tpu.evaluation.evaluate import _stretch_depth as j_stretch_depth
from inbed_pose_estimation_tpu.ops.vert2map import vert2map as j_vert2map
from inbed_pose_estimation_tpu.render.debug import Debugger as JDebugger
from inbed_pose_estimation_tpu.render.renderer import Renderer as JRenderer
from inbed_pose_estimation_tpu_torch import constants
from inbed_pose_estimation_tpu_torch.evaluation.evaluate import _save_artifacts, _stretch_depth
from inbed_pose_estimation_tpu_torch.ops import vert2map
from inbed_pose_estimation_tpu_torch.render import Debugger, Renderer

RES, V, F = 64, 150, 200
# K4 against JAX: the contact map exactly (a count of neighbours, no
# rounding), the depth map within 1e-6 (one float32 rounding of the
# neighbour sums at the depth scale; the readings are 0).
K4_DEPTH_ATOL = 1e-6


def _mesh(seed, n=1):
    """n meshes of V vertices around the origin (about 1 m across), F random
    faces, weak-perspective cameras [n, 3] and translations [n, 3] that put
    them inside a RES x RES image."""
    r = np.random.default_rng(seed)
    verts = r.normal(0, 0.3, (n, V, 3)).astype(np.float32)
    verts[..., 1] = np.linspace(-0.9, 0.9, V, dtype=np.float32) + r.normal(0, 0.05, (n, V)).astype(np.float32)
    faces = r.integers(0, V, (F, 3)).astype(np.int32)
    cam = np.stack([r.uniform(0.7, 1.1, n), r.uniform(-0.1, 0.1, n), r.uniform(-0.1, 0.1, n)], -1).astype(np.float32)
    cam_t = np.stack([cam[:, 1], cam[:, 2], 2 * constants.FOCAL_LENGTH / (RES * cam[:, 0] + 1e-9)], -1)
    return verts, faces, cam, cam_t.astype(np.float32)


@pytest.mark.parametrize("with_image", [False, True])
def test_painter_matches_jax_bitwise(with_image):
    verts, faces, _, cam_t = _mesh(0)
    image = np.random.default_rng(1).uniform(0, 1, (RES, RES, 3)) if with_image else None
    want = JRenderer(constants.FOCAL_LENGTH, RES, faces)(verts[0], cam_t[0], image)
    got = Renderer(constants.FOCAL_LENGTH, RES, torch.from_numpy(faces))(
        torch.from_numpy(verts[0]), torch.from_numpy(cam_t[0]), image)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    painted = (got != (image if with_image else 0)).any(-1).mean()
    assert 0.05 < painted < 0.9, painted  # the mesh covers part of the image


def test_visualize_tb_matches_jax_bitwise():
    verts, faces, _, cam_t = _mesh(2, n=5)
    images = np.random.default_rng(3).uniform(0, 1, (5, RES, RES, 3))
    want = JRenderer(constants.FOCAL_LENGTH, RES, faces).visualize_tb(verts, cam_t, images)
    got = Renderer(constants.FOCAL_LENGTH, RES, faces).visualize_tb(torch.from_numpy(verts),
                                                                    torch.from_numpy(cam_t), images)
    assert got.shape == (4, RES, RES, 3) and np.array_equal(got, want)


def test_debugger_matches_jax_bitwise(tmp_path):
    r = np.random.default_rng(4)
    img = r.integers(0, 255, (RES, RES, 3), np.uint8)
    joints = np.concatenate([r.uniform(-5, RES + 5, (14, 2)), np.ones((14, 1))], -1)
    points = r.uniform(0, RES, (6, 2))
    drawn = []
    for cls, name in ((JDebugger, "jax"), (Debugger, "port")):
        dbg = cls()
        dbg.add_img(img)
        dbg.add_point_2d(points, color=(0, 0, 255))
        dbg.add_skeleton_2d(joints)
        dbg.save_img(str(tmp_path / f"{name}.png"))
        drawn.append(dbg.imgs["default"])
    assert np.array_equal(drawn[0], drawn[1]) and not np.array_equal(drawn[1], img)
    assert (tmp_path / "jax.png").read_bytes() == (tmp_path / "port.png").read_bytes()


def test_stretch_depth_matches_jax_over_every_value():
    depth = np.arange(256, dtype=np.uint8).reshape(16, 16)
    black = np.zeros((16, 16), bool)
    black[::5, ::3] = True
    got = _stretch_depth(depth, black)
    assert got.dtype == np.uint8 and np.array_equal(got, j_stretch_depth(depth, black))
    assert got[0, 3] == 0 and got.reshape(-1)[100] == np.uint8((100 - 150) * 3 % 256)  # black; uint8 wraparound


def test_save_artifacts_matches_jax_file_for_file(tmp_path):
    """A batch of 10 (8 drawn), preds padded to 12, offset 5: the same file
    names and the same bytes in both packages.  The port also gets a
    fusion model's `mask` among its recovered images, which it skips."""
    bs, B, offset = 10, 12, 5
    r = np.random.default_rng(5)
    verts, faces, cam, _ = _mesh(6, n=B)
    mean, std = np.asarray(constants.IMG_NORM_MEAN), np.asarray(constants.IMG_NORM_STD)
    img01 = r.uniform(0, 1, (bs, RES, RES, 3))
    img01[:, :, :6] = 0.0  # the crop's black padding
    img = ((img01 - mean) / std).astype(np.float32)
    recon = {k: r.normal(0, 1.5, (B, RES, RES, 1)).astype(np.float32) for k in ("depth", "ir", "pm")}
    masks = (r.uniform(0, 1, (B, RES, RES)) > 0.5).astype(np.float32)
    smpl = types.SimpleNamespace(faces=faces)

    j_save_artifacts(str(tmp_path / "jax"), "slp-4mod-uncover", offset, {"img": img},
                     {"cam": cam, "vertices": verts, "recon": recon}, smpl, RES, pred_masks=masks)
    port_recon = {k: torch.from_numpy(np.moveaxis(v, -1, 1)) for k, v in recon.items()}
    port_recon["mask"] = torch.ones(B, 1, RES, RES)
    _save_artifacts(str(tmp_path / "port"), "slp-4mod-uncover", offset, {"img": np.moveaxis(img, -1, 1)},
                    {"cam": torch.from_numpy(cam), "vertices": torch.from_numpy(verts), "recon": port_recon},
                    smpl, RES, pred_masks=torch.from_numpy(masks))

    want_dir, got_dir = tmp_path / "jax" / "slp-4mod-uncover", tmp_path / "port" / "slp-4mod-uncover"
    names = sorted(os.listdir(want_dir))
    kinds = ("shape", "shape_side", "shape_top", "depth_recovered", "depthoutori", "depthout", "ir_recovered",
             "irout", "pm_recovered", "mask")
    assert names == sorted(f"{offset + i:06d}_{k}.png" for i in range(8) for k in kinds)
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name


def _taxel_verts(case, rng, H, W):
    """[3, 300, 3] vertices in taxel units for one K4 case (one shape, so
    that JAX compiles once)."""
    xy = rng.uniform(0, [W, H], (3, 300, 2))
    if case == "out_of_bounds":
        xy = rng.uniform(-5, [W + 5, H + 5], (3, 300, 2))
        xy[:, :4] = [[-1e9, 2.0], [3.0, 1e9], [W, 0.5], [0.5, H]]
    elif case == "negative_fraction":
        # (-1, 0) truncates toward zero, onto column / row 0.
        xy[:, :40] = rng.uniform(-0.999, 0, (3, 40, 2))
    elif case == "holes":
        # 20 vertices on the grid, so empty cells border occupied ones; the
        # rest far off it.
        xy[:, 20:] = -1e9
    z = rng.uniform(0.0, 1.5, xy.shape[:2] + (1,))
    return np.concatenate([xy, z], -1).astype(np.float32)


_j_vert2map = jax.jit(j_vert2map, static_argnums=(1, 2))


@pytest.mark.parametrize("case", ["basic", "out_of_bounds", "negative_fraction", "holes"])
def test_vert2map_matches_jax(case):
    H, W = 12, 16
    verts = _taxel_verts(case, np.random.default_rng(len(case)), H, W)
    want_depth, want_contact = (np.asarray(a) for a in _j_vert2map(jnp.asarray(verts), W, H))
    depth, contact = vert2map(torch.from_numpy(verts), W, H)
    assert depth.shape == contact.shape == (3, H, W)
    assert np.array_equal(contact.numpy(), want_contact)
    np.testing.assert_allclose(depth.numpy(), want_depth, rtol=0, atol=K4_DEPTH_ATOL)
    filled = (contact.numpy() > 0).mean()
    assert 0 < filled < 1 or case == "basic", filled
