"""Body mask and part segmentation rasterizer on the device (plain torch).

The port of the JAX package's `render/part_renderer.py`, which stands in for
the reference's neural_renderer PartRenderer: the SMPL mesh becomes a binary
mask and a 6-part segmentation.  With `faces` the mesh is rasterized as
filled, z-buffered triangles (`ops/tri_raster.py`, the eval path); without
faces each vertex is splatted with a z-buffer and the result dilated 3x3.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import config, constants
from ..device import resolve_device
from ..geometry import weak_perspective_to_cam_t
from ..ops.tri_raster import rasterize_mesh_batch


def vertex_part_labels(num_vertices: int, cube_parts_path: Optional[str] = None,
                       vertices_template: Optional[np.ndarray] = None) -> np.ndarray:
    """[V] int32 part labels in 1..6 (0 is background): the reference's
    cube_parts.npy colour-cube lookup over the template when the asset is
    there, else 6 bands along the vertex order."""
    path = cube_parts_path or config.asset("cube_parts")
    if path and os.path.exists(path) and vertices_template is not None:
        cube = np.load(path)  # [R, R, R] part ids over normalized coordinates
        v = vertices_template
        norm = (v - v.min(0)) / (v.max(0) - v.min(0) + 1e-9)
        idx = np.clip((norm * (np.array(cube.shape) - 1)).astype(int), 0, np.array(cube.shape) - 1)
        return cube[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.int32)
    bands = np.linspace(0, 1, 7)
    frac = np.linspace(0, 1, num_vertices)
    return (np.digitize(frac, bands[1:-1]) + 1).astype(np.int32)


class PartRenderer:
    """masks, parts = renderer(vertices [B, V, 3], camera [B, 3]).

    `tile` defaults to max(16, ceil(render_res / 8)): projected faces grow
    with the resolution.  `render_labels=False` (mask-only splits) skips the
    part labels; parts then come back as zeros.
    """

    def __init__(self, focal_length: float = constants.FOCAL_LENGTH, render_res: int = 128,
                 num_vertices: int = constants.NUM_VERTICES, part_labels: Optional[np.ndarray] = None,
                 template: Optional[np.ndarray] = None, faces: Optional[np.ndarray] = None,
                 render_labels: bool = True, tile: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.focal_length = focal_length
        self.render_res = render_res
        self.tile = tile if tile is not None else max(16, -(-render_res // 8))
        self.render_labels = bool(render_labels)
        labels = part_labels if part_labels is not None else vertex_part_labels(num_vertices,
                                                                                 vertices_template=template)
        self.labels = torch.as_tensor(np.asarray(labels), device=self.device)
        self.faces = None if faces is None else torch.as_tensor(np.asarray(faces), dtype=torch.int64,
                                                                 device=self.device)

    def project(self, vertices, camera) -> torch.Tensor:
        """uvz [B, V, 3]: pixel x, y under the weak-perspective camera's
        translation (identity rotation, principal point at the centre) and
        the camera-frame depth."""
        cam_t = weak_perspective_to_cam_t(camera, self.focal_length, self.render_res)
        p = vertices + cam_t[:, None, :]
        uv = (p / p[..., 2:3])[..., :2] * self.focal_length + self.render_res / 2.0
        return torch.cat([uv, p[..., 2:3]], dim=-1)

    @torch.no_grad()
    def __call__(self, vertices, camera) -> Tuple[torch.Tensor, torch.Tensor]:
        vertices = torch.as_tensor(vertices, device=self.device)
        camera = torch.as_tensor(camera, dtype=vertices.dtype, device=self.device)
        uvz = self.project(vertices, camera)
        if self.faces is not None:
            return rasterize_mesh_batch(uvz, self.faces, self.render_res,
                                        labels=self.labels if self.render_labels else None, tile=self.tile)
        return self._splat(uvz)

    def _splat(self, uvz):
        B, V = uvz.shape[:2]
        res = self.render_res
        sentinel = res * res
        xi = uvz[..., 0].to(torch.int32).long()
        yi = uvz[..., 1].to(torch.int32).long()
        z = uvz[..., 2]
        valid = (xi >= 0) & (xi < res) & (yi >= 0) & (yi < res)
        flat = torch.where(valid, yi * res + xi, sentinel)

        # Z-buffer: the nearest vertex per pixel wins.
        inf = torch.tensor(float("inf"), dtype=uvz.dtype, device=uvz.device)
        zbuf = torch.full((B, sentinel + 1), float("inf"), dtype=uvz.dtype, device=uvz.device)
        zbuf.scatter_reduce_(1, flat, torch.where(valid, z, inf), reduce="amin")
        mask = torch.isfinite(zbuf[:, :sentinel]).to(torch.float32).reshape(B, 1, res, res)
        # 3x3 dilation closes the splat's holes.
        mask = F.max_pool2d(mask, 3, stride=1, padding=1)[:, 0]
        if not self.render_labels:
            return mask, torch.zeros((B, res, res), dtype=torch.int32, device=uvz.device)

        # The labels of depth-winning vertices (within epsilon), dilated.
        win = torch.abs(z - torch.gather(zbuf, 1, flat)) < 1e-4
        lab = self.labels[None, :].expand(B, V).to(torch.int32)
        parts = torch.zeros((B, sentinel + 1), dtype=torch.int32, device=uvz.device)
        parts.scatter_reduce_(1, flat, torch.where(valid & win, lab, 0), reduce="amax")
        parts = parts[:, :sentinel].reshape(B, 1, res, res).to(torch.float32)
        parts = F.max_pool2d(parts, 3, stride=1, padding=1)[:, 0]
        return mask, parts.to(torch.int32)
