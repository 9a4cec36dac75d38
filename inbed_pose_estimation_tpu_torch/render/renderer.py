"""Mesh overlays for inspection: a painter's-algorithm triangle fill on the
host, in numpy.

The port of the JAX package's `render/renderer.py` without its pyrender
branch: the port does not depend on pyrender, so it keeps only the painter
path, which is what the JAX package runs where pyrender is absent, and on
the same numpy inputs it paints the same image bit for bit.  Overlapping
faces are blended far to near (`0.3 * pixel + 0.7 * colour * shade`), not
depth-tested, so the mesh rasterizer of `ops/tri_raster.py` (a z-buffer)
cannot stand in for it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(x) -> Optional[np.ndarray]:
    """A tensor on any device, or an array, as a numpy array on the host."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _project(vertices: np.ndarray, cam_t: np.ndarray, focal: float, res: int) -> np.ndarray:
    p = vertices + cam_t[None]
    uv = p[:, :2] / p[:, 2:3] * focal + res / 2.0
    return np.concatenate([uv, p[:, 2:3]], axis=1)


def _cpu_rasterize(vertices, faces, cam_t, focal, res, base_img=None, color=(0.8, 0.3, 0.3)):
    """Paint each face, far to near, over `base_img` [res, res, 3] in [0, 1]
    (black without one); returns the image clipped to [0, 1]."""
    img = (base_img.copy() if base_img is not None else np.zeros((res, res, 3), np.float32))
    pts = _project(vertices, cam_t, focal, res)
    tri = pts[faces]  # [F, 3, 3]
    order = np.argsort(-tri[:, :, 2].mean(axis=1))  # far to near
    for f in order:
        t = tri[f]
        x0, y0 = np.floor(t[:, 0].min()), np.floor(t[:, 1].min())
        x1, y1 = np.ceil(t[:, 0].max()), np.ceil(t[:, 1].max())
        x0, y0 = int(max(x0, 0)), int(max(y0, 0))
        x1, y1 = int(min(x1, res - 1)), int(min(y1, res - 1))
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        # Barycentric inside test.
        d = ((t[1, 1] - t[2, 1]) * (t[0, 0] - t[2, 0]) + (t[2, 0] - t[1, 0]) * (t[0, 1] - t[2, 1]))
        if abs(d) < 1e-9:
            continue
        a = ((t[1, 1] - t[2, 1]) * (xs - t[2, 0]) + (t[2, 0] - t[1, 0]) * (ys - t[2, 1])) / d
        b = ((t[2, 1] - t[0, 1]) * (xs - t[2, 0]) + (t[0, 0] - t[2, 0]) * (ys - t[2, 1])) / d
        c = 1 - a - b
        inside = (a >= 0) & (b >= 0) & (c >= 0)
        shade = 0.5 + 0.5 * min(1.0, 1.0 / max(t[:, 2].mean(), 1e-6) * 3)
        for ch in range(3):
            patch = img[ys[inside], xs[inside], ch]
            img[ys[inside], xs[inside], ch] = 0.3 * patch + 0.7 * color[ch] * shade
    return np.clip(img, 0, 1)


class Renderer:
    """Overlay SMPL meshes on input images (the reference's
    utils/renderer.py API).  Takes tensors on any device, or arrays, and
    moves them to the host once a call."""

    def __init__(self, focal_length: float = 5000.0, img_res: int = 224, faces=None):
        self.focal_length = focal_length
        self.img_res = img_res
        self.faces = _host(faces)

    def __call__(self, vertices, camera_translation, image=None) -> np.ndarray:
        """vertices [V, 3], camera_translation [3], image [res, res, 3] in
        [0, 1] or None -> the overlay [res, res, 3] in [0, 1]."""
        return _cpu_rasterize(_host(vertices), self.faces, _host(camera_translation), self.focal_length,
                              self.img_res, _host(image))

    def visualize_tb(self, vertices, camera_translation, images, extra=None) -> np.ndarray:
        """The overlays of the first 4 samples (vertices [N, V, 3], camera
        translations [N, 3], images [N, res, res, 3] or None), stacked
        [n, res, res, 3]."""
        n = min(len(vertices), 4)
        vertices, camera_translation = _host(vertices[:n]), _host(camera_translation[:n])
        images = _host(images[:n]) if images is not None else None
        return np.stack([self(vertices[i], camera_translation[i], images[i] if images is not None else None)
                         for i in range(n)])
