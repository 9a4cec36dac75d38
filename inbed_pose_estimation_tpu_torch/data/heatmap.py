"""Affine-transform and gaussian-heatmap utilities for keypoint-heatmap
workflows, in numpy.

The port's copy of the JAX package's `data/heatmap.py` (the reference's
utils/image.py:25-134 helpers, which its main pipeline does not import
either): the same arithmetic, so the same arrays.
"""

from __future__ import annotations

import numpy as np


def get_affine_transform(center, scale, rot, output_size, inv=False) -> np.ndarray:
    """2x3 affine mapping the (center, scale) box to output_size, rotated."""
    if not isinstance(scale, (list, tuple, np.ndarray)):
        scale = np.array([scale, scale])
    src_w = scale[0] * 200.0
    dst_w, dst_h = output_size

    rot_rad = np.pi * rot / 180
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    src_dir = np.array([0, src_w * -0.5]) @ np.array([[cs, -sn], [sn, cs]]).T
    dst_dir = np.array([0, dst_w * -0.5])

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]])

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + src_dir
    src[2] = third(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])

    if inv:
        src, dst = dst, src
    # Solve the 6-dof affine from the 3 point pairs.
    A = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        A[2 * i, :3] = [src[i, 0], src[i, 1], 1]
        A[2 * i + 1, 3:] = [src[i, 0], src[i, 1], 1]
        b[2 * i] = dst[i, 0]
        b[2 * i + 1] = dst[i, 1]
    m = np.linalg.solve(A, b)
    return m.reshape(2, 3)


def affine_transform_point(pt, t) -> np.ndarray:
    p = np.array([pt[0], pt[1], 1.0])
    return (t @ p)[:2]


def draw_gaussian(heatmap: np.ndarray, center, sigma: float) -> np.ndarray:
    """Add a 2D gaussian blob at `center` (x, y); max-composited in place."""
    tmp_size = int(3 * sigma)
    mu_x, mu_y = int(center[0] + 0.5), int(center[1] + 0.5)
    h, w = heatmap.shape
    ul = [mu_x - tmp_size, mu_y - tmp_size]
    br = [mu_x + tmp_size + 1, mu_y + tmp_size + 1]
    if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
        return heatmap
    size = 2 * tmp_size + 1
    x = np.arange(size, dtype=np.float32)
    y = x[:, None]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))

    gx = max(0, -ul[0]), min(br[0], w) - ul[0]
    gy = max(0, -ul[1]), min(br[1], h) - ul[1]
    hx = max(0, ul[0]), min(br[0], w)
    hy = max(0, ul[1]), min(br[1], h)
    heatmap[hy[0]:hy[1], hx[0]:hx[1]] = np.maximum(
        heatmap[hy[0]:hy[1], hx[0]:hx[1]], g[gy[0]:gy[1], gx[0]:gx[1]]
    )
    return heatmap
