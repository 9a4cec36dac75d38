"""Body masks from projected SMPL vertices (K2): a scatter of points into a
canvas, a 5x5 max dilation and a bilinear upsample, in plain torch.

The JAX package wrote this as a jnp scatter program, not a Pallas kernel;
the port keeps it plain torch until a profile on the card asks for a
kernel.  Its numerics are the JAX package's:
  * coordinates are truncated toward zero to ints (`.to(torch.int32)`);
  * the canvas has a margin of dilation // 2 pixels on each side, so points
    just outside the output still dilate into its border; points outside
    the margin are dropped: they go to a sentinel slot past the end, which
    is sliced off (a torch scatter raises on an index out of range where
    JAX drops it);
  * the dilation is a max pool with padding dilation // 2 on the margin
    canvas, then the margin is cropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import FOCAL_LENGTH, IMG_RES
from ..geometry import perspective_projection, weak_perspective_to_cam_t

# Coordinates are clamped to this magnitude before the int cast: far outside
# any canvas (so still dropped), and inside int32's range.
_FAR = 1.0e6


def splat_points_to_mask(xy: torch.Tensor, height: int, width: int, dilation: int = 5) -> torch.Tensor:
    """Points [B, N, 2] (pixel x, y, float) -> mask [B, 1, height, width] in
    {0, 1}: each point sets its pixel, then a `dilation` x `dilation` box
    max dilates the set pixels."""
    B = xy.shape[0]
    m = dilation // 2
    h2, w2 = height + 2 * m, width + 2 * m
    ij = xy.clamp(-_FAR, _FAR).to(torch.int32).to(torch.int64) + m  # truncation toward zero
    xi, yi = ij[..., 0], ij[..., 1]
    valid = (xi >= 0) & (xi < w2) & (yi >= 0) & (yi < h2)
    flat = torch.where(valid, yi * w2 + xi, h2 * w2)
    canvas = torch.zeros(B, h2 * w2 + 1, dtype=xy.dtype, device=xy.device)
    canvas.scatter_(1, flat, 1.0)  # every write is a 1: the max of ones
    mask = canvas[:, :-1].reshape(B, 1, h2, w2)
    if dilation > 1:
        mask = F.max_pool2d(mask, dilation, stride=1, padding=m)
    if m:
        mask = mask[:, :, m:-m, m:-m]
    return mask


def render_body_mask(vertices: torch.Tensor, pred_camera: torch.Tensor, img_res: int = IMG_RES,
                     focal_length: float = FOCAL_LENGTH, mask_scale: int = 2, upsample: bool = True) -> torch.Tensor:
    """SMPL vertices [B, V, 3] + weak-perspective camera [B, 3] -> body mask
    [B, 1, img_res, img_res]: every vertex projected at 1 / `mask_scale`
    resolution, splatted and dilated 5x5, then upsampled bilinearly to
    `img_res`.

    The upsample is `jax.image.resize(method="bilinear")`'s: half-pixel
    centres, and at the border the triangle kernel's weights renormalized
    over the pixels inside, which puts the border output on the edge pixel.
    For a magnification that is exactly what `F.interpolate(bilinear,
    align_corners=False)` computes (it clamps the source coordinate to the
    edge), so that call is used; the tests hold it against JAX.
    """
    B = vertices.shape[0]
    cam_t = weak_perspective_to_cam_t(pred_camera, focal_length, img_res)
    eye = torch.eye(3, dtype=vertices.dtype, device=vertices.device).expand(B, 3, 3)
    uv = perspective_projection(vertices, eye, cam_t, focal_length, torch.zeros_like(cam_t[:, :2]))
    uv = (uv + 0.5 * img_res) / mask_scale
    res = img_res // mask_scale
    mask = splat_points_to_mask(uv, res, res, dilation=5)
    if upsample and mask_scale != 1:
        mask = F.interpolate(mask, size=(img_res, img_res), mode="bilinear", align_corners=False)
    return mask
