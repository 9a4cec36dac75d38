"""Preprocessing on the device (plain torch, no hand-written kernel): the
eval path's crop, resize and normalize of a batch of raw frames, and the
training path's decode of the uint8 feed (`decode_uint8_batch`).

`crop_resize` computes what the JAX package's `crop_resize` computes with
`jax.image.scale_and_translate(method="linear")`, which antialiases: when the
box shrinks by a factor s, the triangle kernel is widened by s, each output
pixel's weights are normalised to sum to one, and an output pixel whose
sample point falls outside [-0.5, in - 0.5] gets zero.  Bilinear
`F.interpolate` / `F.grid_sample` compute something else, so the port builds
the same per-sample weight matrices (one per axis, as JAX's
`compute_weight_mat` does) and applies them with two batched matmuls.
"""

from __future__ import annotations

import torch

from .. import constants
from ..device import constant, resolve_device

_STATS = {
    "img": (constants.IMG_NORM_MEAN, constants.IMG_NORM_STD),
    "ir_img": (constants.IR_NORM_MEAN, constants.IR_NORM_STD),
    "depth_img": (constants.DEPTH_NORM_MEAN, constants.DEPTH_NORM_STD),
    "pm_img": (constants.PM_NORM_MEAN, constants.PM_NORM_STD),
}


def _weight_mat(in_size: int, out_size: int, scale, translation):
    """Triangle-kernel resampling weights [B, in_size, out_size] for the map
    out = in * scale + translation (scale, translation [B])."""
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=scale.dtype, device=scale.device)
    in_pos = torch.arange(in_size, dtype=scale.dtype, device=scale.device)
    sample_f = (out_pos[None] + 0.5) * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5  # [B, out]
    x = torch.abs(sample_f[:, None, :] - in_pos[None, :, None]) / kernel_scale[:, None, None]
    weights = torch.clamp(1 - torch.abs(x), min=0)
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(torch.abs(total) > eps, weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def crop_resize(img: torch.Tensor, center: torch.Tensor, scale: torch.Tensor, res: int) -> torch.Tensor:
    """Crop each sample's (center, 200 * scale) box and resize it to res x res.

    img [B, C, H, W] float; center [B, 2] (x, y); scale [B].  The box corners
    are truncated toward zero like the host crop's integer box, so a box
    crossing the top or left edge lands on the same source pixels.
    """
    h = 200.0 * scale
    ul = torch.trunc(center - h[:, None] / 2.0)
    br = torch.trunc(center + h[:, None] / 2.0)
    bw = torch.clamp(br - ul, min=1.0)
    sxy = res / bw
    txy = -ul * res / bw
    wx = _weight_mat(img.shape[3], res, sxy[:, 0], txy[:, 0]).to(img.dtype)  # [B, W, res]
    wy = _weight_mat(img.shape[2], res, sxy[:, 1], txy[:, 1]).to(img.dtype)  # [B, H, res]
    rows = torch.matmul(img, wx[:, None])                                   # [B, C, H, res]
    return torch.matmul(wy.transpose(1, 2)[:, None], rows)                  # [B, C, res, res]


def make_device_preprocess(res: int = constants.IMG_RES, device: str | torch.device = "cuda"):
    """fn(raw: dict of [B, C, H, W] uint8 or [0, 1] float frames keyed by
    modality, center [B, 2], scale [B], flip [B], noise [B, 3]) -> dict of
    normalized [B, C, res, res] float32 on `device`."""
    dev = resolve_device(device)
    stats = {k: (torch.tensor(m, device=dev).view(-1, 1, 1), torch.tensor(s, device=dev).view(-1, 1, 1))
             for k, (m, s) in _STATS.items()}

    @torch.no_grad()
    def preprocess(raw, center, scale, flip, noise) -> dict:
        center, scale, flip, noise = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                                      for t in (center, scale, flip, noise))
        out = {}
        for key, (mean, std) in stats.items():
            if key not in raw:
                continue
            imgs = torch.as_tensor(raw[key], device=dev)
            imgs = imgs.to(torch.float32) / 255.0 if imgs.dtype == torch.uint8 else imgs.to(torch.float32)
            x = crop_resize(imgs, center, scale, res)
            x = torch.where(flip[:, None, None, None] > 0, x.flip(-1), x)
            n = noise if key == "img" else noise[:, :1]
            x = torch.clamp(x * n[:, :, None, None], 0.0, 1.0)
            out[key] = (x - mean) / std
        return out

    return preprocess


# Per-key statistics of the uint8 training feed; None: no normalization (the
# mask is compared in [0, 1]).  The uncover targets take their modality's
# statistics, as on the host path.
_UINT8_FEED_STATS = {
    "img": (constants.IMG_NORM_MEAN, constants.IMG_NORM_STD),
    "ir_img": (constants.IR_NORM_MEAN, constants.IR_NORM_STD),
    "depth_img": (constants.DEPTH_NORM_MEAN, constants.DEPTH_NORM_STD),
    "pm_img": (constants.PM_NORM_MEAN, constants.PM_NORM_STD),
    "ir_img_uncover": (constants.IR_NORM_MEAN, constants.IR_NORM_STD),
    "depth_img_uncover": (constants.DEPTH_NORM_MEAN, constants.DEPTH_NORM_STD),
    "pm_img_uncover": (constants.PM_NORM_MEAN, constants.PM_NORM_STD),
    "mask_uncover": None,
}


def decode_uint8_batch(batch: dict) -> dict:
    """Decode the uint8 training feed where the tensors are: for each uint8
    image [B, C, H, W] of `_UINT8_FEED_STATS`, clip(u8 * pn, 0, 255) / 255
    with the batch's noise factors `pixel_noise` [B, 3] (all three for RGB,
    the first for one channel), then its modality's normalization, in
    float32.  The host's float path does the same operations but multiplies
    the noise in float64, so the two agree to one float32 ulp.  A batch
    without `pixel_noise` (the float feed) is returned as it is."""
    if "pixel_noise" not in batch:
        return batch
    out = dict(batch)
    pn = batch["pixel_noise"].to(torch.float32)
    for key, stats in _UINT8_FEED_STATS.items():
        x = out.get(key)
        if x is None or x.dtype != torch.uint8:
            continue
        n = pn[:, :3] if x.shape[1] == 3 else pn[:, :1]
        # A tensor divisor: CUDA divides by a Python number as a product with
        # its reciprocal, one rounding off the host's division.
        xf = torch.clamp(x.to(torch.float32) * n[:, :, None, None], 0.0, 255.0) / constant(
            (255.0,), torch.float32, x.device)
        if stats is not None:
            mean, std = (constant(tuple(v), torch.float32, x.device).view(-1, 1, 1) for v in stats)
            xf = (xf - mean) / std
        out[key] = xf
    return out
