"""Filled-triangle z-buffer mesh rasterization as scatter code (plain torch).

The port of the JAX package's `ops/tri_raster.py`, which stands in for the
reference's neural_renderer at eval time: each face tests a tile x tile
block of pixels anchored at the floor of its bbox corner with barycentric
edge functions and scatter-mins its interpolated depth into a z-buffer; the
projected vertices are also splatted, which closes faces larger than the
tile.  Pixels are sampled at integer coordinates.

torch's `scatter_reduce_` has no `mode="drop"`: fragments off the canvas go
to one sentinel slot past its end, which is sliced off.  The batch is
rasterized one sample after another, like the JAX package's `lax.map`, so
that peak memory stays at F * tile^2 fragments of one sample.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rasterize_sample(uvz: torch.Tensor, faces: torch.Tensor, res: int, labels: Optional[torch.Tensor] = None,
                     tile: int = 16, z_eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """uvz [V, 3] (pixel x, y and camera depth z), faces [F, 3] int64,
    labels [V] int part labels (1..P) or None.

    Returns (mask [res, res] float32, parts [res, res] int32); parts are
    zero without labels.  Winding-invariant; a pixel's part is the label of
    the max-barycentric corner of the depth-winning face.
    """
    tri = uvz[faces]                       # [F, 3 corners, 3]
    x, y, z = tri[..., 0], tri[..., 1], tri[..., 2]
    xmin = torch.floor(x.min(dim=1).values).to(torch.int32)
    ymin = torch.floor(y.min(dim=1).values).to(torch.int32)

    offs = torch.arange(tile, dtype=torch.int32, device=uvz.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    px = xmin[:, None] + ox.reshape(1, -1)  # [F, tile^2]
    py = ymin[:, None] + oy.reshape(1, -1)
    pxf, pyf = px.to(uvz.dtype), py.to(uvz.dtype)

    x0, y0 = x[:, 0, None], y[:, 0, None]
    x1, y1 = x[:, 1, None], y[:, 1, None]
    x2, y2 = x[:, 2, None], y[:, 2, None]
    # Edge functions (twice the signed areas); w_i / denom are barycentrics.
    w0 = (x2 - x1) * (pyf - y1) - (y2 - y1) * (pxf - x1)
    w1 = (x0 - x2) * (pyf - y2) - (y0 - y2) * (pxf - x2)
    w2 = (x1 - x0) * (pyf - y0) - (y1 - y0) * (pxf - x0)
    denom = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)  # [F, 1]

    sgn = torch.sign(denom)
    inside = (w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0) & (denom != 0)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    b0, b1, b2 = w0 / safe, w1 / safe, w2 / safe
    zpix = b0 * z[:, 0, None] + b1 * z[:, 1, None] + b2 * z[:, 2, None]

    sentinel = res * res
    inbounds = (px >= 0) & (px < res) & (py >= 0) & (py < res)
    valid = inside & inbounds & (zpix > 0)
    flat = torch.where(valid, py.long() * res + px.long(), sentinel)

    inf = torch.tensor(float("inf"), dtype=uvz.dtype, device=uvz.device)
    zbuf = torch.full((sentinel + 1,), float("inf"), dtype=uvz.dtype, device=uvz.device)
    zbuf.scatter_reduce_(0, flat.reshape(-1), torch.where(valid, zpix, inf).reshape(-1), reduce="amin")

    # Vertex splat.
    vx = uvz[:, 0].to(torch.int32).long()
    vy = uvz[:, 1].to(torch.int32).long()
    vz = uvz[:, 2]
    vvalid = (vx >= 0) & (vx < res) & (vy >= 0) & (vy < res) & (vz > 0)
    vflat = torch.where(vvalid, vy * res + vx, sentinel)
    zbuf.scatter_reduce_(0, vflat, torch.where(vvalid, vz, inf), reduce="amin")

    mask = torch.isfinite(zbuf[:sentinel])
    if labels is None:
        return mask.to(torch.float32).reshape(res, res), torch.zeros((res, res), dtype=torch.int32, device=uvz.device)

    face_lab = labels[faces]                                   # [F, 3]
    bmax = torch.argmax(torch.stack([b0, b1, b2], dim=-1), dim=-1)  # [F, tile^2]
    pix_lab = torch.gather(face_lab, 1, bmax)                  # [F, tile^2]
    win = valid & (torch.abs(zpix - zbuf[flat]) < z_eps)
    parts = torch.zeros((sentinel + 1,), dtype=torch.int32, device=uvz.device)
    parts.scatter_reduce_(0, flat.reshape(-1), torch.where(win, pix_lab, 0).reshape(-1).to(torch.int32),
                          reduce="amax")
    vwin = vvalid & (torch.abs(vz - zbuf[vflat]) < z_eps)
    parts.scatter_reduce_(0, vflat, torch.where(vwin, labels, 0).to(torch.int32), reduce="amax")
    parts = parts[:sentinel] * mask.to(torch.int32)
    return mask.to(torch.float32).reshape(res, res), parts.reshape(res, res)


def projected_face_extent(uvz: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """The largest projected face bbox span in pixels over uvz [..., V, 3].
    `rasterize_sample(tile=T)` fills every face whose span is below T."""
    tri = uvz[..., faces, :]                   # [..., F, 3, 3]
    span_x = tri[..., 0].amax(dim=-1) - tri[..., 0].amin(dim=-1)
    span_y = tri[..., 1].amax(dim=-1) - tri[..., 1].amin(dim=-1)
    return torch.maximum(span_x, span_y).max()


def rasterize_mesh_batch(uvz: torch.Tensor, faces: torch.Tensor, res: int, labels: Optional[torch.Tensor] = None,
                         tile: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """uvz [B, V, 3] -> (masks [B, res, res] float32, parts [B, res, res]
    int32), one sample at a time."""
    faces = faces.to(device=uvz.device, dtype=torch.int64)
    out = [rasterize_sample(u, faces, res, labels=labels, tile=tile) for u in uvz]
    return torch.stack([m for m, _ in out]), torch.stack([p for _, p in out])
