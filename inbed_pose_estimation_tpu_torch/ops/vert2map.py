"""Vertices -> pressure-taxel depth and contact maps (K4), in plain torch.

The port of the JAX package's `ops/vert2map.py::vert2map`, a jnp scatter
program, not a Pallas kernel: it stays plain torch until a profile on the
card asks for a kernel.  It runs on the device of the tensor it is given:
  1. bin the vertices into a width x height taxel grid, keeping each cell's
     least depth (a scatter amin over an `inf` fill; the least value does
     not depend on the order of the writes, so the map is exact);
  2. fill each empty cell with the mean depth of its occupied 3x3
     neighbours;
  3. mark every occupied or filled cell in the contact map.
Its numerics are the JAX package's:
  * the taxel coordinates are truncated toward zero (`.to(torch.int32)`,
    as JAX's `astype`), so x = -0.5 lands in column 0 and counts;
  * a vertex off the grid goes to a sentinel slot one past its end, which
    is sliced off (a torch scatter raises on an index out of range where
    JAX drops it);
  * the 3x3 neighbour sum has zero padding (JAX's `reduce_window` add),
    written as the sum of the 9 shifted slices of the padded map, so that
    no convolution algorithm (nor TF32) enters the sum.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# Coordinates are clamped to this magnitude before the int cast: far off
# any grid (so still dropped), and inside int32's range.
_FAR = 1.0e6


def _sum3x3(a: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> the sum over each cell's 3x3 window, zero outside."""
    H, W = a.shape[1:]
    p = F.pad(a, (1, 1, 1, 1))
    out = p[:, 0:H, 0:W]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                out = out + p[:, dy:dy + H, dx:dx + W]
    return out


def vert2map(verts_taxel: torch.Tensor, width: int = 112, height: int = 112,
             depth_scale: float = 0.0286) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertices [B, V, 3] in taxel units (x, y; z the height above the mat)
    -> (depth_map [B, height, width] scaled by `depth_scale`, contact
    [B, height, width] in {0, 1})."""
    B = verts_taxel.shape[0]
    dtype = verts_taxel.dtype
    xy = verts_taxel[..., :2].clamp(-_FAR, _FAR).to(torch.int32).to(torch.int64)
    x, y = xy[..., 0], xy[..., 1]
    z = verts_taxel[..., 2]

    valid = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    flat = torch.where(valid, y * width + x, height * width)
    inf = torch.tensor(float("inf"), dtype=dtype, device=verts_taxel.device)
    depth = torch.full((B, height * width + 1), float("inf"), dtype=dtype, device=verts_taxel.device)
    depth.scatter_reduce_(1, flat, torch.where(valid, z, inf), "amin", include_self=True)
    depth = depth[:, :-1]
    occupied = torch.isfinite(depth)
    depth = torch.where(occupied, depth, torch.zeros_like(depth)).reshape(B, height, width)
    occ = occupied.to(dtype).reshape(B, height, width)

    neigh_depth = _sum3x3(depth) - depth
    neigh_count = _sum3x3(occ) - occ
    hole = (occ == 0) & (neigh_count > 0)
    patched = torch.where(hole, neigh_depth / torch.clamp(neigh_count, min=1), depth)
    contact = torch.maximum(occ, hole.to(dtype))
    return patched * depth_scale, contact
