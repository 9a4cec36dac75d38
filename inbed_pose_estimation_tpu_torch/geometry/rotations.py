"""Rotation representation conversions on tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternions [..., 4] (not necessarily unit) -> [..., 3, 3]."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3].

    Keeps the reference's +1e-8 on the norm, so that theta == 0 gives the
    identity without a 0/0.
    """
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    normalized = aa / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_rotmat(quat)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D representation -> rotation matrices by Gram-Schmidt.

    The 6 numbers are read as a (3, 2) matrix of the first two raw columns;
    [B, 144] gives [B*24, 3, 3], like the reference's `.view(-1, 3, 2)`.
    """
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = F.normalize(a1, dim=-1, eps=1e-12)
    b2 = F.normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1, dim=-1, eps=1e-12)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)
