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


def rotmat_to_rot6d(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> the first two rows, [..., 6].

    The reference's convention: not the inverse of `rot6d_to_rotmat`, which
    reads the 6 numbers as columns.
    """
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit (w, x, y, z) quaternions [..., 4].

    Branch-free Shepperd extraction: all four candidates are computed and
    the one whose pivot (trace, m00, m11 or m22) is largest is selected.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + trace)
    q0 = torch.stack([qw0, (m21 - m12) / qw0, (m02 - m20) / qw0, (m10 - m01) / qw0], -1) * 0.5
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / qx1, qx1, (m01 + m10) / qx1, (m02 + m20) / qx1], -1) * 0.5
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / qy2, (m01 + m10) / qy2, qy2, (m12 + m21) / qy2], -1) * 0.5
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / qz3, (m02 + m20) / qz3, (m12 + m21) / qz3, qz3], -1) * 0.5

    cond0 = (trace > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3].

    The quaternion is taken with w >= 0, so the angle lies in [0, pi]; at
    the identity the result is exactly zero.
    """
    q = rotmat_to_quat(R)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    # Near zero, sin(angle/2) ~ angle/2, so aa ~ 2 xyz: no 0/0.
    scale = torch.where(sin_half > 1e-7, angle / torch.clamp(sin_half, min=1e-12), 2.0)
    return xyz * scale[..., None]


def aa_rotate_z(aa: torch.Tensor, rot_deg: torch.Tensor) -> torch.Tensor:
    """Rotate axis-angle global orientations [..., 3] in the image plane by
    the augmentation angle rot_deg [...] (degrees): log(Rz(-rot) exp(aa))."""
    rad = -torch.deg2rad(rot_deg)
    cs, sn = torch.cos(rad), torch.sin(rad)
    zeros, ones = torch.zeros_like(cs), torch.ones_like(cs)
    Rz = torch.stack([cs, -sn, zeros, sn, cs, zeros, zeros, zeros, ones], dim=-1).reshape(rot_deg.shape + (3, 3))
    return rotmat_to_aa(Rz @ batch_rodrigues(aa))


def flip_pose(pose: torch.Tensor, flip_perm: torch.Tensor) -> torch.Tensor:
    """Left/right mirror of SMPL axis-angle poses [..., 72]: swap the joints
    by `flip_perm` and negate each joint's y and z."""
    flipped = pose[..., flip_perm]
    sign = torch.ones(72, dtype=pose.dtype, device=pose.device)
    sign[1::3] = -1.0
    sign[2::3] = -1.0
    return flipped * sign
