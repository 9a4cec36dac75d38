"""Camera models: pinhole projection, weak-perspective conversion and the
batched camera-translation least squares."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FOCAL_LENGTH, IMG_RES


def perspective_projection(points, rotation, translation, focal_length, camera_center):
    """Pinhole projection of points [B, N, 3] under rotation [B, 3, 3] and
    translation [B, 3]; focal_length a scalar, camera_center [B, 2].
    Returns pixel coordinates [B, N, 2]."""
    cam_points = torch.einsum("bij,bkj->bki", rotation, points) + translation[:, None, :]
    projected = cam_points / cam_points[..., 2:3]
    return projected[..., :2] * focal_length + camera_center[:, None, :]


def weak_perspective_to_cam_t(pred_camera, focal_length=FOCAL_LENGTH, img_res=IMG_RES):
    """[s, tx, ty] weak-perspective camera [B, 3] -> translation [B, 3],
    tz = 2 f / (res s + 1e-9)."""
    s, tx, ty = pred_camera.unbind(-1)
    tz = 2.0 * focal_length / (img_res * s + 1e-9)
    return torch.stack([tx, ty, tz], dim=-1)


def weak_perspective_to_cam_t_np(pred_camera: np.ndarray, focal_length=FOCAL_LENGTH, img_res=IMG_RES) -> np.ndarray:
    """`weak_perspective_to_cam_t` on the host, for the renderers: numpy
    divides correctly rounded, as the JAX package does, where torch divides
    a Python number by a tensor through its reciprocal."""
    tz = 2.0 * focal_length / (img_res * pred_camera[:, 0] + 1e-9)
    return np.stack([pred_camera[:, 1], pred_camera[:, 2], tz], axis=-1)


def estimate_translation(S, joints_2d, focal_length=FOCAL_LENGTH, img_size=IMG_RES):
    """Camera translation [B, 3] that best projects the 24 ground-truth
    joints (rows 25: of the 49-joint superset) of S [B, 49, 3] onto
    joints_2d [B, 49, 3] (pixels, confidence in channel 2).

    Each joint gives two rows, weighted by sqrt(confidence):
        [f, 0, c - u] . t = (u - c) Z - f X
        [0, f, c - v] . t = (v - c) Z - f Y
    solved through the 3x3 normal equations, batched, with a 1e-6 ridge so
    that a sample with no confident joint still gets a finite answer.
    """
    S24 = S[:, 25:, :]
    u, v = joints_2d[:, 25:, 0], joints_2d[:, 25:, 1]
    conf = joints_2d[:, 25:, 2]
    f = focal_length
    c = img_size / 2.0

    X, Y, Z = S24.unbind(-1)
    w = torch.sqrt(torch.clamp(conf, min=0.0))
    zeros = torch.zeros_like(u)
    f_col = torch.full_like(u, f)
    Q = torch.stack([torch.stack([f_col, zeros, c - u], dim=-1),
                     torch.stack([zeros, f_col, c - v], dim=-1)], dim=-2)       # [B, 24, 2, 3]
    rhs = torch.stack([(u - c) * Z - f * X, (v - c) * Z - f * Y], dim=-1)      # [B, 24, 2]

    Wq = Q * w[..., None, None]
    Wrhs = rhs * w[..., None]
    A = torch.einsum("bjri,bjrk->bik", Wq, Wq) + 1e-6 * torch.eye(3, dtype=S.dtype, device=S.device)
    b = torch.einsum("bjri,bjr->bi", Wq, Wrhs)
    return torch.linalg.solve(A, b[..., None])[..., 0]
