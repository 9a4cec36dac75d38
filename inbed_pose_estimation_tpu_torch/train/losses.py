"""Training losses as fixed-shape masked reductions.

Where the reference filters rows (`pred[has_smpl == 1]`), these take the
mean over the selected rows by a row mask, so shapes never depend on the
data and nothing waits for the card.
"""

from __future__ import annotations

import torch

from ..geometry import batch_rodrigues
from ..parallel import mesh


def _masked_mean(values: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Mean of values [B, ...] over the rows where row_mask [B] is 1; 0 when
    no row is selected.

    Under data parallel (`parallel.mesh`) the rows are this rank's share of
    the global batch and the mean is the global one: this rank's sum over
    the global count (all-reduced), times the world size, so that the mean
    over the ranks, which the gradient average takes, is the masked mean of
    the global batch.  Ranks hold different counts wherever the mask
    depends on the data (a valid fit)."""
    B = values.shape[0]
    per_row = values.reshape(B, -1).mean(dim=1)
    n = torch.sum(row_mask).detach()
    scale = 1.0
    if mesh.is_initialized():
        n = mesh.all_reduce_(n.clone())
        scale = float(mesh.world_size())
    return torch.where(n > 0, torch.sum(per_row * row_mask) * scale / torch.clamp(n, min=1), 0.0)


def keypoint_loss(pred_kp2d, gt_kp2d, openpose_weight: float, gt_weight: float) -> torch.Tensor:
    """Confidence-weighted 2D keypoint MSE over the 25 OpenPose and 24
    ground-truth joints, each group with its weight."""
    conf = gt_kp2d[:, :, 2:3]
    w = torch.cat([torch.full((25, 1), openpose_weight, dtype=conf.dtype, device=conf.device),
                   torch.full((24, 1), gt_weight, dtype=conf.dtype, device=conf.device)], dim=0)
    conf = conf * w[None]
    return (conf * (pred_kp2d - gt_kp2d[:, :, :2]) ** 2).mean()


def keypoint_3d_loss(pred_kp3d, gt_kp3d, has_pose_3d) -> torch.Tensor:
    """Pelvis-centred 3D keypoint MSE over the samples with 3D ground truth;
    the prediction is rows 25: of the 49-joint superset."""
    pred = pred_kp3d[:, 25:, :]
    conf = gt_kp3d[:, :, 3:4]
    gt = gt_kp3d[:, :, :3]
    gt = gt - ((gt[:, 2, :] + gt[:, 3, :]) / 2)[:, None, :]
    pred = pred - ((pred[:, 2, :] + pred[:, 3, :]) / 2)[:, None, :]
    return _masked_mean(conf * (pred - gt) ** 2, has_pose_3d.to(pred.dtype))


def shape_loss(pred_vertices, gt_vertices, has_smpl) -> torch.Tensor:
    """Per-vertex L1 over the samples with a valid fit."""
    return _masked_mean(torch.abs(pred_vertices - gt_vertices), has_smpl.to(pred_vertices.dtype))


def smpl_losses(pred_rotmat, pred_betas, gt_pose_aa, gt_betas, has_smpl):
    """MSE on the rotation matrices and on the betas over the valid samples."""
    gt_rotmat = batch_rodrigues(gt_pose_aa.reshape(-1, 3)).reshape(-1, 24, 3, 3)
    m = has_smpl.to(pred_rotmat.dtype)
    return _masked_mean((pred_rotmat - gt_rotmat) ** 2, m), _masked_mean((pred_betas - gt_betas) ** 2, m)


def recon_l1_loss(pred_img, gt_img, mask=None) -> torch.Tensor:
    """Image-recovery L1.  With a mask both images are gated, and the mean
    still runs over all pixels, as the reference normalizes it."""
    if mask is not None:
        pred_img = pred_img * mask
        gt_img = gt_img * mask
    return torch.abs(pred_img - gt_img).mean()


def camera_scale_regularizer(pred_camera) -> torch.Tensor:
    """Keeps the weak-perspective scale positive: mean of exp(-10 s)^2."""
    return (torch.exp(-pred_camera[:, 0] * 10.0) ** 2).mean()
