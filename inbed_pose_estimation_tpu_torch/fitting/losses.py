"""SMPLify fitting losses: the body loss (robust reprojection + pose prior
+ angle prior + shape prior) and the camera loss (torso reprojection +
depth anchor)."""

from __future__ import annotations

import torch

from .. import constants
from ..device import constant
from ..geometry import perspective_projection
from .prior import GMMPrior, max_mixture_nll

# Joints the camera stage fits.
_OP_JOINTS = ["OP RHip", "OP LHip", "OP RShoulder", "OP LShoulder"]
_GT_JOINTS = ["Right Hip", "Left Hip", "Right Shoulder", "Left Shoulder"]
OP_JOINTS_IND = [constants.JOINT_IDS[j] for j in _OP_JOINTS]
GT_JOINTS_IND = [constants.JOINT_IDS[j] for j in _GT_JOINTS]

# Joints the body stage ignores.
_IGN_JOINTS = ["OP Neck", "OP RHip", "OP LHip", "Right Hip", "Left Hip"]
IGN_JOINTS_IND = [constants.JOINT_IDS[j] for j in _IGN_JOINTS]

# Knee and elbow entries of the 69-dim body pose, and the sign of an
# unnatural bend of each.
_ANGLE_PRIOR_IND = [55 - 3, 58 - 3, 12 - 3, 15 - 3]
_ANGLE_PRIOR_SIGN = [1.0, -1.0, -1.0, -1.0]


def _identity(B, like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(B, 3, 3)


def _index(ind, like):
    return constant(tuple(ind), torch.int64, like.device)


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robust error sigma^2 x^2 / (sigma^2 + x^2)."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """Knee/elbow bend penalty [B, 4] for body poses [B, 69]."""
    sign = constant(tuple(_ANGLE_PRIOR_SIGN), body_pose.dtype, body_pose.device)
    return torch.exp(body_pose[:, _index(_ANGLE_PRIOR_IND, body_pose)] * sign) ** 2


def body_fitting_loss(body_pose, betas, model_joints, camera_t, camera_center, joints_2d, joints_conf,
                      pose_prior: GMMPrior, focal_length: float = 5000.0, sigma: float = 100.0,
                      pose_prior_weight: float = 4.78, shape_prior_weight: float = 5.0,
                      angle_prior_weight: float = 15.2, output: str = "sum"):
    """The body stage's loss.  output="sum": one scalar over the batch;
    output="reprojection": the per-joint conf^2-weighted robust
    reprojection error [B, 49]."""
    B = body_pose.shape[0]
    projected = perspective_projection(model_joints, _identity(B, body_pose), camera_t, focal_length, camera_center)
    reproj = gmof(projected - joints_2d, sigma)
    reproj_loss = (joints_conf ** 2) * reproj.sum(dim=-1)                                # [B, 49]
    if output == "reprojection":
        return reproj_loss
    if output != "sum":
        raise ValueError(f"body_fitting_loss: output must be 'sum' or 'reprojection', got {output!r}")
    prior_loss = (pose_prior_weight ** 2) * max_mixture_nll(pose_prior, body_pose)
    angle_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(dim=-1)
    shape_loss = (shape_prior_weight ** 2) * torch.sum(betas ** 2, dim=-1)
    return (reproj_loss.sum(dim=-1) + prior_loss + angle_loss + shape_loss).sum()


def camera_fitting_loss(model_joints, camera_t, camera_t_est, camera_center, joints_2d, joints_conf,
                        focal_length: float = 5000.0, depth_loss_weight: float = 100.0):
    """The camera stage's loss, one scalar over the batch: squared torso
    reprojection error (the OpenPose torso joints where all four are
    confident, else the ground-truth ones) + the depth anchor to the
    estimated translation."""
    B = model_joints.shape[0]
    projected = perspective_projection(model_joints, _identity(B, model_joints), camera_t, focal_length,
                                       camera_center)
    op, gt = _index(OP_JOINTS_IND, joints_2d), _index(GT_JOINTS_IND, joints_2d)
    err_op = (joints_2d[:, op] - projected[:, op]) ** 2
    err_gt = (joints_2d[:, gt] - projected[:, gt]) ** 2
    is_valid = (torch.amin(joints_conf[:, op], dim=-1) > 0).to(model_joints.dtype)[:, None, None]
    reproj = (is_valid * err_op + (1 - is_valid) * err_gt).sum(dim=(1, 2))
    depth_loss = (depth_loss_weight ** 2) * (camera_t[:, 2] - camera_t_est[:, 2]) ** 2
    return (reproj + depth_loss).sum()
