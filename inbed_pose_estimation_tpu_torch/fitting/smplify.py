"""SMPLify: the two-stage in-the-loop body fit, as eager Adam loops.

Stage 1 fits (global_orient, camera_t) to the torso joints with the depth
anchored to the initial translation; stage 2 fits (body_pose, betas,
global_orient) under the robust reprojection + GMM prior + angle prior +
shape prior, with the hip and neck joints ignored.  Each stage runs
`num_iters` steps of Adam (lr `step_size`, b1 0.9, b2 0.999, eps 1e-8, a
fresh state per stage), so one call runs the SMPL forward, and with it the
skinning kernel, 2 * num_iters + 1 times.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from ..device import constant
from ..ops.skinning import skinning
from ..smpl.model import SMPLModel, smpl_forward
from .losses import IGN_JOINTS_IND, body_fitting_loss, camera_fitting_loss
from .prior import GMMPrior


class SMPLifyResult(NamedTuple):
    vertices: torch.Tensor            # [B, V, 3]
    joints: torch.Tensor              # [B, 49, 3]
    pose: torch.Tensor                # [B, 72] axis-angle
    betas: torch.Tensor               # [B, 10]
    camera_translation: torch.Tensor  # [B, 3]
    reprojection_loss: torch.Tensor   # [B, 49] per-joint conf^2-weighted robust error


def _zero_ignored(joints_conf: torch.Tensor) -> torch.Tensor:
    """The confidences [B, 49] with the ignored joints zeroed, as a new
    tensor: the caller's is left as it is."""
    keep = constant(tuple(0.0 if j in IGN_JOINTS_IND else 1.0 for j in range(joints_conf.shape[1])),
                    joints_conf.dtype, joints_conf.device)
    return joints_conf * keep


def adam(loss_fn: Callable[..., torch.Tensor], params: Sequence[torch.Tensor], lr: float, num_iters: int,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> list[torch.Tensor]:
    """`num_iters` Adam steps on `loss_fn(*params)` from a zero state; the
    update is optax.adam's, mu/(1 - b1^t) / (sqrt(nu/(1 - b2^t)) + eps).

    Gradients come from `torch.autograd.grad` under `enable_grad`, so
    nothing is written to `.grad` and a caller's no_grad does not stop the
    fit.  Returns the final parameters, detached.
    """
    params = [p.detach() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for t in range(1, num_iters + 1):
        with torch.enable_grad():
            leaves = [p.requires_grad_(True) for p in params]
            grads = torch.autograd.grad(loss_fn(*leaves), leaves)
        with torch.no_grad():
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, mu)]
            nu = [(1.0 - b2) * g * g + b2 * v for g, v in zip(grads, nu)]
            params = [p + (m / c1) / (torch.sqrt(v / c2) + eps) * (-lr) for p, m, v in zip(params, mu, nu)]
    return params


def make_smplify(smpl_model: SMPLModel, pose_prior: GMMPrior, step_size: float = 1e-2, num_iters: int = 100,
                 focal_length: float = 5000.0, skin=skinning):
    """smplify(init_pose [B,72], init_betas [B,10], init_cam_t [B,3],
    camera_center [B,2], keypoints_2d [B,49,3]) -> SMPLifyResult.

    The inputs are taken detached.  `skin` is the skinning function the
    SMPL forwards use (the CUDA kernel's wrapper by default).
    """

    def smplify(init_pose, init_betas, init_cam_t, camera_center, keypoints_2d) -> SMPLifyResult:
        init_pose, init_betas, init_cam_t, camera_center, keypoints_2d = (
            t.detach() for t in (init_pose, init_betas, init_cam_t, camera_center, keypoints_2d))
        joints_2d = keypoints_2d[:, :, :2]
        joints_conf = keypoints_2d[:, :, 2]
        body_pose0, global_orient0 = init_pose[:, 3:], init_pose[:, :3]

        def stage1_loss(global_orient, camera_t):
            pose = torch.cat([global_orient, body_pose0], dim=1)
            out = smpl_forward(smpl_model, init_betas, pose_aa=pose, skin=skin)
            return camera_fitting_loss(out.joints, camera_t, init_cam_t, camera_center, joints_2d, joints_conf,
                                       focal_length=focal_length)

        global_orient, camera_t = adam(stage1_loss, [global_orient0, init_cam_t], step_size, num_iters)

        conf2 = _zero_ignored(joints_conf)

        def stage2_loss(body_pose, betas, orient):
            out = smpl_forward(smpl_model, betas, pose_aa=torch.cat([orient, body_pose], dim=1), skin=skin)
            return body_fitting_loss(body_pose, betas, out.joints, camera_t, camera_center, joints_2d, conf2,
                                     pose_prior, focal_length=focal_length)

        body_pose, betas, global_orient = adam(stage2_loss, [body_pose0, init_betas, global_orient], step_size,
                                               num_iters)

        with torch.no_grad():
            pose = torch.cat([global_orient, body_pose], dim=1)
            out = smpl_forward(smpl_model, betas, pose_aa=pose, skin=skin)
            reproj = body_fitting_loss(body_pose, betas, out.joints, camera_t, camera_center, joints_2d, conf2,
                                       pose_prior, focal_length=focal_length, output="reprojection")
        return SMPLifyResult(vertices=out.vertices, joints=out.joints, pose=pose, betas=betas,
                             camera_translation=camera_t, reprojection_loss=reproj)

    return smplify


def make_fitting_loss(smpl_model: SMPLModel, pose_prior: GMMPrior, focal_length: float = 5000.0):
    """fitting_loss(pose [B,72], betas, cam_t, camera_center, keypoints_2d)
    -> the per-joint reprojection loss [B, 49] of given fits, with the
    ignored joints zeroed as in SMPLify's body stage."""

    def fitting_loss(pose, betas, cam_t, camera_center, keypoints_2d):
        joints_conf = _zero_ignored(keypoints_2d[:, :, 2])
        out = smpl_forward(smpl_model, betas, pose_aa=pose)
        return body_fitting_loss(pose[:, 3:], betas, out.joints, cam_t, camera_center, keypoints_2d[:, :, :2],
                                 joints_conf, pose_prior, focal_length=focal_length, output="reprojection")

    return fitting_loss
