"""The training step of the concat-input family (hmr, hmr4mod,
irhmr/depthhmr/pmhmr, mulhmr, rechmr, cashmr, cashmrV2, rec3hmr, cas3hmr).

One step, in order:

    ground-truth SMPL -> fits gather (+ the batch's augmentation) -> fits SMPL
    -> camera translation least squares (ground truth and fits) -> fitting
    loss of the fits -> cascade of train-mode forwards -> SMPL + projection
    of the final stage -> [SMPLify, fits scatter where it improved] ->
    masked losses of the final and earlier stages + recovery L1, x60 ->
    gradients -> one Adam step

With SMPLify on, one step runs the SMPL forward, and with it the skinning
kernel, 6 + 2 * num_smplify_iters times (5 without SMPLify).

The state is updated in place: the model's parameters and BatchNorm
running statistics, the optimizer's moments and the dropout generator;
the fits store is a new tensor each step.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import constants
from ..device import resolve_device
from ..fitting import GMMPrior, make_fitting_loss, make_smplify
from ..geometry import estimate_translation, perspective_projection, rotmat_to_aa, weak_perspective_to_cam_t
from ..models import cascade_apply
from ..smpl.model import SMPLModel, smpl_forward
from . import losses as L
from .fits_dict import fits_get, fits_set

# Recovered image -> the batch key of its ground truth.
UNCOVER_KEY = {"depth": "depth_img_uncover", "ir": "ir_img_uncover", "pm": "pm_img_uncover"}

# Batch keys the step reads besides the model's modalities and the
# ground truth of its recovery heads.
SCALAR_KEYS = ("keypoints", "pose", "betas", "pose_3d", "has_smpl", "has_pose_3d",
               "is_flipped", "rot_angle", "sample_index")


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    fits: torch.Tensor            # [N, 82]
    generator: torch.Generator    # dropout masks, on the model's device
    step: int = 0


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over the model's parameters as optax.adam(lr) sets it: betas
    (0.9, 0.999), eps 1e-8, no weight decay."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def init_train_state(model: nn.Module, options, fits, seed: int = 0, device: str | torch.device = "cuda") -> TrainState:
    """A fresh state on `device`: the model in training mode, a zero Adam
    state, the fits store [N, 82] in the parameters' type and a dropout
    generator seeded with `seed`."""
    dev = resolve_device(device)
    model.to(dev).train()
    return TrainState(model=model, optimizer=make_optimizer(model, options.lr),
                      fits=torch.as_tensor(fits).to(dev, next(model.parameters()).dtype),
                      generator=torch.Generator(dev).manual_seed(seed))


def step_feed_keys(spec) -> frozenset:
    """The batch keys one step of this (concat-input) model reads."""
    return frozenset(spec.modalities) | frozenset(SCALAR_KEYS) | {UNCOVER_KEY[h] for h in spec.recon_heads}


def make_train_step(model: nn.Module, spec, smpl_model: SMPLModel, prior: GMMPrior, options,
                    device: str | torch.device = "cuda"):
    """Build train_step(state, batch) -> (state, metrics) on `device`.

    `batch` maps the keys of `step_feed_keys(spec)` to arrays or tensors:
    the modalities and recovery targets as [B, C, H, W] (NCHW), keypoints
    [B, 49, 3] in [-1, 1] with confidence, pose [B, 72], betas [B, 10],
    pose_3d [B, 24, 4], has_smpl / has_pose_3d / is_flipped / rot_angle
    (degrees) [B] and sample_index [B] (rows of the fits store).  metrics
    holds the loss and its parts as detached scalars on the device.
    Floating inputs are cast to the type of the model's parameters.

    After a step each parameter's `.grad` holds the gradient that Adam
    took.  Only concat-input models are ported; the others raise.
    """
    dev = resolve_device(device)
    if spec.input_mode != "concat":
        raise NotImplementedError(f"training of input mode '{spec.input_mode}' is not ported yet: "
                                  "ROADMAP Queue 1 item 9")
    model.to(dev)
    smpl_model.to(dev)
    prior = GMMPrior(*(t.to(dev) for t in prior))
    img_res = float(options.img_res)
    focal = constants.FOCAL_LENGTH
    num_cas = int(options.num_cas_iters) if spec.cascade else 1
    run_smplify = bool(options.run_smplify)
    fitting_loss_fn = make_fitting_loss(smpl_model, prior, focal)
    smplify_fn = make_smplify(smpl_model, prior, step_size=1e-2, num_iters=int(options.num_smplify_iters),
                              focal_length=focal)

    def get_vertices(rotmat, betas, camera):
        """SMPL + weak-perspective projection, keypoints normalized to [-1, 1]."""
        out = smpl_forward(smpl_model, betas, rot_mats=rotmat)
        cam_t = weak_perspective_to_cam_t(camera, focal, img_res)
        B = rotmat.shape[0]
        eye = torch.eye(3, dtype=rotmat.dtype, device=rotmat.device).expand(B, 3, 3)
        kp2d = perspective_projection(out.joints, eye, cam_t, focal, torch.zeros_like(cam_t[:, :2])) / (img_res / 2.0)
        return out.vertices, out.joints, kp2d, cam_t

    def loss_fn(fits, batch, generator):
        gt_kp2d, gt_pose, gt_betas = batch["keypoints"], batch["pose"], batch["betas"]
        gt_joints3d, has_smpl, has_pose_3d = batch["pose_3d"], batch["has_smpl"], batch["has_pose_3d"]
        indices = batch["sample_index"]
        B = gt_kp2d.shape[0]

        with torch.no_grad():
            # Ground-truth and current-best-fit meshes, their camera
            # translations, and the fits' own reprojection loss.
            gt_out = smpl_forward(smpl_model, gt_betas, pose_aa=gt_pose)
            opt_pose, opt_betas = fits_get(fits, indices, batch["rot_angle"], batch["is_flipped"])
            opt_out = smpl_forward(smpl_model, opt_betas, pose_aa=opt_pose)
            opt_vertices = opt_out.vertices
            gt_kp2d_orig = torch.cat([0.5 * img_res * (gt_kp2d[:, :, :2] + 1), gt_kp2d[:, :, 2:]], dim=-1)
            opt_cam_t = estimate_translation(opt_out.joints, gt_kp2d_orig, focal, img_res)
            camera_center = torch.full((B, 2), 0.5 * img_res, dtype=gt_kp2d.dtype, device=gt_kp2d.device)
            opt_joint_loss = fitting_loss_fn(opt_pose, opt_betas, opt_cam_t, camera_center, gt_kp2d_orig).mean(dim=-1)

        # Cascade of train-mode forwards: batch statistics, running-stat
        # updates and dropout.
        def apply_fn(mods, **kw):
            return model(torch.cat(list(mods), dim=1), generator=generator, **kw)

        stage_outs = cascade_apply(apply_fn, tuple(batch[k] for k in spec.modalities), num_cas,
                                   feed_map=spec.cascade_feed_map)
        final = stage_outs[-1]
        pred_vertices, pred_joints, pred_kp2d, pred_cam_t = get_vertices(final.rotmat, final.betas, final.cam)

        with torch.no_grad():
            if run_smplify:
                fit = smplify_fn(rotmat_to_aa(final.rotmat).reshape(B, 72), final.betas, pred_cam_t,
                                 camera_center, gt_kp2d_orig)
                new_opt_joint_loss = fit.reprojection_loss.mean(dim=-1)
                update = (new_opt_joint_loss < opt_joint_loss).to(gt_kp2d.dtype)
                upd = update[:, None] > 0
                opt_joint_loss = torch.minimum(new_opt_joint_loss, opt_joint_loss)
                opt_vertices = torch.where(upd[..., None], fit.vertices, opt_vertices)
                opt_pose = torch.where(upd, fit.pose, opt_pose)
                opt_betas = torch.where(upd, fit.betas, opt_betas)
                fits = fits_set(fits, indices, batch["rot_angle"], batch["is_flipped"], update, opt_pose, opt_betas)
            # Reset extreme betas, then put the ground truth where there is one.
            extreme = (opt_betas.abs() > 3).any(dim=-1, keepdim=True)
            opt_betas = torch.where(extreme, 0.0, opt_betas)
            hs = has_smpl[:, None] > 0
            opt_vertices = torch.where(hs[..., None], gt_out.vertices, opt_vertices)
            opt_pose = torch.where(hs, gt_pose, opt_pose)
            opt_betas = torch.where(hs, gt_betas, opt_betas)
            valid_fit = ((opt_joint_loss < options.smplify_threshold) | (has_smpl > 0)).to(gt_kp2d.dtype)

        # Final-stage losses.
        loss_regr_pose, loss_regr_betas = L.smpl_losses(final.rotmat, final.betas, opt_pose, opt_betas, valid_fit)
        loss_kp = L.keypoint_loss(pred_kp2d, gt_kp2d, options.openpose_train_weight, options.gt_train_weight)
        loss_kp3d = L.keypoint_3d_loss(pred_joints, gt_joints3d, has_pose_3d)
        loss_shape = L.shape_loss(pred_vertices, opt_vertices, valid_fit)
        total = (options.shape_loss_weight * loss_shape
                 + options.keypoint_loss_weight * loss_kp
                 + options.keypoint_loss_weight * loss_kp3d
                 + loss_regr_pose
                 + options.beta_loss_weight * loss_regr_betas
                 + L.camera_scale_regularizer(final.cam))

        # Earlier stages and the recovered images.
        def stage_aux_losses(out):
            sv, sj, skp2d, _ = get_vertices(out.rotmat, out.betas, out.cam)
            lp, lb = L.smpl_losses(out.rotmat, out.betas, opt_pose, opt_betas, valid_fit)
            return (options.shape_loss_weight * L.shape_loss(sv, opt_vertices, valid_fit)
                    + options.keypoint_loss_weight * L.keypoint_loss(skp2d, gt_kp2d, options.openpose_train_weight,
                                                                     options.gt_train_weight)
                    + options.keypoint_loss_weight * L.keypoint_3d_loss(sj, gt_joints3d, has_pose_3d)
                    + lp
                    + options.beta_loss_weight * lb
                    + L.camera_scale_regularizer(final.cam))

        loss_extra = 0.0
        for out in [final] + stage_outs[:-1]:
            for name, img in out.recon.items():
                if UNCOVER_KEY.get(name) in batch:
                    loss_extra = loss_extra + L.recon_l1_loss(img, batch[UNCOVER_KEY[name]])
            if out is not final:
                loss_extra = loss_extra + stage_aux_losses(out)

        total = (total + loss_extra) * 60.0
        metrics = {
            "loss": total.detach(),
            "loss_keypoints": loss_kp.detach(),
            "loss_keypoints_3d": loss_kp3d.detach(),
            "loss_regr_pose": loss_regr_pose.detach(),
            "loss_regr_betas": loss_regr_betas.detach(),
            "loss_shape": loss_shape.detach(),
        }
        return total, fits, metrics

    def to_device(batch):
        dtype = next(model.parameters()).dtype
        return {k: torch.as_tensor(v).to(dev, torch.int64 if k == "sample_index" else dtype)
                for k, v in batch.items()}

    def train_step(state: TrainState, batch):
        model.train()
        total, fits, metrics = loss_fn(state.fits, to_device(batch), state.generator)
        params = list(model.parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # A parameter the loss does not reach gets a zero gradient, so that
        # Adam still decays its moments, as optax does.
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state.optimizer.step()
        return dataclasses.replace(state, fits=fits, step=state.step + 1), metrics

    return train_step
