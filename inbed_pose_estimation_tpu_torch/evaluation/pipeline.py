"""The eval inference path: modalities -> cascade -> SMPL LBS -> H36M J17,
and the per-sample MPJPE / PA-MPJPE metrics."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import config, constants
from ..device import resolve_device
from ..geometry import perspective_projection, reconstruction_error, weak_perspective_to_cam_t
from ..models import cascade_apply
from ..models.hmr import HMROutput
from ..ops.mask_raster import splat_points_to_mask
from ..smpl.model import SMPLModel, lbs, smpl_forward
from ..utils.profiling import span


def load_j_regressor_h36m(path: Optional[str] = None, num_vertices: int = constants.NUM_VERTICES) -> np.ndarray:
    """J_regressor_h36m.npy [17, V] from `path` (by default the asset
    directory's, `config.asset("j_regressor_h36m")`), or a deterministic
    synthetic stand-in with the same shape and row normalization when it is
    missing."""
    path = path or config.asset("j_regressor_h36m")
    if os.path.exists(path):
        return np.load(path).astype(np.float32)
    J = np.zeros((17, num_vertices), np.float32)
    for j, cfrac in enumerate(np.linspace(0.03, 0.97, 17)):
        idx = int(cfrac * num_vertices)
        lo, hi = max(0, idx - 30), min(num_vertices, idx + 30)
        J[j, lo:hi] = 1.0 / (hi - lo)
    return J


def make_forward_fn(model, spec, num_cas_iters: int = 2, final_recon: bool = True,
                    smpl_model: Optional[SMPLModel] = None):
    """fn(modality tuple of [B, C, H, W]) -> HMROutput of the final stage.

    concat: the modalities joined on the channel axis; multi: the tuple, one
    trunk each; both through the cascade when the spec has one.  fusion: the
    model's stage 2, with the recovered images and the body mask ("mask")
    as `recon`; the model runs `smpl_model` inside.  pm_contact
    (Bodies-At-Rest): the modalities and the contact channels (the tuple's
    last element) joined on the channel axis, regressed in mode "0"; for
    bodiesAtRest4mod with `smpl_model`, a refinement: the 49 joints of that
    regression projected at the input's resolution, splatted into an
    estimated body map (5x5 dilation), and the stack with that map as its
    last channel regressed in mode "2", with the map as `recon["est_map"]`.
    The model runs in the mode it is in (`build_model` returns it in eval
    mode).
    """
    if spec.input_mode == "concat":
        def apply_fn(mods, **kw):
            return model(torch.cat(list(mods), dim=1), **kw)
    elif spec.input_mode == "multi":
        def apply_fn(mods, **kw):
            return model(tuple(mods), **kw)
    elif spec.input_mode == "fusion":
        def apply_fn(mods, **kw):
            fo = model(tuple(mods), smpl_model)
            return fo.stage2._replace(recon=dict(fo.recovered, mask=fo.mask))
    elif spec.input_mode == "pm_contact" and spec.name == "bodiesAtRest4mod" and smpl_model is not None:
        def apply_fn(mods, **kw):
            stacked = torch.cat(list(mods), dim=1)
            out = model(stacked, mode="0")
            res, B = stacked.shape[-1], stacked.shape[0]
            joints = smpl_forward(smpl_model, out.betas, rot_mats=out.rotmat).joints
            cam_t = weak_perspective_to_cam_t(out.cam, constants.FOCAL_LENGTH, res)
            eye = torch.eye(3, dtype=joints.dtype, device=joints.device).expand(B, 3, 3)
            uv = perspective_projection(joints, eye, cam_t, constants.FOCAL_LENGTH, torch.zeros_like(cam_t[:, :2]))
            est_map = splat_points_to_mask(uv + 0.5 * res, res, res, dilation=5)
            return model(torch.cat([stacked, est_map], dim=1), mode="2")._replace(recon={"est_map": est_map})
    elif spec.input_mode == "pm_contact":
        def apply_fn(mods, **kw):
            return model(torch.cat(list(mods), dim=1), mode="0")
    else:
        raise ValueError(f"unsupported input mode '{spec.input_mode}'")

    def forward(inputs) -> HMROutput:
        if spec.cascade:
            return cascade_apply(apply_fn, inputs, num_cas_iters, feed_map=spec.cascade_feed_map,
                                 final_recon=final_recon)[-1]
        return apply_fn(inputs, compute_recon=final_recon)

    return forward


def regress_j17(j_regressor, verts):
    """Pelvis-centred 17 H36M joints [B, 17, 3] from vertices [B, V, 3]."""
    with span("eval.j17"):
        k3d = torch.einsum("jv,bvc->bjc", j_regressor, verts)
        return k3d[:, constants.H36M_TO_J17] - k3d[:, 0:1]


def make_inference_fn(
    model,
    spec,
    smpl_model: SMPLModel,
    j_regressor_h36m: Optional[np.ndarray] = None,
    num_cas_iters: int = 2,
    final_recon: bool = True,
    device: str | torch.device = "cuda",
):
    """The full eval step on `device`: fn(modality tuple) -> dict.

    Moves the model and SMPL assets to `device`; the inputs (NCHW tensors or
    arrays, one per modality, then Bodies-At-Rest's contact channels) are
    moved there on each call.  Outputs:
    rotmat, betas, cam, vertices [B, V, 3], recon, and keypoints_3d_17 when
    a J-regressor is given.  Puts the model in eval mode and runs without
    autograd.  Each call is an `eval.call` span, with the copies under
    `eval.h2d` and the model's own spans beneath it.
    """
    dev = resolve_device(device)
    model.to(dev).eval()
    smpl_model.to(dev)
    forward = make_forward_fn(model, spec, num_cas_iters, final_recon=final_recon, smpl_model=smpl_model)
    jreg = None if j_regressor_h36m is None else torch.as_tensor(j_regressor_h36m, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def infer(inputs) -> dict:
        with span("eval.call"):
            with span("eval.h2d"):
                inputs = tuple(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in inputs)
            out = forward(inputs)
            verts, _ = lbs(smpl_model, out.betas, out.rotmat)
            result = {"rotmat": out.rotmat, "betas": out.betas, "cam": out.cam, "vertices": verts,
                      "recon": out.recon}
            if jreg is not None:
                result["keypoints_3d_17"] = regress_j17(jreg, verts)
            return result

    return infer


def eval_metrics(pred_joints17, gt_joints17) -> dict:
    """Per-sample MPJPE and PA-MPJPE on the device of the inputs."""
    mpjpe = torch.sqrt(torch.sum((pred_joints17 - gt_joints17) ** 2, dim=-1)).mean(dim=-1)
    pa = reconstruction_error(pred_joints17, gt_joints17, reduction=None)
    return {"mpjpe": mpjpe, "pa_mpjpe": pa}
