"""The eval inference path: modalities -> cascade -> SMPL LBS -> H36M J17,
and the per-sample MPJPE / PA-MPJPE metrics."""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from .. import config, constants
from ..device import constant, resolve_device
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
        j17 = constant(tuple(constants.H36M_TO_J17), torch.int64, k3d.device)
        return k3d.index_select(1, j17) - k3d[:, 0:1]


@functools.cache
def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream that eval batches are copied to `device` on, one per
    device and process."""
    return torch.cuda.Stream(device=device)


class _Slot:
    """One pinned float32 host tensor per input of a call, the copy's end on
    the copy stream, and the end of the call that used the slot last on the
    compute stream."""

    def __init__(self, signature):
        self.host = tuple(torch.empty(shape, dtype=torch.float32, pin_memory=True) for shape, _ in signature)
        self.copied = torch.cuda.Event()
        self.done = torch.cuda.Event()


class StagingRing:
    """An eval call's inputs moved to `device` without blocking the host on
    the card.

    On the CPU, or when an input is already on the card, the inputs pass
    through as `torch.as_tensor(x, dtype=float32, device=device)`.
    Otherwise the call takes the next of two pinned host slots, waits until
    the call that used that slot last has ended (so the host runs at most
    two calls ahead of the card), copies the caller's batch into it on the
    host (the `eval.stage` span), and copies each input to fresh device
    memory on the device's copy stream, which the current (compute)
    stream waits for.  The device inputs come from the caching allocator,
    marked as used by the compute stream, so an answer the caller keeps
    never aliases a later call's inputs; the caller's host memory is free
    once `stage` returns.  A call whose inputs differ in count, shape or
    dtype from the ring's re-makes the ring.  `finish` marks the end of the
    call's last launch.

    `counts`: calls staged, calls passed through, and re-makes of the ring.
    """

    def __init__(self, device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.counts = {"staged": 0, "passed": 0, "remade": 0}
        self.signature = None
        self.slots = ()
        self.turn = 0
        self.current = None

    def stage(self, inputs) -> tuple:
        tensors = [torch.as_tensor(x) for x in inputs]
        if self.device.type != "cuda" or any(t.is_cuda for t in tensors):
            self.counts["passed"] += 1
            return tuple(torch.as_tensor(t, dtype=torch.float32, device=self.device) for t in tensors)
        signature = tuple((t.shape, t.dtype) for t in tensors)
        if signature != self.signature:
            if self.signature is not None:
                self.counts["remade"] += 1
            self.signature, self.slots, self.turn = signature, (_Slot(signature), _Slot(signature)), 0
        slot = self.slots[self.turn]
        self.turn = 1 - self.turn
        slot.done.synchronize()
        compute, stream = torch.cuda.current_stream(self.device), _copy_stream(self.device)
        moved = []
        # Each input's device copy is queued as soon as it is in the slot,
        # so a batch that finds the card idle starts moving before the
        # host has copied all of it.
        with torch.cuda.stream(stream), span("eval.stage"):
            for pinned, t in zip(slot.host, tensors):
                pinned.copy_(t)
                moved.append(torch.empty(pinned.shape, dtype=torch.float32, device=self.device)
                             .copy_(pinned, non_blocking=True))
            slot.copied.record(stream)
        compute.wait_event(slot.copied)
        for m in moved:
            m.record_stream(compute)
        self.counts["staged"] += 1
        self.current = slot
        return tuple(moved)

    def finish(self) -> None:
        if self.current is not None:
            self.current.done.record(torch.cuda.current_stream(self.device))
            self.current = None


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
    moved there on each call through a `StagingRing`, whose counts the
    function carries as `staging`.  Outputs:
    rotmat, betas, cam, vertices [B, V, 3], recon, and keypoints_3d_17 when
    a J-regressor is given.  Puts the model in eval mode and runs without
    autograd.  Each call is an `eval.call` span, with the staging and the
    copies' launch under `eval.h2d` (the host copy into a pinned slot as
    `eval.stage` beneath it) and the model's own spans beneath the call.
    """
    dev = resolve_device(device)
    model.to(dev).eval()
    smpl_model.to(dev)
    forward = make_forward_fn(model, spec, num_cas_iters, final_recon=final_recon, smpl_model=smpl_model)
    jreg = None if j_regressor_h36m is None else torch.as_tensor(j_regressor_h36m, dtype=torch.float32, device=dev)
    ring = StagingRing(dev)

    @torch.no_grad()
    def infer(inputs) -> dict:
        with span("eval.call"):
            with span("eval.h2d"):
                inputs = ring.stage(inputs)
            out = forward(inputs)
            verts, _ = lbs(smpl_model, out.betas, out.rotmat)
            result = {"rotmat": out.rotmat, "betas": out.betas, "cam": out.cam, "vertices": verts,
                      "recon": out.recon}
            if jreg is not None:
                result["keypoints_3d_17"] = regress_j17(jreg, verts)
            ring.finish()
            return result

    infer.staging = ring.counts
    return infer


def eval_metrics(pred_joints17, gt_joints17) -> dict:
    """Per-sample MPJPE and PA-MPJPE on the device of the inputs."""
    mpjpe = torch.sqrt(torch.sum((pred_joints17 - gt_joints17) ** 2, dim=-1)).mean(dim=-1)
    pa = reconstruction_error(pred_joints17, gt_joints17, reduction=None)
    return {"mpjpe": mpjpe, "pa_mpjpe": pa}
