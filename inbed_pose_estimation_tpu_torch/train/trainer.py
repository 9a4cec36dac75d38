"""Training of the concat-input family (hmr, hmr4mod, irhmr/depthhmr/pmhmr,
mulhmr, rechmr, cashmr, cashmrV2, rec3hmr, cas3hmr), the multi-trunk family
(featcat, featcat_cashmr, featatt_cashmr, ir_depth_featatt_cashmrV2), the
fusion family (the *_fusion names) and Bodies-At-Rest (bodiesAtRest,
bodiesAtRest4mod): the train step, and `Trainer`, the epoch driver around
it.

One step, in order:

    ground-truth SMPL -> fits gather (+ the batch's augmentation) -> fits SMPL
    -> camera translation least squares (ground truth and fits) -> fitting
    loss of the fits -> cascade of train-mode forwards (concat, multi),
    the fusion model's two stages, or Bodies-At-Rest's one regression
    -> SMPL + projection of the final stage -> [SMPLify, fits scatter where
    it improved] -> masked losses of the final and earlier stages +
    recovery L1 (fusion: + 0.01 x mask L1 and the mask-gated recovery L1;
    Bodies-At-Rest in mode "0": + 0.1 x the L1 of the predicted mesh's body
    mask, which moves the loss and no gradient), x60 -> gradients -> one
    Adam step

With SMPLify on, one step runs the SMPL forward, and with it the skinning
kernel, 6 + 2 * num_smplify_iters times for a 2-pass cascade (5 without
SMPLify); a fusion model adds one for its body mask, and the frozen-guided
pipelines one more for the guide's; Bodies-At-Rest, one pass, runs one
fewer than a 2-pass cascade (its mask reuses the final stage's vertices).

Bodies-At-Rest trains in mode "0" until `--mod1_epoch`, then in mode "1",
where every output is detached: each gradient is zero and Adam still
applies its moments, as optax does.  bodiesAtRest4mod's mode-2 stack, which
no training step runs, keeps its values.

The state is updated in place: the model's parameters and BatchNorm
running statistics, the optimizer's moments and the dropout generator;
the fits store is a new tensor each step.

`Trainer` feeds the step from a resumable loader and keeps the run's state
across steps: summaries, checkpoints (`epoch_<E>_<B>.pt`), the graceful
save-and-exit on `time_to_run`, the eval at each epoch's end, and resume
from its own checkpoints, the reference's `.pt` or the JAX package's
`.npz`.

Data parallel (`parallel.mesh`, one process a device under torchrun) runs
one global step, as the JAX package's step over its device mesh does: each
rank holds its rows of the global batch and a replica of the state, and
every reduction is global.  BatchNorm takes global statistics
(`models.backbone`), the masked means divide by global counts
(`losses._masked_mean`), dropout draws the global batch's masks from the
generator every rank holds in lockstep (`models.heads.dropout`), every rank
applies every rank's fits updates, so that the fits store stays replicated
(SMPLify's loss is a sum over samples, so fitting each rank's rows is
exact), and the gradients are averaged over the ranks before Adam.  The
metrics a step returns are the global batch's.  One step's numbers then do
not depend on the number of ranks, up to float32 reduction order.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
from torch import nn

from .. import config, constants
from ..data.device_preprocess import decode_uint8_batch
from ..data.loader import CheckpointDataLoader
from ..device import resolve_device
from ..fitting import GMMPrior, make_fitting_loss, make_smplify
from ..geometry import estimate_translation, perspective_projection, rotmat_to_aa, weak_perspective_to_cam_t
from ..models import cascade_apply
from ..models.hmr import TRUNK_NAME
from ..models.layers import checkpoint
from ..ops.mask_raster import render_body_mask
from ..parallel import mesh
from ..smpl.model import SMPLModel, smpl_forward
from ..utils.profiling import StepTimer, span
from . import losses as L
from .checkpoint import latest_checkpoint, load_guide, load_pretrained, resume_train_state, save_checkpoint
from .fits_dict import FitsStore, fits_get, fits_set

# Recovered image -> the batch key of its ground truth.
UNCOVER_KEY = {"depth": "depth_img_uncover", "ir": "ir_img_uncover", "pm": "pm_img_uncover"}

# Batch keys the step reads besides the model's modalities and the
# ground truth of its recovery heads (`pixel_noise` only in the uint8 feed).
SCALAR_KEYS = ("keypoints", "pose", "betas", "pose_3d", "has_smpl", "has_pose_3d",
               "is_flipped", "rot_angle", "sample_index", "pixel_noise")


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    fits: torch.Tensor            # [N, 82]
    generator: torch.Generator    # dropout masks, on the model's device
    step: int = 0


def trainable(model: nn.Module) -> list:
    """The parameters the step trains: all but a frozen guide's."""
    return [p for p in model.parameters() if p.requires_grad]


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam over the model's trainable parameters as optax.adam(lr) sets it:
    betas (0.9, 0.999), eps 1e-8, no weight decay.  A frozen guide gets no
    Adam state (in JAX its gradient is zero and Adam leaves it in place)."""
    return torch.optim.Adam(trainable(model), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


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
    """The batch keys one step of this model reads: a fusion model also
    reads the ground-truth body mask and every input modality's uncovered
    image, Bodies-At-Rest the contact channels and the body mask."""
    keys = set(spec.modalities) | set(SCALAR_KEYS) | {UNCOVER_KEY[h] for h in spec.recon_heads}
    if spec.input_mode == "fusion":
        keys |= {"mask_uncover"} | {UNCOVER_KEY[TRUNK_NAME[m]] for m in spec.modalities if TRUNK_NAME[m] in UNCOVER_KEY}
    if spec.input_mode == "pm_contact":
        keys |= {"pm_contact", "mask_uncover"}
    return frozenset(keys)


def make_train_step(model: nn.Module, spec, smpl_model: SMPLModel, prior: GMMPrior, options,
                    device: str | torch.device = "cuda", bar_mode: str = "0"):
    """Build train_step(state, batch) -> (state, metrics) on `device`.

    `batch` maps the keys of `step_feed_keys(spec)` to arrays or tensors:
    the modalities and recovery targets as [B, C, H, W] (NCHW), keypoints
    [B, 49, 3] in [-1, 1] with confidence, pose [B, 72], betas [B, 10],
    pose_3d [B, 24, 4], has_smpl / has_pose_3d / is_flipped / rot_angle
    (degrees) [B] and sample_index [B] (rows of the fits store).  The images
    are either normalized floats (the float feed) or the uint8 feed with its
    `pixel_noise` [B, 3]: uint8 images cross to the device as uint8 and are
    decoded there (`decode_uint8_batch`) before the cascade.  metrics holds
    the loss and its parts as detached scalars on the device.  Floating
    inputs are cast to the type of the model's parameters.  A fusion batch
    also holds `mask_uncover` and the uncovered images [B, 1, H, W]; a
    Bodies-At-Rest batch `pm_contact` [B, 2, H, W] and `mask_uncover`.

    `bar_mode` is Bodies-At-Rest's mode: "0" (with the body-mask term) or
    "1" (the step after `--mod1_epoch`).  After a step each trainable
    parameter's `.grad` holds the gradient that Adam took.

    In a process group (`parallel.mesh`) `batch` is this rank's rows of the
    global batch and `state` a replica: the gradients of every trainable
    parameter (zero where the loss does not reach it, the same parameters
    on every rank) are averaged by one bucketed all_reduce before Adam.
    DDP is not used: its unused-parameter search and its hooks would have
    to agree with the frozen guide, Bodies-At-Rest's mode "1" (no
    gradient at all) and the non-reentrant checkpoint of `--remat`, where
    one explicit all_reduce after the backward pass needs nothing.

    `options.remat` "stage" (or True) recomputes each cascade stage of the
    concat and multi families in the backward pass (`layers.checkpoint`:
    the same dropout masks, the running statistics updated once), which
    changes no number of the step; the fusion family and Bodies-At-Rest
    ignore it, as in JAX.  The model's compute dtype is its own
    (`build_model(dtype=)`); the geometry, SMPLify and the losses run in
    the parameters' float32.
    """
    dev = resolve_device(device)
    if bar_mode not in ("0", "1"):
        raise ValueError(f"bar_mode must be '0' or '1', not {bar_mode!r}")
    model.to(dev)
    smpl_model.to(dev)
    prior = GMMPrior(*(t.to(dev) for t in prior))
    img_res = float(options.img_res)
    focal = constants.FOCAL_LENGTH
    num_cas = int(options.num_cas_iters) if spec.cascade else 1
    run_smplify = bool(options.run_smplify)
    # --remat (stage) checkpoints each cascade stage of the concat and multi
    # families; --remat decoder is the model's own (build_model's
    # remat_decoder) and needs nothing here.
    remat_stages = getattr(options, "remat", False) in (True, "stage") and spec.input_mode in ("concat", "multi")
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

    def scatter_rows(indices, rot, is_flipped, update, pose, betas):
        """The fits update of every rank's rows, on every rank (in float64,
        which holds the indices and the float32 values exactly), so that
        the replicated store takes the global batch's updates."""
        if not mesh.is_initialized():
            return indices, rot, is_flipped, update, pose, betas
        packed = torch.cat([indices[:, None].double(), rot[:, None].double(), is_flipped[:, None].double(),
                            update[:, None].double(), pose.double(), betas.double()], dim=1)
        rows = mesh.gather_rows(packed)
        dt = pose.dtype
        return (rows[:, 0].long(), rows[:, 1].to(rot.dtype), rows[:, 2].to(is_flipped.dtype),
                rows[:, 3].to(update.dtype), rows[:, 4:76].to(dt), rows[:, 76:].to(dt))

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

        # Train-mode forwards (batch statistics, running-stat updates and
        # dropout): the cascade, or the fusion model's two stages, whose
        # shared encoder updates its running statistics twice, in order.
        inputs = tuple(batch[k] for k in spec.modalities)
        fusion_out = None
        if spec.input_mode == "fusion":
            fusion_out = model(inputs, smpl_model, generator=generator)
            stage_outs = [fusion_out.stage1, fusion_out.stage2]
        elif spec.input_mode == "pm_contact":
            stage_outs = [model(torch.cat(list(inputs) + [batch["pm_contact"]], dim=1), mode=bar_mode,
                                generator=generator)]
        else:
            def apply_fn(mods, **kw):
                x = torch.cat(list(mods), dim=1) if spec.input_mode == "concat" else tuple(mods)

                def stage(x):
                    return model(x, generator=generator, **kw)

                return checkpoint(stage, x, generator=generator) if remat_stages else stage(x)

            stage_outs = cascade_apply(apply_fn, inputs, num_cas, feed_map=spec.cascade_feed_map)
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
                fits = fits_set(fits, *scatter_rows(indices, batch["rot_angle"], batch["is_flipped"], update,
                                                    opt_pose, opt_betas))
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
        if spec.input_mode == "pm_contact":
            if bar_mode == "0":
                # The predicted mesh's body mask against the uncovered one.
                with torch.no_grad():
                    pred_mask = render_body_mask(pred_vertices, final.cam, img_res=int(img_res))
                loss_extra = loss_extra + 0.1 * L.recon_l1_loss(pred_mask, batch["mask_uncover"])
        elif fusion_out is None:
            for out in [final] + stage_outs[:-1]:
                for name, img in out.recon.items():
                    if UNCOVER_KEY.get(name) in batch:
                        loss_extra = loss_extra + L.recon_l1_loss(img, batch[UNCOVER_KEY[name]])
                if out is not final:
                    loss_extra = loss_extra + stage_aux_losses(out)
        else:
            # The body mask against the uncovered ground truth, each
            # recovered image gated by that mask, then stage 1's terms.
            mask_gt = batch["mask_uncover"]
            loss_extra = loss_extra + 0.01 * L.recon_l1_loss(fusion_out.mask, mask_gt)
            for name, img in fusion_out.recovered.items():
                if UNCOVER_KEY.get(name) in batch:
                    loss_extra = loss_extra + L.recon_l1_loss(img, batch[UNCOVER_KEY[name]], mask=mask_gt)
            loss_extra = loss_extra + stage_aux_losses(fusion_out.stage1)

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

        def cast(k, v):
            v = torch.as_tensor(v)
            if v.dtype == torch.uint8:
                return v.to(dev)
            return v.to(dev, torch.int64 if k == "sample_index" else dtype)

        decoded = decode_uint8_batch({k: cast(k, v) for k, v in batch.items()})
        return {k: v.to(dtype) if v.is_floating_point() else v for k, v in decoded.items()}

    def train_step(state: TrainState, batch):
        with span("train.step"):
            model.train()
            with span("train.h2d"):
                feed = to_device(batch)
            with span("train.loss"):
                total, fits, metrics = loss_fn(state.fits, feed, state.generator)
            params = trainable(model)
            # Bodies-At-Rest's mode "1" detaches every output: no gradient at all.
            with span("train.backward"):
                grads = (torch.autograd.grad(total, params, allow_unused=True) if total.requires_grad
                         else [None] * len(params))
            # A parameter the loss does not reach gets a zero gradient, so that
            # Adam still decays its moments, as optax does.
            for p, g in zip(params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            with span("train.allreduce"):
                mesh.sync_gradients(params)
            with span("train.optimizer"):
                state.optimizer.step()
            if mesh.is_initialized():  # the global batch's values: the mean over the ranks
                values = mesh.all_reduce_(torch.stack(list(metrics.values()))) / mesh.world_size()
                metrics = dict(zip(metrics, values))
            return dataclasses.replace(state, fits=fits, step=state.step + 1), metrics

    return train_step


class Trainer:
    """The epoch and step driver, on one device or data parallel.

    `options` are the train CLI's (`train.options.parse_args`); `train_ds`
    yields items of the training feed (a `MixedDataset` or `BaseDataset`
    with `is_train=True`).  On construction: the train step, the fits store
    (seeded from the checkpoint directory, then the static fits), the guide
    of a frozen-guided fusion pipeline from `--pretrained_fusion_checkpoint`,
    the `--pretrained_checkpoint` weights where their names and shapes match,
    a fresh Adam and the dropout generator (seed + 1), then, with
    `--resume`, the state of `--checkpoint` or else of the newest
    checkpoint in the directory.  `history` collects what `train` measures,
    one dict per event: "summary" (metrics, phase means in ms, wall ms per
    step, images/s), "save" (path, bytes, seconds), "eval" (seconds), and
    for Bodies-At-Rest "bar_mode" (the epoch and the step's mode, "0" or
    "1", at its start).

    In a process group (`parallel.mesh`) `options.batch_size` is the global
    batch, each rank loads and steps on its contiguous rows of it, the
    state is broadcast from rank 0 after set-up (and after a resume, which
    every rank reads), rank 0 alone writes the checkpoints, the fits and
    the summaries, and the exit on `time_to_run` is rank 0's decision,
    broadcast every step, so that no rank leaves while another waits in the
    next step's collective.  Where the JAX package runs its mesh on the
    largest device count that divides the batch and idles the other
    devices, this raises at set-up when the world size does not divide
    `batch_size`: the JAX package cannot choose its device count, and a
    torchrun user can.
    """

    def __init__(self, options, model, spec, smpl_model, prior, train_ds, summary_writer=None,
                 device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        world = mesh.world_size()
        if options.batch_size % world:
            largest = max(n for n in range(1, world + 1) if options.batch_size % n == 0)
            raise ValueError(f"--batch_size {options.batch_size} does not split over {world} ranks; the largest "
                             f"rank count that divides it is {largest}")
        self.options = options
        self.model = model
        self.spec = spec
        self.train_ds = train_ds
        self.summary_writer = summary_writer
        self.train_step = make_train_step(model, spec, smpl_model, prior, options, device=dev)
        # Bodies-At-Rest swaps to the mode-1 step from `--mod1_epoch` on.
        self._mode1_step = (make_train_step(model, spec, smpl_model, prior, options, device=dev, bar_mode="1")
                            if spec.input_mode == "pm_contact" else None)
        self.feed_keys = step_feed_keys(spec)
        layout = getattr(train_ds, "fits_layout", None) or [(options.data_train, len(train_ds))]
        self.fits_store = FitsStore(layout, checkpoint_dir=options.checkpoint_dir,
                                    static_fits_dir=config.asset("static_fits"), device=dev)
        if getattr(options, "pretrained_fusion_checkpoint", None):
            load_guide(model, options.pretrained_fusion_checkpoint)
        if getattr(options, "pretrained_checkpoint", None):
            load_pretrained(model, options.pretrained_checkpoint)
        self.state = init_train_state(model, options, self.fits_store.array, seed=options.seed + 1, device=dev)

        self.epoch0, self.checkpoint_batch_idx, self.step_count, self.dataset_perm = 0, 0, 0, None
        if options.resume:
            # An explicit --checkpoint wins over the newest file.
            ck = getattr(options, "checkpoint", None) or latest_checkpoint(options.checkpoint_dir)
            if ck:
                meta = resume_train_state(ck, self.state)
                for group in self.state.optimizer.param_groups:
                    group["lr"] = options.lr  # --lr, not the file's, as in the JAX package
                self.epoch0 = int(meta.get("epoch", 0))
                self.checkpoint_batch_idx = int(meta.get("batch_idx", 0))
                self.step_count = int(meta.get("total_step_count", 0))
                if meta.get("dataset_perm") is not None:
                    self.dataset_perm = np.asarray(meta["dataset_perm"])
        mesh.replicate(self.state)
        self.state.step = self.step_count
        self.history: list[dict] = []

    def _save(self, epoch: int, batch_idx: int, perm) -> None:
        t0 = time.perf_counter()
        self.fits_store.array = self.state.fits
        self.fits_store.save()
        path = save_checkpoint(self.options.checkpoint_dir, self.state, epoch=epoch, batch_idx=batch_idx,
                               batch_size=self.options.batch_size, dataset_perm=perm,
                               total_step_count=self.step_count)
        self.history.append({"kind": "save", "step": self.step_count, "path": path,
                             "bytes": os.path.getsize(path), "seconds": time.perf_counter() - t0})

    def _eval(self, eval_fn) -> None:
        t0 = time.perf_counter()
        eval_fn(self)
        self.history.append({"kind": "eval", "step": self.step_count, "seconds": time.perf_counter() - t0})

    def train(self, eval_fn=None) -> None:
        """Run the epochs from the resume point to `num_epochs`; `eval_fn`
        (called with the trainer) runs every `test_steps` and after each
        epoch's checkpoint."""
        opts = self.options
        start = time.time()
        # Phases: "data" waits on the loader, "dispatch" is the step's host
        # time (eager: most of the step), "sync" waits on the device for the
        # summary's metrics, the step's one read-back.  Each is also a
        # `train.<phase>` span.
        timer = StepTimer("train")
        window_t0, window_steps = time.time(), 0
        for epoch in range(self.epoch0, opts.num_epochs):
            if self._mode1_step is not None:
                if epoch >= opts.mod1_epoch:
                    self.train_step = self._mode1_step
                self.history.append({"kind": "bar_mode", "epoch": epoch,
                                     "mode": "1" if self.train_step is self._mode1_step else "0"})
            ckpt = None
            if epoch == self.epoch0 and self.dataset_perm is not None:
                ckpt = {"dataset_perm": self.dataset_perm, "batch_idx": self.checkpoint_batch_idx}
            loader = CheckpointDataLoader(self.train_ds, batch_size=opts.batch_size, shuffle=opts.shuffle_train,
                                          num_workers=opts.num_workers, checkpoint=ckpt, seed=opts.seed + epoch,
                                          rank=mesh.rank(), world_size=mesh.world_size())
            it = iter(loader)
            while True:
                with timer.phase("data"):
                    got = next(it, None)
                if got is None:
                    break
                batch_idx, batch = got
                with timer.phase("dispatch"):
                    feed = {k: v for k, v in batch.items() if k in self.feed_keys}
                    self.state, metrics = self.train_step(self.state, feed)
                self.step_count += 1
                window_steps += 1

                if self.step_count % opts.summary_steps == 0:
                    with timer.phase("sync"):
                        m = {k: float(v) for k, v in metrics.items()}
                    wall = time.time() - window_t0
                    ips = opts.batch_size * window_steps / wall if wall > 0 else 0.0
                    step_ms = 1000.0 * wall / window_steps
                    if self.summary_writer is not None and mesh.rank() == 0:
                        for k, v in m.items():
                            self.summary_writer.add_scalar(k, v, self.step_count)
                        self.summary_writer.add_scalar("perf/images_per_sec", ips, self.step_count)
                        self.summary_writer.add_scalar("perf/step_ms", step_ms, self.step_count)
                    if mesh.rank() == 0:
                        print(f"epoch {epoch} step {self.step_count}: "
                              + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                              + f" | {timer.summary()} wall_step={step_ms:.1f}ms ips={ips:.1f}", flush=True)
                    self.history.append({"kind": "summary", "epoch": epoch, "step": self.step_count, "metrics": m,
                                         "phases_ms": {k: 1e3 * v for k, v in timer.means.items()},
                                         "steps": window_steps, "wall_ms_per_step": step_ms, "images_per_s": ips})
                    timer.reset()
                    window_t0, window_steps = time.time(), 0

                if self.step_count % opts.checkpoint_steps == 0:
                    self._save(epoch, batch_idx + 1, loader.dataset_perm)
                if opts.test_steps and self.step_count % opts.test_steps == 0 and eval_fn:
                    self._eval(eval_fn)
                # One decision for every rank: rank 0's clock.
                if mesh.broadcast_object(time.time() - start > opts.time_to_run):
                    it.close()
                    self._save(epoch, batch_idx + 1, loader.dataset_perm)
                    print("Timeout reached: checkpoint saved, exiting cleanly", flush=True)
                    return
            self._save(epoch + 1, 0, loader.dataset_perm)
            if eval_fn:
                self._eval(eval_fn)
