"""The evaluation driver: score one split with MPJPE, PA-MPJPE, PVE and the
body-mask accuracy and F1.

The port of the JAX package's `evaluation/evaluate.py::run_evaluation`, on
one device or data parallel (`parallel.mesh`): as the JAX driver shards
each padded batch over its mesh, each rank infers its rows of each global
batch, and the per-sample metrics and the mask counts are summed over the
ranks at the end, so that the results are those of one process.  Per
batch: the host loader's batch (or its raw frames through the device
crop), the inference closure (cascade -> SMPL LBS, one skinning kernel
launch -> J17), the per-sample metrics, and for SLP splits the mesh
rasterized into a body mask, uncropped on the host and scored against the
ground-truth mask file.  The pose metrics stay on the device until a drain
point (every `log_freq` batches and the end), so that batches do not wait
for one another; the mask branch reads each batch's masks back, as the JAX
driver does.  With `result_file`, the first 8 samples of each batch are also
drawn on the host (`_save_artifacts`).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import cv2
import numpy as np
import torch

from .. import constants
from ..data.device_preprocess import make_device_preprocess
from ..data.image_io import read_gray_u8, write
from ..data.loader import CheckpointDataLoader
from ..data.transforms import uncrop
from ..device import resolve_device
from ..geometry import rotmat_to_aa, weak_perspective_to_cam_t_np
from ..parallel import mesh
from ..render.part_renderer import PartRenderer
from ..render.renderer import Renderer
from ..smpl.model import SMPLModel, smpl_forward
from ..utils.profiling import StepTimer
from .pipeline import eval_metrics, load_j_regressor_h36m, make_inference_fn, regress_j17


# Samples drawn a batch, which keeps the dumps small.
_DUMPS_PER_BATCH = 8

# Normalization of each recovered modality: (mean, std).
_RECON_NORM = {"depth": (constants.DEPTH_NORM_MEAN, constants.DEPTH_NORM_STD),
               "ir": (constants.IR_NORM_MEAN, constants.IR_NORM_STD),
               "pm": (constants.PM_NORM_MEAN, constants.PM_NORM_STD)}


def _gt_mask_path(imgname: str) -> str:
    """The ground-truth body mask of an SLP RGB frame (the reference's
    rewriting: RGB -> masks, cover1/cover2 -> uncover, no `image_`)."""
    return (imgname.replace("RGB", "masks").replace("cover1", "uncover").replace("cover2", "uncover")
            .replace("image_", ""))


def mask_confusion(masks: np.ndarray, batch: dict, bs: int):
    """Mask scores of the first `bs` samples of a batch: each predicted mask
    [res, res] is uncropped (nearest) to its frame and compared with the
    ground-truth mask file.  Returns (correct pixels, pixels, tp [2],
    fp [2], fn [2]) over background (0) and body (1); samples without a
    ground-truth file are skipped."""
    correct, pixels = 0, 0
    tp, fp, fn = np.zeros(2), np.zeros(2), np.zeros(2)
    for i in range(bs):
        pred = uncrop((masks[i] > 0).astype(np.uint8), batch["center"][i], batch["scale"][i],
                      batch["orig_shape"][i]) > 0
        gt_img = read_gray_u8(_gt_mask_path(batch["imgname"][i]))
        if gt_img is None:
            continue
        gt = gt_img > 0
        correct += (gt == pred).sum()
        pixels += int(np.prod(gt.shape))
        for c in range(2):
            cgt, cpred = gt == c, pred == c
            tp[c] += (cgt & cpred).sum()
            fp[c] += (~cgt & cpred).sum()
            fn[c] += (cgt & ~cpred).sum()
    return correct, pixels, tp, fp, fn


def _parts_confusion(parts: np.ndarray, batch: dict, bs: int):
    """LSP 6-part segmentation scores of a batch: (correct, pixels, tp [7],
    fp [7], fn [7]); label 255 in the ground truth is ignored."""
    correct, pixels = 0, 0
    tp, fp, fn = np.zeros(7), np.zeros(7), np.zeros(7)
    for i in range(bs):
        pp = uncrop(parts[i].astype(np.uint8), batch["center"][i], batch["scale"][i], batch["orig_shape"][i])
        partname = batch.get("partname", [""] * bs)[i]
        gt = read_gray_u8(partname) if partname else None
        if gt is None:
            continue
        for c in range(7):
            cgt, cpred = gt == c, pp == c
            cpred[gt == 255] = 0
            tp[c] += (cgt & cpred).sum()
            fp[c] += (~cgt & cpred).sum()
            fn[c] += (cgt & ~cpred).sum()
        gt = gt.copy()
        gt[gt == 255] = 0
        pp[pp == 255] = 0
        correct += (gt == pp).sum()
        pixels += int(np.prod(gt.shape))
    return correct, pixels, tp, fp, fn


def _accumulate(totals: list, scores) -> None:
    for j, v in enumerate(scores):
        totals[j] = totals[j] + v


def _rodrigues(aa: np.ndarray) -> np.ndarray:
    """Axis-angle [3] -> rotation matrix [3, 3] (cv2.Rodrigues), float64."""
    aa = np.asarray(aa, np.float64)
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        return np.eye(3)
    k = aa / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _stretch_depth(depth_u8: np.ndarray, black: np.ndarray) -> np.ndarray:
    """The reference's bed / background contrast stretch (eval.py:362-367):
    uint8 pixels below 220 (the bed) become (v - 150) * 3 with uint8
    wraparound, the background (>= 220) passes, the black crop becomes 0."""
    out = depth_u8.copy()
    bed = out < 220
    out[bed] = ((out[bed].astype(np.int64) - 150) * 3).astype(np.uint8)
    out[black] = 0
    return out


def _save_artifacts(result_file, dataset_name, offset, batch, preds, smpl_model, img_res, pred_masks=None,
                    count=None):
    """Draw the first 8 samples of a batch (or its first `count`, when
    fewer) into <result_file>/<dataset_name>/
    as the reference's eval.py:294-378 does, file names <offset + i>_*.png:
      * `shape`: the mesh painted over the input RGB crop; `shape_side`,
        `shape_top`: the mesh turned 90 degrees about its centroid (y, then
        -x), on black;
      * per recovered modality: `<name>_recovered` (grey); for IR `irout`
        (COLORMAP_HOT); for depth `depthoutori` (the contrast stretch) and
        `depthout` (stretched, COLORMAP_OCEAN); the crop's black padding
        zeroed in the colour maps;
      * `mask`: the predicted body mask, when `pred_masks` is given.

    `batch` is the host loader's (it needs `img`, [bs, 3, res, res]
    normalized); `preds` are the inference closure's outputs on any device,
    of which the first rows are read back once.  Unlike the JAX package's,
    a failed render or write raises: the port has no optional renderer to
    fall back from.  Only the modalities with a normalization are drawn:
    the fusion models' `mask` (on which the JAX package raises a KeyError)
    and Bodies-At-Rest's `est_map` are not images of a modality.
    """
    out_dir = os.path.join(result_file, dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    imgs = np.moveaxis(np.asarray(batch["img"]), 1, -1)  # [bs, res, res, 3]
    n = min(imgs.shape[0] if count is None else count, _DUMPS_PER_BATCH)
    cam_t = weak_perspective_to_cam_t_np(preds["cam"][:n].detach().cpu().numpy(), constants.FOCAL_LENGTH, img_res)
    verts = preds["vertices"][:n].detach().cpu().numpy()
    recon = {k: v[:n].detach().float().cpu().numpy() for k, v in preds.get("recon", {}).items() if k in _RECON_NORM}
    masks = pred_masks[:n].detach().cpu().numpy() if pred_masks is not None else None
    renderer = Renderer(focal_length=constants.FOCAL_LENGTH, img_res=img_res, faces=smpl_model.faces)
    mean, std = np.asarray(constants.IMG_NORM_MEAN), np.asarray(constants.IMG_NORM_STD)
    around_side = _rodrigues(np.array([0.0, np.radians(90.0), 0.0]))
    around_top = _rodrigues(np.array([-np.radians(90.0), 0.0, 0.0]))
    for i in range(n):
        prefix = os.path.join(out_dir, f"{offset + i:06d}")
        rgb = np.clip(imgs[i] * std + mean, 0, 1)
        # The crop's zero padding: black in the de-normalized image.
        black = imgs[i][:, :, 0] * std[0] + mean[0] < 1e-4
        center = verts[i].mean(axis=0)
        views = {"shape": renderer(verts[i], cam_t[i], rgb),
                 "shape_side": renderer((verts[i] - center) @ around_side + center, cam_t[i]),
                 "shape_top": renderer((verts[i] - center) @ around_top + center, cam_t[i])}
        for name, img in views.items():
            write(f"{prefix}_{name}.png", (img[:, :, ::-1] * 255).astype(np.uint8))
        for name, img in recon.items():
            mean_r, std_r = _RECON_NORM[name]
            rec_u8 = (np.clip(img[i, 0] * std_r[0] + mean_r[0], 0, 1) * 255).astype(np.uint8)
            write(f"{prefix}_{name}_recovered.png", rec_u8)
            if name == "ir":
                ir_cm = cv2.applyColorMap(rec_u8, cv2.COLORMAP_HOT)
                ir_cm[black] = 0
                write(f"{prefix}_irout.png", ir_cm)
            elif name == "depth":
                d_st = _stretch_depth(rec_u8, black)
                write(f"{prefix}_depthoutori.png", d_st)
                d_cm = cv2.applyColorMap(d_st, cv2.COLORMAP_OCEAN)
                d_cm[black] = 0
                write(f"{prefix}_depthout.png", d_cm)
        if masks is not None:
            write(f"{prefix}_mask.png", (masks[i] > 0).astype(np.uint8) * 255)


def _sum_over_ranks(arrays: list) -> list:
    """Each array (or number) summed over the ranks, in float64, with one
    all-reduce."""
    shapes = [np.shape(a) for a in arrays]
    flat = mesh.all_reduce_numpy(np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays]))
    out, off = [], 0
    for shape in shapes:
        size = int(np.prod(shape))
        out.append(flat[off:off + size].reshape(shape) if shape else flat[off])
        off += size
    return out


def run_evaluation(
    model,
    spec,
    dataset_name: str,
    dataset,
    smpl_model: SMPLModel,
    smpl_gendered: Optional[tuple] = None,
    result_file: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    epoch: int = 0,
    batch_idx=None,
    batch_size: int = 32,
    img_res: int = constants.IMG_RES,
    num_workers: int = 8,
    shuffle: bool = False,
    log_freq: int = 50,
    num_cas_iters: int = 2,
    eval_masks_enabled: bool = True,
    device_preprocess: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """Evaluate `model` (any input family) on `dataset` on `device`.

    Returns {"mpjpe", "pa_mpjpe", "pve" (mm), "mask_accuracy", "mask_f1",
    "parts_accuracy", "parts_f1", "timing"} and appends the metrics to
    <checkpoint_dir>/log.txt.  A metric the split cannot give is None.
    "timing" holds the host clock's view of the run: images, batches,
    seconds, images_per_s, loader_wait_s (blocked on the next batch) and
    mask_s (the mask branch: its read-back, the host uncrop and scores)
    and dump_s (the image dumps), the phases `data`, `mask` and `dump` of
    a `StepTimer("eval")`, so also `eval.*` spans in a profiler's trace.
    With `result_file`, writes <result_file>/smpl_fits/<split>_fits.npz
    (pose [N, 72] axis-angle, rotmat, betas, camera, pred_joints) and the
    image dumps of `_save_artifacts` under <result_file>/<split>/; the raw
    frames of `device_preprocess` have no host image to draw on, so that
    mode writes the npz only and says so once.

    Data parallel: `batch_size` is the global batch, which the world size
    must divide.  Each rank loads and infers its rows of each batch, the
    split's order padded to whole batches with its last sample; the rank
    that holds a sample scores it and draws its dumps, and rank 0 writes
    log.txt and the npz.  Every rank returns the whole split's results.
    The running MPJPE printed every `log_freq` batches is one process's
    only.
    """
    t_start = time.perf_counter()
    dev = resolve_device(device)
    world, rank = mesh.world_size(), mesh.rank()
    if batch_size % world:
        raise ValueError(f"an eval batch of {batch_size} does not split over {world} ranks")
    local_bs = batch_size // world
    smpl_model.to(dev)
    n = len(dataset)
    V = smpl_model.v_template.shape[0]
    jreg_np = load_j_regressor_h36m(num_vertices=V)
    # The final stage's image reconstructions only feed the artifact dumps.
    infer = make_inference_fn(model, spec, smpl_model, j_regressor_h36m=jreg_np, num_cas_iters=num_cas_iters,
                              final_recon=result_file is not None, device=dev)
    jreg = torch.as_tensor(jreg_np, device=dev)

    mpjpe, recon_err, pve = np.zeros(n), np.zeros(n), np.zeros(n)
    # PVE averages over samples with ground-truth SMPL only.
    pve_valid = np.zeros(n, dtype=bool)
    pending = []  # per-batch metrics left on the device until a drain point

    def drain():
        for plo, phi, pbs, err_d, pa_d, pv_d, pvalid in pending:
            mpjpe[plo:phi] = err_d[:pbs].cpu().numpy()
            recon_err[plo:phi] = pa_d[:pbs].cpu().numpy()
            if pv_d is not None:
                pve[plo:phi] = pv_d[:pbs].cpu().numpy() * pvalid
                pve_valid[plo:phi] = pvalid
        pending.clear()

    mask_totals = [0, 0, np.zeros(2), np.zeros(2), np.zeros(2)]
    parts_totals = [0, 0, np.zeros(7), np.zeros(7), np.zeros(7)]

    save_results = result_file is not None
    if save_results:
        smpl_pose, smpl_betas = np.zeros((n, 24, 3, 3)), np.zeros((n, 10))
        smpl_camera, pred_joints_out = np.zeros((n, 3)), np.zeros((n, 17, 3))

    eval_pose = dataset_name.startswith("slp") or any(k in dataset_name for k in ("h36m", "3dpw", "mpi-inf"))
    # Ground truth: slp / h36m / mpi-inf carry packed 3D joints; the others
    # (3dpw) regress them from ground-truth SMPL meshes of each sample's
    # gender (gender == 1 selects the female model).
    packed_3d_gt = any(k in dataset_name for k in ("h36m", "mpi-inf", "slp"))
    if eval_pose and not packed_3d_gt:
        if smpl_gendered is not None:
            smpl_male, smpl_female = (m.to(dev) for m in smpl_gendered)
        else:
            print("WARNING: no gendered SMPL models — gendered-GT eval falls back to the neutral model "
                  "for both genders (reference loads male/female, eval.py:66-73)")
            smpl_male = smpl_female = smpl_model

        @torch.no_grad()
        def gendered_gt(betas, pose, gender):
            vm = smpl_forward(smpl_male, betas, pose_aa=pose).vertices
            vf = smpl_forward(smpl_female, betas, pose_aa=pose).vertices
            gv = torch.where((gender == 1)[:, None, None], vf, vm)
            return regress_j17(jreg, gv), gv

    eval_masks = eval_masks_enabled and dataset_name.startswith("slp")
    eval_parts = eval_masks_enabled and dataset_name == "lsp"
    part_renderer = None
    if eval_masks or eval_parts:
        # One mesh rasterization serves the mask and the parts scores.
        part_renderer = PartRenderer(render_res=img_res, num_vertices=V,
                                     template=smpl_model.v_template.cpu().numpy(),
                                     faces=smpl_model.faces.cpu().numpy(), render_labels=eval_parts, device=dev)
    jm_gt = np.asarray(constants.J24_TO_J17)

    # Every sample is scored, and the padded rows are sliced off.  Every rank
    # takes rank 0's order; in a process group it is padded to whole batches
    # with its last sample, so that each rank loads its rows of the tail
    # batch, and one process pads its tail batch on the host instead.
    order = mesh.broadcast_object(np.random.default_rng().permutation(n) if shuffle else np.arange(n))
    if world > 1:
        order, _ = mesh.pad_to_multiple(order, batch_size)
    loader = CheckpointDataLoader(dataset, batch_size=batch_size, num_workers=num_workers,
                                  checkpoint={"dataset_perm": order}, drop_last=False, rank=rank, world_size=world)
    # Bodies-At-Rest takes the contact channels after the modalities.
    feed_keys = spec.modalities + (("pm_contact",) if spec.input_mode == "pm_contact" else ())
    pre_fn = None
    if device_preprocess and spec.input_mode in ("concat", "multi"):
        pre_fn = make_device_preprocess(res=img_res, device=dev)

    def to_dev(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    timer = StepTimer("eval")
    warned_raw = False
    batches = iter(loader)
    while True:
        with timer.phase("data"):
            got = next(batches, None)
        if got is None:
            break
        step, batch = got
        # This rank's rows are the split's positions lo..hi; the rest of
        # its local_bs rows are padding.
        lo = step * batch_size + rank * local_bs
        bs = int(np.clip(n - lo, 0, local_bs))
        hi = lo + bs
        dev_batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
        dev_batch, _ = mesh.pad_to_multiple(dev_batch, local_bs)  # one process's tail batch
        if pre_fn is not None:  # no flip, no channel noise at eval
            dev_batch.update(pre_fn({k: dev_batch["raw_" + k] for k in spec.modalities if "raw_" + k in dev_batch},
                                    dev_batch["center"], dev_batch["scale"], np.zeros(local_bs, np.float32),
                                    np.ones((local_bs, 3), np.float32)))
        preds = infer(tuple(dev_batch[k] for k in feed_keys))

        if eval_pose:
            gt_verts = None
            if packed_3d_gt:
                gt_kp3d = to_dev(dev_batch["pose_3d"][:, jm_gt, :3])
            else:
                gt_kp3d, gt_verts = gendered_gt(to_dev(dev_batch["betas"]), to_dev(dev_batch["pose"]),
                                                to_dev(dev_batch["gender"], torch.int64))
            metrics = eval_metrics(preds["keypoints_3d_17"], gt_kp3d)
            # PVE against the ground-truth mesh where the sample has SMPL.
            pv_dev, valid = None, np.zeros(bs, dtype=bool)
            if np.any(batch["has_smpl"][:bs] > 0):
                if gt_verts is None:
                    with torch.no_grad():
                        gt_verts = smpl_forward(smpl_model, to_dev(dev_batch["betas"]),
                                                pose_aa=to_dev(dev_batch["pose"])).vertices
                pv_dev = torch.sqrt(torch.sum((preds["vertices"] - gt_verts) ** 2, dim=-1)).mean(dim=-1)
                valid = np.asarray(batch["has_smpl"][:bs] > 0)
            pending.append((lo, hi, bs, metrics["mpjpe"], metrics["pa_mpjpe"], pv_dev, valid))

        if part_renderer is not None:
            with timer.phase("mask"):
                masks_dev, parts_dev = part_renderer(preds["vertices"], preds["cam"])
                if eval_masks:
                    _accumulate(mask_totals, mask_confusion(masks_dev.cpu().numpy(), batch, bs))
                if eval_parts:
                    _accumulate(parts_totals, _parts_confusion(parts_dev.cpu().numpy(), batch, bs))

        if save_results:
            smpl_pose[lo:hi] = preds["rotmat"][:bs].cpu().numpy()
            smpl_betas[lo:hi] = preds["betas"][:bs].cpu().numpy()
            smpl_camera[lo:hi] = preds["cam"][:bs].cpu().numpy()
            pred_joints_out[lo:hi] = preds["keypoints_3d_17"][:bs].cpu().numpy()
            with timer.phase("dump"):
                if "img" in batch:
                    # The batch's first 8 samples, each drawn by the rank that holds it.
                    _save_artifacts(result_file, dataset_name, lo, batch, preds, smpl_model, img_res,
                                    pred_masks=masks_dev if part_renderer is not None else None,
                                    count=min(bs, max(0, _DUMPS_PER_BATCH - rank * local_bs)))
                elif not warned_raw:
                    print("artifact dumps unavailable under --device_preprocess "
                          "(normalized images never materialize on the host)")
                    warned_raw = True

        if log_freq and step % log_freq == log_freq - 1 and eval_pose and world == 1:
            drain()
            print(f"MPJPE: {1000 * mpjpe[:hi].mean()}")
            print(f"Reconstruction Error: {1000 * recon_err[:hi].mean()}")

    drain()
    if mesh.is_initialized():
        # Each rank wrote only its samples' positions (zeros elsewhere), so
        # the sums over the ranks are the whole split's, exactly.
        arrays = [mpjpe, recon_err, pve, pve_valid, *mask_totals, *parts_totals]
        if save_results:
            arrays += [smpl_pose, smpl_betas, smpl_camera, pred_joints_out]
        summed = _sum_over_ranks(arrays)
        mpjpe, recon_err, pve, pve_valid = summed[0], summed[1], summed[2], summed[3] > 0
        mask_totals, parts_totals = summed[4:9], summed[9:14]
        if save_results:
            smpl_pose, smpl_betas, smpl_camera, pred_joints_out = summed[14:]

    def f1(tp, fp, fn):
        return float((2 * tp / np.maximum(2 * tp + fp + fn, 1)).mean())

    correct, pixels, tp, fp, fn = mask_totals
    p_correct, p_pixels, p_tp, p_fp, p_fn = parts_totals
    results = {
        "mpjpe": 1000 * mpjpe.mean() if eval_pose else None,
        "pa_mpjpe": 1000 * recon_err.mean() if eval_pose else None,
        "pve": (1000 * pve[pve_valid].mean() if pve_valid.any() else None) if eval_pose else None,
        "mask_accuracy": (correct / pixels) if pixels else None,
        "mask_f1": f1(tp, fp, fn) if pixels else None,
        "parts_accuracy": (p_correct / p_pixels) if p_pixels else None,
        "parts_f1": f1(p_tp, p_fp, p_fn) if p_pixels else None,
    }

    if save_results and rank == 0:
        out_dir = os.path.join(result_file, "smpl_fits")
        os.makedirs(out_dir, exist_ok=True)
        # The reference's schema: `pose` is [N, 72] axis-angle; the rotation
        # matrices it came from are kept under `rotmat`.
        pose_aa = rotmat_to_aa(torch.as_tensor(smpl_pose, dtype=torch.float32)).double().numpy().reshape(n, 72)
        np.savez(os.path.join(out_dir, f"{dataset_name}_fits.npz"), pred_joints=pred_joints_out, pose=pose_aa,
                 betas=smpl_betas, camera=smpl_camera, rotmat=smpl_pose)

    if eval_pose and rank == 0:
        print(f"{dataset_name}: MPJPE: {results['mpjpe']}")
        print(f"\tReconstruction Error: {results['pa_mpjpe']}")
        if checkpoint_dir:
            with open(os.path.join(checkpoint_dir, "log.txt"), "a") as f:
                f.write(datetime.datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
                        + f"\t[epoch: {epoch}], batch_idx: {batch_idx}\n")
                f.write(f"{dataset_name}\tMPJPE: {results['mpjpe']}")
                f.write(f"\tReconstruction Error: {results['pa_mpjpe']}")
                if results["mask_accuracy"] is not None:
                    f.write(f"\tFB Accuracy: {results['mask_accuracy']}")
                    f.write(f"\tFB F1: {results['mask_f1']}")
                f.write("\n")
    if results["mask_accuracy"] is not None and rank == 0:
        print("Accuracy: ", results["mask_accuracy"])
        print("F1: ", results["mask_f1"])
    mesh.barrier()  # log.txt and the npz are written before any rank returns
    seconds = time.perf_counter() - t_start
    results["timing"] = {"images": n, "batches": len(loader), "seconds": seconds, "images_per_s": n / seconds,
                         "loader_wait_s": timer.totals["data"], "mask_s": timer.totals["mask"],
                         "dump_s": timer.totals["dump"]}
    return results
