#!/usr/bin/env python3
"""Run the PyTorch port's eval inference path and its training step on one
CUDA card and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, in order; any failure exits non-zero before the last line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel source under the port's ops/csrc with nvcc for
     sm_90a, one process per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (skinning: the affines strided as lbs passes
     them, and contiguous), at the training batch (64) and at ragged edges,
     its gradient, and its time (CUDA graph and eager, CUDA events) beside
     its bound, the plain version's time and the single-node floor;
  4. main path: cashmrV2 at full width (batch 32, 224x224, float32, seeded
     random weights, 2-pass cascade, final_recon=False) -> SMPL LBS -> J17
     -> MPJPE / PA-MPJPE through `make_inference_fn`, with the launch
     counts read around one call; its outputs checked against the plain
     skinning on the card and against the CPU on a small input; images/s;
  5. train step: cashmrV2 at full width with the train CLI's defaults
     (batch 64, 224x224, float32, 2-pass cascade, lr 5e-5) and SMPLify in
     the loop (100 Adam steps a stage), a 256-row fits store and a seeded
     synthetic batch, through `make_train_step`: the skinning launches of
     one step (6 + 2 * 100), finite loss and metrics, the batch's fits rows,
     the parameters and the BatchNorm statistics changed; ms per step,
     images/s and peak memory; the cascade's forward+backward, one SMPLify
     call and the rest timed apart; the skinning backward per call; the
     device's busy share of one step (torch.profiler); SMPLify through the
     kernel against the plain skinning at batch 64; and the step on the
     card against the CPU (float32, with float64 as the yardstick of
     float32's own error) at a small size;
  6. eval driver: a synthetic SLP tree at SLP's frame size (45 samples a
     split), then the eval CLI `eval_gpu.main` at its defaults (cashmrV2,
     batch 32, 224x224, masks on) over the three default splits, and over
     slp-4mod-uncover with --device_preprocess and --result_file: one
     skinning launch per batch, finite MPJPE >= PA-MPJPE, mask accuracy and
     F1, the results npz; images/s, time waiting on the loader, inference,
     mask raster (K3), host uncrop + F1 and device crop (K5) per batch, peak
     memory, the card's busy share of one split (torch.profiler); K3 and K5 on the card against the CPU; and the CLI on the card
     against the CPU at RES 64 over 2-sample splits.
Then the kernel table as one JSON line, the nvidia-smi line, and
{"ok": true, "device": ...} as the last line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

MODEL, BATCH, RES, NUM_CAS_ITERS, SEED = "cashmrV2", 32, 224, 2, 0
TIMED_CALLS = 20

# Phase 5: the train CLI's defaults with SMPLify on; the small step that is
# also run on the CPU.
TRAIN_ARGS = ["--run_smplify"]
SMALL_TRAIN_ARGS = TRAIN_ARGS + ["--img_res", "64", "--batch_size", "2", "--num_smplify_iters", "2"]
FITS_ROWS, TIMED_STEPS, CHECK_SMPLIFY_ITERS = 256, 3, 5
# The small step on the card against the CPU, with the cascade's depth
# feedback and without it: the largest relative error of the loss and its
# parts; the worst gradient leaf's distance to the CPU's float64 step over
# float32's own error there; the BatchNorm statistics' error over
# (tol + tol * |value|); the fits' largest absolute error.  Each limit is
# 2-3.5x the card's reading with TF32 off (PERF.md, PR 3); the same step
# with TF32 on must break at least one.
CARD_VS_CPU_LIMITS = {
    "two_pass": {"feed_map": (("depth", 2),), "metrics": 1e-4, "grads": 3.0, "bn_stats_tol": 1e-3, "fits": 4e-4},
    "two_pass_no_feedback": {"feed_map": (), "metrics": 1.5e-5, "grads": 3.0, "bn_stats_tol": 3e-5, "fits": 1e-5},
}

# Phase 6: the eval CLI at its defaults (cashmrV2, batch 32, 224x224, 2-pass
# cascade, masks on, seeded weights, synthetic SMPL) over a synthetic SLP tree
# of SLP's frame size (RGB 1024 high x 576 wide; the aligned IR, depth and
# pressure frames are warped into it) with one subject's 45 poses per split:
# one full batch and a padded tail of 13.
SLP_FRAME_HW, EVAL_SAMPLES = (1024, 576), 45
EVAL_ARGS = ["--model", MODEL, "--allow_synthetic_assets"]
# The same CLI on the card and on the CPU at RES 64 over 2-sample splits: the
# largest relative difference of MPJPE and PA-MPJPE and the largest absolute
# difference of the mask scores over the three splits.  The pose limits are
# 2-3.5x the card's largest readings (MPJPE 5.4e-8 and 1.09e-7 in two runs,
# PA-MPJPE 6.2e-8 in both; PERF.md, PR 4); the mask scores read 0, so their
# limits are one pixel of a split's 38,400 (accuracy) and the F1 that one
# pixel can move.
EVAL_SMALL_ARGS = EVAL_ARGS + ["--img_res", "64", "--batch_size", "2", "--num_workers", "1"]
EVAL_CARD_VS_CPU_LIMITS = {"mpjpe": 3e-7, "pa_mpjpe": 1.5e-7, "mask_accuracy": 2.6e-5, "mask_f1": 1e-4}
# K3 on the card against the CPU at batch 32, 224x224, tile 28, SMPL's 13776
# faces: pixels that may differ (the card read 0, as on the CPU against JAX).
K3_CARD_VS_CPU_MAX_PIXELS = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def train_batch(np, spec, batch_size, res, rows, seed):
    """A synthetic batch with the keys one train step reads (NCHW images)."""
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS

    r = np.random.default_rng(seed)
    B = batch_size
    batch = {m: r.normal(0, 1, (B, MODALITY_CHANNELS[m], res, res)) for m in spec.modalities}
    batch.update({
        "depth_img_uncover": r.normal(0, 1, (B, 1, res, res)),
        "keypoints": np.concatenate([r.uniform(-0.8, 0.8, (B, 49, 2)), r.uniform(0.5, 1.0, (B, 49, 1))], -1),
        "pose": r.normal(0, 0.2, (B, 72)),
        "betas": r.normal(0, 0.5, (B, 10)),
        "pose_3d": np.concatenate([r.normal(0, 0.3, (B, 24, 3)), np.ones((B, 24, 1))], -1),
        "has_smpl": np.arange(B) % 2,  # half from the ground truth, half from the fits
        "has_pose_3d": np.ones(B),
        "is_flipped": r.integers(0, 2, B),
        "rot_angle": r.uniform(-30, 30, B),
        "sample_index": r.choice(rows, B, replace=False),
    })
    return {k: np.asarray(v, np.int64 if k == "sample_index" else np.float32) for k, v in batch.items()}


def small_step(torch, np, device, dtype, feed_map, state_dict, tf32=False):
    """One train step at SMALL_TRAIN_ARGS on `device` in `dtype` from the
    weights `state_dict` (dropout off), with the cascade's feedback
    `feed_map`: (metrics, gradients, BatchNorm statistics, fits) as float64
    numpy arrays keyed by name.  `tf32` lets the step's matrix products and
    convolutions run in TF32 (the entry points turn it off)."""
    import dataclasses

    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
    from inbed_pose_estimation_tpu_torch.train import build_parser, init_train_state, make_train_step

    options = build_parser().parse_args(SMALL_TRAIN_ARGS)
    model, spec = build_model(MODEL, device=device, dropout_rate=0.0)
    model.load_state_dict(state_dict)
    model.to(dtype)
    spec = dataclasses.replace(spec, cascade_feed_map=feed_map)
    prior = synthetic_gmm_prior(device=device)
    fits = np.random.default_rng(SEED).normal(0, 0.2, (FITS_ROWS, 82))
    state = init_train_state(model, options, fits, seed=SEED, device=device)
    step = make_train_step(model, spec, synthetic_smpl_model(SEED, device=device).to(dtype),
                           type(prior)(*(t.to(dtype) for t in prior)), options, device=device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    state, metrics = step(state, train_batch(np, spec, options.batch_size, options.img_res, FITS_ROWS, SEED + 1))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def host(t):
        return t.detach().double().cpu().numpy()

    return ({k: float(v) for k, v in metrics.items()},
            {k: host(p.grad) for k, p in model.named_parameters()},
            {k: host(b) for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))},
            host(state.fits))


def card_vs_cpu(torch, np, dev):
    """The small step on the card against the CPU on the same weights, state
    and batch, for each case of CARD_VS_CPU_LIMITS, in true float32 and,
    as the control that shows the limits can fail, with TF32 on."""
    from inbed_pose_estimation_tpu_torch.models import build_model

    torch.manual_seed(SEED + 2)
    cpu_model, _ = build_model(MODEL, device="cpu", dropout_rate=0.0)
    weights = cpu_model.state_dict()

    def readings(card, cpu, cpu64, limits):
        floor = {k: np.linalg.norm(cpu[1][k] - cpu64[1][k]) + 1e-4 * np.linalg.norm(cpu64[1][k]) for k in cpu[1]}
        tol = limits["bn_stats_tol"]
        return {
            "metrics": max(abs(card[0][k] / cpu[0][k] - 1) for k in cpu[0] if cpu[0][k] != 0),
            "grads": max(float(np.linalg.norm(card[1][k] - cpu64[1][k]) / floor[k]) for k in cpu[1]),
            "bn_stats": max(float((np.abs(card[2][k] - cpu[2][k]) / (tol + tol * np.abs(cpu[2][k]))).max())
                            for k in cpu[2]),
            "fits": float(np.abs(card[3] - cpu[3]).max()),
        }

    report = {}
    for name, limits in CARD_VS_CPU_LIMITS.items():
        feed_map = limits["feed_map"]
        cpu = small_step(torch, np, "cpu", torch.float32, feed_map, weights)
        cpu64 = small_step(torch, np, "cpu", torch.float64, feed_map, weights)
        got = readings(small_step(torch, np, dev, torch.float32, feed_map, weights), cpu, cpu64, limits)
        tf32 = readings(small_step(torch, np, dev, torch.float32, feed_map, weights, tf32=True), cpu, cpu64, limits)
        bounds = {k: 1.0 if k == "bn_stats" else limits[k] for k in got}
        report[name] = {"readings": got, "limits": bounds, "bn_stats_tol": limits["bn_stats_tol"],
                        "tf32_control_readings": tf32}
        for k, v in got.items():
            check(v <= bounds[k], f"card vs CPU ({name}): {k} reads {v:.3g}, limit {bounds[k]:.3g}")
        check(any(v > bounds[k] for k, v in tf32.items()),
              f"card vs CPU ({name}): the TF32 control meets every limit, so they cannot tell TF32 from float32")
    return report


def train_phase(torch, np, dev, smi, smpl, cuda_ms):
    """Phase 5; returns the skinning launches of one train step."""
    from torch.profiler import ProfilerActivity, profile

    from inbed_pose_estimation_tpu_torch.fitting import make_smplify, synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.geometry import batch_rodrigues
    from inbed_pose_estimation_tpu_torch.models import build_model, cascade_apply
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk
    from inbed_pose_estimation_tpu_torch.train import (
        FitsStore, build_parser, init_train_state, make_train_step, step_feed_keys,
    )

    options = build_parser().parse_args(TRAIN_ARGS)
    B, N = options.batch_size, options.num_smplify_iters
    torch.manual_seed(SEED + 1)
    model, spec = build_model(MODEL, device=dev)
    prior = synthetic_gmm_prior(device=dev)
    store = FitsStore("synthetic", FITS_ROWS, device=dev)
    state = init_train_state(model, options, store.array, seed=SEED, device=dev)
    step = make_train_step(model, spec, smpl, prior, options, device=dev)
    host = train_batch(np, spec, B, options.img_res, FITS_ROWS, SEED)
    check(set(host) == step_feed_keys(spec), "the synthetic batch lacks a key the step reads")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    rows = batch["sample_index"]
    params0 = [p.detach().clone() for p in model.parameters()]
    stats0 = {k: b.clone() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))}
    fits0 = state.fits.clone()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = sk.launches
    log("train_step", model=MODEL, batch=B, res=options.img_res, num_cas_iters=options.num_cas_iters,
        num_smplify_iters=N, lr=options.lr, fits_rows=FITS_ROWS, launches={"skinning": launches},
        expected=6 + 2 * N, first_step_s=first_s, metrics={k: v.item() for k, v in metrics.items()})
    check(launches == 6 + 2 * N, f"skinning launched {launches} times in one train step, expected {6 + 2 * N}")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), "train step: a non-finite loss or metric")
    others = torch.ones(FITS_ROWS, dtype=torch.bool, device=dev)
    others[rows] = False
    fits_changed = int((state.fits[rows] != fits0[rows]).any(dim=1).sum())
    check(fits_changed > 0, "train step: SMPLify changed none of the batch's fits rows")
    check(torch.equal(state.fits[others], fits0[others]), "train step: fits rows outside the batch changed")
    check(all(not torch.equal(a, p) for a, p in zip(params0, model.parameters())),
          "train step: a parameter did not move")
    stats = dict(model.named_buffers())
    check(all(not torch.equal(v, stats[k]) for k, v in stats0.items()),
          "train step: a BatchNorm statistic did not move")
    log("train_step_check", fits_rows_changed=fits_changed, batch_rows=B, params_moved=len(params0),
        bn_stats_moved=len(stats0))
    del params0, stats0

    # Steady state: back-to-back steps, CUDA events, one synchronize.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        state, metrics = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    ms_step = start.elapsed_time(end) / TIMED_STEPS
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), "timed train steps: a non-finite loss or metric")
    log("train_throughput", ms_per_step=ms_step, host_ms_per_step=host_ms, images_per_s=1e3 * B / ms_step,
        steps=TIMED_STEPS, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30, card=smi)

    def events_ms(fn, reps):
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    # Where the step's time goes: the cascade's forward+backward (train
    # mode, both passes, gradients of every parameter), one SMPLify call as
    # the step makes it, and the rest by difference.
    params = list(model.parameters())
    inputs = tuple(batch[k] for k in spec.modalities)

    def cascade_fwd_bwd():
        outs = cascade_apply(lambda mods, **kw: model(torch.cat(list(mods), dim=1), generator=state.generator, **kw),
                             inputs, options.num_cas_iters, feed_map=spec.cascade_feed_map)
        total = sum(o.rotmat.sum() + o.betas.sum() + o.cam.sum() + sum(r.mean() for r in o.recon.values())
                    for o in outs)
        torch.autograd.grad(total, params, allow_unused=True)

    cascade_ms = events_ms(cascade_fwd_bwd, 2)
    no_smplify_options = build_parser().parse_args([a for a in TRAIN_ARGS if a != "--run_smplify"])
    no_smplify = make_train_step(model, spec, smpl, prior, no_smplify_options, device=dev)
    step_without_smplify_ms = events_ms(lambda: no_smplify(state, batch), 2)
    smplify = make_smplify(smpl, prior, num_iters=N)
    kp = batch["keypoints"].clone()
    kp[:, :, :2] = 0.5 * options.img_res * (kp[:, :, :2] + 1)
    tz = 2 * 5000.0 / (options.img_res * 0.9)
    fit_args = (batch["pose"] + 0.1, torch.zeros(B, 10, device=dev),
                torch.tensor([[0.0, 0.0, tz]], device=dev).expand(B, 3).contiguous(),
                torch.full((B, 2), options.img_res / 2.0, device=dev), kp)
    smplify_ms = events_ms(lambda: smplify(*fit_args), 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        smplify(*fit_args)
        torch.cuda.synchronize()
    smplify_kernel_ms = sum(e.device_time_total for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    smplify_launches = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    del prof

    # The skinning backward at the SMPLify batch, eager: as autograd calls
    # it (lbs_weights needs no gradient) and with d_W as well.
    gen = torch.Generator(dev).manual_seed(SEED)
    V = smpl.v_template.shape[0]
    bwd_args = (0.3 * torch.randn(B, V, 3, generator=gen, device=dev), smpl.lbs_weights,
                batch_rodrigues(0.4 * torch.randn(B, 24, 3, generator=gen, device=dev)),
                0.2 * torch.randn(B, 24, 3, generator=gen, device=dev), torch.randn(B, V, 3, generator=gen, device=dev))
    bwd_ms = cuda_ms(lambda: sk.skinning_backward(*bwd_args, needs=(True, False, True, True)), 50)
    bwd_all_ms = cuda_ms(lambda: sk.skinning_backward(*bwd_args), 50)

    # Busy share: summed CUDA kernel time of one step over its wall time.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
    kernel_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
    log("train_breakdown", ms_per_step=ms_step, cascade_fwd_bwd_ms=cascade_ms, smplify_ms=smplify_ms,
        step_without_smplify_ms=step_without_smplify_ms, smplify_in_step_ms=ms_step - step_without_smplify_ms,
        rest_ms=step_without_smplify_ms - cascade_ms, smplify_iters_per_stage=N,
        smplify_kernel_ms=smplify_kernel_ms, smplify_launches=smplify_launches,
        skinning_backward_ms_b64=bwd_ms, skinning_backward_with_dW_ms_b64=bwd_all_ms,
        profiled_step_ms=profiled_ms, kernel_ms=kernel_ms,
        busy_share=kernel_ms / ms_step if kernel_ms > 0 else None,
        busy_share_of_profiled_step=kernel_ms / profiled_ms if kernel_ms > 0 else None,
        kernel_launches=sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        top_kernels_ms=[[name[:80], ms] for name, ms in top],
        top_host_ops_self_ms_calls=[[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in host_ops], card=smi)
    del prof, state

    # SMPLify through the kernel against the plain skinning, batch 64.
    fits_k = make_smplify(smpl, prior, num_iters=CHECK_SMPLIFY_ITERS)(*fit_args)
    fits_p = make_smplify(smpl, prior, num_iters=CHECK_SMPLIFY_ITERS, skin=sk.skinning_reference)(*fit_args)
    errs = {k: (getattr(fits_k, k) - getattr(fits_p, k)).abs().max().item()
            for k in ("pose", "betas", "camera_translation")}
    ref = fits_p.reprojection_loss
    errs["reprojection_loss_rel"] = ((fits_k.reprojection_loss - ref).abs().max() / ref.abs().max()).item()
    log("smplify_kernel_vs_plain", batch=B, iters=CHECK_SMPLIFY_ITERS, max_err=errs, tolerance=1e-4)
    check(max(errs.values()) <= 1e-4, "SMPLify through the skinning kernel disagrees with the plain skinning")

    log("train_card_vs_cpu", res=64, batch=2, smplify_iters=2, **card_vs_cpu(torch, np, dev))
    return launches


def eval_card_vs_cpu(np, dev, base):
    """The eval CLI at EVAL_SMALL_ARGS on the card and on the CPU (the same
    seeded weights, a tree of 2-sample splits): each metric's difference,
    relative for the pose metrics, absolute for the mask scores."""
    import eval_gpu

    from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment

    _point_env_at(write_synthetic_environment(f"{base}/small", num_subjects=1, samples_per_subject=2))
    card = eval_gpu.main(EVAL_SMALL_ARGS + ["--device", dev.type])
    cpu = eval_gpu.main(EVAL_SMALL_ARGS + ["--device", "cpu"])
    readings = {k: 0.0 for k in EVAL_CARD_VS_CPU_LIMITS}
    for split, want in cpu.items():
        for k in readings:
            check(card[split][k] is not None and np.isfinite(card[split][k]), f"card vs CPU: {split} {k} missing")
            diff = abs(card[split][k] - want[k])
            readings[k] = max(readings[k], diff / abs(want[k]) if k in ("mpjpe", "pa_mpjpe") else diff)
    return readings, {s: {k: r[k] for k in readings} for s, r in cpu.items()}


def _point_env_at(env: dict) -> None:
    os.environ["INBED_DATA_ROOT"] = env["data_root"]
    os.environ["INBED_NPZ_PATH"] = env["npz_path"]


def eval_driver_phase(torch, np, dev, smi, cuda_ms):
    """Phase 6; returns the skinning launches of the driver's run and its
    batch count."""
    import tempfile
    import types

    from torch.profiler import ProfilerActivity, profile

    import eval_gpu

    from inbed_pose_estimation_tpu_torch.data import BaseDataset, CheckpointDataLoader
    from inbed_pose_estimation_tpu_torch.data.device_preprocess import crop_resize, make_device_preprocess
    from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment
    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn, mask_confusion
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk
    from inbed_pose_estimation_tpu_torch.ops.tri_raster import rasterize_mesh_batch
    from inbed_pose_estimation_tpu_torch.render import PartRenderer
    from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model

    saved_env = {k: os.environ.get(k) for k in ("INBED_DATA_ROOT", "INBED_NPZ_PATH", "INBED_ASSET_DIR")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as base:
        try:
            os.environ["INBED_ASSET_DIR"] = f"{base}/no_assets"  # synthetic SMPL and regressor
            t0 = time.perf_counter()
            _point_env_at(write_synthetic_environment(base, num_subjects=1, samples_per_subject=EVAL_SAMPLES,
                                                      img_hw=SLP_FRAME_HW))
            log("eval_tree", samples_per_split=EVAL_SAMPLES, frame_hw=list(SLP_FRAME_HW),
                seconds=time.perf_counter() - t0)

            # The CLI at its defaults over the three default splits.
            splits = eval_gpu.DEFAULT_SPLITS
            batches = len(splits) * -(-EVAL_SAMPLES // BATCH)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sk.launches = 0
            results = eval_gpu.main(EVAL_ARGS + ["--device", dev.type])
            torch.cuda.synchronize()
            launches = sk.launches
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            log("eval_driver", args=EVAL_ARGS, splits=list(splits), launches={"skinning": launches},
                expected=batches, peak_mem_gib=peak_gib, card=smi, results=results)
            check(launches == batches, f"the eval driver launched skinning {launches} times, expected {batches}")
            for split, r in results.items():
                check(r["timing"]["images"] == EVAL_SAMPLES, f"{split}: {r['timing']['images']} images scored")
                check(np.isfinite(r["mpjpe"]) and np.isfinite(r["pa_mpjpe"]) and r["pa_mpjpe"] <= r["mpjpe"],
                      f"{split}: MPJPE {r['mpjpe']} / PA-MPJPE {r['pa_mpjpe']}")
                check(r["mask_accuracy"] is not None and 0 < r["mask_accuracy"] <= 1 and 0 < r["mask_f1"] <= 1,
                      f"{split}: mask accuracy {r['mask_accuracy']}, F1 {r['mask_f1']}")

            # The card's busy share of one split's driver run: its summed
            # kernel time over run_evaluation's wall time, profiled.
            split = "slp-4mod-uncover"
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                profiled = eval_gpu.main(EVAL_ARGS + ["--device", dev.type, "--dataset", split])[split]
                torch.cuda.synchronize()
            by_kernel = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
            del prof
            kernel_ms = sum(by_kernel.values())
            log("eval_driver_busy", split=split, kernel_ms=kernel_ms, wall_s=profiled["timing"]["seconds"],
                busy_share=kernel_ms / (1e3 * profiled["timing"]["seconds"]), kernels=sum(1 for _ in by_kernel),
                top_kernels_ms=[[k[:80], v] for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]],
                card=smi)

            # The raw frames through the device crop, with the results npz.
            sk.launches = 0
            pre = eval_gpu.main(EVAL_ARGS + ["--device", dev.type, "--dataset", split, "--device_preprocess",
                                             "--result_file", f"{base}/results"])[split]
            torch.cuda.synchronize()
            pre_launches = sk.launches
            fits = np.load(f"{base}/results/smpl_fits/{split}_fits.npz")
            shapes = {k: list(fits[k].shape) for k in fits.files}
            n = EVAL_SAMPLES
            log("eval_driver_device_preprocess", split=split, launches={"skinning": pre_launches},
                results=pre, npz=shapes, host_crop_mpjpe=results[split]["mpjpe"], card=smi)
            check(pre_launches == -(-n // BATCH), f"--device_preprocess: skinning launched {pre_launches} times")
            check(np.isfinite(pre["mpjpe"]) and pre["pa_mpjpe"] <= pre["mpjpe"] and pre["mask_f1"] is not None,
                  "--device_preprocess: metrics")
            check(shapes == {"pred_joints": [n, 17, 3], "pose": [n, 72], "betas": [n, 10], "camera": [n, 3],
                             "rotmat": [n, 24, 3, 3]}, f"results npz schema {shapes}")
            check(all(np.isfinite(fits[k]).all() for k in fits.files), "results npz: non-finite values")

            # The driver's parts at B=32, 224^2, on the first batch of a split.
            # The host time of one batch on the loader's 8 threads, and of
            # one sample on one thread, with the host crop and raw frames.
            load_ms, sample_ms, first = {}, {}, {}
            for mode in ("host_crop", "raw_frames"):
                ds = BaseDataset(types.SimpleNamespace(img_res=RES, device_preprocess=mode == "raw_frames"), split)
                loader = CheckpointDataLoader(ds, batch_size=BATCH, shuffle=False, num_workers=8, drop_last=False)
                t0 = time.perf_counter()
                first[mode] = next(iter(loader))[1]
                load_ms[mode] = 1e3 * (time.perf_counter() - t0)
                t0 = time.perf_counter()
                for i in range(4):
                    ds[i]
                sample_ms[mode] = 1e3 * (time.perf_counter() - t0) / 4
            batch, raw = first["host_crop"], first["raw_frames"]
            torch.manual_seed(0)
            model, spec = build_model(MODEL, device=dev)
            smpl = synthetic_smpl_model(0, device=dev)
            infer = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(num_vertices=smpl.v_template.shape[0]),
                                      num_cas_iters=NUM_CAS_ITERS, final_recon=False, device=dev)
            inputs = tuple(torch.from_numpy(batch[k]).to(dev) for k in spec.modalities)
            infer_ms = cuda_ms(lambda: infer(inputs), 10)
            out = infer(inputs)
            renderer = PartRenderer(render_res=RES, template=smpl.v_template.cpu().numpy(),
                                    faces=smpl.faces.cpu().numpy(), render_labels=False, device=dev)
            raster_ms = cuda_ms(lambda: renderer(out["vertices"], out["cam"]), 10)
            # K3 at SMPL's face count (13776), the real F * tile^2 work.
            V = smpl.v_template.shape[0]
            smpl_faces = torch.stack([torch.arange(13776, device=dev) + i for i in range(3)], dim=1) % V
            uvz = renderer.project(out["vertices"], out["cam"])
            raster_smpl_ms = cuda_ms(lambda: rasterize_mesh_batch(uvz, smpl_faces, RES, tile=renderer.tile), 5)
            masks = renderer(out["vertices"], out["cam"])[0].cpu().numpy()
            t0 = time.perf_counter()
            scores = mask_confusion(masks, batch, BATCH)
            host_f1_ms = 1e3 * (time.perf_counter() - t0)
            # K5 on the raw frames already on the card, and their upload.
            pre_fn = make_device_preprocess(res=RES, device=dev)
            t0 = time.perf_counter()
            raw_dev = {k: torch.from_numpy(raw["raw_" + k]).to(dev) for k in spec.modalities}
            torch.cuda.synchronize()
            h2d_ms = 1e3 * (time.perf_counter() - t0)
            box = [torch.from_numpy(raw[k]).to(dev) for k in ("center", "scale")]
            flip, noise = torch.zeros(BATCH, device=dev), torch.ones(BATCH, 3, device=dev)
            crop_ms = cuda_ms(lambda: pre_fn(raw_dev, *box, flip, noise), 10)
            # K3 and K5 on the card against the CPU on the same inputs.
            cpu_masks = rasterize_mesh_batch(uvz.cpu(), smpl_faces.cpu(), RES, tile=renderer.tile)[0]
            card_masks = rasterize_mesh_batch(uvz, smpl_faces, RES, tile=renderer.tile)[0].cpu()
            img01 = raw_dev["img"][:4].float() / 255.0
            k5_err = (crop_resize(img01, box[0][:4], box[1][:4], RES).cpu()
                      - crop_resize(img01.cpu(), box[0][:4].cpu(), box[1][:4].cpu(), RES)).abs().max().item()
            k3_diff = int((card_masks != cpu_masks).sum())
            log("eval_driver_parts", batch=BATCH, res=RES, split=split, card=smi,
                images_per_s={s: r["timing"]["images_per_s"] for s, r in results.items()},
                loader_wait_s={s: r["timing"]["loader_wait_s"] for s, r in results.items()},
                mask_branch_s={s: r["timing"]["mask_s"] for s, r in results.items()},
                driver_seconds={s: r["timing"]["seconds"] for s, r in results.items()},
                batch_load_ms_8_threads=load_ms, sample_ms_1_thread=sample_ms,
                inference_ms_per_batch=infer_ms,
                mask_raster_ms_per_batch=raster_ms, mask_raster_faces=int(smpl.faces.shape[0]),
                mask_raster_smpl_faces_ms_per_batch=raster_smpl_ms, raster_tile=renderer.tile,
                host_uncrop_f1_ms_per_batch=host_f1_ms, mask_pixels_scored=int(scores[1]),
                device_crop_ms_per_batch=crop_ms, raw_upload_ms_per_batch=h2d_ms, peak_mem_gib=peak_gib,
                k3_card_vs_cpu_differing_pixels=k3_diff, k3_pixels=int(cpu_masks.numel()),
                k5_card_vs_cpu_max_abs_err=k5_err)
            check(k3_diff <= K3_CARD_VS_CPU_MAX_PIXELS, f"K3: {k3_diff} pixels differ between the card and the CPU")
            check(k5_err <= 1e-5, f"K5: the card's crop differs from the CPU's by {k5_err}")

            readings, cpu_metrics = eval_card_vs_cpu(np, dev, base)
            log("eval_card_vs_cpu", args=EVAL_SMALL_ARGS, readings=readings, limits=EVAL_CARD_VS_CPU_LIMITS,
                cpu=cpu_metrics)
            for k, v in readings.items():
                check(v <= EVAL_CARD_VS_CPU_LIMITS[k], f"eval card vs CPU: {k} reads {v:.3g}, "
                                                       f"limit {EVAL_CARD_VS_CPU_LIMITS[k]:.3g}")
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return launches, batches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    import numpy as np

    from inbed_pose_estimation_tpu_torch.evaluation import (
        eval_metrics, load_j_regressor_h36m, make_forward_fn, make_inference_fn, regress_j17,
    )
    from inbed_pose_estimation_tpu_torch.geometry import batch_rodrigues
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS
    from inbed_pose_estimation_tpu_torch.ops import build
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk
    from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        capability=list(torch.cuda.get_device_capability(0)), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    check(torch.cuda.get_device_capability(0) == (9, 0), "the kernels are built for sm_90a (Hopper)")

    # 2. build
    t0 = time.perf_counter()
    logs = build.build_all()
    log("build", sources=build.sources(), seconds=round(time.perf_counter() - t0, 3))
    for name, text in logs.items():
        print(f"--- nvcc {name} ---\n{text.strip()}", flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(dev).manual_seed(SEED)
    smpl = synthetic_smpl_model(SEED, device=dev)
    V = smpl.v_template.shape[0]

    def skin_inputs(b, v, weights=None):
        """v_posed, W, and the affines as lbs hands them over: A_rot and A_t
        are strided views of one [b, 24, 4, 4] world-transform tensor."""
        verts = 0.3 * torch.randn(b, v, 3, generator=gen, device=dev)
        if weights is None:
            weights = torch.rand(v, 24, generator=gen, device=dev)
            weights = weights / weights.sum(1, keepdim=True)
        world = torch.zeros(b, 24, 4, 4, device=dev)
        world[..., :3, :3] = batch_rodrigues(0.4 * torch.randn(b, 24, 3, generator=gen, device=dev))
        world[..., :3, 3] = 0.2 * torch.randn(b, 24, 3, generator=gen, device=dev)
        world[..., 3, 3] = 1.0
        return [verts, weights, world[..., :3, :3], world[..., :3, 3]]

    def max_err(args):
        out = sk.skinning_forward(*args)
        torch.cuda.synchronize()
        return (out - sk.skinning_reference(*args)).abs().max().item()

    # Forward: strided affines (as lbs passes them) and their contiguous
    # copies at the main path's shapes, at the training batch, and at a
    # ragged B and V (B not a multiple of the chunk, V not of the tile).
    main_args = skin_inputs(BATCH, V, smpl.lbs_weights)
    b64_args = skin_inputs(64, V, smpl.lbs_weights)
    errs = {
        "b32_v6890_strided": max_err(main_args),
        "b32_v6890_contiguous": max_err([a.contiguous() for a in main_args]),
        "b64_v6890_strided": max_err(b64_args),
        "b5_v6890_strided": max_err(skin_inputs(5, V)),
        "b33_v701_strided": max_err(skin_inputs(33, 701)),
        "b3_v700_strided": max_err(skin_inputs(3, 700)),
        "b1_v1_strided": max_err(skin_inputs(1, 1)),
    }
    err_main = errs["b32_v6890_strided"]
    log("skinning_forward", max_abs_err=errs, tolerance=1e-5)
    check(max(errs.values()) <= 1e-5, "skinning kernel disagrees with skinning_reference")

    grad_args = [a.detach().clone().requires_grad_(True) for a in skin_inputs(2, 300)]
    ref_args = [a.detach().clone().requires_grad_(True) for a in grad_args]
    g = torch.randn(2, 300, 3, generator=gen, device=dev)
    sk.skinning(*grad_args).backward(g)
    sk.skinning_reference(*ref_args).backward(g)
    grad_err = max(((a.grad - r.grad).abs() / (2e-4 + 2e-4 * r.grad.abs())).max().item()
                   for a, r in zip(grad_args, ref_args))
    log("skinning_backward", worst_err_over_tolerance=grad_err, atol=2e-4, rtol=2e-4)
    check(grad_err <= 1.0, "skinning gradients disagree with autograd through skinning_reference")

    def cuda_ms(fn, iters):
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, reps=100, replays=5):
        """Device time per call: `reps` calls captured in one CUDA graph and
        replayed, so the host's per-call Python cost is not in the time."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * replays)

    def bound(b):
        """(bytes, flops, bound ms, bound_by) of one call at batch b, V vertices."""
        nbytes = 4 * (2 * b * V * 3 + V * 24 + b * 24 * 12)
        flops = 2 * b * V * (24 * 12 + 12)
        bytes_ms, flops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S
        return nbytes, flops, max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"

    # The least one graph node costs on this card: a one-element in-place op.
    one = torch.zeros(1, device=dev)
    floor_ms = graph_ms(lambda: one.add_(1.0))
    log("single_node_floor", ms=floor_ms, card=smi)

    # Two yardsticks beside the kernel, one graph node each: a copy of
    # v_posed into a buffer of its size (the kernel's unavoidable traffic,
    # v_posed in and out, without the blend), and the [B, 24, 12] affine
    # pack that the earlier wrapper ran before its kernel (torch.cat of the
    # contiguous A_rot and A_t).
    sink = torch.empty_like(main_args[0])
    copy_ms = graph_ms(lambda: sink.copy_(main_args[0]))
    rot_c, t_c = main_args[2].contiguous(), main_args[3].contiguous()
    pack_ms = graph_ms(lambda: torch.cat([rot_c.reshape(BATCH, 24, 9), t_c], dim=-1))
    # ops/csrc/blend_floor.cu: the kernel's blend FMAs alone, every operand
    # in a register, at B = 32 and 64 (the least the CUDA cores take for it).
    floor_lib = build.library("blend_floor")
    floor_lib.blend_floor.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def blend_floor(b):
        err = floor_lib.blend_floor(sink.data_ptr(), b, V, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"blend_floor launch failed ({err})")

    blend_ms = {b: graph_ms(lambda: blend_floor(b)) for b in (BATCH, 64)}
    log("skinning_yardsticks", batch=BATCH, v_posed_copy_ms=copy_ms, affine_pack_ms=pack_ms,
        blend_registers_only_ms=blend_ms, card=smi)

    # Device time of one wrapper call (one kernel launch) and of the plain
    # version, each back to back with its inputs in L2, as on the main path
    # where v_posed was just written; then the same calls issued eagerly
    # from Python, one event pair over 200; then the kernel's time for each
    # batch chunk, beside the chunk the wrapper picks.
    timing = {}
    for b, args in ((BATCH, main_args), (64, b64_args)):
        nbytes, flops, bound_ms, bound_by = bound(b)
        timing[b] = {
            "ms": graph_ms(lambda: sk.skinning_forward(*args)),
            "plain_ms": graph_ms(lambda: sk.skinning_reference(*args)),
            "eager_ms": cuda_ms(lambda: sk.skinning_forward(*args), 200),
            "plain_eager_ms": cuda_ms(lambda: sk.skinning_reference(*args), 200),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        by_chunk = {c: graph_ms(lambda: sk._launch(*args, chunk=c)) for c in (1, 2, 4)}
        log("skinning_time", batch=b, vertices=V, **timing[b], bytes=nbytes, flops=flops,
            share_of_bound=bound_ms / timing[b]["ms"], single_node_floor_ms=floor_ms,
            chunk=sk.batch_chunk(b, V), ms_by_chunk=by_chunk, card=smi)

    # 4. main path
    torch.manual_seed(SEED)  # module initializers draw from torch's default generator
    model, spec = build_model(MODEL, device=dev)
    jreg = load_j_regressor_h36m(num_vertices=V)
    infer = make_inference_fn(model, spec, smpl, jreg, num_cas_iters=NUM_CAS_ITERS, final_recon=False, device=dev)
    rng = np.random.default_rng(SEED)
    inputs = tuple(torch.from_numpy(rng.normal(0, 1, (BATCH, MODALITY_CHANNELS[m], RES, RES)).astype(np.float32)).to(dev)
                   for m in spec.modalities)

    sk.launches = 0
    out = infer(inputs)
    torch.cuda.synchronize()
    counts = {"skinning": sk.launches}
    log("main_path", model=MODEL, batch=BATCH, res=RES, num_cas_iters=NUM_CAS_ITERS, launches=counts)
    check(counts["skinning"] == 1, f"skinning kernel launched {counts['skinning']} times in one call, expected 1")

    k3d = out["keypoints_3d_17"]
    check(tuple(out["vertices"].shape) == (BATCH, V, 3) and tuple(k3d.shape) == (BATCH, 17, 3), "output shapes")
    for key in ("rotmat", "betas", "cam", "vertices", "keypoints_3d_17"):
        check(bool(torch.isfinite(out[key]).all()), f"{key} has non-finite values")
    with torch.no_grad():
        ref_verts, _ = lbs(smpl, out["betas"], out["rotmat"], skin=sk.skinning_reference)
        ref_k3d = regress_j17(torch.as_tensor(jreg, device=dev), ref_verts)
        gt = ref_k3d + 0.05 * torch.randn(ref_k3d.shape, generator=gen, device=dev)
        metrics = eval_metrics(k3d, gt)
    v_err = (out["vertices"] - ref_verts).abs().max().item()
    k_err = (k3d - ref_k3d).abs().max().item()
    log("main_path_check", vertices_max_abs_err=v_err, keypoints_max_abs_err=k_err, tolerance=1e-5,
        mpjpe_mean=metrics["mpjpe"].mean().item(), pa_mpjpe_mean=metrics["pa_mpjpe"].mean().item())
    check(v_err <= 1e-5 and k_err <= 1e-5, "main path disagrees with the plain skinning")
    check(all(bool(torch.isfinite(m).all()) and m.shape == (BATCH,) for m in metrics.values()), "metrics")

    # The same weights on the CPU at a small input: true float32 on the card
    # (TF32 off) agrees to float32 reassociation, TF32 would not.
    small = tuple(x[:2, :, :64, :64].contiguous() for x in inputs)
    got = infer(small)
    cpu_model, _ = build_model(MODEL, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_infer = make_inference_fn(cpu_model, spec, synthetic_smpl_model(SEED, device="cpu"), jreg,
                                  num_cas_iters=NUM_CAS_ITERS, final_recon=False, device="cpu")
    want = cpu_infer(tuple(x.cpu() for x in small))
    cpu_err = {k: (got[k].cpu() - want[k]).abs().max().item() for k in ("rotmat", "betas", "cam", "keypoints_3d_17")}
    log("card_vs_cpu_res64", max_abs_err=cpu_err, atol={"rotmat": 5e-4, "betas": 2e-4, "cam": 2e-4,
                                                         "keypoints_3d_17": 1e-3})
    check(cpu_err["rotmat"] <= 5e-4 and cpu_err["betas"] <= 2e-4 and cpu_err["cam"] <= 2e-4
          and cpu_err["keypoints_3d_17"] <= 1e-3, "card and CPU disagree on a small input")

    # Throughput: back-to-back calls, one synchronize at the end.
    for _ in range(3):
        infer(inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = sk.launches
    t0 = time.perf_counter()
    for _ in range(TIMED_CALLS):
        out = infer(inputs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(sk.launches - before == TIMED_CALLS, "skinning launches per call != 1 in the timed loop")
    log("throughput", images_per_s=BATCH * TIMED_CALLS / seconds, ms_per_batch=1e3 * seconds / TIMED_CALLS,
        calls=TIMED_CALLS, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=smi)

    # Where the time goes: one pass with and without the depth decoder, the
    # whole cascade, LBS; and the cascade's FLOPs (conv and matmul, counted
    # by torch's FlopCounterMode) over its time.
    from torch.utils.flop_counter import FlopCounterMode

    forward = make_forward_fn(model, spec, NUM_CAS_ITERS, final_recon=False)
    x = torch.cat(inputs, dim=1)
    with torch.no_grad():
        pass_with_decoder_ms = cuda_ms(lambda: model(x), 10)
        pass_without_decoder_ms = cuda_ms(lambda: model(x, compute_recon=False), 10)
        forward_ms = cuda_ms(lambda: forward(inputs), 10)
        lbs_ms = cuda_ms(lambda: lbs(smpl, out["betas"], out["rotmat"]), 50)
        with FlopCounterMode(display=False) as counter:
            forward(inputs)
    cascade_flop = counter.get_total_flops()
    log("breakdown", pass_with_decoder_ms=pass_with_decoder_ms, pass_without_decoder_ms=pass_without_decoder_ms,
        cascade_forward_ms=forward_ms, lbs_ms=lbs_ms, cascade_flop=cascade_flop,
        cascade_tflop_per_s=cascade_flop / forward_ms / 1e9, card=smi)

    # 5. train step
    launches_train_step = train_phase(torch, np, dev, smi, smpl, cuda_ms)

    # 6. eval driver
    launches_eval_driver, eval_driver_batches = eval_driver_phase(torch, np, dev, smi, cuda_ms)

    kernels = [{
        "name": "skinning", "route": "cuda",
        "source": "inbed_pose_estimation_tpu_torch/ops/csrc/skinning.cu",
        "replaces": "inbed_pose_estimation_tpu/ops/pallas_lbs.py:31",
        "launches": counts["skinning"], "max_abs_err": err_main,
        "ms": timing[BATCH]["ms"], "plain_ms": timing[BATCH]["plain_ms"], "bound_ms": timing[BATCH]["bound_ms"],
        "bound_by": timing[BATCH]["bound_by"], "library_ms": None,
        "eager_ms": timing[BATCH]["eager_ms"], "single_node_floor_ms": floor_ms,
        "ms_b64": timing[64]["ms"], "plain_ms_b64": timing[64]["plain_ms"], "bound_ms_b64": timing[64]["bound_ms"],
        "bound_by_b64": timing[64]["bound_by"], "eager_ms_b64": timing[64]["eager_ms"],
        "launches_train_step": launches_train_step,
        "launches_eval_driver": launches_eval_driver, "eval_driver_batches": eval_driver_batches,
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
