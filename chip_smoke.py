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
     its bound, the plain version's time and the single-node floor; the
     trunk's tail kernel (batch_norm_act) in each form at batch 32 on the
     trunk's shapes, equal to its plain version bit for bit (not timed);
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
     against the CPU at RES 64 over 2-sample splits;
  7. train driver: a synthetic SLP tree at SLP's frame size with a train
     split of 256 samples, then the train CLI `train_gpu.main` at its
     defaults (cashmrV2, batch 64, 224x224, float32, 2-pass cascade, 8
     loader threads, uint8 feed, shuffle and augmentation on) with
     --run_smplify (100 Adam steps a stage) for one epoch of 4 steps (1
     warm-up, 3 timed, each step's phases kept) and the epoch-end checkpoint
     and eval on
     slp-4mod-uncover: 206 skinning launches a step, images/s, ms a step,
     the loader wait and its share, the step alone on a loaded batch,
     checkpoint seconds and size, eval seconds, peak memory; then the run
     resumed in-process from its `.pt` (epoch, step, permutation, Adam's
     moments, the dropout generator and the fits as saved) and one more
     step from there.  Its checkpoints go to a temporary directory that is
     deleted;
  8. families: the 23 registered model names built on the card; the multi-trunk and fusion models at full width (224x224,
     float32, seeded random weights): eval inference of featatt_cashmr,
     ir_depth_featatt_cashmrV2, ir_depth_fusion and ir_depth_pm_fusion at
     batch 32 (the skinning launches of one call, including the fusion
     models' in-model body masks, the shuffled projection's and the trunk
     tail kernel's launches, images/s, peak memory), featatt_cashmr and
     ir_depth_pm_fusion on the card against the CPU at RES 64, the body mask
     (K2) on the card against the CPU and its time, and the train step with
     SMPLify (100 Adam steps a stage) of featatt_cashmr, ir_depth_fusion and
     ir_depth_pm_fusion (launches a step, ms a step, peak memory, the frozen
     guide unchanged); inside phases 6 and 7, on their trees, the eval CLI
     for featatt_cashmr and for ir_depth_pm_fusion with a guide checkpoint
     the phase writes (--pretrained_fusion_checkpoint), and one train CLI
     step of ir_depth_pm_fusion with that guide (its launches, the guide
     bitwise unchanged);
  9. Bodies-At-Rest and the crop cache: eval inference of bodiesAtRest and
     bodiesAtRest4mod at batch 32, 224x224, float32, seeded weights (1 / 2
     skinning launches a call, the vertices against the plain skinning,
     the estimated map, images/s), both on the card against the CPU at RES
     64 with a TF32 control, and bodiesAtRest4mod's train step at the
     CLI's defaults with SMPLify (N = 100) in mode "0" and then mode "1"
     (205 launches each, the gradients zero in mode "1", the mode-2 stack
     bitwise unchanged, ms a step); inside phase 6, on its tree, the eval
     CLI for bodiesAtRest4mod on one split, that split's crop cache built by
     the port's tool (seconds, items through it bitwise the disk's, a
     loader batch of 32 from disk / the cache / the cache with
     --fast_preprocess) and the eval CLI with and without --crop_cache;
     inside phase 7, on its tree, a 64-row train split's crop cache (the
     same checks on augmented items, both feeds, a batch of 64) and the
     train CLI for bodiesAtRest through it at batch 32 over 2 epochs with
     --mod1_epoch 1 (the step's mode in each epoch);
 10. bfloat16 and rematerialization: cashmrV2 eval at batch 32, 224x224 in
     bfloat16 beside float32 (images/s, ms a batch, one skinning launch a
     call, the distance of the predictions, the top device kernels of a
     bfloat16 call), bench_gpu.py as a subprocess, one bfloat16 eval batch
     of featatt_cashmr, ir_depth_fusion and bodiesAtRest4mod (finite, their
     distance from float32, 1 / 2 / 2 launches), the bfloat16 forward on the
     card against the CPU at RES 64 (ratio rule), the train step at batch 64
     without SMPLify for {float32, bfloat16} x {no remat, stage, decoder}
     (ms a step, peak memory, the losses of 4 steps), one bfloat16 step
     with SMPLify (N = 100; 206 launches), tools/bench_train.py at its
     defaults; inside phase 7, on its tree, one train CLI step with
     --dtype bfloat16 --remat;
 11. result dumps and host tools: inside phase 6, on its tree, the eval CLI
     at its defaults on one split with --result_file (2 skinning launches,
     the npz, the 7 PNGs of each of the 16 samples drawn, each readable at
     224x224; images/s with and without the dumps, seconds per dumped
     sample); `_save_artifacts` from the card's predictions and from the
     same predictions on the host, byte-identical files; the painter at
     SMPL's 13776 faces (seconds per image for the overlay and each view);
     K4 on the card against the CPU at B=32 and 64 (6890 vertices on the
     112x112 grid, some off it, some at negative fractions) and its ms per
     call; the offline index tool on a one-subject, 2-pose raw danaLab tree,
     its npz schema and an item of it through the port's dataset;
 12. data parallel (`parallel/`): inside phase 6, on its tree, the eval CLI
     under `torchrun --standalone --nproc_per_node 1` (one NCCL rank) on
     slp-4mod-uncover, its metrics held to phase 6's run without a process
     group, then run_evaluation on two gloo ranks sharing the card against
     the same run (skinning launches per rank read from each child); inside
     phase 7, on its tree, the train CLI under torchrun on one NCCL rank
     over a 128-row split (2 steps at its defaults with SMPLify, 206
     launches a step, the epoch's checkpoint); then through the parallel
     API at the CLI's width (cashmrV2, batch 64, 224x224, SMPLify N = 100):
     the step in one process and on one NCCL rank (ms a step with and
     without the process group, the all-reduces of a step read from a
     torch.profiler trace of a step with SMPLify at one iteration: their
     count, bytes and time), and on two gloo
     ranks sharing the card (32 rows a rank, uneven valid fits) against the
     one process's first step at the tests' tolerances, the averaged
     gradient within DP_GRAD_RTOL and its controls beyond it, the fits
     within DP_FITS_ATOL and the fits scatter left local beyond it, both
     ranks' states bitwise equal, 206 launches a rank, one eval batch.
     Two ranks on one card check correctness, not scaling; NCCL between
     cards is not reached by one card;
 13. the tools: inside phase 7, tools/loader_bench.py on phase 9's cached
     split (it raises if the dataset refuses the cache);
     tools/latency_mode.py at batch 32, tools/profile_mfu.py's inference at
     batches 32 and 64 and its train step at 64, `mfu` and `mfu_counted`
     each in (0, 1);
 14. the body-mask tool: inside phase 6, tools/get_mask.py over one
     subject's uncovered frames of its tree (45 at 1024 x 576), copied into
     a temporary root: one mask a frame at the frame's size, uint8 0 / 255,
     equal to `fallback_mask` of the frame in this process, a file for
     every uncover sample of the subject where the eval driver looks for
     it, and the seconds a frame.
Then the seconds of each phase, the kernel table as one JSON line, the
nvidia-smi line, and {"ok": true, "device": ...} as the last line.
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
TRAIN_ARGS = ["--name", "chip_smoke", "--run_smplify"]
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


# Phase 7: the train CLI at its defaults with SMPLify on over a synthetic SLP
# tree at SLP's frame size whose train split (uncover + cover1) holds
# 2 * TRAIN_SAMPLES = 256 samples: one epoch is 4 steps at batch 64 (cut
# from 6 to keep the script inside its time with phases 12-13), the loader
# busy prefetching during the first two and idle in the last two; the eval
# split slp-4mod-uncover holds TRAIN_SAMPLES.
TRAIN_SAMPLES, TRAIN_DRIVER_STEPS = 128, 4
TRAIN_DRIVER_ARGS = ["--name", "chip_smoke", "--run_smplify", "--num_epochs", "1", "--summary_steps", "1",
                     "--data_test", "slp-4mod-uncover", "--allow_synthetic_assets"]

# Phase 8: the multi-trunk and fusion families.  Eval inference at batch 32
# and the skinning launches of one call: the LBS after the network, plus one
# per TwoStageFusion for its body mask (the frozen pipelines run two: the
# guide's and the main stage's).
FAMILY_EVAL_LAUNCHES = {"featatt_cashmr": 1, "ir_depth_featatt_cashmrV2": 1, "ir_depth_fusion": 2,
                        "ir_depth_pm_fusion": 3}
# The train step at the train CLI's defaults with SMPLify (N = 100): (batch,
# skinning launches a step).  A 2-pass cascade runs 6 + 2N, a fusion model
# one more for its mask, a frozen pipeline two more.  featatt_cashmr's four
# trunks over two passes fit at batch 64 (peak 68.3 GiB allocated, 77.0 GiB
# reserved, of the 80 GB; PERF.md section 5), so nothing is cut.
FAMILY_TRAIN = {"featatt_cashmr": (64, 206), "ir_depth_fusion": (64, 207), "ir_depth_pm_fusion": (64, 208)}
# The decoders' shuffled projection kernel: its launches in one eval call
# (one per image decoder that the call runs: pass 0's Reconstruct, each
# recovery decoder of a fusion model, the guide's and the main stage's in a
# frozen pipeline) and in one train step (only the frozen guide runs without
# autograd, its two recovery decoders).
FAMILY_PROJECTIONS = {"featatt_cashmr": 1, "ir_depth_featatt_cashmrV2": 2, "ir_depth_fusion": 2,
                      "ir_depth_pm_fusion": 4}
FAMILY_TRAIN_PROJECTIONS = {"featatt_cashmr": 0, "ir_depth_fusion": 0, "ir_depth_pm_fusion": 2}
# The trunk's eval tail kernel: 33 relu, 12 add_relu and 4 bn_add_relu
# launches a ResNet-50 pass, times the trunk passes of one eval call (cascade
# passes x trunks, less the featatt_cashmr trunks that pass 1 reuses).
TRUNK_TAILS = {"relu": 33, "add_relu": 12, "bn_add_relu": 4}
# (channels, side, arrays read and written) of the tails of one 224^2 trunk
# pass: the stem, then per stage conv1/conv2 (relu: x, out), conv3 (add_relu:
# x, r, out) and the first block's conv3 with its projection (x, r, out).
# The first block's conv1 runs at the previous stage's side.
TRUNK_PASS_TAILS = [(64, 112, 2), (64, 56, 2 * 6), (256, 56, 3 * 3),
                    (128, 56, 2), (128, 28, 2 * 7), (512, 28, 3 * 4),
                    (256, 28, 2), (256, 14, 2 * 11), (1024, 14, 3 * 6),
                    (512, 14, 2), (512, 7, 2 * 5), (2048, 7, 3 * 3)]
TRUNK_TAIL_SHAPES = [(64, 112), (64, 56), (256, 56), (128, 28), (512, 28), (256, 14), (1024, 14), (512, 7),
                     (2048, 7)]
FAMILY_TRUNK_PASSES = {"featatt_cashmr": 5, "ir_depth_featatt_cashmrV2": 4, "ir_depth_fusion": 2,
                       "ir_depth_pm_fusion": 4}
# The projection kernel's launches read by the phases, for the final kernels line.
projection_launches = {}
# The same weights on the card and on the CPU at RES 64, batch 2: the
# largest absolute differences, and the body-mask pixels that may differ.
# The card read rotmat 1.2e-7, betas 1.9e-9, cam 3.7e-9, keypoints 2.4e-7
# (PERF.md section 6): each limit is 3-5x the reading, or float32's rounding
# at the values' scale where that is larger; the same inference with TF32
# on must break at least one.
FAMILY_CARD_VS_CPU_LIMITS = {"rotmat": 5e-7, "betas": 3e-8, "cam": 3e-8, "keypoints_3d_17": 1e-6}
FAMILY_CARD_VS_CPU_MASK_PIXELS = 0
# The guide of the frozen pipelines in the CLI runs: a seeded ir_depth_fusion.
GUIDE_SEED = 3

# Phase 9: Bodies-At-Rest and the crop cache.  Eval inference at batch 32
# and the skinning launches of one call: the LBS after the network, and for
# bodiesAtRest4mod the refinement's SMPL forward before it.
BAR_EVAL_LAUNCHES = {"bodiesAtRest": 1, "bodiesAtRest4mod": 2}
# bodiesAtRest4mod's train step at the train CLI's defaults with SMPLify
# (N = 100), in mode "0" and in mode "1": one regression, so 5 + 2N launches,
# one fewer than a 2-pass cascade (the mask term reuses the final vertices).
BAR_TRAIN_MODEL, BAR_TRAIN_LAUNCHES = "bodiesAtRest4mod", 205
# The same weights on the card and on the CPU at RES 64, batch 2: the
# largest absolute differences; the estimated map must be equal.  The card
# read rotmat 3.3e-7, betas 2.3e-9, cam 2.8e-9, keypoints 7.2e-7 (PERF.md
# section 6, PR 7): each limit is 3.5x the reading; TF32 reads 8e-5 to
# 4e-4 on rotmat and keypoints and must break at least one.
BAR_CARD_VS_CPU_LIMITS = {"rotmat": 1.2e-6, "betas": 8e-9, "cam": 1e-8, "keypoints_3d_17": 2.5e-6}
# The eval CLI on phase 6's tree, at its defaults (batch 32, 224x224).
BAR_EVAL_ARGS = ["--model", "bodiesAtRest4mod", "--allow_synthetic_assets"]
# The train CLI on phase 7's tree: a split of its first 64 training rows (2
# steps an epoch at batch 32) read through its crop cache, bodiesAtRest over
# 2 epochs switching to mode "1" at epoch 1, without SMPLify (4 skinning
# launches a step).
BAR_TRAIN_SPLIT, BAR_TRAIN_ROWS = "slp-multi", 64
BAR_TRAIN_CLI_ARGS = ["--name", "chip_smoke_bar", "--model", "bodiesAtRest", "--data_train", BAR_TRAIN_SPLIT,
                      "--batch_size", "32", "--num_epochs", "2", "--mod1_epoch", "1", "--summary_steps", "1",
                      "--data_test", "", "--allow_synthetic_assets"]
# The crop cache: items compared bitwise with the disk's per feed, the
# loader's threads and the train batch for the first-batch times.
CACHE_ITEMS_COMPARED, LOADER_THREADS, CACHE_TRAIN_BATCH = 4, 8, 64

# Phase 10: bfloat16 and rematerialization.  Eval in bfloat16 beside float32
# for cashmrV2 at batch 32, then one batch of each name below (its skinning
# launches a call are float32's).  Each model's bfloat16 predictions at batch
# 32 are at least BF16_MIN_DISTANCE from its float32 ones (about half the
# least of the card's readings: rotmat 8.8e-4, keypoints 0.18 mm on average;
# PERF.md section 6), so that bfloat16 really ran.  The bfloat16 forward on the card against the CPU
# at RES 64 under the tests' ratio rule: the card's bfloat16 distance from the
# CPU's float32 within BF16_RATIO times the CPU's own bfloat16 distance from
# it, plus phase 4's float32 tolerance; and the card's bfloat16 against the
# CPU's bfloat16 directly within BF16_CARD_VS_CPU_LIMITS (max abs): 2.5-3x
# the card's readings (rotmat 1.19e-4, keypoints 2.09e-5, betas and cam 0;
# PERF.md section 6), betas and cam at a third of what the card's float32
# forward reads there, which must break every limit.
BF16_EVAL_LAUNCHES = {"featatt_cashmr": 1, "ir_depth_fusion": 2, "bodiesAtRest4mod": 2}
BF16_MIN_DISTANCE = {"rotmat": 4e-4, "keypoints_mm_mean": 0.09}
BF16_RATIO = 1.5
BF16_FLOORS = {"rotmat": 5e-4, "betas": 2e-4, "cam": 2e-4, "keypoints_3d_17": 1e-3}
BF16_CARD_VS_CPU_LIMITS = {"rotmat": 3e-4, "betas": 1e-4, "cam": 1e-4, "keypoints_3d_17": 6e-5}
# The train step at batch 64, 224^2 without SMPLify for each dtype and each
# --remat (a warm-up step, then BF16_TIMED_STEPS timed), float32 without
# remat twice: the second run is the control, how far two identical float32
# runs drift apart with cuDNN's default algorithms.  Then one bfloat16 step
# with SMPLify (N = 100).  bfloat16's loss stays within BF16_LOSS_REL of
# float32's at each step (the JAX package's guardrail, tests/test_bf16_train.py).
# Recompute changes no number: a bfloat16 remat run's losses equal the run's
# without remat exactly, and so do float32's with cuDNN's deterministic
# algorithms over REMAT_EXACT_STEPS steps, after which the parameters,
# BatchNorm's buffers and the dropout generator's state are equal too.
REMAT_CASES, BF16_TIMED_STEPS, REMAT_EXACT_STEPS = (False, "stage", "decoder"), 3, 2
BF16_LOSS_REL = 0.05

# Phase 11: the result dumps and the host tools.  The eval CLI with
# --result_file on phase 6's tree (host crop): 8 samples a batch are drawn,
# 7 files each (cashmrV2 recovers depth).
DUMP_KINDS = ("shape", "shape_side", "shape_top", "depth_recovered", "depthoutori", "depthout", "mask")
DUMPS_PER_BATCH = 8
# The painter at SMPL's face count (the faces built as phase 6 builds K3's),
# 224^2: images timed for each view.
PAINTER_FACES, PAINTER_IMAGES = 13776, 2
# K4 on the card against the CPU at SMPL's vertex count on the 112 x 112
# grid: the contact maps equal, the depth maps within float32's epsilon
# times the map's largest value (one rounding at its scale; both devices
# sum the same 9 slices in the same order).
K4_BATCHES, K4_GRID = (32, 64), 112
# The offline index tool on a one-subject, 2-pose raw danaLab tree: its
# subject lists and pose count are patched to the tree's.
PREPROCESS_ARGS = ["--eval_files", "--train_files"]
PREPROCESS_SUBJECTS, PREPROCESS_IMGS = [1], 2
SLP_INDEX_KEYS = ["S", "center", "depthname", "gender", "imgname", "irimgname", "openpose", "part", "pmname", "scale"]

# Phase 12: data parallel.  (a) One NCCL rank under torchrun: the train CLI
# at its defaults with SMPLify over a DP_TRAIN_ROWS-row split of phase 7's
# tree (2 steps at batch 64, the epoch's checkpoint), the eval CLI on phase
# 6's DP_EVAL_SPLIT, whose metrics equal phase 6's run without a process
# group within DP_ONE_RANK_REL; the step through the parallel API at the
# CLI's width with and without the process group.  (b) Two ranks sharing
# the card over gloo through the parallel API (NCCL refuses two ranks on one
# device): the step at full width, 32 rows a rank, against one process's
# (the tests' tolerances; both ranks' states bitwise equal), and
# run_evaluation on DP_EVAL_SPLIT against phase 6's within DP_TWO_RANK_REL
# (each rank's convolutions run at half the batch).  Every child has
# DP_TIMEOUT seconds, and every collective the group's own timeout.
DP_TRAIN_SPLIT, DP_TRAIN_ROWS, DP_EVAL_SPLIT = "slp-ir", 128, "slp-4mod-uncover"
DP_TRAIN_CLI_ARGS = ["--name", "chip_smoke_dp", "--run_smplify", "--data_train", DP_TRAIN_SPLIT, "--num_epochs", "1",
                     "--summary_steps", "1", "--data_test", "", "--allow_synthetic_assets"]
DP_STEP_FLAGS = {"model": MODEL, "res": RES, "batch": 64, "smplify_iters": 100}
DP_TIMED_STEPS, DP_TIMEOUT = 3, 600
DP_ONE_RANK_REL, DP_TWO_RANK_REL = 1e-6, 1e-5
DP_LR = 5e-5
DP_LOSS_RTOL, DP_PARAM_RTOL, DP_PARAM_ATOL, DP_BN_RTOL, DP_BN_ATOL = 1e-4, 1e-4, 1.2 * 2 * DP_LR, 1e-3, 2e-4
# The fits: SMPLify's 100 iterations carry the step's float32 reassociation
# to 8.77e-4 on the card (PERF.md section 6, every data-parallel run), so the limit
# is 3.4x that; the fits with rank 1's updates left out of rank 0's store
# (the scatter left local) read 1.51 and must break it.
DP_FITS_ATOL = 3e-3
# The averaged gradient's worst parameter, relative to one process's
# (`dryrun.gradient_readings`; the tests' limit): 0.113 on the card; its
# controls (summed, divided twice, rank 0's alone) read 0.52-19.9 and must
# break it.
DP_GRAD_RTOL = 0.25
# A child process that runs one CLI's `main` (argv[1]: train or eval) in a
# process group and prints its skinning launches and what `main` returned,
# after the tag.
DP_CLI_CHILD = r"""
import json, sys
import torch
from inbed_pose_estimation_tpu_torch.ops import skinning as sk
from inbed_pose_estimation_tpu_torch.parallel import mesh
cli, argv = sys.argv[1], sys.argv[2:]
out = {}
if cli == "train":
    import train_gpu
    trainer = train_gpu.main(argv)
    summaries = [h for h in trainer.history if h["kind"] == "summary"]
    out.update(steps=trainer.step_count, smplify_iters=trainer.options.num_smplify_iters,
               ms_per_step=[h["wall_ms_per_step"] for h in summaries], loss=[h["metrics"]["loss"] for h in summaries],
               saves=[h["path"] for h in trainer.history if h["kind"] == "save"])
else:
    import eval_gpu
    results = eval_gpu.main(argv)
    out.update(results={s: {k: v for k, v in r.items() if k != "timing"} for s, r in results.items()},
               timing={s: r["timing"] for s, r in results.items()})
if torch.cuda.is_available():
    torch.cuda.synchronize()
out.update(launches=sk.launches, rank=mesh.rank(), world_size=mesh.world_size(),
           backend=torch.distributed.get_backend() if mesh.is_initialized() else None)
print("DP_CHILD " + json.dumps(out), flush=True)
mesh.shutdown()
"""
# Two ranks' run_evaluation on one device over gloo, with the eval CLI's
# model, weights and defaults (argv: the split, the batch, the model and the
# device, cuda:0 on the card).
DP_EVAL_CHILD = r"""
import json, sys, types
import torch
from inbed_pose_estimation_tpu_torch import config
from inbed_pose_estimation_tpu_torch.data import BaseDataset
from inbed_pose_estimation_tpu_torch.evaluation import run_evaluation
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.ops import skinning as sk
from inbed_pose_estimation_tpu_torch.parallel import mesh
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
split, batch, model_name, device = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = mesh.initialize_distributed(backend="gloo", device=device)
torch.manual_seed(0)
model, spec = build_model(model_name, smpl_mean_params=config.asset("smpl_mean_params"), device=dev, img_res=224)
opts = types.SimpleNamespace(img_res=224, device_preprocess=False, crop_cache=None, fast_preprocess=False)
r = run_evaluation(model, spec, split, BaseDataset(opts, split, is_train=False), synthetic_smpl_model(0, device=dev),
                   batch_size=batch, img_res=224, num_workers=8, device=dev)
if torch.cuda.is_available():
    torch.cuda.synchronize()
print("DP_CHILD " + json.dumps({"results": {k: v for k, v in r.items() if k != "timing"}, "timing": r["timing"],
                                "launches": sk.launches, "rank": mesh.rank(), "world_size": mesh.world_size(),
                                "backend": torch.distributed.get_backend()}), flush=True)
mesh.shutdown()
"""

# Phase 13: the three host-side tools at small depth.  latency_mode at batch
# 32; loader_bench on phase 9's cached split of phase 7's tree; profile_mfu's
# inference at two batches and its train step at one (bfloat16, no SMPLify).
LATENCY_ARGS = ["--batch", "32", "--iters", "10"]
LOADER_BENCH_ARGS = ["--dataset", BAR_TRAIN_SPLIT, "--batch_size", "4", "--rounds", "2", "--batches", "2"]
MFU_ARGS, MFU_TRAIN_ARGS = ["--batches", "32,64", "--iters", "3"], ["--train", "--batches", "64", "--iters", "3"]

# Phase 14: the body-mask tool on this subject of phase 6's tree.
GET_MASK_SUBJECT = 1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    from inbed_pose_estimation_tpu_torch.tools.bench_train import train_batch
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
    state, metrics = step(state, train_batch(spec, options.batch_size, options.img_res, FITS_ROWS, SEED + 1))
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
    from inbed_pose_estimation_tpu_torch.tools.bench_train import train_batch
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
    host = train_batch(spec, B, options.img_res, FITS_ROWS, SEED)
    check(set(host) == step_feed_keys(spec) - {"pixel_noise"}, "the synthetic batch lacks a key the float feed has")
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
    """Phase 6 (and phase 8's, 9's, 11's and 12's eval CLI runs and phase
    14's body-mask tool on its tree); returns the skinning launches of the
    driver's run, its batch count, the launches of phase 8's runs by model,
    of phase 9's, of phase 11's and of phase 12's."""
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
            dp_want = results[DP_EVAL_SPLIT]  # phase 12 holds its runs to this one
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

            # Phase 8's and phase 9's eval CLI runs on this tree.
            family_launches = families_eval_driver(torch, np, dev, smi, base)
            bar_launches = bar_eval_driver(torch, np, dev, smi, base)
            # Phase 11's eval CLI run with --result_file on this tree.
            dumps_launches = dumps_eval_driver(torch, np, dev, smi, base)
            # Phase 12's eval runs in a process group on this tree.
            torch.cuda.empty_cache()
            dp_launches = dp_eval_driver(torch, np, dev, smi, dp_want)
            # Phase 14's body-mask tool on this tree's frames.
            get_mask_driver(np, smi)

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
    return launches, batches, family_launches, bar_launches, dumps_launches, dp_launches


def train_driver_phase(torch, np, dev, smi):
    """Phase 7 (and phase 8's and phase 10's train CLI steps and phase 9's
    train CLI run on its tree); returns the skinning launches of one driver
    step and of the driver's whole run, its steps, and the launches of phase
    8's fusion step, of phase 9's run and of phase 10's step."""
    import tempfile

    import train_gpu

    from inbed_pose_estimation_tpu_torch.data import CheckpointDataLoader
    from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk

    saved_env = {k: os.environ.get(k) for k in ("INBED_DATA_ROOT", "INBED_NPZ_PATH", "INBED_ASSET_DIR")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as base:
        try:
            os.environ["INBED_ASSET_DIR"] = f"{base}/no_assets"  # synthetic SMPL and GMM prior
            t0 = time.perf_counter()
            _point_env_at(write_synthetic_environment(base, num_subjects=1, samples_per_subject=TRAIN_SAMPLES,
                                                      img_hw=SLP_FRAME_HW))
            log("train_tree", train_samples=2 * TRAIN_SAMPLES, eval_samples=TRAIN_SAMPLES,
                frame_hw=list(SLP_FRAME_HW), seconds=time.perf_counter() - t0)
            args = TRAIN_DRIVER_ARGS + ["--log_dir", f"{base}/logs", "--device", dev.type]

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sk.launches = 0
            t0 = time.perf_counter()
            trainer = train_gpu.main(args)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = sk.launches
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            opts = trainer.options
            B, N, steps = opts.batch_size, opts.num_smplify_iters, trainer.step_count
            eval_batches = -(-TRAIN_SAMPLES // min(B, 32))
            summaries = [h for h in trainer.history if h["kind"] == "summary"]
            saves = [h for h in trainer.history if h["kind"] == "save"]
            evals = [h for h in trainer.history if h["kind"] == "eval"]
            per_step = (launches - eval_batches) / steps if steps else 0
            check(steps == TRAIN_DRIVER_STEPS and len(summaries) == steps and len(saves) == 1 and len(evals) == 1,
                  f"train driver: {steps} steps, {len(saves)} saves, {len(evals)} evals")
            check(per_step == 6 + 2 * N, f"train driver: {launches} skinning launches for {steps} steps and "
                                         f"{eval_batches} eval batches, {per_step} a step, expected {6 + 2 * N}")
            for h in summaries:
                check(all(np.isfinite(v) for v in h["metrics"].values()), f"train driver step {h['step']}: metrics")
            timed = summaries[1:]
            wall_ms = sum(h["wall_ms_per_step"] for h in timed) / len(timed)
            phase_ms = {k: sum(h["phases_ms"][k] for h in timed) / len(timed) for k in timed[0]["phases_ms"]}
            log("train_driver", args=args, model=opts.model, batch=B, res=opts.img_res, smplify_iters=N,
                workers=opts.num_workers, uint8_feed=opts.uint8_feed, steps=steps, timed_steps=len(timed),
                launches={"skinning": launches}, launches_per_step=per_step, eval_batches=eval_batches,
                images_per_s=B * len(timed) / (sum(h["wall_ms_per_step"] for h in timed) / 1e3),
                ms_per_step=wall_ms, loader_wait_ms_per_step=phase_ms["data"],
                loader_wait_share=phase_ms["data"] / wall_ms, step_dispatch_ms=phase_ms["dispatch"],
                step_sync_ms=phase_ms["sync"], first_step_ms=summaries[0]["wall_ms_per_step"],
                first_step_loader_wait_ms=summaries[0]["phases_ms"]["data"],
                per_step=[{k: h[k] for k in ("step", "wall_ms_per_step", "phases_ms")} for h in summaries],
                checkpoint_s=saves[0]["seconds"], checkpoint_gb=saves[0]["bytes"] / 1e9,
                eval_s=evals[0]["seconds"], run_s=run_s, peak_mem_gib=peak_gib,
                loss=[h["metrics"]["loss"] for h in summaries], card=smi)

            # What was saved equals the live state (the eval that followed
            # changes nothing the checkpoint holds).
            ck_path = saves[0]["path"]
            saved = torch.load(ck_path, map_location="cpu", weights_only=True)
            fits_path = os.path.join(opts.checkpoint_dir, "slp-4mod-train_fits.npy")
            saved_fits = np.load(fits_path)
            live = trainer.state
            check(all(torch.equal(v.cpu(), saved["model"][k]) for k, v in live.model.state_dict().items()),
                  "train driver: the checkpoint's weights differ from the live model's")
            check(torch.equal(live.generator.get_state(), saved["generator"]), "checkpoint: generator state")
            check(np.array_equal(saved_fits, live.fits.cpu().numpy()), "checkpoint: fits")

            # The step alone on a loaded batch, no loader running beside it:
            # the driver's step against phase 5's.
            batches = iter(CheckpointDataLoader(trainer.train_ds, batch_size=B, num_workers=opts.num_workers, seed=0))
            batch = next(batches)[1]
            batches.close()  # stops the loader before the timing
            feed = {k: v for k, v in batch.items() if k in trainer.feed_keys}
            state = trainer.train_step(trainer.state, feed)[0]
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(2):
                state = trainer.train_step(state, feed)[0]
            end.record()
            torch.cuda.synchronize()
            alone_ms = start.elapsed_time(end) / 2
            log("train_driver_step_alone", ms_per_step=alone_ms, host_ms_per_step=1e3 * (time.perf_counter() - t0) / 2,
                driver_ms_per_step=wall_ms, driver_dispatch_ms=phase_ms["dispatch"],
                uint8_bytes_per_batch=sum(np.asarray(v).nbytes for v in feed.values()), card=smi)
            del trainer, state, live, feed, batch
            torch.cuda.empty_cache()

            # Resume in-process from the saved .pt: the state as saved, then
            # one more step (time_to_run 0 saves and stops after it).
            t0 = time.perf_counter()
            _, resumed, eval_fn = train_gpu.setup(args + ["--resume", "--num_epochs", "2", "--time_to_run", "0"])
            resume_s = time.perf_counter() - t0
            rs = resumed.state
            check((resumed.epoch0, resumed.checkpoint_batch_idx, resumed.step_count) == (1, 0, steps),
                  f"resume: epoch {resumed.epoch0}, batch {resumed.checkpoint_batch_idx}, step {resumed.step_count}")
            check(np.array_equal(resumed.dataset_perm, saved["dataset_perm"].numpy()), "resume: dataset_perm")
            params = list(rs.model.parameters())
            opt_saved = saved["optimizer"]["state"]
            check(len(opt_saved) == len(params), "resume: Adam state count")
            adam_equal = all(torch.equal(rs.optimizer.state[p][n].cpu(), opt_saved[i][n])
                             for i, p in enumerate(params) for n in ("exp_avg", "exp_avg_sq", "step"))
            nonzero = sum(int(bool(opt_saved[i]["exp_avg"].abs().max() > 0)) for i in range(len(params)))
            adam_steps = {float(opt_saved[i]["step"]) for i in range(len(params))}
            check(adam_equal and nonzero > 0 and adam_steps == {float(steps)},
                  f"resume: Adam moments equal {adam_equal}, non-zero in {nonzero}, steps {adam_steps}")
            check(torch.equal(rs.generator.get_state(), saved["generator"]), "resume: generator state")
            check(np.array_equal(rs.fits.cpu().numpy(), saved_fits), "resume: fits")
            del saved
            sk.launches = 0
            t0 = time.perf_counter()
            resumed.train(eval_fn=eval_fn)
            torch.cuda.synchronize()
            more_s = time.perf_counter() - t0
            more = [h for h in resumed.history if h["kind"] == "summary"]
            check(resumed.step_count == steps + 1 and len(more) == 1 and sk.launches == 6 + 2 * N
                  and all(np.isfinite(v) for v in more[0]["metrics"].values()),
                  f"resumed run: step {resumed.step_count}, {sk.launches} skinning launches")
            check(os.path.exists(os.path.join(opts.checkpoint_dir, "epoch_1_1.pt")), "resumed run: no epoch_1_1.pt")
            log("train_driver_resume", checkpoint=os.path.basename(ck_path), setup_s=resume_s,
                adam_moments_nonzero_params=nonzero, params=len(params), adam_steps=sorted(adam_steps),
                step=resumed.step_count, step_ms=more[0]["wall_ms_per_step"], step_and_save_s=more_s,
                launches={"skinning": sk.launches}, loss=more[0]["metrics"]["loss"], card=smi)
            del resumed, rs, params
            torch.cuda.empty_cache()

            # Phase 8's and phase 10's train CLI steps and phase 9's train CLI
            # run on this tree.
            family_launches = families_train_driver(torch, np, dev, smi, base)
            bar_launches = bar_train_driver(torch, np, dev, smi, base)
            bf16_launches = bf16_train_driver(torch, np, dev, smi, base)
            # Phase 12's train CLI run in a process group and phase 13's
            # loader_bench (on phase 9's cache) on this tree.
            torch.cuda.empty_cache()
            dp_launches = dp_train_driver(torch, np, dev, smi, base)
            loader_bench_driver(np, smi, base)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return per_step, launches, steps, family_launches, bar_launches, bf16_launches, dp_launches


def write_guide(torch, path: str) -> dict:
    """A seeded ir_depth_fusion's weights as a `.pt` in the reference layout
    at `path`, for --pretrained_fusion_checkpoint; returns them (CPU)."""
    from inbed_pose_estimation_tpu_torch.models import build_model

    torch.manual_seed(GUIDE_SEED)
    donor, _ = build_model("ir_depth_fusion", device="cpu")
    state = donor.state_dict()
    torch.save({"model": state}, path)
    return state


def guide_unchanged(torch, model, want: dict) -> bool:
    """Is the frozen guide of `model` bitwise `want`?"""
    return all(torch.equal(v.cpu(), want[k]) for k, v in model.guide.state_dict().items())


def families_eval_driver(torch, np, dev, smi, base):
    """Phase 8 on phase 6's tree: the eval CLI for featatt_cashmr and for
    ir_depth_pm_fusion with a guide checkpoint, one split each; returns
    their skinning launches."""
    import eval_gpu

    from inbed_pose_estimation_tpu_torch.ops import shuffle_project as sp
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk

    guide = f"{base}/guide.pt"
    write_guide(torch, guide)
    split, batches = "slp-4mod-uncover", -(-EVAL_SAMPLES // BATCH)
    launches = {}
    for name, extra in (("featatt_cashmr", []), ("ir_depth_pm_fusion", ["--pretrained_fusion_checkpoint", guide])):
        args = ["--model", name, "--allow_synthetic_assets", "--dataset", split, *extra, "--device", dev.type]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.launches = sp.launches = 0
        r = eval_gpu.main(args)[split]
        torch.cuda.synchronize()
        launches[name] = sk.launches
        projection_launches.setdefault("families_eval_driver", {})[name] = sp.launches
        expected = FAMILY_EVAL_LAUNCHES[name] * batches
        log("families_eval_driver", args=args, launches={"skinning": sk.launches, "shuffle_project": sp.launches},
            expected=expected, expected_shuffle_project=FAMILY_PROJECTIONS[name] * batches,
            batches=batches, images_per_s=r["timing"]["images_per_s"], seconds=r["timing"]["seconds"],
            loader_wait_s=r["timing"]["loader_wait_s"], peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            mpjpe=r["mpjpe"], pa_mpjpe=r["pa_mpjpe"], mask_f1=r["mask_f1"], card=smi)
        check(sk.launches == expected, f"eval_gpu --model {name}: {sk.launches} skinning launches, expected {expected}")
        check(sp.launches == FAMILY_PROJECTIONS[name] * batches,
              f"eval_gpu --model {name}: {sp.launches} shuffled projection launches, "
              f"expected {FAMILY_PROJECTIONS[name] * batches}")
        check(r["timing"]["images"] == EVAL_SAMPLES and np.isfinite(r["mpjpe"]) and r["pa_mpjpe"] <= r["mpjpe"],
              f"eval_gpu --model {name}: metrics {r['mpjpe']} / {r['pa_mpjpe']}")
    return launches


def families_train_driver(torch, np, dev, smi, base):
    """Phase 8 on phase 7's tree: one train CLI step of ir_depth_pm_fusion
    with SMPLify and a guide checkpoint; returns its skinning launches."""
    import train_gpu

    from inbed_pose_estimation_tpu_torch.ops import skinning as sk

    guide = f"{base}/guide.pt"
    want = write_guide(torch, guide)
    name, (_, expected) = "ir_depth_pm_fusion", FAMILY_TRAIN["ir_depth_pm_fusion"]
    args = TRAIN_DRIVER_ARGS + ["--log_dir", f"{base}/fusion_logs", "--model", name, "--pretrained_fusion_checkpoint",
                                guide, "--time_to_run", "0", "--device", dev.type]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    t0 = time.perf_counter()
    trainer = train_gpu.main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = sk.launches
    summary = [h for h in trainer.history if h["kind"] == "summary"]
    saves = [h for h in trainer.history if h["kind"] == "save"]
    log("families_train_driver", args=args, steps=trainer.step_count, launches={"skinning": launches},
        expected=expected, step_ms=summary[0]["wall_ms_per_step"] if summary else None,
        loader_wait_ms=summary[0]["phases_ms"]["data"] if summary else None, run_s=run_s,
        checkpoint_gb=saves[0]["bytes"] / 1e9 if saves else None,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=smi)
    check(trainer.step_count == 1 and len(summary) == 1 and len(saves) == 1,
          f"train_gpu --model {name}: {trainer.step_count} steps, {len(saves)} saves")
    check(launches == expected, f"train_gpu --model {name}: {launches} skinning launches, expected {expected}")
    check(all(np.isfinite(v) for v in summary[0]["metrics"].values()), f"train_gpu --model {name}: metrics")
    check(guide_unchanged(torch, trainer.state.model, want), f"train_gpu --model {name}: the guide changed")
    del trainer
    torch.cuda.empty_cache()
    return launches


def families_phase(torch, np, dev, smi, smpl, cuda_ms):
    """Phase 8 on synthetic inputs; returns the skinning launches of one eval
    call and of one train step per model."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model, model_names
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS
    from inbed_pose_estimation_tpu_torch.ops import batch_norm_act as bna
    from inbed_pose_estimation_tpu_torch.ops import shuffle_project as sp
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk
    from inbed_pose_estimation_tpu_torch.ops.mask_raster import render_body_mask
    from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
    from inbed_pose_estimation_tpu_torch.tools.bench_train import train_batch
    from inbed_pose_estimation_tpu_torch.train import FitsStore, build_parser, init_train_state, make_train_step

    V = smpl.v_template.shape[0]
    jreg = load_j_regressor_h36m(num_vertices=V)
    rng = np.random.default_rng(SEED)
    eval_launches, train_launches = {}, {}

    # Every registered name builds on the card.
    built = {}
    for name in model_names():
        model, _ = build_model(name, device=dev)
        check(all(p.is_cuda for p in model.parameters()), f"{name}: parameters off the card")
        built[name] = sum(p.numel() for p in model.parameters())
        del model
    torch.cuda.empty_cache()
    log("families_build", parameters=built, models=len(built))
    check(len(built) == 24, f"{len(built)} models built on the card, expected 24 (23 of the JAX package, hmr2_vith4mod)")

    # Eval inference at batch 32, 224^2.
    for name, expected in FAMILY_EVAL_LAUNCHES.items():
        torch.manual_seed(SEED)
        model, spec = build_model(name, device=dev)
        infer = make_inference_fn(model, spec, smpl, jreg, num_cas_iters=NUM_CAS_ITERS, final_recon=False, device=dev)
        inputs = tuple(torch.from_numpy(rng.normal(0, 1, (BATCH, MODALITY_CHANNELS[m], RES, RES)).astype(np.float32))
                       .to(dev) for m in spec.modalities)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.launches = sp.launches = 0
        bna.launches = dict.fromkeys(bna.FORMS, 0)
        out = infer(inputs)
        torch.cuda.synchronize()
        eval_launches[name] = sk.launches
        projection_launches.setdefault("families_eval", {})[name] = sp.launches
        tails = dict(bna.launches)
        expected_tails = {k: n * FAMILY_TRUNK_PASSES[name] for k, n in TRUNK_TAILS.items()}
        check(tails == expected_tails, f"{name}: the trunk's tail kernel launched {tails} in one eval call, "
                                       f"expected {expected_tails}")
        check(sk.launches == expected, f"{name}: skinning launched {sk.launches} times in one eval call, "
                                       f"expected {expected}")
        check(sp.launches == FAMILY_PROJECTIONS[name], f"{name}: shuffled projection launched {sp.launches} times in "
                                                       f"one eval call, expected {FAMILY_PROJECTIONS[name]}")
        check(tuple(out["vertices"].shape) == (BATCH, V, 3) and tuple(out["keypoints_3d_17"].shape) == (BATCH, 17, 3),
              f"{name}: output shapes")
        for key in ("rotmat", "betas", "cam", "vertices", "keypoints_3d_17"):
            check(bool(torch.isfinite(out[key]).all()), f"{name}: {key} has non-finite values")
        mask = out["recon"].get("mask")
        if mask is not None:
            check(bool(((mask >= 0) & (mask <= 1)).all()) and 0 < float(mask.mean()) < 1,
                  f"{name}: the body mask is {float(mask.mean())} on average")
        for _ in range(3):
            infer(inputs)
        torch.cuda.synchronize()
        before = sk.launches
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            infer(inputs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(sk.launches - before == expected * TIMED_CALLS, f"{name}: launches in the timed loop")
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            infer(inputs)
        log("families_eval", model=name, batch=BATCH, res=RES,
            launches={"skinning": eval_launches[name], "shuffle_project": projection_launches["families_eval"][name],
                      "batch_norm_act": tails},
            expected=expected, images_per_s=BATCH * TIMED_CALLS / seconds, ms_per_batch=1e3 * seconds / TIMED_CALLS,
            calls=TIMED_CALLS, tflop_per_batch=counter.get_total_flops() / 1e12,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=smi)

        if name == "ir_depth_fusion":
            # K2 on this batch's meshes: its time at batch 32, 224^2, and the
            # card against the CPU on the same vertices.
            verts, cam = out["vertices"], out["cam"]
            k2_ms = cuda_ms(lambda: render_body_mask(verts, cam), 20)
            card = render_body_mask(verts, cam).cpu()
            cpu = render_body_mask(verts.cpu(), cam.cpu())
            k2_diff = int((card != cpu).sum())
            log("families_mask_raster", batch=BATCH, res=RES, vertices=V, ms_per_batch=k2_ms,
                card_vs_cpu_differing_pixels=k2_diff, pixels=int(cpu.numel()), body_share=float(cpu.mean()),
                card=smi)
            check(k2_diff == 0, f"K2: {k2_diff} mask pixels differ between the card and the CPU")
        del model, infer, inputs, out
        torch.cuda.empty_cache()

    # The same weights on the card and on the CPU at RES 64, batch 2.
    cpu_smpl = synthetic_smpl_model(SEED, device="cpu")
    for name in ("featatt_cashmr", "ir_depth_pm_fusion"):
        torch.manual_seed(SEED + 4)
        cpu_model, spec = build_model(name, device="cpu")
        model, _ = build_model(name, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        small = [rng.normal(0, 1, (2, MODALITY_CHANNELS[m], 64, 64)).astype(np.float32) for m in spec.modalities]
        infer = make_inference_fn(model, spec, smpl, jreg, final_recon=False, device=dev)
        want = make_inference_fn(cpu_model, spec, cpu_smpl, jreg, final_recon=False, device="cpu")(small)

        def readings(got):
            errs = {k: (got[k].cpu() - want[k]).abs().max().item() for k in FAMILY_CARD_VS_CPU_LIMITS}
            errs["mask_pixels"] = int((got["recon"]["mask"].cpu() != want["recon"]["mask"]).sum()) \
                if "mask" in want["recon"] else 0
            return errs

        errs = readings(infer(small))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        tf32 = readings(infer(small))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        limits = dict(FAMILY_CARD_VS_CPU_LIMITS, mask_pixels=FAMILY_CARD_VS_CPU_MASK_PIXELS)
        log("families_card_vs_cpu", model=name, res=64, batch=2, max_abs_err=errs, limits=limits,
            tf32_control=tf32)
        for k, v in errs.items():
            check(v <= limits[k], f"{name} card vs CPU: {k} reads {v:.3g}, limit {limits[k]:.3g}")
        check(any(v > limits[k] for k, v in tf32.items()),
              f"{name} card vs CPU: the TF32 control meets every limit, so they cannot tell TF32 from float32")
        del model, cpu_model, infer

    # The train step with SMPLify at the train CLI's defaults.  featatt_cashmr
    # needs 65-68 GiB of the card's 80 at batch 64: start from an empty cache.
    gc.collect()
    torch.cuda.empty_cache()
    options = build_parser().parse_args(TRAIN_ARGS)
    N = options.num_smplify_iters
    prior = synthetic_gmm_prior(device=dev)
    for name, (B, expected) in FAMILY_TRAIN.items():
        options.batch_size = B
        torch.manual_seed(SEED + 1)
        model, spec = build_model(name, device=dev)
        store = FitsStore("synthetic", FITS_ROWS, device=dev)
        state = init_train_state(model, options, store.array, seed=SEED, device=dev)
        step = make_train_step(model, spec, smpl, prior, options, device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in train_batch(spec, B, RES, FITS_ROWS, SEED).items()}
        guide0 = {k: v.cpu().clone() for k, v in model.guide.state_dict().items()} if hasattr(model, "guide") else None
        params0 = [p.detach().clone() for p in state.optimizer.param_groups[0]["params"]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.launches = sp.launches = 0
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        train_launches[name] = sk.launches
        projection_launches.setdefault("families_train_step", {})[name] = sp.launches
        check(sk.launches == expected, f"{name}: skinning launched {sk.launches} times in one train step, "
                                       f"expected {expected} (N = {N})")
        check(sp.launches == FAMILY_TRAIN_PROJECTIONS[name], f"{name}: shuffled projection launched {sp.launches} "
                                                             f"times in one train step, expected "
                                                             f"{FAMILY_TRAIN_PROJECTIONS[name]}")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"{name} train step: a non-finite metric")
        moved = sum(int(not torch.equal(a, p)) for a, p in zip(params0, state.optimizer.param_groups[0]["params"]))
        del params0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 2
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"{name} timed train steps: a non-finite metric")
        if guide0 is not None:
            check(guide_unchanged(torch, model, guide0), f"{name}: the frozen guide changed in training")
        log("families_train_step", model=name, batch=B, res=RES, num_smplify_iters=N,
            launches={"skinning": train_launches[name],
                      "shuffle_project": projection_launches["families_train_step"][name]}, expected=expected, first_step_s=first_s, ms_per_step=ms,
            images_per_s=1e3 * B / ms, params_moved=moved,
            trained_params=len(state.optimizer.param_groups[0]["params"]),
            guide_unchanged=guide0 is not None, metrics={k: v.item() for k, v in metrics.items()},
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30, card=smi)
        del model, state, step, batch, metrics
        torch.cuda.empty_cache()
    return eval_launches, train_launches


def bar_inputs(np, spec, batch, res, rng):
    """Bodies-At-Rest's inputs: the modalities N(0, 1), then the contact
    channels in [0, 1]."""
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS

    mods = [rng.normal(0, 1, (batch, MODALITY_CHANNELS[m], res, res)).astype(np.float32) for m in spec.modalities]
    return mods + [rng.uniform(0, 1, (batch, 2, res, res)).astype(np.float32)]


def bar_phase(torch, np, dev, smi, smpl):
    """Phase 9 on synthetic inputs; returns the skinning launches of one eval
    call per name and of one train step per mode."""
    import gc

    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk
    from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model
    from inbed_pose_estimation_tpu_torch.tools.bench_train import train_batch
    from inbed_pose_estimation_tpu_torch.train import FitsStore, build_parser, init_train_state, make_train_step

    V = smpl.v_template.shape[0]
    jreg = load_j_regressor_h36m(num_vertices=V)
    rng = np.random.default_rng(SEED + 9)
    eval_launches, train_launches = {}, {}

    # Eval inference at batch 32, 224^2: launches, the plain skinning, time.
    for name, expected in BAR_EVAL_LAUNCHES.items():
        torch.manual_seed(SEED)
        model, spec = build_model(name, device=dev, img_res=RES)
        infer = make_inference_fn(model, spec, smpl, jreg, device=dev)
        inputs = [torch.from_numpy(x).to(dev) for x in bar_inputs(np, spec, BATCH, RES, rng)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.launches = 0
        out = infer(inputs)
        torch.cuda.synchronize()
        eval_launches[name] = sk.launches
        check(sk.launches == expected, f"{name}: skinning launched {sk.launches} times in one eval call, "
                                       f"expected {expected}")
        check(tuple(out["vertices"].shape) == (BATCH, V, 3) and tuple(out["keypoints_3d_17"].shape) == (BATCH, 17, 3),
              f"{name}: output shapes")
        for key in ("rotmat", "betas", "cam", "vertices", "keypoints_3d_17"):
            check(bool(torch.isfinite(out[key]).all()), f"{name}: {key} has non-finite values")
        with torch.no_grad():
            ref_verts, _ = lbs(smpl, out["betas"], out["rotmat"], skin=sk.skinning_reference)
        v_err = (out["vertices"] - ref_verts).abs().max().item()
        check(v_err <= 1e-5, f"{name}: vertices differ from the plain skinning's by {v_err}")
        est_map = out["recon"].get("est_map")
        if est_map is not None:
            check(tuple(est_map.shape) == (BATCH, 1, RES, RES) and bool(((est_map == 0) | (est_map == 1)).all()),
                  f"{name}: the estimated map is not a {{0, 1}} map of the input's size")
        for _ in range(3):
            infer(inputs)
        torch.cuda.synchronize()
        before = sk.launches
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            infer(inputs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(sk.launches - before == expected * TIMED_CALLS, f"{name}: launches in the timed loop")
        log("bar_eval", model=name, batch=BATCH, res=RES, launches={"skinning": eval_launches[name]},
            expected=expected, vertices_vs_plain_max_abs_err=v_err,
            est_map_mean=None if est_map is None else float(est_map.mean()),
            images_per_s=BATCH * TIMED_CALLS / seconds, ms_per_batch=1e3 * seconds / TIMED_CALLS, calls=TIMED_CALLS,
            parameters=sum(p.numel() for p in model.parameters()),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=smi)
        del model, infer, inputs, out
        torch.cuda.empty_cache()

    # The same weights on the card and on the CPU at RES 64, batch 2, and a
    # TF32 control that must break a limit.
    cpu_smpl = synthetic_smpl_model(SEED, device="cpu")
    for name in BAR_EVAL_LAUNCHES:
        torch.manual_seed(SEED + 4)
        cpu_model, spec = build_model(name, device="cpu", img_res=64)
        model, _ = build_model(name, device=dev, img_res=64)
        model.load_state_dict(cpu_model.state_dict())
        small = bar_inputs(np, spec, 2, 64, rng)
        infer = make_inference_fn(model, spec, smpl, jreg, device=dev)
        want = make_inference_fn(cpu_model, spec, cpu_smpl, jreg, device="cpu")(small)

        def readings(got):
            errs = {k: (got[k].cpu() - want[k]).abs().max().item() for k in BAR_CARD_VS_CPU_LIMITS}
            errs["est_map_pixels"] = int((got["recon"]["est_map"].cpu() != want["recon"]["est_map"]).sum()) \
                if "est_map" in want["recon"] else 0
            return errs

        errs = readings(infer(small))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        tf32 = readings(infer(small))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        limits = dict(BAR_CARD_VS_CPU_LIMITS, est_map_pixels=0)
        log("bar_card_vs_cpu", model=name, res=64, batch=2, max_abs_err=errs, limits=limits, tf32_control=tf32,
            est_map_mean=float(want["recon"]["est_map"].mean()) if "est_map" in want["recon"] else None, card=smi)
        for k, v in errs.items():
            check(v <= limits[k], f"{name} card vs CPU: {k} reads {v:.3g}, limit {limits[k]:.3g}")
        check(any(v > limits[k] for k, v in tf32.items()),
              f"{name} card vs CPU: the TF32 control meets every limit, so they cannot tell TF32 from float32")
        del model, cpu_model, infer

    # bodiesAtRest4mod's train step at the train CLI's defaults with SMPLify:
    # a mode-0 step, then a mode-1 step (every output detached: zero
    # gradients, Adam applying its moments).
    gc.collect()
    torch.cuda.empty_cache()
    options = build_parser().parse_args(TRAIN_ARGS)
    B, N = options.batch_size, options.num_smplify_iters
    torch.manual_seed(SEED + 1)
    model, spec = build_model(BAR_TRAIN_MODEL, device=dev, img_res=options.img_res)
    store = FitsStore("synthetic", FITS_ROWS, device=dev)
    state = init_train_state(model, options, store.array, seed=SEED, device=dev)
    prior = synthetic_gmm_prior(device=dev)
    steps = {m: make_train_step(model, spec, smpl, prior, options, device=dev, bar_mode=m) for m in "01"}
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(spec, B, options.img_res, FITS_ROWS, SEED).items()}
    mode2 = {k: v.clone() for k, v in model.state_dict().items() if k.split(".")[0].endswith("_mode2")}
    for mode, step in steps.items():
        trained = {k: p.detach().clone() for k, p in model.named_parameters() if not k.split(".")[0].endswith("_mode2")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.launches = 0
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        train_launches[mode] = sk.launches
        check(sk.launches == BAR_TRAIN_LAUNCHES, f"{BAR_TRAIN_MODEL} mode {mode}: skinning launched {sk.launches} "
                                                 f"times in one train step, expected {BAR_TRAIN_LAUNCHES} (N = {N})")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"mode {mode} train step: a non-finite metric")
        params = dict(model.named_parameters())
        moved = sum(int(not torch.equal(v, params[k])) for k, v in trained.items())
        zero_grads = all(not bool(params[k].grad.any()) for k in trained)
        check(moved == len(trained), f"mode {mode} step: {moved} of {len(trained)} parameters moved")
        check(zero_grads == (mode == "1"), f"mode {mode} step: all gradients zero is {zero_grads}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(2):
            state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 2
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"mode {mode} timed steps: a non-finite metric")
        log("bar_train_step", model=BAR_TRAIN_MODEL, mode=mode, batch=B, res=options.img_res, num_smplify_iters=N,
            launches={"skinning": train_launches[mode]}, expected=BAR_TRAIN_LAUNCHES, first_step_s=first_s,
            ms_per_step=ms, images_per_s=1e3 * B / ms, params_moved=moved, all_grads_zero=zero_grads,
            metrics={k: v.item() for k, v in metrics.items()}, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            card=smi)
    unchanged = all(torch.equal(v, model.state_dict()[k]) for k, v in mode2.items())
    log("bar_mode2_unchanged", model=BAR_TRAIN_MODEL, tensors=len(mode2), unchanged=unchanged)
    check(unchanged and len(mode2) == 16, f"{BAR_TRAIN_MODEL}: the mode-2 stack changed in training")
    del model, state, steps, batch, metrics
    torch.cuda.empty_cache()
    return eval_launches, train_launches


def _items_equal(np, a, b) -> bool:
    return set(a) == set(b) and all(
        (np.asarray(a[k]).dtype == np.asarray(v).dtype and np.array_equal(a[k], v)) if isinstance(v, np.ndarray)
        else a[k] == v for k, v in b.items())


def _first_batch_ms(ds, batch_size):
    """The host time of a loader's first batch on LOADER_THREADS threads."""
    from inbed_pose_estimation_tpu_torch.data import CheckpointDataLoader

    loader = iter(CheckpointDataLoader(ds, batch_size=batch_size, shuffle=False, num_workers=LOADER_THREADS,
                                       drop_last=False))
    t0 = time.perf_counter()
    next(loader)
    ms = 1e3 * (time.perf_counter() - t0)
    loader.close()
    return ms


def cache_phase(np, base, split, is_train, options, batch_size, smi):
    """Phase 9's crop cache on a tree at `base` (INBED_* pointed at it): the
    port's tool builds `split`'s cache (timed), items through it must equal
    items from disk bitwise (a train split's on the same seeded
    augmentation draws, in both feeds), and a loader's first batch of
    `batch_size` is timed from disk, through the cache, and through the
    cache with --fast_preprocess.  Returns the cache directory."""
    import types

    from inbed_pose_estimation_tpu_torch.data import BaseDataset
    from inbed_pose_estimation_tpu_torch.tools.build_crop_cache import main as build_tool

    cache_dir = f"{base}/crop_cache"
    t0 = time.perf_counter()
    build_tool(["--dataset", split, "--out", cache_dir, "--img_res", str(RES), "--progress_every", "0"]
               + ([] if is_train else ["--eval"]))
    build_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(cache_dir, f)) for f in os.listdir(cache_dir) if f.startswith(split))

    def dataset(**kw):
        return BaseDataset(types.SimpleNamespace(**{**options, **kw}), split, is_train=is_train)

    feeds = (False, True) if is_train else (False,)
    compared = 0
    for u8 in feeds:
        disk, cached = dataset(uint8_feed=u8), dataset(uint8_feed=u8, crop_cache=cache_dir)
        check(cached._cache is not None, f"crop cache of {split} refused")
        for i in range(CACHE_ITEMS_COMPARED):
            seed = SEED + i  # train: the same augmentation draws on both sides
            a = disk.__getitem__(i, rng=np.random.default_rng(seed))
            b = cached.__getitem__(i, rng=np.random.default_rng(seed))
            check(_items_equal(np, b, a), f"crop cache: {split} item {i} (uint8 feed {u8}) differs from disk")
            compared += 1
    u8 = is_train
    load_ms = {"disk": _first_batch_ms(dataset(uint8_feed=u8), batch_size),
               "crop_cache": _first_batch_ms(dataset(uint8_feed=u8, crop_cache=cache_dir), batch_size),
               "crop_cache_fast_preprocess": _first_batch_ms(
                   dataset(uint8_feed=u8, crop_cache=cache_dir, fast_preprocess=True), batch_size)}
    log("crop_cache", split=split, train=is_train, samples=len(dataset()), build_s=build_s, cache_mb=size / 1e6,
        items_compared_bitwise=compared, uint8_feed=u8, batch=batch_size, threads=LOADER_THREADS,
        first_batch_ms=load_ms, card=smi)
    return cache_dir


def bar_eval_driver(torch, np, dev, smi, base):
    """Phase 9 on phase 6's tree: the eval CLI for bodiesAtRest4mod on one
    split; the crop cache of that split, and the eval CLI (its defaults)
    with and without it.  Returns bodiesAtRest4mod's skinning launches."""
    import eval_gpu

    from inbed_pose_estimation_tpu_torch.ops import skinning as sk

    split, batches = "slp-4mod-uncover", -(-EVAL_SAMPLES // BATCH)
    name, expected = "bodiesAtRest4mod", BAR_EVAL_LAUNCHES["bodiesAtRest4mod"] * batches
    args = BAR_EVAL_ARGS + ["--dataset", split, "--device", dev.type]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    r = eval_gpu.main(args)[split]
    torch.cuda.synchronize()
    launches = sk.launches
    log("bar_eval_driver", args=args, launches={"skinning": launches}, expected=expected, batches=batches,
        images_per_s=r["timing"]["images_per_s"], seconds=r["timing"]["seconds"],
        loader_wait_s=r["timing"]["loader_wait_s"], peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        mpjpe=r["mpjpe"], pa_mpjpe=r["pa_mpjpe"], mask_f1=r["mask_f1"], card=smi)
    check(launches == expected, f"eval_gpu --model {name}: {launches} skinning launches, expected {expected}")
    check(r["timing"]["images"] == EVAL_SAMPLES and np.isfinite(r["mpjpe"]) and r["pa_mpjpe"] <= r["mpjpe"],
          f"eval_gpu --model {name}: metrics {r['mpjpe']} / {r['pa_mpjpe']}")

    cache_dir = cache_phase(np, base, split, False, {"img_res": RES}, BATCH, smi)
    runs = {}
    for label, extra in (("disk", []), ("crop_cache", ["--crop_cache", cache_dir]), ("disk_again", [])):
        runs[label] = eval_gpu.main(EVAL_ARGS + ["--dataset", split, "--device", dev.type, *extra])[split]
    log("crop_cache_eval_driver", args=EVAL_ARGS + ["--dataset", split], split=split,
        images_per_s={k: v["timing"]["images_per_s"] for k, v in runs.items()},
        loader_wait_s={k: v["timing"]["loader_wait_s"] for k, v in runs.items()},
        mpjpe={k: v["mpjpe"] for k, v in runs.items()}, mask_f1={k: v["mask_f1"] for k, v in runs.items()}, card=smi)
    check(all(runs["crop_cache"][k] == runs["disk"][k] for k in ("mpjpe", "pa_mpjpe", "mask_accuracy", "mask_f1")),
          "eval_gpu --crop_cache: the metrics differ from the run that read from disk")
    return launches


def bar_train_driver(torch, np, dev, smi, base):
    """Phase 9 on phase 7's tree: a BAR_TRAIN_ROWS-row train split, its crop
    cache, and the train CLI for bodiesAtRest through that cache over 2
    epochs with --mod1_epoch 1 (no SMPLify): the step's mode in each epoch.
    Returns the run's skinning launches."""
    import train_gpu

    from inbed_pose_estimation_tpu_torch import config
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk

    with np.load(config.dataset_file("slp-4mod-train", is_train=True)) as full:
        np.savez(config.dataset_file(BAR_TRAIN_SPLIT, is_train=True),
                 **{k: full[k][:BAR_TRAIN_ROWS] for k in full.files})
    options = {"img_res": RES, "noise_factor": 0.4, "rot_factor": 15.0, "scale_factor": 0.15}
    cache_dir = cache_phase(np, base, BAR_TRAIN_SPLIT, True, options, CACHE_TRAIN_BATCH, smi)
    args = BAR_TRAIN_CLI_ARGS + ["--log_dir", f"{base}/bar_logs", "--crop_cache", cache_dir, "--device", dev.type]
    sk.launches = 0
    t0 = time.perf_counter()
    trainer = train_gpu.main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    modes = [(h["epoch"], h["mode"]) for h in trainer.history if h["kind"] == "bar_mode"]
    summaries = [h for h in trainer.history if h["kind"] == "summary"]
    steps_per_epoch = BAR_TRAIN_ROWS // trainer.options.batch_size
    log("bar_train_driver", args=args, steps=trainer.step_count, modes=modes, launches={"skinning": sk.launches},
        step_ms=[h["wall_ms_per_step"] for h in summaries], loader_wait_ms=[h["phases_ms"]["data"] for h in summaries],
        loss=[h["metrics"]["loss"] for h in summaries], run_s=run_s, card=smi)
    check(modes == [(0, "0"), (1, "1")], f"train_gpu --mod1_epoch 1: the step's modes by epoch were {modes}")
    check(trainer.step_count == 2 * steps_per_epoch and len(summaries) == trainer.step_count,
          f"train_gpu bodiesAtRest: {trainer.step_count} steps")
    check(all(np.isfinite(h["metrics"]["loss"]) for h in summaries), "train_gpu bodiesAtRest: a non-finite loss")
    check(sk.launches == 4 * trainer.step_count, f"train_gpu bodiesAtRest: {sk.launches} skinning launches")
    launches = sk.launches
    del trainer
    torch.cuda.empty_cache()
    return launches


def bf16_train_driver(torch, np, dev, smi, base):
    """Phase 10 on phase 7's tree: one train CLI step of cashmrV2 with
    SMPLify, --dtype bfloat16 and --remat; returns its skinning launches."""
    import train_gpu

    from inbed_pose_estimation_tpu_torch.ops import skinning as sk

    args = TRAIN_DRIVER_ARGS + ["--log_dir", f"{base}/bf16_logs", "--dtype", "bfloat16", "--remat", "--time_to_run",
                                "0", "--device", dev.type]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    t0 = time.perf_counter()
    trainer = train_gpu.main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, expected = sk.launches, 6 + 2 * trainer.options.num_smplify_iters
    model, opt = trainer.state.model, trainer.state.optimizer
    summary = [h for h in trainer.history if h["kind"] == "summary"]
    float32_state = (all(p.dtype == torch.float32 for p in model.parameters())
                     and all(v.dtype == torch.float32 for st in opt.state.values() for k, v in st.items()
                             if k != "step"))
    log("bf16_train_driver", args=args, steps=trainer.step_count, launches={"skinning": launches}, expected=expected,
        compute_dtype=str(model.conv1.compute_dtype), remat=trainer.options.remat,
        step_ms=summary[0]["wall_ms_per_step"] if summary else None, run_s=run_s,
        metrics=summary[0]["metrics"] if summary else None, float32_params_and_moments=float32_state,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=smi)
    check(trainer.step_count == 1 and len(summary) == 1, f"train_gpu --dtype bfloat16: {trainer.step_count} steps")
    check(model.conv1.compute_dtype == torch.bfloat16 and trainer.options.remat == "stage",
          "train_gpu --dtype bfloat16 --remat: the flags did not reach the model and the step")
    check(launches == expected, f"train_gpu --dtype bfloat16: {launches} skinning launches, expected {expected}")
    check(all(np.isfinite(v) for v in summary[0]["metrics"].values()), "train_gpu --dtype bfloat16: metrics")
    check(float32_state, "train_gpu --dtype bfloat16: a parameter or an Adam moment is not float32")
    del trainer, model, opt
    torch.cuda.empty_cache()
    return launches


def run_children(cmd, timeout=DP_TIMEOUT):
    """Run `cmd` in its own process group; returns its output, or fails
    (after killing the group) when it exits non-zero or outlives `timeout`."""
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        fail(f"{' '.join(cmd[:6])} ... outlived {timeout} s:\n{out[-6000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    check(proc.returncode == 0, f"{' '.join(cmd[:6])} ... exited with {proc.returncode}:\n{out[-6000:]}")
    return out


def child_results(out: str) -> list:
    """The DP_CHILD lines of a run, by rank."""
    got = [json.loads(ln[len("DP_CHILD "):]) for ln in out.splitlines() if ln.startswith("DP_CHILD ")]
    return sorted(got, key=lambda r: r["rank"])


def torchrun_cli(cli: str, argv: list, nprocs: int = 1) -> list:
    """One CLI's `main` under `torchrun --standalone` (DP_CLI_CHILD); each
    rank's DP_CHILD result."""
    out = run_children([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                        str(nprocs), "--no-python", sys.executable, "-c", DP_CLI_CHILD, cli, *argv])
    got = child_results(out)
    check(len(got) == nprocs, f"torchrun {cli}: {len(got)} of {nprocs} ranks reported:\n{out[-4000:]}")
    return got


def _rel(a, b) -> float:
    return abs(a - b) / max(1.0, abs(b))


def dp_eval_driver(torch, np, dev, smi, want: dict):
    """Phase 12 on phase 6's tree: the eval CLI under torchrun on one NCCL
    rank, and run_evaluation on two gloo ranks sharing the card, each held
    to `want`, phase 6's run of DP_EVAL_SPLIT without a process group.
    Returns the skinning launches per rank of both runs."""
    from inbed_pose_estimation_tpu_torch.parallel import dryrun

    keys = ("mpjpe", "pa_mpjpe", "pve", "mask_accuracy", "mask_f1")
    batches = -(-EVAL_SAMPLES // BATCH)
    args = EVAL_ARGS + ["--dataset", DP_EVAL_SPLIT, "--device", dev.type]
    t0 = time.perf_counter()
    one = torchrun_cli("eval", args)[0]
    one_s = time.perf_counter() - t0
    got = one["results"][DP_EVAL_SPLIT]
    diff = {k: _rel(got[k], want[k]) for k in keys if want[k] is not None}
    log("dp_eval_driver_one_rank", args=args, backend=one["backend"], world_size=one["world_size"],
        launches={"skinning": one["launches"]}, expected=batches, rel_diff=diff, limit=DP_ONE_RANK_REL,
        images_per_s=one["timing"][DP_EVAL_SPLIT]["images_per_s"], run_s=one_s, card=smi)
    check(one["backend"] == "nccl" and one["world_size"] == 1, f"eval_gpu under torchrun: {one['backend']}")
    check(one["launches"] == batches, f"eval_gpu under torchrun: {one['launches']} launches, expected {batches}")
    check(all(got[k] is not None for k in diff) and max(diff.values()) <= DP_ONE_RANK_REL,
          f"eval_gpu under torchrun (1 rank) differs from the run without a process group: {diff}")

    t0 = time.perf_counter()
    shared = "cuda:0" if dev.type == "cuda" else "cpu"
    runs = dryrun.launch(["-c", DP_EVAL_CHILD, DP_EVAL_SPLIT, str(BATCH), MODEL, shared], 2, timeout=DP_TIMEOUT)
    two_s = time.perf_counter() - t0
    for r, (rc, out) in enumerate(runs):
        check(rc == 0, f"run_evaluation on 2 gloo ranks: rank {r} exited with {rc}:\n{out[-6000:]}")
    two = [child_results(out)[0] for _, out in runs]
    diff2 = {k: _rel(two[0]["results"][k], want[k]) for k in keys if want[k] is not None}
    log("dp_eval_two_ranks", split=DP_EVAL_SPLIT, batch=BATCH, backend=two[0]["backend"],
        launches_per_rank=[t["launches"] for t in two], expected_per_rank=batches, rel_diff=diff2,
        limit=DP_TWO_RANK_REL, seconds_per_rank=[t["timing"]["seconds"] for t in two], run_s=two_s, card=smi)
    check(two[0]["results"] == two[1]["results"], "run_evaluation: the 2 ranks returned different results")
    check([t["launches"] for t in two] == [batches, batches], "run_evaluation on 2 ranks: launches per rank")
    check(max(diff2.values()) <= DP_TWO_RANK_REL, f"run_evaluation on 2 gloo ranks differs from 1 process: {diff2}")
    return one["launches"], two[0]["launches"]


def dp_train_driver(torch, np, dev, smi, base):
    """Phase 12 on phase 7's tree: the train CLI under torchrun on one NCCL
    rank over a DP_TRAIN_ROWS-row split (2 steps at its defaults with
    SMPLify, the epoch's checkpoint).  Returns its launches a step."""
    from inbed_pose_estimation_tpu_torch import config

    with np.load(config.dataset_file("slp-4mod-train", is_train=True)) as full:
        np.savez(config.dataset_file(DP_TRAIN_SPLIT, is_train=True), **{k: full[k][:DP_TRAIN_ROWS] for k in full.files})
    args = DP_TRAIN_CLI_ARGS + ["--log_dir", f"{base}/dp_logs", "--device", dev.type]
    t0 = time.perf_counter()
    got = torchrun_cli("train", args)[0]
    run_s = time.perf_counter() - t0
    steps, n = got["steps"], got["smplify_iters"]
    per_step = got["launches"] / steps if steps else 0
    log("dp_train_driver", args=args, backend=got["backend"], world_size=got["world_size"], steps=steps,
        launches={"skinning": got["launches"]}, launches_per_step=per_step, ms_per_step=got["ms_per_step"],
        loss=got["loss"], checkpoints=[os.path.basename(p) for p in got["saves"]], run_s=run_s, card=smi)
    check(got["backend"] == "nccl" and got["world_size"] == 1, f"train_gpu under torchrun: {got['backend']}")
    check(steps == DP_TRAIN_ROWS // 64 and per_step == 6 + 2 * n,
          f"train_gpu under torchrun: {steps} steps, {per_step} launches a step, expected {6 + 2 * n}")
    check(all(np.isfinite(v) for v in got["loss"]), "train_gpu under torchrun: a non-finite loss")
    check(len(got["saves"]) == 1 and os.path.exists(got["saves"][0]), "train_gpu under torchrun: no checkpoint")
    return per_step


def dp_step_phase(torch, np, dev, smi):
    """Phase 12 through the parallel API at the train CLI's width: the step
    in one process, on one NCCL rank, and on two gloo ranks sharing the card
    (against the one process's first step); the collectives of a step.
    Returns the skinning launches per rank of the 2-rank step and eval."""
    import tempfile

    from inbed_pose_estimation_tpu_torch.parallel import dryrun

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as base:
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        t0 = time.perf_counter()
        shared = "cuda:0" if dev.type == "cuda" else "cpu"  # the card that both ranks share
        out = run_children([sys.executable] + dryrun.worker_argv(steps=DP_TIMED_STEPS, device=dev.type,
                                                                 out=f"{base}/single.pt", **DP_STEP_FLAGS))
        single = dryrun.results([(0, out)])[0]
        single_s = time.perf_counter() - t0
        one = dryrun.results(dryrun.launch(dryrun.worker_argv(steps=DP_TIMED_STEPS, device=dev.type, profile=True,
                                                              **DP_STEP_FLAGS), 1, timeout=DP_TIMEOUT, env=env))[0]
        t0 = time.perf_counter()
        runs = dryrun.launch(dryrun.worker_argv(device=shared, backend="gloo", out=f"{base}/ranks.pt",
                                                profile=True, eval=True, **DP_STEP_FLAGS), 2, timeout=DP_TIMEOUT,
                             env=env)
        two_s = time.perf_counter() - t0
        for r, (rc, o) in enumerate(runs):
            check(rc == 0, f"the step on 2 gloo ranks: rank {r} exited with {rc}:\n{o[-6000:]}")
        two = dryrun.results(runs)
        a, b = torch.load(f"{base}/single.pt", map_location=dev), torch.load(f"{base}/ranks.pt", map_location=dev)
        grads = dryrun.gradient_readings(b, a, 2)
        # The control of the fits: rank 0's store had the scatter stayed
        # local, without rank 1's rows (those rank 0 does not also hold).
        own = set(two[0]["sample_index"])
        rows = torch.tensor(sorted(set(two[1]["sample_index"]) - own))
        local_fits = b["fits"].clone()
        local_fits[rows] = torch.from_numpy(dryrun.seeded_fits(len(local_fits)))[rows].to(dev)
        fits_control = (local_fits - a["fits"]).abs().max().item()
        del a["grads"], b["grads"], b["local_grads"]

    n = DP_STEP_FLAGS["smplify_iters"]
    timed = lambda r: sum(r["step_ms"][1:]) / (len(r["step_ms"]) - 1)  # noqa: E731
    log("dp_step_one_rank", flags=DP_STEP_FLAGS, backend=one["backend"], launches_per_step=one["launches_per_step"],
        ms_per_step_with_group=timed(one), ms_per_step_without_group=timed(single),
        step_ms_with_group=one["step_ms"], step_ms_without_group=single["step_ms"],
        group_cost_ms=timed(one) - timed(single), collectives=one["collectives"], single_process_s=single_s,
        card=smi)
    for r in [one] + two:
        c = r["collectives"]
        check(c["all_reduces"] > 0 and c["bytes_all_reduced"] >= c["gradient_bytes"],
              f"the trace of rank {r['rank']} ({r['backend']}) holds too few all-reduces: {c}")
    check(one["backend"] == "nccl" and single["backend"] is None, "the 1-rank step did not run on NCCL")
    check(one["launches_per_step"] == single["launches_per_step"] == 6 + 2 * n,
          f"skinning launches a step: {one['launches_per_step']} (NCCL), {single['launches_per_step']} (none)")
    check(one["metrics"] == single["metrics"] or _rel(one["metrics"]["loss"], single["metrics"]["loss"]) <= 1e-4,
          "the 1-rank step's loss differs from the step without a process group")

    dist = {"params": 0.0, "bn": 0.0}
    for k, want in a["model"].items():
        got = b["model"][k]
        if k.endswith("num_batches_tracked"):
            check(torch.equal(got, want), f"2 ranks: {k}")
            continue
        bn = k.endswith(("running_mean", "running_var"))
        rtol, atol = (DP_BN_RTOL, DP_BN_ATOL) if bn else (DP_PARAM_RTOL, DP_PARAM_ATOL)
        check(bool(((got - want).abs() <= atol + rtol * want.abs()).all()), f"2 ranks vs 1 process: {k}")
        dist["bn" if bn else "params"] = max(dist["bn" if bn else "params"], (got - want).abs().max().item())
    fits_err = (b["fits"] - a["fits"]).abs().max().item()
    loss_rel = abs(two[0]["metrics"]["loss"] / single["metrics"]["loss"] - 1)
    log("dp_step_two_ranks", flags=DP_STEP_FLAGS, backend=two[0]["backend"], device=two[0]["device"],
        rows_per_rank=[r["local_rows"] for r in two], valid_fit_rows=[r["valid_fit_rows"] for r in two],
        launches_per_rank=[r["launches_per_step"] for r in two], eval_launches_per_rank=[r["eval_launches"] for r in two],
        loss_rel=loss_rel, max_abs=dist, fits_max_abs=fits_err, fits_limit=DP_FITS_ATOL,
        fits_control_scatter_local=fits_control, fits_control_rows=len(rows), gradient=grads,
        gradient_limit=DP_GRAD_RTOL, bitwise_equal=[r["state_same_on_every_rank"] for r in two],
        step_ms=[r["step_ms"] for r in two], collectives=[r["collectives"] for r in two], run_s=two_s,
        note="two ranks share one card and gloo stages through the host: correctness, not scaling", card=smi)
    check(all(r["state_same_on_every_rank"] for r in two), "2 ranks: the states are not bitwise equal")
    check(two[0]["metrics"] == two[1]["metrics"], "2 ranks: the global metrics differ between the ranks")
    check(loss_rel <= DP_LOSS_RTOL, f"2 ranks vs 1 process: loss rel {loss_rel}")
    check(fits_err <= DP_FITS_ATOL, f"2 ranks vs 1 process: fits {fits_err}")
    check(fits_control > DP_FITS_ATOL, f"the fits scatter left local meets the fits limit: {fits_control}")
    check(grads["sound"][0] <= DP_GRAD_RTOL, f"2 ranks vs 1 process: gradient {grads['sound']}")
    check(min(grads["controls"].values()) > DP_GRAD_RTOL,
          f"a gradient control meets the gradient limit: {grads['controls']}")
    check([r["launches_per_step"] for r in two] == [6 + 2 * n] * 2, "2 ranks: skinning launches a step per rank")
    check([r["eval_launches"] for r in two] == [1, 1] and all(r["eval_finite"] for r in two), "2 ranks: eval batch")
    check(len({r["valid_fit_rows"] for r in two}) == 2, "2 ranks: the valid fits fall evenly; the batch must split them")
    return two[0]["launches_per_step"], two[0]["eval_launches"]


def loader_bench_driver(np, smi, base):
    """Phase 13 on phase 7's tree: tools/loader_bench.py over phase 9's
    cached split (disk, native crop, cache, cache + native crop)."""
    from inbed_pose_estimation_tpu_torch.tools import loader_bench

    args = LOADER_BENCH_ARGS + ["--crop_cache", f"{base}/crop_cache"]
    got = loader_bench.main(args)
    log("loader_bench", args=args, result=got, card=smi)
    check(set(got["configs"]) == {"disk", "disk+fast", "cache", "cache+fast"}
          and all(np.isfinite(c["median_ms"]) for c in got["configs"].values()), "loader_bench: configs")


def get_mask_driver(np, smi):
    """Phase 14 on phase 6's tree (INBED_* pointed at it): tools/get_mask.py
    over GET_MASK_SUBJECT's RGB/uncover frames, copied into a temporary
    root.  One mask a frame, at the frame's height x width, uint8 with
    values in {0, 255}, equal to `fallback_mask` of the frame read in this
    process (the CLI's read and write lose nothing), and a file for every
    uncover sample of the subject where the eval driver's mask-path
    rewrite looks for it."""
    import shutil
    import tempfile

    from inbed_pose_estimation_tpu_torch import config
    from inbed_pose_estimation_tpu_torch.data.image_io import read_gray_u8, read_rgb_u8
    from inbed_pose_estimation_tpu_torch.evaluation.evaluate import _gt_mask_path
    from inbed_pose_estimation_tpu_torch.tools import get_mask

    sub = f"{GET_MASK_SUBJECT:05d}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_get_mask_") as root:
        frames_dir = os.path.join(root, sub, "RGB", "uncover")
        shutil.copytree(os.path.join(config.dataset_folder("slp"), sub, "RGB", "uncover"), frames_dir)
        frames = sorted(os.listdir(frames_dir))
        t0 = time.perf_counter()
        written = get_mask.main(["--slp_root", root, "--subjects", f"{GET_MASK_SUBJECT}-{GET_MASK_SUBJECT}"])
        seconds = time.perf_counter() - t0
        check(len(written) == len(frames) > 0, f"get_mask: {len(written)} masks for {len(frames)} frames")
        body = []
        for fn in frames:
            frame = read_rgb_u8(os.path.join(frames_dir, fn))
            mask = read_gray_u8(os.path.join(root, sub, "masks", "uncover", fn.replace("image_", "")))
            check(mask is not None and mask.dtype == np.uint8 and mask.shape == frame.shape[:2]
                  and set(np.unique(mask).tolist()) <= {0, 255}, f"get_mask: the mask of {fn}")
            check(np.array_equal(mask, get_mask.fallback_mask(frame)),
                  f"get_mask: the mask of {fn} differs from fallback_mask of the frame")
            body.append(float((mask == 255).mean()))
        with np.load(config.dataset_file("slp-4mod-uncover")) as index:
            names = [str(n) for n in index["imgname"] if str(n).split("/")[0] == sub]
        missing = [n for n in names if not os.path.exists(_gt_mask_path(os.path.join(root, n)))]
        log("get_mask", subject=sub, frames=len(frames), frame_hw=list(frame.shape[:2]), seconds=seconds,
            seconds_per_frame=seconds / len(frames), body_share=[min(body), max(body)],
            uncover_samples=len(names), card=smi)
        check(len(names) == EVAL_SAMPLES and not missing,
              f"get_mask: {len(missing)} of {len(names)} uncover samples have no mask where the eval driver looks")


def tools_phase(torch, np, dev, smi):
    """Phase 13: latency_mode and profile_mfu on the card."""
    from inbed_pose_estimation_tpu_torch.tools import latency_mode, profile_mfu

    rows = latency_mode.main(LATENCY_ARGS)
    log("latency_mode", args=LATENCY_ARGS, rows=rows, card=smi)
    check(all(np.isfinite(v) and v > 0 for k, v in rows.items() if k != "derived"), "latency_mode: rows")
    torch.cuda.empty_cache()
    for args in (MFU_ARGS, MFU_TRAIN_ARGS):
        got = profile_mfu.main(args)
        log("profile_mfu", args=args, rows=got, card=smi)
        check(all(r[k] is not None and 0 < r[k] < 1 for r in got for k in ("mfu", "mfu_counted"))
              and all(r["device"] == torch.cuda.get_device_name(0) for r in got), f"profile_mfu {args}: MFU")
        torch.cuda.empty_cache()


def bf16_phase(torch, np, dev, smi, smpl):
    """Phase 10 on synthetic inputs; returns the skinning launches of one
    bfloat16 eval call per model and of one bfloat16 train step with
    SMPLify."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS
    from inbed_pose_estimation_tpu_torch.ops import skinning as sk
    from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
    from inbed_pose_estimation_tpu_torch.tools import bench_train
    from inbed_pose_estimation_tpu_torch.train import FitsStore, build_parser, init_train_state, make_train_step

    V = smpl.v_template.shape[0]
    jreg = load_j_regressor_h36m(num_vertices=V)
    rng = np.random.default_rng(SEED + 10)
    eval_launches = {}

    def pair(name, device, res=RES):
        """The float32 model of `name` from the seed and a bfloat16 one with
        its weights, with their inference functions."""
        torch.manual_seed(SEED)
        m32, spec = build_model(name, device=device, img_res=res)
        m16, _ = build_model(name, device=device, img_res=res, dtype=torch.bfloat16)
        m16.load_state_dict(m32.state_dict())
        s = smpl if device == dev else synthetic_smpl_model(SEED, device=device)
        return spec, [make_inference_fn(m, spec, s, jreg, num_cas_iters=NUM_CAS_ITERS, final_recon=False,
                                        device=device) for m in (m32, m16)]

    def inputs_for(spec, batch, res):
        if spec.input_mode == "pm_contact":
            return [torch.from_numpy(x).to(dev) for x in bar_inputs(np, spec, batch, res, rng)]
        return [torch.from_numpy(rng.normal(0, 1, (batch, MODALITY_CHANNELS[m], res, res)).astype(np.float32))
                .to(dev) for m in spec.modalities]

    def distance(a, b):
        """bfloat16 output `a` from float32 output `b`: keypoints in mm (mean
        and max over joints), rotmat, betas and cam (max abs)."""
        mm = 1e3 * (a["keypoints_3d_17"] - b["keypoints_3d_17"]).norm(dim=-1)
        d = {k: (a[k] - b[k]).abs().max().item() for k in ("rotmat", "betas", "cam")}
        return dict(d, keypoints_mm_mean=mm.mean().item(), keypoints_mm_max=mm.max().item())

    def finite(out):
        return all(bool(torch.isfinite(out[k]).all()) for k in ("rotmat", "betas", "cam", "vertices",
                                                                 "keypoints_3d_17"))

    def check_bf16_ran(name, dist):
        check(all(dist[k] > v for k, v in BF16_MIN_DISTANCE.items()),
              f"{name}: the bfloat16 predictions are closer to float32's than {BF16_MIN_DISTANCE}: {dist}")

    # cashmrV2 at batch 32: images/s in both dtypes, the distance, the top
    # device kernels of one bfloat16 call.
    spec, (infer32, infer16) = pair(MODEL, dev)
    inputs = inputs_for(spec, BATCH, RES)
    readings = {}
    for dtype, infer in (("float32", infer32), ("bfloat16", infer16)):
        for _ in range(3):
            infer(inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.launches = 0
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            out = infer(inputs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(sk.launches == TIMED_CALLS, f"{MODEL} {dtype} eval: {sk.launches} skinning launches in "
                                          f"{TIMED_CALLS} calls")
        check(finite(out) and all(out[k].dtype == torch.float32 for k in ("rotmat", "betas", "cam", "vertices")),
              f"{MODEL} {dtype} eval: non-finite or non-float32 outputs")
        readings[dtype] = {"images_per_s": BATCH * TIMED_CALLS / seconds, "ms_per_batch": 1e3 * seconds / TIMED_CALLS,
                           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    sk.launches = 0
    out16 = infer16(inputs)
    eval_launches[MODEL] = sk.launches
    dist = distance(out16, infer32(inputs))
    check(eval_launches[MODEL] == 1, f"{MODEL} bfloat16 eval: {eval_launches[MODEL]} skinning launches, expected 1")
    check_bf16_ran(MODEL, dist)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        infer16(inputs)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
    layout_ms = sum(ms for name, ms in by_kernel.items() if "nchwToNhwc" in name or "nhwcToNchw" in name)
    log("bf16_eval", model=MODEL, batch=BATCH, res=RES, num_cas_iters=NUM_CAS_ITERS, calls=TIMED_CALLS,
        readings=readings, speedup=readings["float32"]["ms_per_batch"] / readings["bfloat16"]["ms_per_batch"],
        launches={"skinning": eval_launches[MODEL]}, bf16_vs_f32=dist, kernel_ms=sum(by_kernel.values()),
        layout_transform_ms=layout_ms, top_kernels_ms=[[n[:90], ms] for n, ms in
                                                       sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]],
        card=smi)
    del infer32, infer16, inputs, out16, prof
    gc.collect()
    torch.cuda.empty_cache()

    # bench_gpu.py, as a user runs it.
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.join(root, "bench_gpu.py")], cwd=root, capture_output=True,
                         text=True, timeout=600)
    lines = run.stdout.strip().splitlines()
    check(run.returncode == 0 and lines, f"bench_gpu.py exited {run.returncode}: {run.stderr[-2000:]}")
    line = json.loads(lines[-1])
    log("bench_gpu", line=line, seconds=time.perf_counter() - t0, card=smi)
    check(set(line) == {"metric", "value", "unit", "vs_baseline"} and line["value"] > 0,
          f"bench_gpu.py printed {line}")

    # One bfloat16 batch of each family's flagship.
    for name, expected in BF16_EVAL_LAUNCHES.items():
        spec, (infer32, infer16) = pair(name, dev)
        inputs = inputs_for(spec, BATCH, RES)
        sk.launches = 0
        out16 = infer16(inputs)
        torch.cuda.synchronize()
        eval_launches[name] = sk.launches
        out32 = infer32(inputs)
        dist = distance(out16, out32)
        log("bf16_family_eval", model=name, batch=BATCH, res=RES, launches={"skinning": eval_launches[name]},
            expected=expected, bf16_vs_f32=dist,
            recon_dtypes={k: str(v.dtype) for k, v in out16["recon"].items()}, card=smi)
        check(eval_launches[name] == expected, f"{name} bfloat16 eval: {eval_launches[name]} skinning launches, "
                                               f"expected {expected}")
        check(finite(out16), f"{name} bfloat16 eval: non-finite outputs")
        check_bf16_ran(name, dist)
        del infer32, infer16, inputs, out16, out32
        torch.cuda.empty_cache()

    # The bfloat16 forward on the card against the CPU at RES 64, batch 2.
    spec, (cpu32, cpu16) = pair(MODEL, "cpu", 64)
    _, (card32, card16) = pair(MODEL, dev, 64)
    small = [x.cpu().numpy() for x in inputs_for(spec, 2, 64)]
    want, cpu_bf16, card, card_f32 = cpu32(small), cpu16(small), card16(small), card32(small)
    ratios = {}
    for k, floor in BF16_FLOORS.items():
        d_card = (card[k].cpu() - want[k]).abs().max().item()
        d_cpu = (cpu_bf16[k] - want[k]).abs().max().item()
        ratios[k] = {"card_bf16_vs_cpu_f32": d_card, "cpu_bf16_vs_cpu_f32": d_cpu,
                     "limit": BF16_RATIO * d_cpu + floor,
                     "card_bf16_vs_cpu_bf16": (card[k].cpu() - cpu_bf16[k]).abs().max().item(),
                     "direct_limit": BF16_CARD_VS_CPU_LIMITS[k],
                     "control_card_f32_vs_cpu_bf16": (card_f32[k].cpu() - cpu_bf16[k]).abs().max().item()}
    log("bf16_card_vs_cpu", model=MODEL, res=64, batch=2, ratio=BF16_RATIO, readings=ratios, card=smi)
    for k, r in ratios.items():
        check(r["card_bf16_vs_cpu_f32"] <= r["limit"], f"bfloat16 card vs CPU: {k} reads "
                                                       f"{r['card_bf16_vs_cpu_f32']:.3g}, limit {r['limit']:.3g}")
        check(r["card_bf16_vs_cpu_bf16"] <= r["direct_limit"],
              f"bfloat16 card vs CPU bfloat16: {k} reads {r['card_bf16_vs_cpu_bf16']:.3g}, "
              f"limit {r['direct_limit']:.3g}")
        check(r["control_card_f32_vs_cpu_bf16"] > r["direct_limit"],
              f"the card's float32 forward passes the bfloat16 limit on {k}: {r}")
    del cpu32, cpu16, card32, card16

    # The train step at batch 64 without SMPLify, each dtype x each remat.
    gc.collect()
    torch.cuda.empty_cache()
    prior = synthetic_gmm_prior(device=dev)
    losses, train = {}, {}

    def stepper(dtype, remat, smplify):
        args = TRAIN_ARGS if smplify else [a for a in TRAIN_ARGS if a != "--run_smplify"]
        options = build_parser().parse_args(args + ["--dtype", dtype] + (["--remat", remat] if remat else []))
        torch.manual_seed(SEED + 1)
        model, spec = build_model(MODEL, device=dev, dtype=getattr(torch, dtype), remat_decoder=remat == "decoder")
        state = init_train_state(model, options, FitsStore("synthetic", FITS_ROWS, device=dev).array, seed=SEED,
                                 device=dev)
        step = make_train_step(model, spec, smpl, prior, options, device=dev)
        host = bench_train.train_batch(spec, options.batch_size, options.img_res, FITS_ROWS, SEED)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        return options, state, step, batch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run(dtype, remat, steps):
        """A warm-up step and `steps` more: the losses, the timed steps'
        reading, and the parameters, BatchNorm's buffers and the generator's
        state after them (on the host)."""
        options, state, step, batch = stepper(dtype, remat, smplify=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = step(state, batch)
        run_losses = [metrics["loss"]]
        start.record()
        for _ in range(steps):
            state, metrics = step(state, batch)
            run_losses.append(metrics["loss"])
        end.record()
        torch.cuda.synchronize()
        reading = {"ms_per_step": start.elapsed_time(end) / steps,
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
        after = {k: t.detach().cpu() for k, t in [*state.model.named_parameters(), *state.model.named_buffers()]}
        after["generator"] = state.generator.get_state()
        run_losses = [v.item() for v in run_losses]
        check(all(np.isfinite(run_losses)), f"train step {dtype}/{remat or 'none'}: a non-finite loss")
        del options, state, step, batch, metrics
        gc.collect()
        torch.cuda.empty_cache()
        return run_losses, reading, after

    def differing(a, b):
        """The names of the tensors that differ between two runs' states."""
        return [k for k in a if not torch.equal(a[k], b[k])]

    for dtype in ("float32", "bfloat16"):
        for remat in REMAT_CASES:
            key = f"{dtype}/{remat or 'none'}"
            losses[key], train[key], _ = run(dtype, remat, BF16_TIMED_STEPS)
    losses["float32/none/control"], train["float32/none/control"], _ = run("float32", False, BF16_TIMED_STEPS)
    torch.backends.cudnn.deterministic = True
    exact = {remat or "none": run("float32", remat, REMAT_EXACT_STEPS) for remat in REMAT_CASES}
    torch.backends.cudnn.deterministic = False
    f32, bf16 = np.array(losses["float32/none"]), np.array(losses["bfloat16/none"])
    bf16_rel = np.abs(bf16 - f32) / np.abs(f32)

    def rel(key, ref):
        return float(np.max(np.abs(np.array(losses[key]) - np.array(losses[ref])) / np.abs(losses[ref])))

    remat_rel = {k: rel(k, k.split("/")[0] + "/none") for k in losses if not k.endswith("/none")}
    deterministic = {"losses": {k: v[0] for k, v in exact.items()},
                     "differing_tensors": {k: differing(exact[k][2], exact["none"][2]) for k in ("stage", "decoder")}}
    log("bf16_remat_train", model=MODEL, batch=build_parser().parse_args(TRAIN_ARGS).batch_size, res=RES,
        smplify=False, timed_steps=BF16_TIMED_STEPS, readings=train, losses=losses,
        bf16_vs_f32_loss_rel=bf16_rel.tolist(), remat_vs_none_loss_rel=remat_rel,
        float32_control_loss_rel=remat_rel["float32/none/control"], float32_deterministic=deterministic, card=smi)
    check(float(bf16_rel.max()) < BF16_LOSS_REL, f"bfloat16 loss off float32's by {bf16_rel.max():.3g}")
    check(all(v[0] == losses[k.split("/")[0] + "/none"][0] for k, v in losses.items()),
          "a remat step's first loss differs from the step's without remat")
    check(losses["bfloat16/stage"] == losses["bfloat16/none"] == losses["bfloat16/decoder"],
          f"a bfloat16 remat step's loss differs from the step's without remat: {remat_rel}")
    exact_equal = (all(v[0] == exact["none"][0] for v in exact.values())
                   and not any(deterministic["differing_tensors"].values()))
    check(exact_equal, f"deterministic float32: a remat run differs from the run without remat: {deterministic}")
    del exact

    # One bfloat16 step with SMPLify (N = 100).
    options, state, step, batch = stepper("bfloat16", False, smplify=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    launches, expected = sk.launches, 6 + 2 * options.num_smplify_iters
    start.record()
    state, metrics = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    log("bf16_train_step", model=MODEL, batch=options.batch_size, res=RES, num_smplify_iters=options.num_smplify_iters,
        launches={"skinning": launches}, expected=expected, ms_per_step=start.elapsed_time(end),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, metrics={k: v.item() for k, v in metrics.items()},
        card=smi)
    check(launches == expected, f"bfloat16 train step: {launches} skinning launches, expected {expected}")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), "bfloat16 train step: a non-finite metric")
    del options, state, step, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # tools/bench_train.py at its defaults.
    t0 = time.perf_counter()
    result = bench_train.main([])
    log("bench_train", result=result, seconds=time.perf_counter() - t0, card=smi)
    check(result["value"] > 0 and np.isfinite(result["loss"]), f"bench_train printed {result}")
    return eval_launches, launches


def dumps_eval_driver(torch, np, dev, smi, base):
    """Phase 11 on phase 6's tree: the eval CLI at its defaults on one split
    without --result_file, with it (the npz and the image dumps), and
    without it again.  Returns the skinning launches of the run with the
    dumps."""
    import cv2

    import eval_gpu

    from inbed_pose_estimation_tpu_torch.ops import skinning as sk

    split, batches = "slp-4mod-uncover", -(-EVAL_SAMPLES // BATCH)
    out = f"{base}/dumps"
    args = EVAL_ARGS + ["--device", dev.type, "--dataset", split]
    plain = eval_gpu.main(args)[split]
    sk.launches = 0
    dumped = eval_gpu.main(args + ["--result_file", out])[split]
    torch.cuda.synchronize()
    launches = sk.launches
    plain_again = eval_gpu.main(args)[split]
    samples = [lo + i for lo in range(0, EVAL_SAMPLES, BATCH) for i in range(min(DUMPS_PER_BATCH, EVAL_SAMPLES - lo))]
    want = sorted(f"{i:06d}_{k}.png" for i in samples for k in DUMP_KINDS)
    got = sorted(os.listdir(f"{out}/{split}"))
    bad = [name for name in got if os.path.getsize(f"{out}/{split}/{name}") == 0
           or getattr(cv2.imread(f"{out}/{split}/{name}", cv2.IMREAD_UNCHANGED), "shape", (0, 0))[:2] != (RES, RES)]
    fits = np.load(f"{out}/smpl_fits/{split}_fits.npz")
    shapes = {k: list(fits[k].shape) for k in fits.files}
    n = EVAL_SAMPLES
    log("dumps_eval_driver", args=args + ["--result_file", out], launches={"skinning": launches}, expected=batches,
        images_per_s={"no_dumps": plain["timing"]["images_per_s"], "dumps": dumped["timing"]["images_per_s"],
                      "no_dumps_again": plain_again["timing"]["images_per_s"]},
        seconds={"no_dumps": plain["timing"]["seconds"], "dumps": dumped["timing"]["seconds"],
                 "no_dumps_again": plain_again["timing"]["seconds"]},
        dump_s=dumped["timing"]["dump_s"], dumped_samples=len(samples),
        s_per_dumped_sample=dumped["timing"]["dump_s"] / len(samples), files=len(got),
        bytes=sum(os.path.getsize(f"{out}/{split}/{name}") for name in got), npz=shapes, card=smi)
    check(launches == batches, f"eval_gpu --result_file: {launches} skinning launches, expected {batches}")
    check(np.isfinite(dumped["mpjpe"]) and dumped["pa_mpjpe"] <= dumped["mpjpe"] and dumped["mask_f1"] is not None,
          "eval_gpu --result_file: metrics")
    check(shapes == {"pred_joints": [n, 17, 3], "pose": [n, 72], "betas": [n, 10], "camera": [n, 3],
                     "rotmat": [n, 24, 3, 3]}, f"results npz schema {shapes}")
    check(all(np.isfinite(fits[k]).all() for k in fits.files), "results npz: non-finite values")
    check(got == want, f"eval_gpu --result_file wrote {len(got)} files, expected {len(want)}: "
                       f"missing {sorted(set(want) - set(got))[:5]}, extra {sorted(set(got) - set(want))[:5]}")
    check(not bad, f"eval_gpu --result_file: empty or unreadable PNGs {bad[:5]}")
    return launches


def dumps_phase(torch, np, dev, smi, smpl, cuda_ms):
    """Phase 11 outside the CLI: `_save_artifacts` from the card's
    predictions against the same predictions on the host (byte-identical
    files), the painter at SMPL's face count, K4 on the card against the
    CPU with its time, and the offline index tool on a raw danaLab tree
    read back through the port's dataset."""
    import functools
    import pathlib
    import tempfile
    import types

    from inbed_pose_estimation_tpu_torch import constants
    from inbed_pose_estimation_tpu_torch.data import BaseDataset
    from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_danalab
    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
    from inbed_pose_estimation_tpu_torch.evaluation.evaluate import _rodrigues, _save_artifacts
    from inbed_pose_estimation_tpu_torch.geometry import weak_perspective_to_cam_t_np
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS
    from inbed_pose_estimation_tpu_torch.ops import vert2map
    from inbed_pose_estimation_tpu_torch.render import PartRenderer, Renderer
    from inbed_pose_estimation_tpu_torch.tools import preprocess_datasets

    # The dumps of one batch from the card's predictions (final_recon on, as
    # --result_file runs it) and from the same predictions on the host.
    torch.manual_seed(SEED)
    model, spec = build_model(MODEL, device=dev)
    V = smpl.v_template.shape[0]
    infer = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(num_vertices=V), num_cas_iters=NUM_CAS_ITERS,
                              final_recon=True, device=dev)
    rng = np.random.default_rng(SEED + 11)
    inputs = tuple(torch.from_numpy(rng.normal(0, 1, (BATCH, MODALITY_CHANNELS[m], RES, RES)).astype(np.float32))
                   .to(dev) for m in spec.modalities)
    preds = infer(inputs)
    masks = PartRenderer(render_res=RES, template=smpl.v_template.cpu().numpy(), faces=smpl.faces.cpu().numpy(),
                         render_labels=False, device=dev)(preds["vertices"], preds["cam"])[0]
    batch = {"img": inputs[spec.modalities.index("img")].cpu().numpy()}
    host = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu()) for k, v in preds.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dumps_") as base:
        t0 = time.perf_counter()
        _save_artifacts(f"{base}/card", "split", 0, batch, preds, smpl, RES, pred_masks=masks)
        card_s = time.perf_counter() - t0
        _save_artifacts(f"{base}/host", "split", 0, batch, host, types.SimpleNamespace(faces=smpl.faces.cpu()), RES,
                        pred_masks=masks.cpu())
        card_dir, host_dir = pathlib.Path(f"{base}/card/split"), pathlib.Path(f"{base}/host/split")
        names = sorted(os.listdir(card_dir))
        same_names = names == sorted(os.listdir(host_dir))
        differ = ([n for n in names if (card_dir / n).read_bytes() != (host_dir / n).read_bytes()]
                  if same_names else names)
    log("dumps_device_check", files=len(names), differing_files=differ, same_names=same_names, seconds=card_s,
        faces=int(smpl.faces.shape[0]), card=smi)
    check(same_names and len(names) == DUMPS_PER_BATCH * len(DUMP_KINDS) and not differ,
          f"_save_artifacts: the card's predictions and the host's wrote different files {differ[:5]}")

    # The painter at SMPL's face count, on the card machine's host.
    faces = (np.arange(PAINTER_FACES)[:, None] + np.arange(3)[None]) % V
    painter = Renderer(focal_length=constants.FOCAL_LENGTH, img_res=RES, faces=faces)
    verts = host["vertices"][:PAINTER_IMAGES].numpy()
    cam_t = weak_perspective_to_cam_t_np(host["cam"][:PAINTER_IMAGES].numpy(), constants.FOCAL_LENGTH, RES)
    rgb = np.clip(np.moveaxis(batch["img"][:PAINTER_IMAGES], 1, -1) * np.asarray(constants.IMG_NORM_STD)
                  + np.asarray(constants.IMG_NORM_MEAN), 0, 1)
    turn = {"side": _rodrigues(np.array([0.0, np.radians(90.0), 0.0])),
            "top": _rodrigues(np.array([-np.radians(90.0), 0.0, 0.0]))}
    painter_s, painted = {}, {}
    for view in ("overlay", "side", "top"):
        t0 = time.perf_counter()
        for i in range(PAINTER_IMAGES):
            if view == "overlay":
                img = painter(verts[i], cam_t[i], rgb[i])
            else:
                c = verts[i].mean(axis=0)
                img = painter((verts[i] - c) @ turn[view] + c, cam_t[i])
        painter_s[view] = (time.perf_counter() - t0) / PAINTER_IMAGES
        painted[view] = float((img != (rgb[-1] if view == "overlay" else 0)).any(-1).mean())
    log("painter", faces=PAINTER_FACES, res=RES, images=PAINTER_IMAGES, s_per_image=painter_s,
        painted_share=painted, card=smi)
    check(all(v > 0 for v in painted.values()), f"the painter drew nothing: {painted}")

    # K4 on the card against the CPU, and its time (CUDA events).
    for b in K4_BATCHES:
        r = np.random.default_rng(SEED + b)
        taxel = np.concatenate([r.uniform(-8, K4_GRID + 8, (b, V, 2)), r.uniform(0, 1.5, (b, V, 1))], -1)
        taxel[:, :300, :2] = r.uniform(-0.999, 0, (b, 300, 2))
        taxel = torch.from_numpy(taxel.astype(np.float32))
        depth, contact = vert2map(taxel, K4_GRID, K4_GRID)
        on_card = taxel.to(dev)
        card_depth, card_contact = (a.cpu() for a in vert2map(on_card, K4_GRID, K4_GRID))
        err = (card_depth - depth).abs().max().item()
        limit = torch.finfo(torch.float32).eps * depth.abs().max().item()
        contact_diff = int((card_contact != contact).sum())
        ms = cuda_ms(lambda: vert2map(on_card, K4_GRID, K4_GRID), 20)
        nbytes = 4 * (b * V * 3 + 2 * b * K4_GRID * K4_GRID)
        log("k4_vert2map", batch=b, vertices=V, grid=K4_GRID, ms=ms, bytes=nbytes,
            bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes", depth_max_abs_err=err, depth_limit=limit,
            contact_differing_cells=contact_diff, contact_share=contact.mean().item(), card=smi)
        check(contact_diff == 0, f"K4 at B={b}: {contact_diff} contact cells differ between the card and the CPU")
        check(err <= limit, f"K4 at B={b}: the card's depth map is {err:.3g} from the CPU's, limit {limit:.3g}")

    # The offline index tool on a raw danaLab tree, read back by the dataset.
    saved_env = {k: os.environ.get(k) for k in ("INBED_DATA_ROOT", "INBED_NPZ_PATH")}
    saved_tool = {k: getattr(preprocess_datasets, k) for k in ("TEST_SUBJECTS", "TRAIN_SUBJECTS", "slp_multi_mod")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_preprocess_") as base:
        try:
            os.environ["INBED_DATA_ROOT"], os.environ["INBED_NPZ_PATH"] = f"{base}/data", f"{base}/extras"
            preprocess_datasets.TEST_SUBJECTS = preprocess_datasets.TRAIN_SUBJECTS = PREPROCESS_SUBJECTS
            preprocess_datasets.slp_multi_mod = functools.partial(saved_tool["slp_multi_mod"],
                                                                  imgs_per_cover=PREPROCESS_IMGS)
            write_synthetic_danalab(f"{base}/data", num_imgs=2)
            t0 = time.perf_counter()
            written = preprocess_datasets.main(PREPROCESS_ARGS)
            tool_s = time.perf_counter() - t0
            schema = {}
            for path in written:
                with np.load(path) as index:
                    schema[os.path.basename(path)] = {k: list(index[k].shape) for k in index.files}
            item = BaseDataset(types.SimpleNamespace(img_res=RES, device_preprocess=False), "slp-4mod-uncover",
                               is_train=False)[0]
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            for k, v in saved_tool.items():
                setattr(preprocess_datasets, k, v)
    log("preprocess_tool", args=PREPROCESS_ARGS, subjects=PREPROCESS_SUBJECTS, imgs_per_cover=PREPROCESS_IMGS,
        seconds=tool_s, files=schema, item={k: list(v.shape) for k, v in item.items() if hasattr(v, "shape")},
        card=smi)
    check(len(schema) == 4 and all(sorted(f) == SLP_INDEX_KEYS for f in schema.values()),
          f"the index tool's npz schema {schema}")
    rows = {name: f["imgname"][0] for name, f in schema.items()}
    check(rows == {"slp_4mod_uncover.npz": 2, "slp_4mod_cover1.npz": 2, "slp_4mod_cover2.npz": 2,
                   "slp_4mod_train.npz": 6}, f"the index tool's rows {rows}")
    check(item["img"].shape == (3, RES, RES) and item["pose_3d"].shape == (24, 4)
          and all(np.isfinite(item[k]).all() for k in ("img", "ir_img", "depth_img", "pm_img")),
          "the dataset's item from the tool's index")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    import numpy as np

    from inbed_pose_estimation_tpu_torch.device import resolve_device
    from inbed_pose_estimation_tpu_torch.evaluation import (
        eval_metrics, load_j_regressor_h36m, make_forward_fn, make_inference_fn, regress_j17,
    )
    from inbed_pose_estimation_tpu_torch.geometry import batch_rodrigues
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS
    from inbed_pose_estimation_tpu_torch.ops import batch_norm_act as bna
    from inbed_pose_estimation_tpu_torch.ops import build
    from inbed_pose_estimation_tpu_torch.ops import shuffle_project as sp
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

    # Device time of one wrapper call (one kernel launch), of the plain
    # version and of the one PyTorch call that computes the same function
    # (torch.einsum over the packed affines [A_rot | A_t] and homogeneous
    # vertices, packed beforehand), each back to back with its inputs in L2,
    # as on the main path where v_posed was just written; then the same
    # calls issued eagerly from Python, one event pair over 200; then the
    # kernel's time for each batch chunk, beside the chunk the wrapper picks.
    def library_args(args):
        verts, weights, rot, t = args
        affine = torch.cat([rot, t[..., None]], dim=-1)  # [b, 24, 3, 4]
        return weights, affine, torch.cat([verts, torch.ones_like(verts[..., :1])], dim=-1)

    def library(weights, affine, homo):
        return torch.einsum("vj,bjrc,bvc->bvr", weights, affine, homo)

    library_err = {}
    timing = {}
    for b, args in ((BATCH, main_args), (64, b64_args)):
        nbytes, flops, bound_ms, bound_by = bound(b)
        lib = library_args(args)
        library_err[b] = (library(*lib) - sk.skinning_reference(*args)).abs().max().item()
        check(library_err[b] <= 1e-5, f"the einsum skinning disagrees with skinning_reference at B={b}")
        timing[b] = {
            "ms": graph_ms(lambda: sk.skinning_forward(*args)),
            "plain_ms": graph_ms(lambda: sk.skinning_reference(*args)),
            "library_ms": graph_ms(lambda: library(*lib)),
            "eager_ms": cuda_ms(lambda: sk.skinning_forward(*args), 200),
            "plain_eager_ms": cuda_ms(lambda: sk.skinning_reference(*args), 200),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        by_chunk = {c: graph_ms(lambda: sk._launch(*args, chunk=c)) for c in (1, 2, 4)}
        log("skinning_time", batch=b, vertices=V, **timing[b], library_max_abs_err=library_err[b], bytes=nbytes,
            flops=flops,
            share_of_bound=bound_ms / timing[b]["ms"], single_node_floor_ms=floor_ms,
            chunk=sk.batch_chunk(b, V), ms_by_chunk=by_chunk, card=smi)

    # The decoders' shuffled one-channel projection at its two shapes:
    # Reconstruct's last stage in cashmrV2 and featatt_cashmr (a 512-channel
    # pre-shuffle map at 112^2, a BatchNorm with a shift of a few units, no
    # bias) and a fusion dec*3 (256 channels, no BatchNorm, a bias).  The
    # kernel against its plain version, then its device time, the plain
    # version's and the modules' (PixelShuffle, the eval BatchNorm, the cuDNN
    # convolution) as K1's are timed, in graphs of 10 calls for the two whose
    # every call writes the whole shuffled map.
    def projection_bound(c):
        nbytes = 4 * (BATCH * 4 * c * (RES // 2) ** 2 + BATCH * RES ** 2 + 9 * c + 4 * c + 1)
        flops = 2 * 9 * c * BATCH * RES ** 2
        bytes_ms, flops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S
        return nbytes, flops, max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"

    resolve_device(dev)  # TF32 off: the plain version and the modules convolve in float32, as the port does
    projection = {}
    for c, with_norm in ((128, True), (64, False)):
        t0 = time.perf_counter()
        pre = torch.randn(BATCH, 4 * c, RES // 2, RES // 2, generator=gen, device=dev)
        tail = torch.nn.Sequential(torch.nn.PixelShuffle(2), torch.nn.BatchNorm2d(c) if with_norm else
                                   torch.nn.Identity(), torch.nn.Conv2d(c, 1, 3, padding=1, bias=not with_norm))
        tail.to(dev).eval().requires_grad_(False)
        with torch.no_grad():
            if with_norm:
                bn = tail[1]
                for t, draw in ((bn.running_mean, torch.randn(c)), (bn.running_var, torch.rand(c) + 0.5),
                                (bn.weight, torch.rand(c) + 0.5), (bn.bias, 4 * torch.randn(c))):
                    t.copy_(draw)
        args = [tail[2].weight, sp.batch_norm_terms(tail[1]) if with_norm else None, tail[2].bias]
        want = sp.shuffle_project_reference(pre, *args)
        err = ((sp.shuffle_project(pre, *args) - want).abs().max() / want.abs().max()).item()
        check_s = time.perf_counter() - t0
        log("shuffle_project", channels=c, batch_norm=with_norm, bias=not with_norm, max_err_over_max_abs=err,
            tolerance=1e-5, seconds=check_s)
        check(err <= 1e-5, f"shuffled projection kernel disagrees with shuffle_project_reference at C={c}")
        del want
        t0 = time.perf_counter()
        nbytes, flops, bound_ms, bound_by = projection_bound(c)
        projection[c] = {
            "ms": graph_ms(lambda: sp.shuffle_project(pre, *args)),
            "plain_ms": graph_ms(lambda: sp.shuffle_project_reference(pre, *args), reps=10),
            "library_ms": graph_ms(lambda: tail(pre), reps=10),
            "eager_ms": cuda_ms(lambda: sp.shuffle_project(pre, *args), 50),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_err_over_max_abs": err,
        }
        log("shuffle_project_time", channels=c, batch=BATCH, pre_shuffle=list(pre.shape), **projection[c],
            bytes=nbytes, flops=flops, share_of_bound=bound_ms / projection[c]["ms"],
            seconds=time.perf_counter() - t0, card=smi)
        del pre, args, tail
    torch.cuda.empty_cache()

    # The trunk's eval tail (ops/batch_norm_act.py) in each form at B=32 on
    # the shapes of one 224^2 trunk pass, against its plain version bit for
    # bit, with BatchNorms off their init values and NaN, infinities and
    # signed zeros in the inputs; 7^2 takes the kernel's scalar path.  Not
    # timed: bound_ms is the bytes of one trunk pass's 49 launches at the
    # card's bandwidth.
    tails = {}
    for c, side in TRUNK_TAIL_SHAPES:
        norms = [torch.nn.BatchNorm2d(c).to(dev).eval().requires_grad_(False) for _ in range(2)]
        with torch.no_grad():
            for bn in norms:
                for t, draw in ((bn.running_mean, torch.randn(c)), (bn.running_var, 2 * torch.rand(c) + 0.1),
                                (bn.weight, torch.rand(c) + 0.5), (bn.bias, torch.randn(c))):
                    t.copy_(draw)
        x, r = (2 * torch.randn(BATCH, c, side, side, generator=gen, device=dev) for _ in range(2))
        for t in (x, r):
            t.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0])
        bna.launches = dict.fromkeys(bna.FORMS, 0)
        for form, args in zip(bna.FORMS, ((x, norms[0]), (x, norms[0], r), (x, norms[0], r, norms[1]))):
            got, want = bna.batch_norm_act(*args), bna.batch_norm_act_reference(*args)
            tails[f"{form}_c{c}_{side}"] = torch.equal(got.view(torch.int32), want.view(torch.int32))
        torch.cuda.synchronize()
        check(bna.launches == dict.fromkeys(bna.FORMS, 1),
              f"batch_norm_act launched {bna.launches} at C={c}, {side}^2, expected one of each form")
        del x, r, got, want
    log("batch_norm_act", batch=BATCH, bit_equal=tails)
    check(all(tails.values()), f"batch_norm_act kernel differs from batch_norm_act_reference: {tails}")
    tail_bytes = 4 * BATCH * sum(n * c * side * side for c, side, n in TRUNK_PASS_TAILS)
    tail_bound_ms = 1e3 * tail_bytes / HBM_BYTES_PER_S

    # 4. main path
    torch.manual_seed(SEED)  # module initializers draw from torch's default generator
    model, spec = build_model(MODEL, device=dev)
    jreg = load_j_regressor_h36m(num_vertices=V)
    infer = make_inference_fn(model, spec, smpl, jreg, num_cas_iters=NUM_CAS_ITERS, final_recon=False, device=dev)
    rng = np.random.default_rng(SEED)
    inputs = tuple(torch.from_numpy(rng.normal(0, 1, (BATCH, MODALITY_CHANNELS[m], RES, RES)).astype(np.float32)).to(dev)
                   for m in spec.modalities)

    sk.launches = sp.launches = 0
    bna.launches = dict.fromkeys(bna.FORMS, 0)
    out = infer(inputs)
    torch.cuda.synchronize()
    counts = {"skinning": sk.launches, "shuffle_project": sp.launches, "batch_norm_act": dict(bna.launches)}
    log("main_path", model=MODEL, batch=BATCH, res=RES, num_cas_iters=NUM_CAS_ITERS, launches=counts)
    check(counts["skinning"] == 1, f"skinning kernel launched {counts['skinning']} times in one call, expected 1")
    check(counts["shuffle_project"] == 1,
          f"shuffled projection kernel launched {counts['shuffle_project']} times in one call, expected 1")
    expected_tails = {k: n * NUM_CAS_ITERS for k, n in TRUNK_TAILS.items()}
    check(counts["batch_norm_act"] == expected_tails,
          f"trunk tail kernel launched {counts['batch_norm_act']} times in one call, expected {expected_tails}")

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

    seconds = {"phases_1_4": time.perf_counter() - t_start}

    def lap(name):
        seconds[name] = time.perf_counter() - t_start - sum(seconds.values())

    # 5. train step
    launches_train_step = train_phase(torch, np, dev, smi, smpl, cuda_ms)
    lap("phase_5")

    # 6. eval driver (with phase 8's, 9's, 11's and 12's eval CLI runs and
    # phase 14's body-mask tool on its tree)
    (launches_eval_driver, eval_driver_batches, launches_families_eval_driver, launches_bar_eval_driver,
     launches_dumps_eval_driver, (launches_dp_eval_one_rank, launches_dp_eval_per_rank)) = eval_driver_phase(
        torch, np, dev, smi, cuda_ms)
    lap("phase_6")

    # 7. train driver (with phase 8's, 9's, 10's and 12's train CLI runs and
    # phase 13's loader_bench on its tree)
    (launches_train_driver_step, launches_train_driver, train_driver_steps, launches_families_train_driver,
     launches_bar_train_driver, launches_bf16_train_driver, launches_dp_train_driver_step) = train_driver_phase(
        torch, np, dev, smi)
    lap("phase_7")

    # 8. families
    launches_families_eval, launches_families_train_step = families_phase(torch, np, dev, smi, smpl, cuda_ms)
    lap("phase_8")

    # 9. Bodies-At-Rest
    launches_bar_eval, launches_bar_train_step = bar_phase(torch, np, dev, smi, smpl)
    lap("phase_9")

    # 10. bfloat16 and rematerialization
    launches_bf16_eval, launches_bf16_train_step = bf16_phase(torch, np, dev, smi, smpl)
    lap("phase_10")

    # 11. result dumps and host tools (with the eval CLI run inside phase 6)
    dumps_phase(torch, np, dev, smi, smpl, cuda_ms)
    lap("phase_11")

    # 12. data parallel (with the CLI runs inside phases 6 and 7)
    torch.cuda.empty_cache()
    launches_dp_train_step_per_rank, launches_dp_eval_per_rank_step = dp_step_phase(torch, np, dev, smi)
    lap("phase_12")

    # 13. the tools (with loader_bench inside phase 7)
    tools_phase(torch, np, dev, smi)
    lap("phase_13")
    log("phase_seconds", seconds=seconds, total=time.perf_counter() - t_start, card=smi)

    kernels = [{
        "name": "skinning", "route": "cuda",
        "source": "inbed_pose_estimation_tpu_torch/ops/csrc/skinning.cu",
        "replaces": "inbed_pose_estimation_tpu/ops/pallas_lbs.py:31",
        "launches": counts["skinning"], "max_abs_err": err_main,
        "ms": timing[BATCH]["ms"], "plain_ms": timing[BATCH]["plain_ms"], "bound_ms": timing[BATCH]["bound_ms"],
        "bound_by": timing[BATCH]["bound_by"], "library_ms": timing[BATCH]["library_ms"],
        "library_ms_b64": timing[64]["library_ms"], "library_max_abs_err": library_err,
        "eager_ms": timing[BATCH]["eager_ms"], "single_node_floor_ms": floor_ms,
        "ms_b64": timing[64]["ms"], "plain_ms_b64": timing[64]["plain_ms"], "bound_ms_b64": timing[64]["bound_ms"],
        "bound_by_b64": timing[64]["bound_by"], "eager_ms_b64": timing[64]["eager_ms"],
        "launches_train_step": launches_train_step,
        "launches_eval_driver": launches_eval_driver, "eval_driver_batches": eval_driver_batches,
        "launches_train_driver_step": launches_train_driver_step, "launches_train_driver": launches_train_driver,
        "train_driver_steps": train_driver_steps,
        "launches_families_eval": launches_families_eval,
        "launches_families_train_step": launches_families_train_step,
        "launches_families_eval_driver": launches_families_eval_driver,
        "launches_families_train_driver_step": launches_families_train_driver,
        "launches_bar_eval": launches_bar_eval, "launches_bar_train_step": launches_bar_train_step,
        "launches_bar_eval_driver": launches_bar_eval_driver, "launches_bar_train_driver": launches_bar_train_driver,
        "launches_bf16_eval": launches_bf16_eval, "launches_bf16_train_step": launches_bf16_train_step,
        "launches_bf16_train_driver_step": launches_bf16_train_driver,
        "launches_dumps_eval_driver": launches_dumps_eval_driver,
        "launches_dp_train_step_per_rank": launches_dp_train_step_per_rank,
        "launches_dp_eval_per_rank": launches_dp_eval_per_rank,
        "launches_dp_eval_per_rank_step_batch": launches_dp_eval_per_rank_step,
        "launches_dp_train_driver_step": launches_dp_train_driver_step,
        "launches_dp_eval_driver_one_rank": launches_dp_eval_one_rank,
    }, {
        "name": "shuffle_project", "route": "cuda",
        "source": "inbed_pose_estimation_tpu_torch/ops/csrc/shuffle_project.cu",
        "replaces": "none (the JAX package's jnp SmallOCConv3x3, inbed_pose_estimation_tpu/models/decoder.py:33)",
        "launches": counts["shuffle_project"], "max_err_over_max_abs": projection[128]["max_err_over_max_abs"],
        "ms": projection[128]["ms"], "plain_ms": projection[128]["plain_ms"],
        "bound_ms": projection[128]["bound_ms"], "bound_by": projection[128]["bound_by"],
        "library_ms": projection[128]["library_ms"], "eager_ms": projection[128]["eager_ms"],
        "max_err_over_max_abs_c64": projection[64]["max_err_over_max_abs"],
        "ms_c64": projection[64]["ms"], "plain_ms_c64": projection[64]["plain_ms"],
        "bound_ms_c64": projection[64]["bound_ms"], "bound_by_c64": projection[64]["bound_by"],
        "library_ms_c64": projection[64]["library_ms"], "eager_ms_c64": projection[64]["eager_ms"],
        **{f"launches_{k}": v for k, v in projection_launches.items()},
    }, {
        "name": "batch_norm_act", "route": "cuda",
        "source": "inbed_pose_estimation_tpu_torch/ops/csrc/batch_norm_act.cu",
        "replaces": "none (the JAX package's flax BatchNorm, add and relu in inbed_pose_estimation_tpu/models/backbone.py)",
        "launches": counts["batch_norm_act"], "bit_equal": all(tails.values()), "shapes_checked": len(tails),
        "bound_ms_trunk_pass": tail_bound_ms, "bound_by": "bytes", "bytes_trunk_pass": tail_bytes,
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
