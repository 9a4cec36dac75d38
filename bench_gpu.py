#!/usr/bin/env python3
"""Benchmark of the PyTorch port: batch-32 4-modality cashmrV2 inference
images/s on one CUDA card, in bfloat16.

The counterpart of bench.py: the full eval-path compute of one batch
through `make_inference_fn` (the 2-pass cascade with depth feedback, the
last pass without its decoder, SMPL LBS through the skinning kernel and the
17-joint regression), cashmrV2 built in bfloat16 (float32 parameters,
geometry in float32) with seeded weights and the synthetic SMPL model, at
224x224.  Three warm-up calls, then two passes of back-to-back calls, each
closed by one synchronize; the faster pass is the value, as in bench.py.

vs_baseline divides by configs/baseline_torch_cpu.json's images_per_sec,
the PyTorch-on-CPU time of the same compute graph that bench.py compares
with; the file must exist.

    python3 bench_gpu.py

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

BATCH, RES, NUM_CAS_ITERS, ITERS = 32, 224, 2, 20
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "baseline_torch_cpu.json")


def get_baseline() -> float:
    """images/s of the PyTorch CPU baseline; raises when the file is missing."""
    path = BASELINE_FILE
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: the baseline that vs_baseline divides by is missing")
    with open(path) as f:
        return float(json.load(f)["images_per_sec"])


def measure(batch: int = BATCH, res: int = RES, device: str = "cuda", iters: int = ITERS) -> float:
    """images/s of `make_inference_fn` for bfloat16 cashmrV2 at `batch`,
    `res`x`res` on `device`."""
    import torch

    from inbed_pose_estimation_tpu_torch.device import resolve_device
    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.models.factory import MODALITY_CHANNELS
    from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model

    dev = resolve_device(device)
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device=dev, dtype=torch.bfloat16)
    smpl = synthetic_smpl_model(0, device=dev)
    infer = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(num_vertices=smpl.v_template.shape[0]),
                              num_cas_iters=NUM_CAS_ITERS, final_recon=False, device=dev)
    rng = np.random.default_rng(0)
    inputs = tuple(torch.from_numpy(rng.normal(0, 1, (batch, MODALITY_CHANNELS[m], res, res)).astype(np.float32))
                   .to(dev) for m in spec.modalities)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed_pass():
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = infer(inputs)
        sync()
        seconds = time.perf_counter() - t0
        if not bool(torch.isfinite(out["keypoints_3d_17"]).all()):
            raise RuntimeError("non-finite keypoints_3d_17")
        return batch * iters / seconds

    for _ in range(3):
        infer(inputs)
    return max(timed_pass() for _ in range(2))


def headline(images_per_sec: float, baseline: float, batch: int = BATCH, res: int = RES) -> dict:
    """The JSON line for `images_per_sec` measured at `batch`, `res`x`res`."""
    return {
        "metric": f"images/sec/chip batch-{batch} 4-mod cashmrV2 inference (cascade+LBS, bfloat16, "
                  f"{res}^2, PyTorch port)",
        "value": images_per_sec,
        "unit": "images/sec/chip",
        "vs_baseline": images_per_sec / baseline,
    }


def main() -> dict:
    baseline = get_baseline()  # raises before measuring when the file is missing
    line = headline(measure(), baseline)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
