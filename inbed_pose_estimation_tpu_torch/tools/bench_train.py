"""Training-step throughput of the PyTorch port (see bench_gpu.py for the
headline inference metric).

Times the full cashmrV2 training step through `make_train_step`: fits
gather, SMPL LBS, camera least squares, the cascade's forward and backward,
optionally SMPLify in the loop, and Adam, on a seeded synthetic batch at
the JAX package's tool's flags and defaults (224x224, batch 32, 2-pass
cascade, bfloat16 compute).  One warm-up step, then `--iters` steps timed
with CUDA events (the wall clock on the CPU).

    python -m inbed_pose_estimation_tpu_torch.tools.bench_train [--batch 32] [--res 224]
        [--num_cas_iters 2] [--run_smplify] [--num_smplify_iters 100] [--remat [{stage,decoder}]]
        [--iters 10] [--dtype {float32,bfloat16}] [--device cuda]

Prints one JSON line: images/s ("value"), ms a step, peak GiB allocated on
the card (null on the CPU), the first step's seconds and the last loss.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--num_cas_iters", type=int, default=2)
    ap.add_argument("--run_smplify", action="store_true")
    ap.add_argument("--num_smplify_iters", type=int, default=100)
    ap.add_argument("--remat", nargs="?", const="stage", default=False, choices=["stage", "decoder"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def synthetic_batch(batch: int, res: int, seed: int = 0) -> dict:
    """The seeded NCHW batch of the JAX package's tool (every sample with
    ground-truth SMPL and 3D joints)."""
    r = np.random.default_rng(seed)
    B = batch
    out = {k: r.normal(0, 1, (B, 3 if k == "img" else 1, res, res))
           for k in ("img", "ir_img", "depth_img", "pm_img", "depth_img_uncover")}
    out.update({
        "keypoints": np.concatenate([r.uniform(-1, 1, (B, 49, 2)), np.ones((B, 49, 1))], -1),
        "pose": r.normal(0, 0.2, (B, 72)),
        "betas": r.normal(0, 0.5, (B, 10)),
        "pose_3d": np.concatenate([r.normal(0, 0.3, (B, 24, 3)), np.ones((B, 24, 1))], -1),
        "has_smpl": np.ones(B),
        "has_pose_3d": np.ones(B),
        "is_flipped": np.zeros(B),
        "rot_angle": np.zeros(B),
        "sample_index": np.arange(B),
    })
    return {k: np.asarray(v, np.int64 if k == "sample_index" else np.float32) for k, v in out.items()}


def train_batch(spec, batch_size: int, res: int, rows: int, seed: int) -> dict:
    """A synthetic batch with the keys one train step of `spec` reads (NCHW
    images; a fusion or Bodies-At-Rest model's ground-truth body mask in
    {0, 1}, Bodies-At-Rest's contact channels in [0, 1])."""
    from ..models.factory import MODALITY_CHANNELS
    from ..train import step_feed_keys

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
    keys = step_feed_keys(spec) - {"pixel_noise"}
    for k in sorted(keys - set(batch)):
        if k == "pm_contact":  # Bodies-At-Rest's contact and edge channels, in [0, 1]
            batch[k] = r.uniform(0, 1, (B, 2, res, res))
            continue
        image = r.normal(0, 1, (B, 1, res, res))
        batch[k] = image > 0 if k == "mask_uncover" else image
    return {k: np.asarray(v, np.int64 if k == "sample_index" else np.float32) for k, v in batch.items() if k in keys}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..fitting import synthetic_gmm_prior
    from ..models import build_model
    from ..smpl import synthetic_smpl_model
    from ..train import build_parser as train_parser
    from ..train import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    options = train_parser().parse_args(
        ["--name", "bench_train", "--img_res", str(args.res), "--batch_size", str(args.batch),
         "--num_cas_iters", str(args.num_cas_iters), "--num_smplify_iters", str(args.num_smplify_iters),
         "--dtype", args.dtype] + (["--run_smplify"] if args.run_smplify else [])
        + (["--remat", args.remat] if args.remat else []))
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device=dev, dtype=getattr(torch, args.dtype),
                              remat_decoder=args.remat == "decoder")
    smpl = synthetic_smpl_model(0, device=dev)
    state = init_train_state(model, options, np.zeros((max(args.batch, 64), 82), np.float32), seed=1, device=dev)
    step = make_train_step(model, spec, smpl, synthetic_gmm_prior(device=dev), options, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(args.batch, args.res).items()}

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    float(metrics["loss"])  # waits for the step
    first_s = time.perf_counter() - t0

    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, metrics = step(state, batch)
    if cuda:
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.iters if cuda else 1e3 * (time.perf_counter() - t0) / args.iters
    result = {
        "metric": f"train images/sec/chip (cashmrV2 {args.res}^2 batch {args.batch} cas{args.num_cas_iters}"
                  + (f" +smplify{args.num_smplify_iters}" if args.run_smplify else "")
                  + (f" +remat:{args.remat}" if args.remat else "") + f" {args.dtype}, {dev.type})",
        "value": args.batch * 1e3 / step_ms,
        "unit": "images/sec/chip",
        "step_ms": step_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
        "first_step_s": first_s,
        "loss": float(metrics["loss"]),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
