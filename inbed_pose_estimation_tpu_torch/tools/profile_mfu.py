"""Model FLOP utilization of cashmrV2 on the card: a batch sweep of bfloat16
inference, or of the full train step (`--train`).

The port of the JAX package's `tools/profile_mfu.py`, with its flags and
its output keys.  The FLOPs are the JAX tool's closed form
(`analytic_inference_flops`; 3x that for a train step), and torch's
`FlopCounterMode` counts the convolutions and matrix products of one call
beside it (`gflops_counted`).  The time is CUDA events around `--iters`
calls after a warm-up (the host clock on the CPU).  MFU is the achieved
FLOP/s over the card's dense peak for the compute dtype, from
`PEAK_FLOPS`: `mfu` from the closed form, as the JAX tool reports it
(whose 4.1 GFLOP an image is ResNet-50's count of multiply-adds, so it
understates), and `mfu_counted` from `gflops_counted`, two FLOPs a
multiply-add.  Both are null on the CPU and on a card the table does not
name.  `--trace_dir` writes a torch.profiler trace of 3 inference calls.

    python -m inbed_pose_estimation_tpu_torch.tools.profile_mfu [--train] [--batches 32,64,128,256]
        [--res 224] [--iters 20] [--num_cas_iters 2] [--run_smplify] [--remat [{stage,decoder}]]
        [--dtype {float32,bfloat16}] [--trace_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# Dense peak FLOP/s by torch.cuda.get_device_name() and compute dtype, from
# NVIDIA's H100 data sheet (without sparsity; float32 outside the tensor
# cores, as the port runs it with TF32 off), at the card's full power limit.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12},  # SXM5
    "NVIDIA H100 PCIe": {"bfloat16": 756e12, "float32": 51e12},
    "NVIDIA H100 NVL": {"bfloat16": 835e12, "float32": 60e12},
}


def peak_flops(device_name: str, dtype: str):
    """The card's dense peak for `dtype`, or None when the table lacks it."""
    return PEAK_FLOPS.get(device_name, {}).get(dtype)


def analytic_inference_flops(batch: int, res: int, num_cas: int) -> float:
    """The JAX tool's closed form: ResNet-50's forward ~4.1 GFLOP per 224^2
    image and the decoder ~3.4 GFLOP, scaled with res^2, for each cascade
    pass (LBS is negligible)."""
    scale = (res / 224.0) ** 2
    per_image = (4.1e9 + 3.4e9) * scale
    return batch * per_image * num_cas


def _timer(torch, dev):
    """fn, iters -> ms per call: CUDA events on a card, the host clock on
    the CPU."""
    def run(fn, iters):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters

    return run


def _row(what, batch, res, ms, flops, counted, dev, dtype, torch) -> dict:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = peak_flops(name, dtype)
    return {"what": what, "batch": batch, "res": res, "step_ms": ms, "images_per_sec": batch * 1e3 / ms,
            "gflops_per_step": flops / 1e9, "flops_source": "analytic", "gflops_counted": counted / 1e9,
            "achieved_tflops": flops / ms / 1e9, "mfu": None if peak is None else flops / (ms / 1e3) / peak,
            "mfu_counted": None if peak is None else counted / (ms / 1e3) / peak, "device": name}


def profile_inference(batch: int, res: int = 224, num_cas: int = 2, iters: int = 20, device: str = "cuda") -> dict:
    """bfloat16 cashmrV2 inference (cascade, SMPL, J17) at `batch`."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..device import resolve_device
    from ..evaluation import load_j_regressor_h36m, make_inference_fn
    from ..models import build_model
    from ..models.factory import MODALITY_CHANNELS
    from ..smpl import synthetic_smpl_model

    dev = resolve_device(device)
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device=dev, dtype=torch.bfloat16)
    smpl = synthetic_smpl_model(0, device=dev)
    fn = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(num_vertices=smpl.v_template.shape[0]),
                           num_cas_iters=num_cas, final_recon=False, device=dev)
    rng = np.random.default_rng(0)
    inputs = tuple(torch.from_numpy(rng.normal(0, 1, (batch, MODALITY_CHANNELS[m], res, res)).astype(np.float32))
                   .to(dev) for m in spec.modalities)
    with FlopCounterMode(display=False) as counter:
        out = fn(inputs)
    if not bool(torch.isfinite(out["cam"]).all()):
        raise RuntimeError("non-finite camera from the inference call")
    ms = _timer(torch, dev)(lambda: fn(inputs), iters)
    return _row("cashmrV2 inference", batch, res, ms, analytic_inference_flops(batch, res, num_cas),
                counter.get_total_flops(), dev, "bfloat16", torch)


def profile_train(batch: int, res: int = 224, num_cas: int = 2, iters: int = 10, run_smplify: bool = False,
                  remat=False, dtype: str = "bfloat16", device: str = "cuda") -> dict:
    """The full train step of cashmrV2 (cascade forward and backward, SMPL,
    camera least squares, losses, Adam, the fits scatter) at `batch`."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..device import resolve_device
    from ..fitting import synthetic_gmm_prior
    from ..models import build_model
    from ..smpl import synthetic_smpl_model
    from ..train import build_parser, init_train_state, make_train_step
    from .bench_train import synthetic_batch

    dev = resolve_device(device)
    options = build_parser().parse_args(
        ["--name", "profile_mfu", "--img_res", str(res), "--batch_size", str(batch), "--num_cas_iters", str(num_cas),
         "--dtype", dtype] + (["--run_smplify"] if run_smplify else []) + (["--remat", remat] if remat else []))
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device=dev, dtype=getattr(torch, dtype), remat_decoder=remat == "decoder")
    smpl = synthetic_smpl_model(0, device=dev)
    state = init_train_state(model, options, np.zeros((max(batch, 64), 82), np.float32), seed=1, device=dev)
    step = make_train_step(model, spec, smpl, synthetic_gmm_prior(device=dev), options, device=dev)
    data = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(batch, res).items()}
    with FlopCounterMode(display=False) as counter:
        state, metrics = step(state, data)
    if not np.isfinite(float(metrics["loss"])):
        raise RuntimeError(f"non-finite loss {float(metrics['loss'])} from the train step")

    def one():
        step(state, data)

    ms = _timer(torch, dev)(one, iters)
    what = ("cashmrV2 train step" + (" +smplify" if run_smplify else "")
            + (f" +remat:{remat}" if remat else "") + f" {dtype}")
    # The backward pass costs about twice the forward.
    return _row(what, batch, res, ms, 3.0 * analytic_inference_flops(batch, res, num_cas),
                counter.get_total_flops(), dev, dtype, torch)


def capture_trace(logdir: str, batch: int = 32, res: int = 224, device: str = "cuda") -> str:
    """A torch.profiler trace (chrome JSON) of 3 inference calls in `logdir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.startswith("cuda") else [])
    with profile(activities=acts) as prof:
        profile_inference(batch, res, iters=3, device=device)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "profile_mfu_trace.json")
    prof.export_chrome_trace(path)
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="32,64,128,256")
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--train", action="store_true", help="profile the full training step instead of inference")
    ap.add_argument("--num_cas_iters", type=int, default=2)
    ap.add_argument("--run_smplify", action="store_true")
    ap.add_argument("--remat", nargs="?", const="stage", default=False, choices=["stage", "decoder"])
    ap.add_argument("--trace_dir", default=None, help="also write a torch.profiler trace here")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="the train step's compute dtype (parameters stay float32); inference is bfloat16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> list:
    """Print one JSON line per batch (and the trace's path); returns the rows."""
    args = build_parser().parse_args(argv)
    rows = []
    for b in [int(x) for x in args.batches.split(",")]:
        if args.train:
            row = profile_train(b, args.res, num_cas=args.num_cas_iters, iters=max(3, args.iters // 2),
                                run_smplify=args.run_smplify, remat=args.remat, dtype=args.dtype, device=args.device)
        else:
            row = profile_inference(b, args.res, num_cas=args.num_cas_iters, iters=args.iters, device=args.device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.trace_dir:
        print(json.dumps({"trace": capture_trace(args.trace_dir, res=args.res, device=args.device)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
