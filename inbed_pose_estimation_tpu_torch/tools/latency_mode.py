"""One request in, its answer back on the host: the latency of bfloat16
cashmrV2 inference at batch 32, taken apart.

The port of the JAX package's `tools/latency_mode.py`, with its rows and
keys.  Every request waits for its own answer on the host (nothing is
pipelined), and each row is the median and the minimum over `--iters`
requests, after 5 warm-up requests:

  rtt              the read-back of a tiny tensor already on the device:
                   one host<->device round trip
  noop             a one-element add and its read-back: the round trip and
                   one launch
  resident         inference on inputs already on the device, the pose
                   outputs (cam, J17) packed into one float32 tensor and
                   read back once
  resident_2fetch  the same, cam and J17 read back apart (two round trips)
  u8_h2d           the serving request: one [B, 6, H, W] uint8 host tensor
                   copied to the device, decoded there by the uint8 feed's
                   `decode_uint8_batch` (its noise factors 1), inference,
                   one packed read-back
  u8_put_only      the bare copy of that uint8 tensor to the device
  f32_h2d          the float32 per-modality host tensors copied, inference,
                   one packed read-back

The last line derives the parts (compute ~ resident - noop, an upload's
cost ~ its row - resident, and the copy's MB/s).  The keys keep the JAX
tool's names: `tunnel_rtt_ms` is the round trip whatever carries it.  The
derived line adds the device's name.

    python -m inbed_pose_estimation_tpu_torch.tools.latency_mode [--batch 32] [--res 224]
        [--iters 30] [--device cuda]
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
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _time_requests(fn, iters: int, warm: int = 5):
    """(median ms, min ms) of `iters` calls of fn, each timed alone on the
    host's clock; fn returns only once its answer is on the host."""
    for _ in range(warm):
        fn()
    xs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        xs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(xs)), float(np.min(xs))


def main(argv=None) -> dict:
    """Print one JSON line per row and the derived line; returns
    {row: median ms} and the derived dict under "derived"."""
    args = build_parser().parse_args(argv)
    B, RES = args.batch, args.res

    import torch

    from ..data.device_preprocess import decode_uint8_batch
    from ..device import resolve_device
    from ..evaluation import load_j_regressor_h36m, make_inference_fn
    from ..models import build_model
    from ..models.factory import MODALITY_CHANNELS
    from ..smpl import synthetic_smpl_model

    dev = resolve_device(args.device)
    torch.manual_seed(0)
    model, spec = build_model("cashmrV2", device=dev, dtype=torch.bfloat16)
    smpl = synthetic_smpl_model(0, device=dev)
    infer_core = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(num_vertices=smpl.v_template.shape[0]),
                                   num_cas_iters=2, final_recon=False, device=dev)

    chans = [MODALITY_CHANNELS[m] for m in spec.modalities]
    rng = np.random.default_rng(0)
    host_f32 = tuple(torch.from_numpy(rng.normal(0, 1, (B, c, RES, RES)).astype(np.float32)) for c in chans)
    host_u8 = torch.from_numpy(rng.integers(0, 256, (B, sum(chans), RES, RES), dtype=np.uint8))
    if dev.type == "cuda":  # page-locked, as a server's staging buffers are
        host_f32 = tuple(t.pin_memory() for t in host_f32)
        host_u8 = host_u8.pin_memory()
    dev_inputs = tuple(t.to(dev) for t in host_f32)
    ones = torch.ones(B, 3, device=dev)

    rows = {}

    def report(name, med, mn):
        rows[name] = med
        print(json.dumps({"mode": name, "median_ms": med, "min_ms": mn}), flush=True)

    # rtt: one distinct device scalar a request, read back.
    scalars = [torch.full((), float(i), device=dev) for i in range(args.iters + 5)]
    it = iter(scalars)
    report("rtt", *_time_requests(lambda: next(it).item(), args.iters))
    scalar = scalars[0]
    report("noop", *_time_requests(lambda: (scalar + 1.0).item(), args.iters))

    def packed(out):
        return torch.cat([out["cam"].reshape(-1), out["keypoints_3d_17"].reshape(-1)]).float()

    def req_resident_2fetch():
        out = infer_core(dev_inputs)
        out["cam"].cpu(), out["keypoints_3d_17"].cpu()

    def req_resident():
        packed(infer_core(dev_inputs)).cpu()

    report("resident_2fetch", *_time_requests(req_resident_2fetch, args.iters))
    report("resident", *_time_requests(req_resident, args.iters))

    def decode(u8):
        feed, off = {"pixel_noise": ones}, 0
        for m, c in zip(spec.modalities, chans):
            feed[m] = u8[:, off:off + c]
            off += c
        decoded = decode_uint8_batch(feed)
        return tuple(decoded[m] for m in spec.modalities)

    def req_u8():
        packed(infer_core(decode(host_u8.to(dev, non_blocking=True)))).cpu()

    report("u8_h2d", *_time_requests(req_u8, args.iters))

    def put_u8():
        host_u8.to(dev, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    report("u8_put_only", *_time_requests(put_u8, args.iters))

    def req_f32():
        packed(infer_core(tuple(t.to(dev, non_blocking=True) for t in host_f32))).cpu()

    report("f32_h2d", *_time_requests(req_f32, args.iters))

    u8_mb = host_u8.numel() / 1e6
    f32_mb = sum(t.numel() * 4 for t in host_f32) / 1e6
    derived = {
        "mode": "derived",
        "tunnel_rtt_ms": rows["rtt"],
        "dispatch_overhead_ms": rows["noop"] - rows["rtt"],
        "compute_ms": rows["resident"] - rows["noop"],
        "second_fetch_ms": rows["resident_2fetch"] - rows["resident"],
        "u8_upload_cost_ms": rows["u8_h2d"] - rows["resident"],
        "u8_put_only_ms": rows["u8_put_only"],
        "f32_upload_cost_ms": rows["f32_h2d"] - rows["resident"],
        "h2d_mb_per_s_u8": u8_mb / max(rows["u8_h2d"] - rows["resident"], 1e-6) * 1e3,
        "h2d_mb_per_s_f32": f32_mb / max(rows["f32_h2d"] - rows["resident"], 1e-6) * 1e3,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(derived), flush=True)
    return {**rows, "derived": derived}


if __name__ == "__main__":
    main()
