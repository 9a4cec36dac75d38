#!/usr/bin/env python3
"""Run the PyTorch port's eval inference path on one CUDA card and check it.

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
     skinning on the card and against the CPU on a small input; images/s.
Then the kernel table as one JSON line, the nvidia-smi line, and
{"ok": true, "device": ...} as the last line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

MODEL, BATCH, RES, NUM_CAS_ITERS, SEED = "cashmrV2", 32, 224, 2, 0
TIMED_CALLS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
