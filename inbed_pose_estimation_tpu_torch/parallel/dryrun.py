"""A multi-process dry run of data parallel, and the launcher it uses.

The counterpart of the JAX package's `__graft_entry__.dryrun_multichip`:
`dryrun_multichip(n)` starts `n` ranks with torchrun's environment, each of
which runs one full data-parallel train step of cashmrV2 at RES 64 (global
batch 2n, SMPLify with 2 iterations, dropout on) and one eval batch, and
checks that every rank ends the step with the same state and the same
global loss.  On the CPU the ranks use gloo; every collective has a
timeout, and each rank has a time limit, so a hung rendezvous fails the
run instead of hanging it.

    python -m inbed_pose_estimation_tpu_torch.parallel.dryrun [--ranks 2] [--device cpu]

The ranks run on cards (`cuda:<LOCAL_RANK>`, NCCL, one card a rank) unless
`--device cpu` asks for gloo on the CPU.

The worker (`--worker`, one rank) is also what the tests and the card's
smoke script drive at other sizes: it builds the model and a state from a
seed, takes its rows of a seeded global batch, runs `--steps` train steps,
reports the first step's global metrics and skinning launches and the ms
of every step, checks that every rank ends with rank 0's state bitwise,
and with `--out` rank 0 saves its state after the first step with the
gradient Adam took (averaged over the ranks) and its own gradient before
the average, for a comparison with one process's run of the same step (the
worker without torchrun's environment).  `--profile` runs one more step
under torch.profiler, with SMPLify at one iteration (a step's all-reduces
do not depend on SMPLify's iterations, whose 10^5 launches at N=100 would
fill the trace), and reads the all-reduces from its trace
(`collective_readings`); `--eval` infers the batch once more in eval mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np

RESULT_TAG = "DRYRUN_RESULT "
SEED = 0  # the weights (torch's seed), the batch, the fits (SEED + 11), the dropout generator (SEED + 1)


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: list, nprocs: int, timeout: float = 300.0, env: Optional[dict] = None,
           cwd: Optional[str] = None) -> list:
    """Run `python <argv>` as `nprocs` ranks with torchrun's environment
    (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT on localhost);
    returns [(returncode, output)] by rank.  A rank still running after
    `timeout` seconds is killed (a negative returncode)."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE=str(nprocs),
                LOCAL_WORLD_SIZE=str(nprocs))
    procs = []
    for r in range(nprocs):
        procs.append(subprocess.Popen([sys.executable] + list(argv), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=cwd))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def results(runs: list) -> list:
    """The worker's result dict of each rank; raises RuntimeError, with the
    rank's output, when a rank failed or printed none."""
    got = []
    for r, (rc, out) in enumerate(runs):
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
        if rc != 0 or not lines:
            raise RuntimeError(f"rank {r} exited with {rc}:\n{out[-6000:]}")
        got.append(json.loads(lines[-1][len(RESULT_TAG):]))
    return got


def worker_argv(**flags) -> list:
    """`-m ...dryrun --worker` with `flags` (name=value; True for a bare flag)."""
    argv = ["-m", "inbed_pose_estimation_tpu_torch.parallel.dryrun", "--worker"]
    for k, v in flags.items():
        if v is True:
            argv.append(f"--{k}")
        elif v is not None and v is not False:
            argv += [f"--{k}", str(v)]
    return argv


# The dry run's step: cashmrV2 at RES 64, SMPLify with 2 iterations, 2 rows
# a rank.
DRYRUN_FLAGS = {"model": "cashmrV2", "res": 64, "smplify_iters": 2}


def dryrun_multichip(n: int = 2, device: str = "cuda", timeout: float = 300.0, out: Optional[str] = None) -> list:
    """One data-parallel train step and one eval batch of cashmrV2 at RES 64
    on `n` ranks (NCCL on `n` cards, or gloo with `device="cpu"`); returns
    each rank's result, after checking that all ranks agree.  With `out`,
    rank 0 saves its state there (`worker --out`)."""
    from ..device import resolve_device

    resolve_device(device)  # raises here, before any rank starts, without a card
    runs = launch(worker_argv(batch=2 * n, device=device, eval=True, out=out, **DRYRUN_FLAGS),
                  n, timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1"))
    got = results(runs)
    losses = {g["metrics"]["loss"] for g in got}
    if len(losses) != 1 or not all(np.isfinite(list(losses))):
        raise RuntimeError(f"the ranks disagree on the global loss: {losses}")
    if not all(g["state_same_on_every_rank"] and g["eval_finite"] for g in got):
        raise RuntimeError(f"ranks' states differ or the eval batch is not finite: {got}")
    print(f"dryrun_multichip({n}): OK, loss={got[0]['metrics']['loss']:.4f}, eval batch OK", flush=True)
    return got


def seeded_fits(rows: int) -> np.ndarray:
    """The worker's initial fits store [rows, 82]."""
    return np.random.default_rng(SEED + 11).normal(0, 0.2, (rows, 82)).astype(np.float32)


def global_batch(spec, batch: int, res: int, rows: int) -> dict:
    """A seeded global train batch whose valid rows fall unevenly over the
    ranks: ground-truth SMPL on the first quarter of the rows only, 3D joints
    on all but every third row."""
    from ..tools.bench_train import train_batch

    out = train_batch(spec, batch, res, rows, SEED)
    out["has_smpl"] = (np.arange(batch) < max(1, batch // 4)).astype(np.float32)
    out["has_pose_3d"] = (np.arange(batch) % 3 != 2).astype(np.float32)
    return out


def gradient_distance(got: dict, want: dict) -> tuple:
    """The worst parameter's relative distance between two gradients keyed
    by name, ||got - want|| / ||want|| (0 where both are zero), and its
    name."""
    import torch

    worst = (0.0, None)
    for k, w in want.items():
        w = torch.as_tensor(w).double()
        num = torch.linalg.vector_norm(torch.as_tensor(got[k]).to(w.device).double() - w).item()
        den = torch.linalg.vector_norm(w).item()
        d = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
        worst = max(worst, (d, k), key=lambda x: x[0])
    return worst


def gradient_readings(ranks: dict, single: dict, world: int) -> dict:
    """The gradient of a `world`-rank step (`ranks`, rank 0's `--out`)
    against one process's (`single`): `gradient_distance` of the averaged
    gradient, and of three controls a check must tell from it: the
    gradient summed over the ranks and divided twice (a wrong world-size
    factor), and rank 0's own gradient before the average."""
    got, want = ranks["grads"], single["grads"]
    if set(got) != set(want):
        raise ValueError(f"the gradients name different parameters: {sorted(set(got) ^ set(want))[:5]}")
    return {"sound": gradient_distance(got, want),
            "controls": {"summed": gradient_distance({k: g * world for k, g in got.items()}, want)[0],
                         "divided_twice": gradient_distance({k: g / world for k, g in got.items()}, want)[0],
                         "rank_0_alone": gradient_distance(ranks["local_grads"], want)[0]}}


# Bytes of an element, by the dtype names of the profiler's records.
_DTYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "long int": 8, "int": 4}


def collective_readings(prof) -> dict:
    """The all-reduces of a torch.profiler trace (recorded with shapes):
    the backend's own spans (`nccl:all_reduce`, `gloo:all_reduce`), their
    count, the bytes of their inputs and their summed host time, and the
    summed device time of NCCL's kernels.  A gloo all-reduce runs on the
    host (a CUDA tensor crosses through it), so it has no kernel."""
    import torch

    spans, nbytes, host_ns, kernel_ns = 0, 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if "nccl" in name.lower():
                kernel_ns += e.duration_ns()
        elif name in ("nccl:all_reduce", "gloo:all_reduce"):
            spans += 1
            host_ns += e.duration_ns()
            for shape, dtype in zip(e.shapes(), e.dtypes()):
                if not shape:  # not a tensor
                    continue
                if dtype not in _DTYPE_BYTES:
                    raise ValueError(f"{name}: an input of dtype {dtype!r}")
                nbytes += int(np.prod(shape)) * _DTYPE_BYTES[dtype]
    return {"all_reduces": spans, "bytes_all_reduced": nbytes, "host_ms": host_ns / 1e6,
            "nccl_kernel_ms": kernel_ns / 1e6}


def worker(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--model", default="cashmrV2")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4, help="the global batch")
    ap.add_argument("--smplify_iters", type=int, default=2)
    ap.add_argument("--remat", default=None, choices=["stage", "decoder"])
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--dropout", type=float, default=None, help="the IEF dropout rate (the model's default)")
    ap.add_argument("--no_feedback", action="store_true", help="cut the cascade's feedback of recovered images")
    ap.add_argument("--init_out", default=None, help="rank 0 saves the initial weights here")
    ap.add_argument("--out", default=None, help="rank 0 saves its state and gradients after the first step here")
    ap.add_argument("--eval", action="store_true", help="also infer one eval batch")
    ap.add_argument("--profile", action="store_true", help="trace the collectives of one more step")
    args = ap.parse_args(argv)

    import torch

    from ..evaluation import load_j_regressor_h36m, make_inference_fn
    from ..fitting import synthetic_gmm_prior
    from ..models import build_model
    from ..ops import skinning as sk
    from ..smpl import synthetic_smpl_model
    from ..train import build_parser, init_train_state, losses, make_train_step
    from . import mesh

    dev = mesh.initialize_distributed(backend=args.backend, device=args.device)
    torch.set_num_threads(1)  # CPU ranks share the host's cores
    cuda = dev.type == "cuda"
    options = build_parser().parse_args(
        ["--name", "dryrun", "--img_res", str(args.res), "--batch_size", str(args.batch), "--run_smplify",
         "--num_smplify_iters", str(args.smplify_iters)]
        + (["--remat", args.remat] if args.remat else []))
    torch.manual_seed(SEED)
    kw = {} if args.dropout is None else {"dropout_rate": args.dropout}
    model, spec = build_model(args.model, device=dev, img_res=args.res, remat_decoder=args.remat == "decoder", **kw)
    if args.no_feedback:
        spec = dataclasses.replace(spec, cascade_feed_map=())
    smpl = synthetic_smpl_model(0, device=dev)
    rows = 4 * args.batch
    state = init_train_state(model, options, seeded_fits(rows), seed=SEED + 1, device=dev)
    mesh.replicate(state)
    if args.init_out and mesh.rank() == 0:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, args.init_out)
    step = make_train_step(model, spec, smpl, synthetic_gmm_prior(device=dev), options, device=dev)
    batch = mesh.shard_batch(global_batch(spec, args.batch, args.res, rows))
    # The rows of this rank with a valid fit in the last step (the mask of
    # the final stage's SMPL losses).
    valid_fit = []

    def smpl_losses(*a):
        valid_fit.append(float(a[-1].sum()))
        return plain_smpl_losses(*a)

    plain_smpl_losses, losses.smpl_losses = losses.smpl_losses, smpl_losses
    # This rank's gradient of the first step before the average over the
    # ranks (what Adam would take without it), by parameter name.
    names = {id(p): k for k, p in model.named_parameters()}
    local_grads = {}

    def sync_gradients(params):
        params = list(params)
        if args.out and mesh.rank() == 0 and mesh.is_initialized() and not local_grads:
            local_grads.update((names[id(p)], p.grad.detach().cpu().clone()) for p in params)
        plain_sync_gradients(params)

    plain_sync_gradients, mesh.sync_gradients = mesh.sync_gradients, sync_gradients

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    result = {"rank": mesh.rank(), "world_size": mesh.world_size(), "device": str(dev),
              "backend": torch.distributed.get_backend() if mesh.is_initialized() else None,
              "local_rows": len(batch["sample_index"]), "sample_index": [int(i) for i in batch["sample_index"]],
              "step_ms": []}
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        before = sk.launches
        valid_fit.clear()
        state, metrics = step(state, batch)
        sync()
        result["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if i == 0:  # the first step's numbers, and its state with --out
            result.update(metrics={k: float(v) for k, v in metrics.items()}, launches_per_step=sk.launches - before,
                          valid_fit_rows=valid_fit[0])
            if args.out and mesh.rank() == 0:
                torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}, "fits": state.fits.cpu(),
                            "grads": {k: p.grad.cpu() for k, p in model.named_parameters() if p.requires_grad},
                            "local_grads": local_grads, "metrics": result["metrics"]}, args.out)

    # Parameters, BatchNorm statistics, Adam's moments and steps, the fits
    # and the dropout generator.
    result["state_same_on_every_rank"] = mesh.same_on_every_rank(state)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        short = argparse.Namespace(**dict(vars(options), num_smplify_iters=1))
        profiled_step = make_train_step(model, spec, smpl, synthetic_gmm_prior(device=dev), short, device=dev)
        sync()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
                     record_shapes=True) as prof:
            state, _ = profiled_step(state, batch)
            sync()
        result["collectives"] = dict(
            collective_readings(prof), profiled_step_ms=1e3 * (time.perf_counter() - t0),
            gradient_bytes=sum(p.numel() * p.element_size() for p in model.parameters() if p.requires_grad))

    if args.eval:
        infer = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(num_vertices=smpl.v_template.shape[0]),
                                  final_recon=False, device=dev)
        before = sk.launches
        preds = infer(tuple(batch[m] for m in spec.modalities))
        result["eval_launches"] = sk.launches - before
        k17 = mesh.gather_rows(preds["keypoints_3d_17"])
        result["eval_rows"] = int(k17.shape[0])
        result["eval_finite"] = bool(torch.isfinite(k17).all())
    print(RESULT_TAG + json.dumps(result), flush=True)
    mesh.shutdown()
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    for r in dryrun_multichip(args.ranks, device=args.device, timeout=args.timeout):
        print(json.dumps(r))


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        worker()
    else:
        main()
