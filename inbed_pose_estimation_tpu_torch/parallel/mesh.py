"""Data parallel across processes: the port's counterpart of the JAX
package's `parallel/mesh.py`.

The JAX package runs its train step and its eval over a 1-D device mesh:
the batch sharded on dim 0, the state replicated, and every reduction of
the step global over the mesh, so that a step's numbers do not depend on
the device count.  The port runs one process a device (`torchrun
--nproc_per_node N`, one rank each) and keeps the same semantics with
explicit collectives:

  * BatchNorm is global: a training `models.backbone.BatchNorm2d` takes
    its mean and its two-pass (biased) variance over every rank's rows, and
    the backward pass of those statistics is all-reduced too;
  * the masked means of the losses (`train.losses._masked_mean`) divide by
    the global count of selected rows;
  * dropout draws the mask of the global batch from the generator that
    every rank holds in lockstep, and each rank keeps its own rows
    (`models.heads.dropout`);
  * the fits store is replicated: every rank applies every rank's fits
    updates;
  * the gradients are averaged over the ranks (`sync_gradients`) before
    Adam, so that every rank takes the same step.  Each rank's loss is
    scaled so that the mean of the ranks' losses is the loss of the global
    batch.

Everything is built on all_reduce, the collective that NCCL (cards) and
gloo (the CPU, and CUDA tensors staged through the host) both run on the
tensors the port uses: rows are gathered by writing them into a zero
buffer of the global shape and summing.

Without torchrun's environment (`RANK`, `WORLD_SIZE`) no process group is
made, and every function here is the identity of one process: a rank of
0, a world of 1, no collective.

The one departure from the JAX package: its `Trainer` and `run_evaluation`
run the mesh on the largest device count that divides the batch and idle
the other devices, because a JAX program cannot choose its device count;
the port's raise at set-up when the world size does not divide the batch,
because a torchrun user chooses it.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

# A collective that waits longer than this raises instead of hanging.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

# Gradients are all-reduced in flat buckets of at most this many elements.
BUCKET_ELEMENTS = 1 << 24

def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """SUM-all-reduce `t` in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def initialize_distributed(backend: Optional[str] = None, device: Optional[str | torch.device] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group that torchrun's environment describes
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and
    return this rank's device.

    The device is `cuda:<LOCAL_RANK>` unless `device` names one: "cpu", or
    a CUDA device with its index ("cuda" alone means this rank's card).
    The backend is NCCL on a card and gloo on the CPU unless `backend` is
    given.  Every collective of the group raises after `timeout`.  Without
    torchrun's environment no group is made and the device is returned as
    given (default "cuda")."""
    dev = torch.device(device if device is not None else "cuda")
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return resolve_device(dev)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=timeout)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def _comm_device() -> torch.device:
    """Where a host value crosses: the card under NCCL, the CPU under gloo
    (which also takes CUDA tensors, through the host)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def local_rows(n_global: int) -> slice:
    """The rows of a global batch of `n_global` that this rank holds:
    contiguous and rank-major, as `P('data')` shards dim 0."""
    w = world_size()
    if n_global % w:
        raise ValueError(f"a batch of {n_global} rows does not split over {w} ranks")
    b = n_global // w
    return slice(rank() * b, (rank() + 1) * b)


def shard_batch(batch: Any) -> Any:
    """This rank's rows of a global host batch (a dict of arrays, tensors or
    lists; an array, tensor or list)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v) for k, v in batch.items()}
    return batch[local_rows(len(batch))]


def pad_to_multiple(batch: Any, multiple: int) -> tuple[Any, int]:
    """Pad every array's dim 0 up to a multiple of `multiple` by repeating
    its last row (so that BatchNorm statistics stay finite); returns
    (padded batch, original size).  `batch` is an array or a dict of
    arrays; callers mask what they score back to the original size."""
    leaves = list(batch.values()) if isinstance(batch, dict) else [batch]
    n = leaves[0].shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return batch, n

    def pad(x):
        return np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)], axis=0)

    return ({k: pad(v) for k, v in batch.items()} if isinstance(batch, dict) else pad(batch)), n


class _AllReduceSum(torch.autograd.Function):
    """The sum of x over the ranks; its gradient is the sum of the ranks'
    upstream gradients (each rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (identity without a
    process group)."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """SUM-all-reduce `x` in place, without autograd."""
    return _all_reduce(x) if is_initialized() else x


def all_reduce_numpy(a: np.ndarray) -> np.ndarray:
    """The sum over the ranks of a host array, in float64."""
    if not is_initialized():
        return np.asarray(a, np.float64)
    t = torch.as_tensor(np.asarray(a, np.float64), device=_comm_device())
    return _all_reduce(t).cpu().numpy()


@torch.no_grad()
def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[b, ...] rows of every rank -> the global [b * world, ...] batch,
    rank-major, on every rank: each rank writes its rows into a zero buffer
    and the buffers are summed (exact, since each element has one
    writer)."""
    if not is_initialized():
        return x
    b = x.shape[0]
    out = torch.zeros((b * world_size(),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[rank() * b:(rank() + 1) * b] = x
    return _all_reduce(out)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank (picklable; written by this program)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


def _buckets(tensors):
    """`tensors` grouped by device and dtype (in the order each first
    appears), each group cut in order into runs of at most
    `BUCKET_ELEMENTS` elements (a larger tensor is a run of its own)."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        bucket, size = [], 0
        for t in group:
            if bucket and size + t.numel() > BUCKET_ELEMENTS:
                yield bucket
                bucket, size = [], 0
            bucket.append(t)
            size += t.numel()
        yield bucket


def _unpack(flat: torch.Tensor, bucket) -> None:
    off = 0
    for t in bucket:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def sync_gradients(params) -> None:
    """Average `.grad` of `params` over the ranks, in place: the gradients
    are packed into flat buckets of at most `BUCKET_ELEMENTS`, one
    all_reduce each, then divided by the world size.  Every rank must pass
    the same parameters in the same order, each with a `.grad`."""
    if not is_initialized():
        return
    w = world_size()
    for bucket in _buckets([p.grad for p in params]):
        _unpack(_all_reduce(torch.cat([g.reshape(-1) for g in bucket])).div_(w), bucket)


@torch.no_grad()
def _broadcast_(t: torch.Tensor) -> torch.Tensor:
    """Overwrite `t` in place with rank 0's (a host tensor crosses through
    the card under NCCL)."""
    if not is_initialized():
        return t
    dev = _comm_device() if t.device.type == "cpu" else t.device
    if dev == t.device:
        dist.broadcast(t, src=0)
    else:
        box = t.to(dev)
        dist.broadcast(box, src=0)
        t.copy_(box)
    return t


def _state_tensors(state) -> list:
    """The tensors of a train state (`model`, `optimizer`, `fits`,
    `generator`) or a module, the generator's state as a copy."""
    if isinstance(state, torch.nn.Module):
        return [t.data for t in list(state.parameters()) + list(state.buffers())]
    adam = [v for s in state.optimizer.state.values() for v in s.values() if torch.is_tensor(v)]
    return _state_tensors(state.model) + adam + [state.fits, state.generator.get_state()]


def replicate(obj) -> Any:
    """Make every rank hold rank 0's `obj` (a module, or a train state with
    `model`, `optimizer`, `fits` and `generator`), broadcast in place in
    flat buckets; returns `obj`."""
    if not is_initialized():
        return obj
    tensors = _state_tensors(obj)
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        _unpack(_broadcast_(flat), bucket)
    if not isinstance(obj, torch.nn.Module):
        obj.generator.set_state(tensors[-1])
    return obj


@torch.no_grad()
def same_on_every_rank(obj) -> bool:
    """True when every rank holds bitwise rank 0's `obj`: a train state, a
    module or a list of tensors."""
    if not is_initialized():
        return True
    tensors = obj if isinstance(obj, (list, tuple)) else _state_tensors(obj)
    ok = True
    for bucket in _buckets([t.detach() for t in tensors]):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        ok = torch.equal(_broadcast_(flat.clone()), flat) and ok
    flag = torch.tensor([0.0 if ok else 1.0], device=_comm_device())
    return _all_reduce(flag).item() == 0.0
