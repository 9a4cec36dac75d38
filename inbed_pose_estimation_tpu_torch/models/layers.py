"""The compute dtype of the port's layers, and rematerialization.

`Conv2d` and `Linear` are torch's layers with one attribute more,
`compute_dtype`.  None (the default) computes in the dtype of the input and
the parameters, as torch's own layers do.  A dtype (torch.bfloat16) casts
the input and the parameters to it for the product, as flax's
`nn.Conv(dtype=)` and `nn.Dense(dtype=)` do; the parameters themselves stay
float32.  `set_compute_dtype` sets it on every module of a model that has
the attribute (these layers and the model classes, which cast their IEF
starting point to it).

`checkpoint` runs a function under `torch.utils.checkpoint` (non-reentrant),
so that the backward pass recomputes its activations instead of keeping
them, with two corrections that `jax.checkpoint` needs no help for: in the
recompute `BatchNorm2d` normalizes with the batch statistics and updates no
running statistic (the forward already did), and a dropout generator is
rewound to its state at the forward's start, so that the recompute draws
the forward's masks, then put back where the forward left it.  Under data
parallel, a collective inside the call (`collective`: BatchNorm's global
statistics) is not issued again in the recompute: the forward keeps its
result and the recompute takes it back, so that no rank waits in a
collective that another rank issues at another point of its backward pass.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

_recompute = threading.local()


class Conv2d(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        return self._conv_forward(x.to(d), self.weight.to(d), None if self.bias is None else self.bias.to(d))


class Linear(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        return F.linear(x.to(d), self.weight.to(d), None if self.bias is None else self.bias.to(d))


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Make `model` compute in `dtype`; float32 (or None) casts nothing, so
    that a float32 model computes exactly as it would without this."""
    value = None if dtype in (None, torch.float32) else dtype
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = value
    return model


def recomputing() -> bool:
    """True inside the backward pass's recompute of a `checkpoint`ed call."""
    return getattr(_recompute, "depth", 0) > 0


def collective(fn, *args):
    """fn(*args), a collective whose result is a tensor.  Inside the
    forward of a `checkpoint`ed call the result is kept, and the backward
    pass's recompute takes it back instead of calling `fn` again."""
    replays = getattr(_recompute, "replays", [])
    if recomputing() and replays:
        value, requires_grad = replays[-1].popleft()
        # A leaf that asks for a gradient when the forward's result did, so
        # that the ops after it save the tensors they saved in the forward.
        out = value.detach().requires_grad_(requires_grad)
    else:
        out = fn(*args)
    for kept in getattr(_recompute, "records", []):
        kept.append((out.detach(), out.requires_grad))
    return out


def checkpoint(fn, *args, generator: Optional[torch.Generator] = None, **kwargs):
    """fn(*args, **kwargs) with its activations recomputed in the backward
    pass; `generator` is the dropout generator that `fn` draws from."""
    start = {}
    kept: list = []

    @contextlib.contextmanager
    def forward():
        if generator is not None:
            start["state"] = generator.get_state()
        _recompute.records = getattr(_recompute, "records", []) + [kept]
        try:
            yield
        finally:
            _recompute.records = [r for r in _recompute.records if r is not kept]

    @contextlib.contextmanager
    def recompute():
        after = None
        if generator is not None:
            after = generator.get_state()
            generator.set_state(start["state"])
        _recompute.depth = getattr(_recompute, "depth", 0) + 1
        _recompute.replays = getattr(_recompute, "replays", []) + [collections.deque(kept)]
        try:
            yield
        finally:
            _recompute.depth -= 1
            _recompute.replays = _recompute.replays[:-1]
            if generator is not None:
                generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=lambda: (forward(), recompute()), **kwargs)
