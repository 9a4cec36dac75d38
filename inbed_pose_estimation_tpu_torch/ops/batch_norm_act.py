"""The ResNet-50 trunk's eval tail after a convolution: CUDA kernel wrapper
and plain version.

    batch_norm_act(x, bn)                 = relu(bn(x))
    batch_norm_act(x, bn, r)              = relu(bn(x) + r)
    batch_norm_act(x, bn, r, residual_bn) = relu(bn(x) + residual_bn(r))

with x a convolution's output [B, C, H, W], bn and residual_bn eval-mode
BatchNorm2d layers normalizing with their running statistics, and r the
block's residual, of x's shape.  `models/backbone.py` calls it in eval
(`fused_route`).  For CUDA tensors it launches `csrc/batch_norm_act.cu`
once, which reads each input once and writes the output once, or raises;
it takes the plain version `batch_norm_act_reference` only for tensors on
the CPU.  It computes no gradient: the trunk takes it only without
autograd.  The kernel reads the BatchNorms' running statistics, weights and
epsilon where they are at each launch, so a `load_state_dict` or an
in-place write to them is seen by the next call.

`launches` counts kernel launches by form ("relu", "add_relu",
"bn_add_relu"); it is raised only where the kernel is launched, so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import launcher

FORMS = ("relu", "add_relu", "bn_add_relu")
launches = dict.fromkeys(FORMS, 0)


def _norm(x, bn):
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)


def batch_norm_act_reference(x, bn, residual=None, residual_bn=None):
    """The plain form: torch's eval BatchNorm, the add, ReLU, as the modules
    compute them."""
    h = _norm(x, bn)
    if residual is not None:
        h = h + (residual if residual_bn is None else _norm(residual, residual_bn))
    return F.relu(h)


def _check_norm(bn, x, what):
    if bn.training:
        raise ValueError(f"batch_norm_act: {what} is in training mode; the kernel normalizes with running statistics")
    terms = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    if any(t is None for t in terms):
        raise ValueError(f"batch_norm_act: {what} needs running statistics, a weight and a bias")
    for t in terms:
        if t.shape != (x.shape[1],):
            raise ValueError(f"batch_norm_act: {what} has {tuple(t.shape)} terms, x {x.shape[1]} channels")
        if t.dtype != torch.float32:
            raise TypeError(f"batch_norm_act: {what}'s terms are {t.dtype}, the kernel takes torch.float32")
        if t.device != x.device:
            raise ValueError(f"batch_norm_act: {what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"batch_norm_act: {what}'s terms must be contiguous")


def _check(x, bn, residual, residual_bn):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"batch_norm_act: x has shape {tuple(x.shape)}, expected a non-empty [B, C, H, W]")
    if x.dtype != torch.float32:
        raise TypeError(f"batch_norm_act: x is {x.dtype}, the kernel takes torch.float32")
    if not x.is_contiguous():
        raise ValueError("batch_norm_act: x must be contiguous (NCHW)")
    _check_norm(bn, x, "bn")
    if residual is not None:
        if residual.shape != x.shape:
            raise ValueError(f"batch_norm_act: residual has shape {tuple(residual.shape)}, x {tuple(x.shape)}")
        if residual.dtype != x.dtype:
            raise TypeError(f"batch_norm_act: residual is {residual.dtype}, x {x.dtype}")
        if residual.device != x.device:
            raise ValueError(f"batch_norm_act: residual is on {residual.device}, x on {x.device}")
        if not residual.is_contiguous():
            raise ValueError("batch_norm_act: residual must be contiguous (NCHW)")
    if residual_bn is not None:
        if residual is None:
            raise ValueError("batch_norm_act: residual_bn needs a residual")
        _check_norm(residual_bn, x, "residual_bn")


_PTRS = [ctypes.c_void_p] * 4
_forward = launcher("batch_norm_act", "batch_norm_act_forward",
                    [ctypes.c_int] + [ctypes.c_void_p] * 3 + _PTRS + [ctypes.c_float] + _PTRS + [ctypes.c_float]
                    + [ctypes.c_int] * 3)


def _terms(bn):
    if bn is None:
        return [None] * 4 + [0.0]
    return [bn.running_mean.data_ptr(), bn.running_var.data_ptr(), bn.weight.data_ptr(), bn.bias.data_ptr(), bn.eps]


def _launch(x, bn, residual, residual_bn):
    form = 0 if residual is None else 1 if residual_bn is None else 2
    operands = [t for t in (x, residual, bn.weight, bn.bias) if t is not None]
    if residual_bn is not None:
        operands += [residual_bn.weight, residual_bn.bias]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("batch_norm_act: the kernel computes no gradient; call it without autograd")
    B, C, H, W = x.shape
    if B * C >= 2**31 or H * W >= 2**31:
        raise ValueError(f"batch_norm_act: x {tuple(x.shape)} is too large for the kernel's grid")
    out = torch.empty_like(x)
    _forward(x.device, form, x.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
             *_terms(bn), *_terms(residual_bn), B, C, H * W)
    launches[FORMS[form]] += 1
    return out


def batch_norm_act(x, bn, residual=None, residual_bn=None):
    """relu(bn(x)), relu(bn(x) + residual) or relu(bn(x) + residual_bn(residual)),
    forward only, with eval-mode BatchNorms.

    x and residual [B, C, H, W], float32, contiguous.  The kernel for CUDA
    tensors, the plain version on the CPU.
    """
    _check(x, bn, residual, residual_bn)
    if x.device.type == "cuda":
        return _launch(x, bn, residual, residual_bn)
    if x.device.type == "cpu":
        return batch_norm_act_reference(x, bn, residual, residual_bn)
    raise ValueError(f"batch_norm_act: unsupported device {x.device}")
