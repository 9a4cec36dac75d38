"""The image decoders' one-channel output stage: CUDA kernel wrapper and
plain version.

    out = conv2d(batch_norm(pixel_shuffle(x, 2)), weight, bias, padding=1)

with x the pre-shuffle map [B, 4C, h, w], an eval-mode BatchNorm given by
its terms `norm` (`batch_norm_terms`) or none, weight [1, C, 3, 3] and an
optional bias [1]; the zero padding of the convolution comes after the
BatchNorm.  `shuffle_project` is what the decoders call in eval
(`models/decoder.py::project_shuffled`).  For CUDA tensors it launches
`csrc/shuffle_project.cu` once, which reads x once and never writes the
shuffled map, or raises; it takes the plain version `shuffle_project_reference`
only for tensors on the CPU.  It computes no gradient: the decoders take it
only without autograd.

`launches` counts kernel launches; it is raised only where the kernel is
launched, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import library

launches = 0


def batch_norm_terms(bn):
    """[4, C]: an eval-mode BatchNorm's running mean, invstd =
    rsqrt(running_var + eps), weight and bias.  On the card torch's eval
    BatchNorm (cuDNN's and its own kernel) computes
    fma(weight * (x - mean), invstd, bias) with this invstd, bit for bit,
    and so does the kernel."""
    return torch.stack((bn.running_mean, torch.rsqrt(bn.running_var + bn.eps), bn.weight, bn.bias))


def shuffle_project_reference(x, weight, norm=None, bias=None):
    """The plain form: pixel_shuffle, then the BatchNorm, then conv2d."""
    h = F.pixel_shuffle(x, 2)
    if norm is not None:
        mean, invstd, gamma, beta = (t.view(1, -1, 1, 1) for t in norm)
        h = gamma * (h - mean) * invstd + beta
    return F.conv2d(h, weight, bias, padding=1)


def _check(x, weight, norm, bias):
    if x.dim() != 4 or x.shape[1] % 4:
        raise ValueError(f"shuffle_project: x has shape {tuple(x.shape)}, expected [B, 4C, h, w]")
    B, C, h, w = x.shape[0], x.shape[1] // 4, x.shape[2], x.shape[3]
    if B == 0 or C == 0 or h == 0 or w == 0:
        raise ValueError(f"shuffle_project: empty input {tuple(x.shape)}")
    shapes = {"weight": (weight, (1, C, 3, 3)), "norm": (norm, (4, C)), "bias": (bias, (1,))}
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"shuffle_project: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != x.dtype:
            raise TypeError(f"shuffle_project: {name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"shuffle_project: {name} is on {t.device}, x on {x.device}")


@functools.cache
def _kernel():
    """The C entry points of csrc/shuffle_project.cu, built and typed once per process."""
    lib = library("shuffle_project")
    lib.shuffle_project_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.shuffle_project_forward.restype = ctypes.c_int
    lib.shuffle_project_error_string.argtypes = [ctypes.c_int]
    lib.shuffle_project_error_string.restype = ctypes.c_char_p
    return lib.shuffle_project_forward, lib.shuffle_project_error_string


def _launch(x, weight, norm, bias):
    global launches
    if x.dtype != torch.float32:
        raise TypeError(f"shuffle_project: x is {x.dtype}, the kernel takes torch.float32")
    operands = [t for t in (x, weight, norm, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("shuffle_project: the kernel computes no gradient; call it without autograd")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("shuffle_project: x, weight, norm and bias must be contiguous")
    B, C, h, w = x.shape[0], x.shape[1] // 4, x.shape[2], x.shape[3]
    if B > 65535 or 4 * C * h * w >= 2**31:
        raise ValueError(f"shuffle_project: x {tuple(x.shape)} is too large for the kernel's grid and offsets")
    if w % 4 or x.data_ptr() % 16:
        raise ValueError(f"shuffle_project: the kernel reads rows in 16-byte pieces; x needs a width that is a "
                         f"multiple of 4 (it is {w}) and a 16-byte aligned start")
    out = torch.empty((B, 1, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    forward, error_string = _kernel()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):  # launch under the tensors' device, on its current stream
        stream = torch.cuda.current_stream().cuda_stream
        err = forward(x.data_ptr(), weight.data_ptr(), ptr(norm), ptr(bias), out.data_ptr(), B, C, h, w, stream)
    if err != 0:
        raise RuntimeError(f"shuffle_project kernel launch failed: {error_string(err).decode()}")
    launches += 1
    return out


def shuffle_project(x, weight, norm=None, bias=None):
    """conv2d(batch_norm(pixel_shuffle(x, 2)), weight, bias, padding=1), forward only.

    x [B, 4C, h, w]; weight [1, C, 3, 3]; norm [4, C] (`batch_norm_terms`)
    or None; bias [1] or None.  Returns [B, 1, 2h, 2w].  The kernel for
    CUDA tensors (float32, contiguous, w a multiple of 4), the plain version
    on the CPU.
    """
    _check(x, weight, norm, bias)
    if x.device.type == "cuda":
        return _launch(x, weight, norm, bias)
    if x.device.type == "cpu":
        return shuffle_project_reference(x, weight, norm, bias)
    raise ValueError(f"shuffle_project: unsupported device {x.device}")
