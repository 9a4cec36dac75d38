"""Seeded weights for a configuration, made on the device in one draw.

One uniform draw in [-1, 1) covers every floating entry of an
architecture's `params(config)` (`reference/<architecture>.py`); each
entry's slice is then
scaled by its kind:

  conv, linear  He-uniform, bound sqrt(6 / fan_in)
  head          decpose / decshape / deccam: bound 0.3 / sqrt(fan_in), so
                that the IEF moves the estimate by tenths, not by noise
  bias          bound 1 / sqrt(fan_in)
  bn_weight     0.5 +- 0.25;  bn_bias +-0.1;  bn_mean +-0.1;  bn_var 1 +- 0.5
  count         BatchNorm's num_batches_tracked, 0

The SMPL mean parameters, where the IEF starts, are one set per
configuration, as one mean-parameter file serves every stage of a model:
init_pose the identity in the 6D convention +- 0.2 (a mean pose that is not
the rest pose), init_shape +-0.5, init_cam (0.9, 0, 0) +- 0.05, each drawn
once and given to every stage.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def make_weights(specs, seed: int, device) -> dict:
    """{name: tensor} for the (name, shape, kind, fan_in) entries `specs`."""
    total = sum(_numel(shape) for _, shape, kind, _ in specs if kind in SCALED)
    flat = torch.empty(total, dtype=torch.float32, device=device).uniform_(-1.0, 1.0,
                                                                          generator=generator(seed, "weights", device))
    means = mean_params(seed, device)
    out, at = {}, 0
    for name, shape, kind, fan_in in specs:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        if kind in means:
            out[name] = means[kind].clone()
            continue
        n = _numel(shape)
        u = flat[at:at + n].view(shape)
        at += n
        out[name] = _scale(u, kind, fan_in)
    return out


SCALED = ("conv", "linear", "head", "bias", "bn_weight", "bn_bias", "bn_mean", "bn_var")


def mean_params(seed: int, device) -> dict:
    u = torch.empty(144 + 10 + 3, device=device).uniform_(-1.0, 1.0, generator=generator(seed, "mean_params", device))
    ident = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], device=device).repeat(24)
    cam = torch.tensor([0.9, 0.0, 0.0], device=device)
    return {"init_pose": (u[:144] * 0.2 + ident)[None], "init_shape": (u[144:154] * 0.5)[None],
            "init_cam": (u[154:] * 0.05 + cam)[None]}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _scale(u, kind, fan_in):
    if kind in ("conv", "linear"):
        return u.mul_((6.0 / fan_in) ** 0.5)
    if kind == "head":
        return u.mul_(0.3 / fan_in ** 0.5)
    if kind == "bias":
        return u.mul_(1.0 / fan_in ** 0.5)
    if kind == "bn_weight":
        return u.mul_(0.25).add_(0.5)
    if kind in ("bn_bias", "bn_mean"):
        return u.mul_(0.1)
    if kind == "bn_var":
        return u.mul_(0.5).add_(1.0)
    raise ValueError(f"unknown parameter kind {kind!r}")
