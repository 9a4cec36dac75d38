"""Spatial cross attention over the 7x7 feature grid (featatt_cashmr,
ir_depth_featatt_cashmrV2), and single-map self attention, NCHW.

The JAX package's behaviour, which departs from the reference: the
reference's accumulator loop overwrote its sum on every modality, keeping
only the last attention map and dropping the input feature.  Here every
modality's values go through every modality's map and are summed:

    out_x = x + sum_i gamma_i * (att_i @ value(x))

with per-modality gains `gamma` that start at zero, so the module is the
identity at its initialization.  In a bfloat16 model the attention runs
in bfloat16 and the sums, as in JAX, in float32: the fused maps leave the
module in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import Conv2d


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


class CrossAttention(nn.Module):
    """n feature maps [B, C, H, W] -> their fused maps, concatenated on the
    channel axis [B, n * C, H, W].

    Parameters carry the reference names: 1x1 `query_conv`, `key_conv` and
    `value_conv` (C -> C, with bias), shared by all modalities, and `gamma`
    [n].
    """

    def __init__(self, channels: int, n: int):
        super().__init__()
        self.query_conv = Conv2d(channels, channels, 1)
        self.key_conv = Conv2d(channels, channels, 1)
        self.value_conv = Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(n))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        B, C, H, W = feats[0].shape
        # energy[b, n, m] = q[b, n] . k[b, m], softmax over m.
        atts = [torch.softmax(_tokens(self.query_conv(x)) @ _tokens(self.key_conv(x)).transpose(1, 2), dim=-1)
                for x in feats]
        outs = []
        for x in feats:
            v = _tokens(self.value_conv(x))
            acc = _tokens(x)
            for i, att in enumerate(atts):
                # In a bfloat16 model the product is cast to gamma's float32
                # first: JAX promotes bfloat16 x float32 to float32, where a
                # 0-dim float32 tensor would leave it bfloat16 here.
                acc = acc + self.gamma[i] * (att @ v).to(self.gamma.dtype)
            outs.append(acc.transpose(1, 2).reshape(B, C, H, W))
        return torch.cat(outs, dim=1)


class SelfAttention(nn.Module):
    """Single-map spatial self attention (reference: models/hmr.py:1078-1110):
    a feature map [B, C, H, W] -> gamma * (att @ value(x)) + x, with
    att = softmax over m of query(x)_n . key(x)_m, the same shape.

    No registered model uses it; it is the port of the JAX package's
    `models/attention.py::SelfAttention`.  Parameters carry the reference
    names, as `CrossAttention`'s do: 1x1 `query_conv`, `key_conv` and
    `value_conv` (C -> C, with bias) and `gamma` [1], zero at
    initialization, where the module is the identity.  In a bfloat16 model
    the attention runs in bfloat16 and its scaled sum with x in float32.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.query_conv = Conv2d(channels, channels, 1)
        self.key_conv = Conv2d(channels, channels, 1)
        self.value_conv = Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = torch.softmax(_tokens(self.query_conv(x)) @ _tokens(self.key_conv(x)).transpose(1, 2), dim=-1)
        out = (att @ _tokens(self.value_conv(x))).to(self.gamma.dtype)
        return self.gamma[0] * out.transpose(1, 2).reshape(x.shape) + x
