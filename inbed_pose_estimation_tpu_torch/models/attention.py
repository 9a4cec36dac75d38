"""Spatial cross attention over the 7x7 feature grid (featatt_cashmr,
ir_depth_featatt_cashmrV2), NCHW.

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

        def tokens(x):  # [B, C, H, W] -> [B, H*W, C]
            return x.reshape(B, C, H * W).transpose(1, 2)

        # energy[b, n, m] = q[b, n] . k[b, m], softmax over m.
        atts = [torch.softmax(tokens(self.query_conv(x)) @ tokens(self.key_conv(x)).transpose(1, 2), dim=-1)
                for x in feats]
        outs = []
        for x in feats:
            v = tokens(self.value_conv(x))
            acc = tokens(x)
            for i, att in enumerate(atts):
                # In a bfloat16 model the product is cast to gamma's float32
                # first: JAX promotes bfloat16 x float32 to float32, where a
                # 0-dim float32 tensor would leave it bfloat16 here.
                acc = acc + self.gamma[i] * (att @ v).to(self.gamma.dtype)
            outs.append(acc.transpose(1, 2).reshape(B, C, H, W))
        return torch.cat(outs, dim=1)
