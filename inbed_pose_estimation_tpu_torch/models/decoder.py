"""Skip-connected image-recovery decoder (depth / IR / PM heads), NCHW.

The plain forms of the reference ops: the upsampler is conv3x3 (n -> 4n)
-> PixelShuffle(2) -> BatchNorm2d(n), each level's skip join is
`cat((skip, h), 1)` -> 1x1 conv, and the projection is Conv2d(128, 1, 3).

The last stage, PixelShuffle -> BatchNorm -> projection, runs as one CUDA
kernel (`ops/shuffle_project.py`) from the last upsampler convolution's
output where `fused_route` allows it: float32 on the card, without
autograd, BatchNorm on its running statistics.  It gives the modules'
output bit for bit there.  The fusion family's recovery decoders end the
same way without the BatchNorm.  The modules and their parameter names
stay; whatever runs under autograd, recompute and bfloat16 run them (the
frozen fusion guide, which runs without autograd, takes the kernel in a
training step too).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.shuffle_project import batch_norm_terms, shuffle_project
from ..utils.profiling import span
from .backbone import BatchNorm2d, fused_route
from .layers import Conv2d


def project_shuffled(h, shuffle: nn.PixelShuffle, proj: Conv2d, bn=None):
    """proj(bn(shuffle(h))) from the pre-shuffle map h (no bn when None):
    one kernel launch on the fused route, the modules otherwise."""
    if fused_route(h, [proj], [] if bn is None else [bn]):
        with span("ops.shuffle_project"):
            return shuffle_project(h, proj.weight, None if bn is None else batch_norm_terms(bn), proj.bias)
    h = shuffle(h)
    return proj(h if bn is None else bn(h))


class ResBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN with identity residual."""

    def __init__(self, n: int):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(n, n, 3, padding=1, bias=False),
            BatchNorm2d(n),
            nn.ReLU(inplace=True),
            Conv2d(n, n, 3, padding=1, bias=False),
            BatchNorm2d(n),
        )

    def forward(self, x):
        return self.body(x) + x


def upsampler(n: int) -> nn.Sequential:
    """conv3 (n -> 4n) + PixelShuffle(2) + BN(n): doubles the resolution."""
    return nn.Sequential(
        Conv2d(n, 4 * n, 3, padding=1, bias=False),
        nn.PixelShuffle(2),
        BatchNorm2d(n),
    )


def _level(cin: int, n: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(cin, n, 1, bias=False), ResBlock(n), upsampler(n))


class Reconstruct(nn.Module):
    """(x0..x4) pyramid -> full-resolution 1-channel image.

    x4 (`in_features` wide: 2048, or 2048 per trunk when the multi-trunk
    models fuse their x4 maps) -> 1024 -> 512 -> 256 -> 128 with the
    single-trunk skip joined at each level, then two ResBlocks, a last
    upsampler and a 3x3 projection.
    """

    def __init__(self, in_features: int = 2048):
        super().__init__()
        self.decDepth1 = _level(in_features, 1024)
        self.decDepth2 = _level(1024 * 2, 512)
        self.decDepth3 = _level(512 * 2, 256)
        self.decDepth4 = _level(256 * 2, 128)
        self.decDepth = nn.Sequential(
            Conv2d(128 + 64, 128, 1, bias=False),
            ResBlock(128),
            ResBlock(128),
            upsampler(128),
            Conv2d(128, 1, 3, padding=1, bias=False),
        )

    def forward(self, x0, x1, x2, x3, x4):
        h = self.decDepth1(x4)
        h = self.decDepth2(torch.cat((x3, h), 1))
        h = self.decDepth3(torch.cat((x2, h), 1))
        h = self.decDepth4(torch.cat((x1, h), 1))
        join, res1, res2, (up, shuffle, bn), proj = self.decDepth
        return project_shuffled(up(res2(res1(join(torch.cat((x0, h), 1))))), shuffle, proj, bn)
