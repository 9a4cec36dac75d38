"""Skip-connected image-recovery decoder (depth / IR / PM heads), NCHW.

The plain forms of the reference ops: the upsampler is conv3x3 (n -> 4n)
-> PixelShuffle(2) -> BatchNorm2d(n), each level's skip join is
`cat((skip, h), 1)` -> 1x1 conv, and the projection is Conv2d(128, 1, 3).
"""

from __future__ import annotations

import torch
from torch import nn


class ResBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN with identity residual."""

    def __init__(self, n: int):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n, n, 3, padding=1, bias=False),
            nn.BatchNorm2d(n),
            nn.ReLU(inplace=True),
            nn.Conv2d(n, n, 3, padding=1, bias=False),
            nn.BatchNorm2d(n),
        )

    def forward(self, x):
        return self.body(x) + x


def upsampler(n: int) -> nn.Sequential:
    """conv3 (n -> 4n) + PixelShuffle(2) + BN(n): doubles the resolution."""
    return nn.Sequential(
        nn.Conv2d(n, 4 * n, 3, padding=1, bias=False),
        nn.PixelShuffle(2),
        nn.BatchNorm2d(n),
    )


def _level(cin: int, n: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, n, 1, bias=False), ResBlock(n), upsampler(n))


class Reconstruct(nn.Module):
    """(x0..x4) pyramid -> full-resolution 1-channel image.

    2048 -> 1024 -> 512 -> 256 -> 128 with the skip joined at each level,
    then two ResBlocks, a last upsampler and a 3x3 projection.
    """

    def __init__(self):
        super().__init__()
        self.decDepth1 = _level(2048, 1024)
        self.decDepth2 = _level(1024 * 2, 512)
        self.decDepth3 = _level(512 * 2, 256)
        self.decDepth4 = _level(256 * 2, 128)
        self.decDepth = nn.Sequential(
            nn.Conv2d(128 + 64, 128, 1, bias=False),
            ResBlock(128),
            ResBlock(128),
            upsampler(128),
            nn.Conv2d(128, 1, 3, padding=1, bias=False),
        )

    def forward(self, x0, x1, x2, x3, x4):
        h = self.decDepth1(x4)
        h = self.decDepth2(torch.cat((x3, h), 1))
        h = self.decDepth3(torch.cat((x2, h), 1))
        h = self.decDepth4(torch.cat((x1, h), 1))
        return self.decDepth(torch.cat((x0, h), 1))
