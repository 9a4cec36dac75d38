"""ResNet-50 feature trunk, NCHW, with the reference's parameter names."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) residual block, optional projection."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, project: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if project:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * 4),
            )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + residual)


def _stage(inplanes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    layers = [Bottleneck(inplanes, planes, stride, project=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50Trunk(nn.Module):
    """Stem + 4 stages; `pyramid(x)` returns the (x0..x4) skip pyramid.

    x0 is the stem conv output *before* BN, as the reference decoders take
    it.  For a 224 input: x0 64x112^2, x1 256x56^2, x2 512x28^2,
    x3 1024x14^2, x4 2048x7^2.  Model classes subclass the trunk so that its
    parameters sit at the top level under the reference names (conv1, bn1,
    layer1..4).
    """

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = _stage(64, 64, 3, 1)
        self.layer2 = _stage(256, 128, 4, 2)
        self.layer3 = _stage(512, 256, 6, 2)
        self.layer4 = _stage(1024, 512, 3, 2)

    def pyramid(self, x):
        x0 = self.conv1(x)
        h = F.max_pool2d(F.relu(self.bn1(x0)), 3, stride=2, padding=1)
        x1 = self.layer1(h)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        return x0, x1, x2, x3, x4

    def forward(self, x):
        return self.pyramid(x)
