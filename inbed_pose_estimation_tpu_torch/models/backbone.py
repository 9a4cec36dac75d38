"""ResNet-50 feature trunk, NCHW, with the reference's parameter names,
and the BatchNorm2d that the port's models use.

In a bfloat16 model (`layers.set_compute_dtype`) the convolutions compute in
bfloat16 and BatchNorm2d takes their bfloat16 output with its float32
weights and statistics: it normalizes in float32 and returns bfloat16, as
flax's `BatchNorm(dtype=)` does.

Under data parallel (a process group, `parallel.mesh`) BatchNorm is global,
as in the JAX package, whose jitted step sees the whole sharded batch: a
training BatchNorm2d takes its statistics over every rank's rows, so that
a step's numbers do not depend on the number of ranks.  torch's
`SyncBatchNorm` is not used: it refuses CPU tensors, and it updates the
running variance with the unbiased variance, which flax does not.  The
step's other global semantics (masked counts, dropout masks, the
replicated fits) and the one departure from JAX (a raise where JAX idles
devices that do not divide the batch) are set out in `parallel.mesh`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .layers import Conv2d, collective, recomputing


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm2d whose train-mode update of `running_var` uses the
    biased batch variance, as flax's BatchNorm does.

    Normalization and `running_mean` are torch's own (momentum 0.1 here is
    flax's 0.9).  torch's fused kernel folds the unbiased variance
    var * n / (n - 1) into the running variance it is given; it is given a
    copy r1 of the old value r0, and with m the momentum

        (1 - m) r0 + m var  =  r1 (n - 1) / n + r0 (1 - m) / n

    is written into `running_var` afterwards, without another pass over
    the activations.  (autograd keeps the copy it was given, so writing
    `running_var` in place does not disturb the backward pass.)  The
    state-dict names are torch's.  In the backward pass's recompute of a
    `layers.checkpoint`ed call it normalizes with the batch statistics and
    updates nothing.

    In a process group (`parallel.mesh`) a training layer takes global
    statistics instead (`_global_forward`).
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if mesh.is_initialized():
            return self._global_forward(x)
        if recomputing():  # statistics to update that are thrown away
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(), self.weight, self.bias,
                                True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        self.num_batches_tracked.add_(1)
        running_var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, running_var, self.weight, self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(running_var, alpha=(n - 1) / n)
        return out

    def _global_forward(self, x):
        """Batch normalization over the rows of every rank, as flax's
        `BatchNorm(use_fast_variance=False)` over the whole sharded batch:
        the per-channel sums and the row count in one all-reduce, the mean,
        then the biased variance mean((x - mean)^2) two-pass in a second.
        Both all-reduces are differentiable (their backward sums the ranks'
        gradients), and the recompute of a `layers.checkpoint`ed call takes
        the forward's sums back instead of issuing them again.  Statistics
        are reduced in float32 whatever x's type, and the running
        statistics take the global mean and biased variance with flax's
        momentum."""
        c = x.shape[1]
        xf = x.float()
        dims = (0, 2, 3)
        count = xf.new_full((1,), xf.numel() // c)
        sums = collective(mesh.all_reduce_sum, torch.cat([xf.sum(dims), count]))
        n = sums[c]
        mean = sums[:c] / n
        d = xf - mean[None, :, None, None]
        var = collective(mesh.all_reduce_sum, (d * d).sum(dims)) / n
        out = d * (torch.rsqrt(var + self.eps) * self.weight)[None, :, None, None] + self.bias[None, :, None, None]
        if not recomputing():
            m = self.momentum
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        return out.to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) residual block, optional projection."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, project: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = None
        if project:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                BatchNorm2d(planes * 4),
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
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
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
