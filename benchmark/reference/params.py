"""The parameters of the blocks of the benchmark's architectures: names,
shapes and how each is drawn (an architecture's `params(config)` joins
them).

Names follow the reference repository's state-dict names (conv1, bn1,
layer1..4, Reconstruct_depth.decDepth*, fc1, fc2, decpose, decshape,
deccam, encoder_1, dec1, dec{IR,Depth}{2,3}, guide., main.), so one dict of
tensors feeds the plain reference in this package and the program under
test alike.  Each entry is (name, shape, kind, fan_in); `kind` tells
`benchmark.weights` how to scale its draw.
"""

from __future__ import annotations

NPOSE = 24 * 6
IEF_IN_EXTRA = NPOSE + 10 + 3


def conv(name, cout, cin, k, bias=False):
    fan_in = cin * k * k
    out = [(f"{name}.weight", (cout, cin, k, k), "conv", fan_in)]
    if bias:
        out.append((f"{name}.bias", (cout,), "bias", fan_in))
    return out


def bn(name, c):
    return [(f"{name}.weight", (c,), "bn_weight", c), (f"{name}.bias", (c,), "bn_bias", c),
            (f"{name}.running_mean", (c,), "bn_mean", c), (f"{name}.running_var", (c,), "bn_var", c),
            (f"{name}.num_batches_tracked", (), "count", 0)]


def linear(name, cout, cin, kind="linear"):
    return [(f"{name}.weight", (cout, cin), kind, cin), (f"{name}.bias", (cout,), "bias", cin)]


def resblock(name, n):
    return conv(f"{name}.body.0", n, n, 3) + bn(f"{name}.body.1", n) + conv(f"{name}.body.3", n, n, 3) \
        + bn(f"{name}.body.4", n)


def upsampler(name, n):
    return conv(f"{name}.0", 4 * n, n, 3) + bn(f"{name}.2", n)


def bottleneck(name, inplanes, planes, project):
    out = conv(f"{name}.conv1", planes, inplanes, 1) + bn(f"{name}.bn1", planes)
    out += conv(f"{name}.conv2", planes, planes, 3) + bn(f"{name}.bn2", planes)
    out += conv(f"{name}.conv3", planes * 4, planes, 1) + bn(f"{name}.bn3", planes * 4)
    if project:
        out += conv(f"{name}.downsample.0", planes * 4, inplanes, 1) + bn(f"{name}.downsample.1", planes * 4)
    return out


# ResNet-50: (planes, blocks, stride) of layer1..4.
RESNET50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def resnet50(prefix, in_channels):
    out = conv(f"{prefix}conv1", 64, in_channels, 7) + bn(f"{prefix}bn1", 64)
    inplanes = 64
    for i, (planes, blocks, _) in enumerate(RESNET50_STAGES, start=1):
        for b in range(blocks):
            out += bottleneck(f"{prefix}layer{i}.{b}", inplanes if b == 0 else planes * 4, planes, b == 0)
        inplanes = planes * 4
    return out


# The depth decoder's levels: (input width, level width) after x4.
DECODER_LEVELS = ((None, 1024), (2048, 512), (1024, 256), (512, 128))


def reconstruct(prefix, in_features=2048):
    out = []
    for i, (cin, n) in enumerate(DECODER_LEVELS, start=1):
        level = f"{prefix}decDepth{i}"
        out += conv(f"{level}.0", n, in_features if cin is None else cin, 1) + resblock(f"{level}.1", n) \
            + upsampler(f"{level}.2", n)
    out += conv(f"{prefix}decDepth.0", 128, 128 + 64, 1) + resblock(f"{prefix}decDepth.1", 128)
    out += resblock(f"{prefix}decDepth.2", 128) + upsampler(f"{prefix}decDepth.3", 128)
    out += conv(f"{prefix}decDepth.4", 1, 128, 3)
    return out


def ief(prefix, feat_dim=2048):
    return (linear(f"{prefix}fc1", 1024, feat_dim + IEF_IN_EXTRA) + linear(f"{prefix}fc2", 1024, 1024)
            + linear(f"{prefix}decpose", NPOSE, 1024, "head") + linear(f"{prefix}decshape", 10, 1024, "head")
            + linear(f"{prefix}deccam", 3, 1024, "head"))


def mean_params(prefix):
    return [(f"{prefix}init_pose", (1, NPOSE), "init_pose", 0), (f"{prefix}init_shape", (1, 10), "init_shape", 0),
            (f"{prefix}init_cam", (1, 3), "init_cam", 0)]


def hmr_core(prefix, in_channels, recon_heads):
    out = resnet50(prefix, in_channels) + ief(prefix)
    for head in recon_heads:
        out += reconstruct(f"{prefix}Reconstruct_{head}.")
    return out + mean_params(prefix)


HEAD_NAME = {"ir": "IR", "depth": "Depth", "pm": "PM"}


def two_stage_fusion(prefix, slot_channels, recover):
    """recover: ((head, slot), ...)."""
    out = hmr_core(f"{prefix}encoder_1.", sum(slot_channels), ())
    for i in range(4):
        out += conv(f"{prefix}dec1.{2 * i}", 512, 2048 if i == 0 else 128, 3, bias=True)
    for head, slot in recover:
        name = HEAD_NAME[head]
        out += conv(f"{prefix}dec{name}2.0", 64, slot_channels[slot], 3, bias=True) + resblock(f"{prefix}dec{name}2.1", 64)
        out += conv(f"{prefix}dec{name}3.0", 256, 128 + 64 + 64, 3, bias=True) + resblock(f"{prefix}dec{name}3.1", 256)
        out += conv(f"{prefix}dec{name}3.3", 1, 64, 3, bias=True)
    return out

