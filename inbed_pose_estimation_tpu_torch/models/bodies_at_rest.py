"""Bodies-At-Rest: a tanh CNN over the pressure map (bodiesAtRest) or the
four modalities (bodiesAtRest4mod), stacked with the contact and edge
channels, and direct pose / shape / camera decoders.

The port of the JAX package's `models/bodies_at_rest.py`, with the
reference's parameter names:
  * `CNN_packtanh` (Sequential: conv7 s2 pad 3, tanh, dropout, maxpool 3 s2 at
    indices 0-3; conv3 s2 at 4; conv3 at 7; conv3 s2 at 10; each conv
    followed by tanh and dropout 0.1; no BatchNorm, no padding after the
    first conv), then flatten;
  * `CNN_fc1.0`, a Linear to 1024, then `decpose`, `decshape` and `deccam`
    (xavier-uniform at gain 0.01), applied once, with no iteration;
  * the same again suffixed `_mode2` for the refinement stack, whose input
    has one more channel (the estimated body map).

Modes: "0" regresses from the first stack; "1" is "0" with every output
detached (the step after `--mod1_epoch`); "2" regresses from the second
stack.  The second stack exists only with `with_mode2`, as in the JAX
package, whose eval builds it for bodiesAtRest4mod alone and whose trainer
never builds it.

Where the port departs from the JAX package: it flattens the last feature
map NCHW, channel-major, as the reference class did, where flax flattens
NHWC.  `CNN_fc1`'s input rows are therefore in (c, h, w) order here and in
(h, w, c) order in a flax kernel; `weights.py` permutes them both ways.
fc1's input width depends on the resolution (384 * 12 * 12 = 55296 at
224², 384 * 2 * 2 = 1536 at 64²): flax infers it, here it is computed from
`img_res`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry import rot6d_to_rotmat
from .heads import NPOSE, dropout
from .hmr import HMROutput

WIDTHS = (192, 192, 384, 384)


def stack_hw(img_res: int) -> int:
    """Side of the tanh stack's last feature map for a square input."""
    h = (img_res + 2 * 3 - 7) // 2 + 1  # conv7 s2 pad 3
    h = (h - 3) // 2 + 1                # maxpool 3 s2
    h = (h - 3) // 2 + 1                # conv3 s2
    h = h - 2                           # conv3
    return (h - 3) // 2 + 1             # conv3 s2


class _Dropout(nn.Module):
    """A place in the Sequential for dropout, whose masks come from the
    caller's generator (`heads.dropout`)."""


class _TanhStack(nn.Sequential):
    def __init__(self, in_channels: int):
        c0, c1, c2, c3 = WIDTHS
        super().__init__(
            nn.Conv2d(in_channels, c0, 7, stride=2, padding=3), nn.Tanh(), _Dropout(), nn.MaxPool2d(3, stride=2),
            nn.Conv2d(c0, c1, 3, stride=2), nn.Tanh(), _Dropout(),
            nn.Conv2d(c1, c2, 3), nn.Tanh(), _Dropout(),
            nn.Conv2d(c2, c3, 3, stride=2), nn.Tanh(), _Dropout(),
        )

    def forward(self, x, rate: float = 0.0, generator=None):
        for layer in self:
            x = dropout(x, rate, generator) if isinstance(layer, _Dropout) else layer(x)
        return x.flatten(1)  # NCHW: channel-major


class BodiesAtRest(nn.Module):
    """The tanh stack and direct head of mode 1 (and of mode 2 with
    `with_mode2`) for `in_channels` input channels at `img_res`²; in
    training mode the stack drops out at `dropout_rate`."""

    def __init__(self, in_channels: int, img_res: int, with_mode2: bool = False, dropout_rate: float = 0.1):
        super().__init__()
        side = stack_hw(img_res)
        self.fc1_chw = (WIDTHS[-1], side, side)
        self.with_mode2 = with_mode2
        self.dropout_rate = dropout_rate
        for suffix, channels in (("", in_channels), ("_mode2", in_channels + 1))[:2 if with_mode2 else 1]:
            self.add_module(f"CNN_packtanh{suffix}", _TanhStack(channels))
            self.add_module(f"CNN_fc1{suffix}", nn.Sequential(nn.Linear(WIDTHS[-1] * side * side, 1024)))
            for name, width in (("decpose", NPOSE), ("decshape", 10), ("deccam", 3)):
                layer = nn.Linear(1024, width)
                nn.init.xavier_uniform_(layer.weight, gain=0.01)
                self.add_module(f"{name}{suffix}", layer)

    def forward(self, x, mode: str = "0", generator=None) -> HMROutput:
        """x: [B, C, H, W], the modalities and the contact channels (and,
        in mode "2", the estimated body map last).  Dropout masks come from
        `generator` in training mode."""
        if mode not in ("0", "1", "2"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "2" and not self.with_mode2:
            raise ValueError("mode '2' needs the refinement stack: build the model with with_mode2")
        suffix = "_mode2" if mode == "2" else ""
        rate = self.dropout_rate if self.training else 0.0
        feats = getattr(self, f"CNN_packtanh{suffix}")(x, rate, generator)
        scores = getattr(self, f"CNN_fc1{suffix}")(feats)
        pose, shape, cam = (getattr(self, f"{name}{suffix}")(scores) for name in ("decpose", "decshape", "deccam"))
        if mode == "1":
            pose, shape, cam = pose.detach(), shape.detach(), cam.detach()
        rotmat = rot6d_to_rotmat(pose).reshape(x.shape[0], 24, 3, 3)
        return HMROutput(rotmat=rotmat, betas=shape, cam=cam, pose6d=pose, recon={})
