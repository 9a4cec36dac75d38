"""Two-stage fusion models with mask-gated appearance recovery, NCHW.

`TwoStageFusion` (ir_depth_fusion, ir_pm_fusion, rgb_depth_fusion,
rgb_pm_fusion):
  stage 1  the shared encoder `encoder_1` (an HMRCore without decoders)
           regresses SMPL from the concatenated covered inputs;
  mask     the stage-1 mesh, detached, through `lbs` (the skinning kernel)
           and K2 (`ops/mask_raster.py`) into a body mask, clipped to [0, 1];
  recover  one small decoder per recovered modality turns the mask-gated
           input, the upsampled x4 (`dec1`) and the stem's x0 into that
           modality's uncovered appearance;
  stage 2  the same encoder, from the mean parameters, on the inputs with
           the recovered images in their slots.

`FrozenGuidedFusion` (ir_depth_pm_fusion, ir_depth_pm_rgb_fusion): a frozen
ir_depth_fusion, `guide`, runs on (ir, depth) in eval mode without
autograd; its recovered ir and depth lead the inputs of a second
TwoStageFusion, `main` ([ir_rec, depth_rec, pm, ir, depth], 5 channels, or
[ir_rec, depth_rec, pm, rgb], 6 channels, with rgb), whose stage-1 IEF
starts from the guide's stage-2 pose, shape and camera.  The rgb variant
follows the JAX package, which builds the reference class's evident intent
(its torch class could not run).

Parameter names are the reference's: encoder_1.*, dec1.{0,2,4,6} (the
upsampler's convs), dec{IR,Depth,PM}2 (strided conv, ResBlock) and
dec{IR,Depth,PM}3 (conv, ResBlock, PixelShuffle, projection).  The frozen
pipelines nest two such trees as guide.* and main.*; `weights.flax_path`
maps them onto the flax tree's guide/ and main/.

In a bfloat16 model the stages' outputs are float32 (HMRCore casts them),
so the body mask is made in float32 and the skinning kernel takes float32;
the recovered images leave their decoders in bfloat16, as in JAX, and the
inputs of stage 2 are concatenated in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..ops.mask_raster import render_body_mask
from ..smpl.model import SMPLModel, lbs
from .decoder import ResBlock
from .hmr import HMRCore, HMROutput
from .layers import Conv2d

# Recovered modality -> the infix of its reference parameter names.
HEAD_NAME = {"ir": "IR", "depth": "Depth", "pm": "PM"}


class FusionOutput(NamedTuple):
    stage1: HMROutput
    stage2: HMROutput
    recovered: dict       # modality -> [B, 1, H, W] uncovered-appearance image
    mask: torch.Tensor    # [B, 1, H, W]


def _feat_up() -> nn.Sequential:
    """x4 (2048 x 7^2) -> 128 x 112^2: four conv3x3 (-> 512) + PixelShuffle(2)."""
    layers = []
    for i in range(4):
        layers += [Conv2d(2048 if i == 0 else 128, 128 * 4, 3, padding=1), nn.PixelShuffle(2)]
    return nn.Sequential(*layers)


class TwoStageFusion(nn.Module):
    """The generic N-modality two-stage fusion regressor.

    `slot_channels` are the input modalities' channels in feed order;
    `recover_heads` name the recovered modalities and `recover_slots` the
    input slot each one gates and replaces.
    """

    def __init__(self, slot_channels: Sequence[int], mean_pose, mean_shape, mean_cam,
                 recover_heads: Sequence[str] = ("ir", "depth"), recover_slots: Sequence[int] = (0, 1),
                 n_iter: int = 3, dropout_rate: float = 0.5):
        super().__init__()
        self.encoder_1 = HMRCore(sum(slot_channels), mean_pose, mean_shape, mean_cam, n_iter=n_iter,
                                 dropout_rate=dropout_rate)
        self.dec1 = _feat_up()
        self.slot_of = dict(zip(recover_heads, recover_slots))
        for head, slot in self.slot_of.items():
            name = HEAD_NAME[head]
            self.add_module(f"dec{name}2", nn.Sequential(
                Conv2d(slot_channels[slot], 64, 3, stride=2, padding=1), ResBlock(64)))
            self.add_module(f"dec{name}3", nn.Sequential(
                Conv2d(128 + 64 + 64, 64 * 4, 3, padding=1), ResBlock(256), nn.PixelShuffle(2),
                Conv2d(64, 1, 3, padding=1)))

    def forward(self, inputs, smpl_model: SMPLModel, generator=None, init=None) -> FusionOutput:
        """inputs: one [B, C, H, W] tensor per slot.  `init` (pose6d, betas,
        cam) warm-starts stage 1's IEF; `generator` draws the IEF's dropout
        masks in training mode (see HMRCore.forward)."""
        H = inputs[0].shape[2]
        out1 = self.encoder_1(torch.cat(list(inputs), dim=1), generator=generator, init=init, return_pyramid=True)
        x0, x4 = out1.pyramid[0], out1.pyramid[4]
        out1 = out1._replace(pyramid=None)

        # The body mask from the stage-1 estimate, outside autograd.
        with torch.no_grad():
            verts, _ = lbs(smpl_model, out1.betas.detach(), out1.rotmat.detach())
            mask = render_body_mask(verts, out1.cam.detach(), img_res=H).clamp(0.0, 1.0)

        feat_up = self.dec1(x4)
        recovered = {}
        for head, slot in self.slot_of.items():
            name = HEAD_NAME[head]
            h = getattr(self, f"dec{name}2")(inputs[slot] * mask)
            recovered[head] = getattr(self, f"dec{name}3")(torch.cat([feat_up, h, x0], dim=1))

        head_of_slot = {s: h for h, s in self.slot_of.items()}
        stage2_in = [recovered[head_of_slot[i]] if i in head_of_slot else x for i, x in enumerate(inputs)]
        out2 = self.encoder_1(torch.cat(stage2_in, dim=1), generator=generator)
        return FusionOutput(stage1=out1, stage2=out2, recovered=recovered, mask=mask)


class FrozenGuidedFusion(nn.Module):
    """The ir_depth_pm_fusion / ir_depth_pm_rgb_fusion pipelines: a frozen
    ir_depth_fusion `guide` feeding a 5- or 6-channel TwoStageFusion `main`.

    The guide's parameters do not require gradients (the optimizer takes
    only `main`'s), it stays in eval mode whatever mode the pipeline is put
    in (BatchNorm on its running statistics, no dropout, statistics never
    updated), and it runs without autograd.  Its weights come from
    `--pretrained_fusion_checkpoint`.
    """

    def __init__(self, mean_pose, mean_shape, mean_cam, with_rgb: bool = False, n_iter: int = 3,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.with_rgb = with_rgb
        self.guide = TwoStageFusion((1, 1), mean_pose, mean_shape, mean_cam, n_iter=n_iter, dropout_rate=dropout_rate)
        self.main = TwoStageFusion((1, 1, 1, 3) if with_rgb else (1, 1, 1, 1, 1), mean_pose, mean_shape, mean_cam,
                                   n_iter=n_iter, dropout_rate=dropout_rate)
        self.guide.requires_grad_(False)
        self.guide.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        self.guide.eval()
        return self

    def forward(self, inputs, smpl_model: SMPLModel, generator=None) -> FusionOutput:
        """inputs: (ir, depth, pm), or (ir, depth, pm, rgb) with rgb."""
        ir, depth, pm = inputs[0], inputs[1], inputs[2]
        with torch.no_grad():
            g = self.guide((ir, depth), smpl_model)
        rec_ir, rec_depth = g.recovered["ir"], g.recovered["depth"]
        main_in = (rec_ir, rec_depth, pm, inputs[3]) if self.with_rgb else (rec_ir, rec_depth, pm, ir, depth)
        return self.main(main_in, smpl_model, generator=generator,
                         init=(g.stage2.pose6d, g.stage2.betas, g.stage2.cam))
