"""HMRCore (ResNet-50 trunk + optional image-recovery decoders + IEF head)
and MultiTrunkCore (one trunk per modality, fused at x4).

HMRCore serves the concat-input family (hmr, hmr4mod, ..., cashmrV2,
cas3hmr) and is the shared encoder of the fusion family; MultiTrunkCore
serves featcat, featcat_cashmr, featatt_cashmr and
ir_depth_featatt_cashmrV2.  Parameters carry the reference state-dict names
(conv1, bn1, layer1..4, fc1, fc2, decpose, decshape, deccam,
Reconstruct_<head>.decDepth*, feat_extraction_<mod>.*, cross_att.*), which
`weights.flax_path` maps onto the JAX package's flax tree.

In a bfloat16 model (`layers.set_compute_dtype`) the trunk, decoders and
IEF compute in bfloat16 from the mean parameters cast to bfloat16, and the
outputs are cast to the parameters' float32 where JAX casts them: pose6d,
betas, cam and the recovered images (rotmat is computed from the float32
pose6d); the pyramid stays bfloat16.  With `remat_decoder` each decoder
call is checkpointed (`layers.checkpoint`), JAX's `nn.remat(Reconstruct)`:
the parameter names do not change.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..geometry import rot6d_to_rotmat
from .attention import CrossAttention
from .backbone import ResNet50Trunk
from .decoder import Reconstruct
from .heads import add_ief_layers, ief_regress
from .layers import checkpoint

# Batch key of a modality -> its name in the reference's parameter names.
TRUNK_NAME = {"img": "rgb", "ir_img": "ir", "depth_img": "depth", "pm_img": "pm"}
MODALITY_CHANNELS = {"img": 3, "ir_img": 1, "depth_img": 1, "pm_img": 1}


class HMROutput(NamedTuple):
    rotmat: torch.Tensor  # [B, 24, 3, 3]
    betas: torch.Tensor   # [B, 10]
    cam: torch.Tensor     # [B, 3] weak-perspective (s, tx, ty)
    pose6d: torch.Tensor  # [B, 144]
    recon: dict           # name -> [B, 1, H, W] recovered images
    pyramid: Optional[tuple] = None  # (x0..x4) when asked for


def _register_mean_params(module: nn.Module, mean_pose, mean_shape, mean_cam) -> None:
    """The IEF's starting point, the SMPL mean parameters, as buffers
    init_pose / init_shape / init_cam."""
    for name, value in (("init_pose", mean_pose), ("init_shape", mean_shape), ("init_cam", mean_cam)):
        module.register_buffer(name, torch.as_tensor(value, dtype=torch.float32).reshape(1, -1))


def _decode(module: nn.Module, pyramid) -> dict:
    """Each of `module`'s decoders on the (x0..x4) pyramid, checkpointed
    with `remat_decoder` (a decoder draws no dropout)."""
    recon = {}
    for head in module.recon_heads:
        dec = getattr(module, f"Reconstruct_{head}")
        recon[head] = checkpoint(dec, *pyramid) if module.remat_decoder else dec(*pyramid)
    return recon


def _regress(module: nn.Module, x4, recon, generator, init=None, pyramid=None) -> HMROutput:
    """Pool x4, run `module`'s IEF from `init` (pose6d, betas, cam) or from
    its mean parameters (in the compute dtype, as JAX casts them), and wrap
    the result, cast to the parameters' type."""
    batch = x4.shape[0]
    if init is None:
        init = (module.init_pose.expand(batch, -1), module.init_shape.expand(batch, -1),
                module.init_cam.expand(batch, -1))
        if module.compute_dtype is not None:
            init = tuple(t.to(module.compute_dtype) for t in init)
    xf = x4.mean(dim=(2, 3))  # global average pool == AvgPool2d(7) on 7x7 maps
    pose6d, betas, cam = ief_regress(module, xf, *init, module.n_iter, module.dropout_rate, generator)
    out_dtype = module.init_pose.dtype
    pose6d, betas, cam = pose6d.to(out_dtype), betas.to(out_dtype), cam.to(out_dtype)
    recon = {k: v.to(out_dtype) for k, v in recon.items()}
    rotmat = rot6d_to_rotmat(pose6d).reshape(batch, 24, 3, 3)
    return HMROutput(rotmat=rotmat, betas=betas, cam=cam, pose6d=pose6d, recon=recon, pyramid=pyramid)


class HMRCore(ResNet50Trunk):
    """Encoder + decoders named by `recon_heads` + IEF head.

    () is plain HMR; ("depth",) is rechmr / cashmr / cashmrV2;
    ("depth", "ir", "pm") is rec3hmr / cas3hmr.  In training mode the IEF
    head drops out at `dropout_rate`.
    """

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, mean_pose, mean_shape, mean_cam,
                 recon_heads: Sequence[str] = (), n_iter: int = 3, dropout_rate: float = 0.5,
                 remat_decoder: bool = False):
        super().__init__(in_channels)
        add_ief_layers(self, 2048)
        self.recon_heads = tuple(recon_heads)
        for head in self.recon_heads:
            self.add_module(f"Reconstruct_{head}", Reconstruct())
        self.n_iter = n_iter
        self.dropout_rate = dropout_rate
        self.remat_decoder = remat_decoder
        _register_mean_params(self, mean_pose, mean_shape, mean_cam)

    def forward(self, x, compute_recon: bool = True, generator=None, init=None,
                return_pyramid: bool = False) -> HMROutput:
        """x: [B, C, H, W].  `compute_recon=False` skips the decoders (their
        output is a discarded byproduct in the last cascade stage of eval).
        `init` (pose6d, betas, cam) warm-starts the IEF in place of the mean
        parameters; `return_pyramid` keeps (x0..x4) in the output.

        The mode is the module's: in training mode BatchNorm normalizes with
        the batch statistics and updates its running ones, and the IEF
        head's dropout masks come from `generator` (a torch.Generator on
        x's device; torch's default generator when None).
        """
        pyramid = self.pyramid(x)
        recon = _decode(self, pyramid) if compute_recon else {}
        return _regress(self, pyramid[4], recon, generator, init, pyramid if return_pyramid else None)


class MultiTrunkCore(nn.Module):
    """One ResNet-50 trunk per modality (`feat_extraction_<mod>`, in feed
    order), their x4 maps fused by concatenation or by `CrossAttention`
    (`cross_att`), decoders on the fused x4 with the skips of trunk
    `skip_trunk`, and the IEF head on the pooled 2048 * n features.

    featcat is 2 trunks without a decoder; featcat_cashmr 4 trunks and the
    depth decoder on the depth trunk's skips; featatt_cashmr the same with
    cross attention; ir_depth_featatt_cashmrV2 2 trunks (ir, depth), cross
    attention and the depth and ir decoders.  As in the JAX package, which
    departs from the reference here, each decoder's first level takes the
    fused x4's width (2048 * n) while its skips keep one trunk's widths: the
    reference's decoder expected fused skips too and would not have run.
    """

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, modalities: Sequence[str], mean_pose, mean_shape, mean_cam,
                 recon_heads: Sequence[str] = (), cross_attention: bool = False, skip_trunk: int = 2,
                 n_iter: int = 3, dropout_rate: float = 0.5, remat_decoder: bool = False):
        super().__init__()
        self.trunk_names = tuple(TRUNK_NAME[m] for m in modalities)
        n = len(self.trunk_names)
        for m, name in zip(modalities, self.trunk_names):
            self.add_module(f"feat_extraction_{name}", ResNet50Trunk(MODALITY_CHANNELS[m]))
        self.cross_att = CrossAttention(2048, n) if cross_attention else None
        self.skip_trunk = min(skip_trunk, n - 1)
        self.recon_heads = tuple(recon_heads)
        for head in self.recon_heads:
            self.add_module(f"Reconstruct_{head}", Reconstruct(2048 * n))
        add_ief_layers(self, 2048 * n)
        self.n_iter = n_iter
        self.dropout_rate = dropout_rate
        self.remat_decoder = remat_decoder
        _register_mean_params(self, mean_pose, mean_shape, mean_cam)

    def forward(self, inputs, compute_recon: bool = True, generator=None) -> HMROutput:
        """inputs: one [B, C, H, W] tensor per modality, in feed order; the
        rest as `HMRCore.forward`."""
        if len(inputs) != len(self.trunk_names):
            raise ValueError(f"{len(inputs)} inputs for the trunks {self.trunk_names}")
        pyramids = [getattr(self, f"feat_extraction_{name}").pyramid(x) for name, x in zip(self.trunk_names, inputs)]
        x4s = [p[4] for p in pyramids]
        x4 = self.cross_att(x4s) if self.cross_att is not None else torch.cat(x4s, dim=1)
        recon = _decode(self, pyramids[self.skip_trunk][:4] + (x4,)) if compute_recon else {}
        return _regress(self, x4, recon, generator)
