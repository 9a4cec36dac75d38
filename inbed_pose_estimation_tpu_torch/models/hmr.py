"""HMRCore: ResNet-50 trunk + optional image-recovery decoders + IEF head.

Serves the concat-input family (hmr, hmr4mod, ..., cashmrV2, cas3hmr).
Parameters carry the reference state-dict names (conv1, bn1, layer1..4,
fc1, fc2, decpose, decshape, deccam, Reconstruct_<head>.decDepth*), so the
JAX package's `convert_torch_state_dict` reads `state_dict()` directly.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..geometry import rot6d_to_rotmat
from .backbone import ResNet50Trunk
from .decoder import Reconstruct
from .heads import add_ief_layers, ief_regress


class HMROutput(NamedTuple):
    rotmat: torch.Tensor  # [B, 24, 3, 3]
    betas: torch.Tensor   # [B, 10]
    cam: torch.Tensor     # [B, 3] weak-perspective (s, tx, ty)
    pose6d: torch.Tensor  # [B, 144]
    recon: dict           # name -> [B, 1, H, W] recovered images


class HMRCore(ResNet50Trunk):
    """Encoder + decoders named by `recon_heads` + IEF head.

    () is plain HMR; ("depth",) is rechmr / cashmr / cashmrV2;
    ("depth", "ir", "pm") is rec3hmr / cas3hmr.  The IEF starts from the
    SMPL mean parameters, held as buffers init_pose / init_shape / init_cam.
    """

    def __init__(self, in_channels: int, mean_pose, mean_shape, mean_cam,
                 recon_heads: Sequence[str] = (), n_iter: int = 3):
        super().__init__(in_channels)
        add_ief_layers(self, 2048)
        self.recon_heads = tuple(recon_heads)
        for head in self.recon_heads:
            self.add_module(f"Reconstruct_{head}", Reconstruct())
        self.n_iter = n_iter
        for name, value in (("init_pose", mean_pose), ("init_shape", mean_shape), ("init_cam", mean_cam)):
            self.register_buffer(name, torch.as_tensor(value, dtype=torch.float32).reshape(1, -1))

    def forward(self, x, compute_recon: bool = True) -> HMROutput:
        """x: [B, C, H, W].  `compute_recon=False` skips the decoders (their
        output is a discarded byproduct in the last cascade stage of eval)."""
        batch = x.shape[0]
        pose = self.init_pose.expand(batch, -1)
        shape = self.init_shape.expand(batch, -1)
        cam = self.init_cam.expand(batch, -1)

        x0, x1, x2, x3, x4 = self.pyramid(x)
        recon = {}
        if compute_recon:
            for head in self.recon_heads:
                recon[head] = getattr(self, f"Reconstruct_{head}")(x0, x1, x2, x3, x4)

        xf = x4.mean(dim=(2, 3))  # global average pool == AvgPool2d(7) on 7x7 maps
        pose6d, betas, cam = ief_regress(self, xf, pose, shape, cam, self.n_iter)
        rotmat = rot6d_to_rotmat(pose6d).reshape(batch, 24, 3, 3)
        return HMROutput(rotmat=rotmat, betas=betas, cam=cam, pose6d=pose6d, recon=recon)
