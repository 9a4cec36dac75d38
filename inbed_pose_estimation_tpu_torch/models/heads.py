"""Iterative-error-feedback (IEF) SMPL regression.

The pooled feature is concatenated with the current (pose6d, betas, cam)
estimate and refined additively n_iter times through
fc1 -> drop -> fc2 -> drop -> decpose / decshape / deccam.  The layers live
on the model itself under those reference names (`add_ief_layers`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NPOSE = 24 * 6


def add_ief_layers(module: nn.Module, feat_dim: int = 2048) -> None:
    """Register fc1, fc2, decpose, decshape and deccam on `module`."""
    module.fc1 = nn.Linear(feat_dim + NPOSE + 13, 1024)
    module.fc2 = nn.Linear(1024, 1024)
    module.decpose = nn.Linear(1024, NPOSE)
    module.decshape = nn.Linear(1024, 10)
    module.deccam = nn.Linear(1024, 3)
    for layer in (module.decpose, module.decshape, module.deccam):
        nn.init.xavier_uniform_(layer.weight, gain=0.01)


def ief_regress(module: nn.Module, xf, pose, shape, cam, n_iter: int = 3):
    """Run the IEF loop with `module`'s layers; dropout is active only in
    training mode.  Returns (pose6d [B,144], betas [B,10], cam [B,3])."""
    for _ in range(n_iter):
        xc = torch.cat([xf, pose, shape, cam], dim=1)
        xc = F.dropout(module.fc1(xc), 0.5, module.training)
        xc = F.dropout(module.fc2(xc), 0.5, module.training)
        pose = module.decpose(xc) + pose
        shape = module.decshape(xc) + shape
        cam = module.deccam(xc) + cam
    return pose, shape, cam
