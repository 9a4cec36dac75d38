"""Iterative-error-feedback (IEF) SMPL regression.

The pooled feature is concatenated with the current (pose6d, betas, cam)
estimate and refined additively n_iter times through
fc1 -> drop -> fc2 -> drop -> decpose / decshape / deccam.  The layers live
on the model itself under those reference names (`add_ief_layers`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import mesh
from .layers import Linear

NPOSE = 24 * 6


def add_ief_layers(module: nn.Module, feat_dim: int = 2048) -> None:
    """Register fc1, fc2, decpose, decshape and deccam on `module`."""
    module.fc1 = Linear(feat_dim + NPOSE + 13, 1024)
    module.fc2 = Linear(1024, 1024)
    module.decpose = Linear(1024, NPOSE)
    module.decshape = Linear(1024, 10)
    module.deccam = Linear(1024, 3)
    for layer in (module.decpose, module.decshape, module.deccam):
        nn.init.xavier_uniform_(layer.weight, gain=0.01)


def dropout(x, rate: float, generator=None):
    """Inverted dropout with the mask drawn from `generator` (torch's
    default generator when None): x / (1 - rate) where kept, else 0.  The
    mask is drawn in float32 whatever x's type, so a bfloat16 model draws
    the masks of a float32 one.

    Under data parallel (`parallel.mesh`) x holds this rank's rows of the
    global batch: the mask of the whole global batch is drawn, as flax
    draws it from one key, and this rank keeps its rows.  The generators of
    all ranks then stay in lockstep, and the ranks together draw the masks
    of one process."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    w = mesh.world_size()
    shape = (x.shape[0] * w,) + tuple(x.shape[1:])
    mask = torch.empty(shape, dtype=torch.float32, device=x.device).bernoulli_(keep, generator=generator)
    if w > 1:
        mask = mask[mesh.local_rows(shape[0])]
    return x * mask.to(x.dtype) / keep


def ief_regress(module: nn.Module, xf, pose, shape, cam, n_iter: int = 3, dropout_rate: float = 0.5,
                generator=None):
    """Run the IEF loop with `module`'s layers; dropout (at `dropout_rate`,
    masks from `generator`) is active only in training mode.  Returns
    (pose6d [B,144], betas [B,10], cam [B,3])."""
    rate = dropout_rate if module.training else 0.0
    for _ in range(n_iter):
        xc = torch.cat([xf, pose, shape, cam], dim=1)
        xc = dropout(module.fc1(xc), rate, generator)
        xc = dropout(module.fc2(xc), rate, generator)
        pose = module.decpose(xc) + pose
        shape = module.decshape(xc) + shape
        cam = module.deccam(xc) + cam
    return pose, shape, cam
