"""The store of best SMPL fits: one [N, 82] tensor (72 axis-angle pose +
10 betas per sample) on the device, read and written by index inside the
train step.

Read:  pose' = flip(rotate(pose, rot), is_flipped)   (the batch's augmentation)
Write: pose' = rotate(flip(pose, is_flipped), -rot)  (undone), only where `update`.

`FitsStore` seeds the tensor from `<name>_fits.npy` files (a checkpoint
directory first, then the static fits) and saves it in the same layout.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from .. import constants
from ..device import constant, resolve_device
from ..geometry import aa_rotate_z, flip_pose
from ..parallel import mesh


def _flip_where(pose, is_flipped):
    perm = constant(tuple(constants.SMPL_POSE_FLIP_PERM), torch.int64, pose.device)
    return torch.where(is_flipped[:, None] > 0, flip_pose(pose, perm), pose)


def _rotate(pose, rot_deg):
    return torch.cat([aa_rotate_z(pose[:, :3], rot_deg), pose[:, 3:]], dim=1)


def fits_get(fits, indices, rot, is_flipped) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the fits [N, 82] of samples `indices` [B] under the batch's
    rotation rot [B] (degrees) and flip is_flipped [B].  Returns
    (pose [B, 72], betas [B, 10])."""
    params = fits[indices]
    return _flip_where(_rotate(params[:, :72], rot), is_flipped), params[:, 72:]


def fits_set(fits, indices, rot, is_flipped, update, pose, betas) -> torch.Tensor:
    """A new store: `fits` with rows `indices` replaced by (pose, betas),
    augmentation undone, where update [B] > 0."""
    new_params = torch.cat([_rotate(_flip_where(pose, is_flipped), -rot), betas], dim=1)
    merged = torch.where(update[:, None] > 0, new_params, fits[indices])
    return fits.index_copy(0, indices, merged)


class FitsStore:
    """The fits tensor of one dataset or of a mixture: `layout` is
    [(name, size), ...] (or one name and `num_samples`), each dataset a
    contiguous block from `offsets[name]`, persisted as one
    `<name>_fits.npy` per dataset."""

    def __init__(self, dataset_name, num_samples: int | None = None, checkpoint_dir: str | None = None,
                 static_fits_dir: str | None = None, device: str | torch.device = "cuda"):
        if isinstance(dataset_name, str):
            layout = [(dataset_name, int(num_samples))]
        else:
            layout = [(n, int(s)) for n, s in dataset_name]
        self.layout = layout
        self.dataset_name = layout[0][0]
        self.checkpoint_dir = checkpoint_dir
        self.offsets = {}
        blocks = []
        total = 0
        for name, size in layout:
            self.offsets[name] = total
            arr = None
            for d in (checkpoint_dir, static_fits_dir):
                path = os.path.join(d, f"{name}_fits.npy") if d else None
                if path and os.path.exists(path):
                    arr = np.load(path)
                    break
            if arr is None:
                arr = np.zeros((size, 82), np.float32)
            if arr.shape[0] != size:
                raise ValueError(f"fits store for {name} has {arr.shape[0]} rows, dataset has {size}")
            blocks.append(arr.astype(np.float32))
            total += size
        self.array = torch.as_tensor(np.concatenate(blocks, axis=0), device=resolve_device(device))

    @property
    def num_rows(self) -> int:
        return sum(s for _, s in self.layout)

    def save(self):
        """Write the store into the checkpoint directory; under data
        parallel rank 0 writes its replica and every rank waits for it."""
        if self.checkpoint_dir and mesh.rank() == 0:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            full = self.array.cpu().numpy()
            for name, size in self.layout:
                off = self.offsets[name]
                np.save(os.path.join(self.checkpoint_dir, f"{name}_fits.npy"), full[off:off + size])
        mesh.barrier()
