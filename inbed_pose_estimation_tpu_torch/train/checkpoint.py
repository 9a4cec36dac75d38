"""Checkpoints: loading the JAX package's native `.npz` checkpoints and the
reference's `.pt` files into a port module, and carrying a JAX package
training state into the port."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..weights import load_jax_variables, load_jax_adam_state
from .trainer import TrainState, init_train_state


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    """{"a/b/c": leaf} -> nested dicts."""
    tree: dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_checkpoint(path: str, module: nn.Module) -> dict:
    """Load a JAX package checkpoint (`epoch_<E>_<B>.npz`: the flax
    variables flattened under `var/`, the optimizer leaves under `opt/`)
    into `module` through `weights.load_jax_variables`; returns the `.json`
    metadata beside it (epoch, batch_idx, dataset_perm, ...), or {}.  The
    optimizer leaves are not read."""
    with np.load(path) as data:
        variables = _unflatten({k[len("var/"):]: data[k] for k in data.files if k.startswith("var/")})
    load_jax_variables(module, variables)
    meta_path = path[:-len(".npz")] + ".json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_torch_checkpoint(path: str, module: nn.Module) -> dict:
    """Load a reference `.pt` checkpoint (a state dict, or a dict holding it
    under "model", with DataParallel's `module.` prefixes) into `module`,
    strictly: the port keeps the reference's parameter names.  Returns the
    metadata the file holds (epoch, batch_idx, batch_size, total_step_count,
    dataset_perm).  The file must come from a trusted source: loading it
    unpickles."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt)
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    module.load_state_dict(state, strict=True)
    meta = {k: ckpt[k] for k in ("epoch", "batch_idx", "batch_size", "total_step_count") if k in ckpt}
    if ckpt.get("dataset_perm") is not None:
        meta["dataset_perm"] = np.asarray(ckpt["dataset_perm"])
    return meta


def train_state_from_jax(model: nn.Module, jax_state, options, seed: int = 0,
                         device: str | torch.device = "cuda") -> TrainState:
    """A port `TrainState` from a JAX `TrainState`: params and batch_stats
    into `model`, the Adam moments and count into a fresh optimizer, the
    fits store and the step.  JAX's PRNG key has no torch counterpart: the
    dropout generator is seeded with `seed`."""
    load_jax_variables(model, {"params": jax_state.params, "batch_stats": jax_state.batch_stats})
    state = init_train_state(model, options, np.asarray(jax_state.fits), seed=seed, device=device)
    load_jax_adam_state(model, state.optimizer, jax_state.opt_state)
    state.step = int(np.asarray(jax_state.step))
    return state
