"""Checkpoints of the port and of the JAX package.

The port writes the reference's layout: `epoch_<E>_<B>.pt` in the
checkpoint directory, a `torch.save` dict {"model": state_dict,
"optimizer": Adam state_dict, "epoch", "batch_idx", "batch_size",
"dataset_perm", "total_step_count"} plus "generator", the dropout
generator's state; the fits store is saved beside it as `<name>_fits.npy`
(`FitsStore.save`).  It reads its own files, the reference's `.pt` files
(`module.` prefixes stripped) and the JAX package's native `.npz` (the flax
variables flattened under `var/`, optax's Adam leaves under `opt/`, the
metadata in a `.json` beside it).  `.pt` files are unpickled: load them only
from a trusted source.

A frozen-guided fusion pipeline (ir_depth_pm_fusion, ir_depth_pm_rgb_fusion)
saves its whole state, guide.* and main.*, with Adam over main's
parameters.  A reference `.pt` of such a name holds the main stage only,
unprefixed, as the JAX package's `load_torch_checkpoint(target_model=)`
reads it: the port loads it into `main`, and the guide comes from
`load_guide` (`--pretrained_fusion_checkpoint`), an ir_depth_fusion `.pt` or
JAX `.npz`.

The reference's Bodies-At-Rest class always held both stacks; the port's
bodiesAtRest has only the first (it never runs mode 2), so the `_mode2`
entries of such a `.pt` are left out of its strict load.  A JAX `.npz` of
bodiesAtRest4mod from the JAX trainer lacks the mode-2 stack; the port's
model keeps its values there (`weights.py`).
"""

from __future__ import annotations

import json
import os
import re
import types
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.bodies_at_rest import BodiesAtRest
from ..models.fusion import FrozenGuidedFusion
from ..parallel import mesh
from ..weights import jax_state_entries, load_jax_adam_state, load_jax_variables

if TYPE_CHECKING:
    from .trainer import TrainState

_NAME = re.compile(r"epoch_(\d+)_(\d+)\.(pt|npz)$")
_META_KEYS = ("epoch", "batch_idx", "batch_size", "total_step_count")


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


def _read_npz(path: str):
    """(flax variables, {"leaf_XXXXX": optimizer leaf}, metadata) of a JAX
    package checkpoint."""
    with np.load(path) as data:
        variables = _unflatten({k[len("var/"):]: data[k] for k in data.files if k.startswith("var/")})
        opt_leaves = {k[len("opt/"):]: data[k] for k in data.files if k.startswith("opt/")}
    meta_path = path[:-len(".npz")] + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return variables, opt_leaves, meta


def _read_pt(path: str) -> dict:
    """A `.pt` checkpoint as {"model": state dict without `module.`
    prefixes, ...}; a bare state dict is taken as the model's."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "model" not in ckpt:
        ckpt = {"model": ckpt}
    ckpt["model"] = {k[len("module."):] if k.startswith("module.") else k: v for k, v in ckpt["model"].items()}
    return ckpt


def _pt_meta(ckpt: dict) -> dict:
    meta = {k: ckpt[k] for k in _META_KEYS if k in ckpt}
    if ckpt.get("dataset_perm") is not None:
        meta["dataset_perm"] = np.asarray(ckpt["dataset_perm"])
    return meta


def _main_only(module: nn.Module, state: dict) -> bool:
    """Is `state` a reference main-stage state dict of a frozen-guided
    pipeline `module`?"""
    return isinstance(module, FrozenGuidedFusion) and not any(k.startswith(("guide.", "main.")) for k in state)


def _load_state(module: nn.Module, state: dict) -> None:
    """`module.load_state_dict(state, strict=True)`, or into its main stage
    for a reference main-stage state dict; a Bodies-At-Rest model without
    the mode-2 stack leaves out the `_mode2` entries."""
    if isinstance(module, BodiesAtRest) and not module.with_mode2:
        state = {k: v for k, v in state.items() if not k.split(".")[0].endswith("_mode2")}
    (module.main if _main_only(module, state) else module).load_state_dict(state, strict=True)


def load_checkpoint(path: str, module: nn.Module) -> dict:
    """Load a JAX package checkpoint's weights into `module` through
    `weights.load_jax_variables` (strict); returns the `.json` metadata
    beside it (epoch, batch_idx, dataset_perm, ...), or {}.  The optimizer
    leaves are not read."""
    variables, _, meta = _read_npz(path)
    load_jax_variables(module, variables)
    return meta


def load_torch_checkpoint(path: str, module: nn.Module) -> dict:
    """Load a `.pt` checkpoint's weights into `module`, strictly: the port
    keeps the reference's parameter names.  Returns the metadata the file
    holds (epoch, batch_idx, batch_size, total_step_count, dataset_perm),
    and "main_only" when a reference `.pt` filled only the main stage of a
    frozen-guided pipeline."""
    ckpt = _read_pt(path)
    _load_state(module, ckpt["model"])
    meta = _pt_meta(ckpt)
    if _main_only(module, ckpt["model"]):
        meta["main_only"] = True
    return meta


def save_checkpoint(ckpt_dir: str, state: "TrainState", epoch: int, batch_idx: int, batch_size: int,
                    dataset_perm, total_step_count: int) -> str:
    """Write `<ckpt_dir>/epoch_<epoch>_<batch_idx>.pt` (through a temporary
    file, so that a cut-off write leaves no file under that name); returns
    its path.  Under data parallel (`parallel.mesh`) rank 0 writes its
    replica, the state every rank holds, and every rank waits for the file
    (a barrier) before it returns."""
    path = os.path.join(ckpt_dir, f"epoch_{epoch}_{batch_idx}.pt")
    if mesh.rank() == 0:
        _write_checkpoint(path, state, epoch, batch_idx, batch_size, dataset_perm, total_step_count)
    mesh.barrier()
    return path


def _write_checkpoint(path, state, epoch, batch_idx, batch_size, dataset_perm, total_step_count) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "epoch": epoch,
        "batch_idx": batch_idx,
        "batch_size": batch_size,
        "dataset_perm": torch.as_tensor(np.ascontiguousarray(dataset_perm), dtype=torch.int64),
        "total_step_count": total_step_count,
        "generator": state.generator.get_state(),
    }, path + ".tmp")
    os.replace(path + ".tmp", path)


def latest_checkpoint(ckpt_dir: Optional[str]) -> Optional[str]:
    """The `epoch_<E>_<B>.pt` or `.npz` in `ckpt_dir` with the largest
    (E, B), compared as numbers (epoch_10_0 after epoch_9_5); a `.pt` wins a
    tie.  None when there is none."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    best, best_key = None, None
    for fn in os.listdir(ckpt_dir):
        m = _NAME.match(fn)
        if m:
            key = (int(m.group(1)), int(m.group(2)), m.group(3) == "pt")
            if best_key is None or key > best_key:
                best, best_key = os.path.join(ckpt_dir, fn), key
    return best


def _paths(tree: dict, prefix: tuple = ()):
    """The leaf paths of nested dicts, as tuples."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def adam_state_from_jax_leaves(module: nn.Module, optimizer: torch.optim.Adam, params: dict, opt_leaves: dict):
    """Write the optax Adam leaves of a JAX package checkpoint into
    `optimizer`, an Adam over `module.parameters()`.

    The JAX package stores `tree_leaves(optax.adam(...).init(params))`
    positionally as `leaf_00000`, ...: the count, then the first moments,
    then the second, each tree flattened with the keys of every level
    sorted.  `params` is the flax params tree; sorting its leaf paths as
    tuples gives that order (the order of the "a/b" strings is the same
    only while no name holds a character that sorts before "/").  Raises
    ValueError when the leaves do not fit the parameters."""
    paths = sorted(_paths(params))
    leaves = [opt_leaves[k] for k in sorted(opt_leaves)]
    n = len(paths)
    if len(leaves) != 1 + 2 * n:
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters: not an optax Adam state of this model")

    def tree(values):
        return _unflatten({"/".join(p): v for p, v in zip(paths, values)})

    adam = types.SimpleNamespace(count=leaves[0], mu=tree(leaves[1:1 + n]), nu=tree(leaves[1 + n:]))
    return load_jax_adam_state(module, optimizer, adam)


def resume_train_state(path: str, state: "TrainState") -> dict:
    """Restore `state` in place from a checkpoint and return its metadata
    (epoch, batch_idx, total_step_count, dataset_perm, ...).

    A `.pt` gives the weights (strictly), Adam's state and, from the port's
    own files, the dropout generator's state.  A JAX package `.npz` gives
    the weights and, when it holds them, the Adam moments and count; JAX's
    PRNG key has no torch counterpart, so the generator keeps its seed."""
    if path.endswith(".npz"):
        variables, opt_leaves, meta = _read_npz(path)
        load_jax_variables(state.model, variables)
        if opt_leaves:
            adam_state_from_jax_leaves(state.model, state.optimizer, variables.get("params", {}), opt_leaves)
        return meta
    ckpt = _read_pt(path)
    _load_state(state.model, ckpt["model"])
    if "optimizer" in ckpt:
        state.optimizer.load_state_dict(ckpt["optimizer"])
    if "generator" in ckpt:
        state.generator.set_state(ckpt["generator"])
    return _pt_meta(ckpt)


@torch.no_grad()
def load_pretrained(module: nn.Module, path: str) -> int:
    """`--pretrained_checkpoint`: copy every entry of a `.pt` state dict or a
    JAX `.npz` whose name and shape match one of `module`'s (the reference's
    strict=False load); the rest keep their values.  Returns how many
    entries were taken."""
    if path.endswith(".npz"):
        incoming = jax_state_entries(module, _read_npz(path)[0])
    else:
        incoming = _read_pt(path)["model"]
        if _main_only(module, incoming):
            incoming = {f"main.{k}": v for k, v in incoming.items()}
    taken = 0
    for key, target in module.state_dict().items():
        src = incoming.get(key)
        if src is not None and tuple(np.shape(src)) == tuple(target.shape):
            target.copy_(torch.as_tensor(src))
            taken += 1
    return taken


@torch.no_grad()
def load_guide(module: nn.Module, path: str) -> None:
    """`--pretrained_fusion_checkpoint`: the weights of an ir_depth_fusion,
    a `.pt` in the reference layout or a JAX package `.npz`, into the guide
    of the frozen-guided pipeline `module`, strictly (every guide entry
    filled, nothing left over).  A model without a guide ignores the flag,
    with a warning, as the JAX package does."""
    if not isinstance(module, FrozenGuidedFusion):
        print("WARNING: --pretrained_fusion_checkpoint is read only by the frozen-guided fusion pipelines "
              "(ir_depth_pm_fusion, ir_depth_pm_rgb_fusion); this model has no guide, so the flag is ignored")
        return
    if path.endswith(".npz"):
        load_jax_variables(module.guide, _read_npz(path)[0])
    else:
        module.guide.load_state_dict(_read_pt(path)["model"], strict=True)


def train_state_from_jax(model: nn.Module, jax_state, options, seed: int = 0,
                         device: str | torch.device = "cuda") -> "TrainState":
    """A port `TrainState` from a JAX `TrainState`: params and batch_stats
    into `model`, the Adam moments and count into a fresh optimizer, the
    fits store and the step.  JAX's PRNG key has no torch counterpart: the
    dropout generator is seeded with `seed`."""
    from .trainer import init_train_state

    load_jax_variables(model, {"params": jax_state.params, "batch_stats": jax_state.batch_stats})
    state = init_train_state(model, options, np.asarray(jax_state.fits), seed=seed, device=device)
    load_jax_adam_state(model, state.optimizer, jax_state.opt_state)
    state.step = int(np.asarray(jax_state.step))
    return state
