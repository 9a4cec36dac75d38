"""Load the JAX package's flax variables into a port module.

`load_jax_variables(module, variables)` takes the flax tree
{"params": ..., "batch_stats": ...} as nested dicts of numpy arrays and
writes it into the module's parameters and buffers: conv kernels
[kh, kw, I, O] -> [O, I, kh, kw], dense [I, O] -> [O, I], and BN
scale / bias / mean / var -> weight / bias / running_mean / running_var.
It maps the reference state-dict names of the HMRCore family the same way
the JAX package's checkpoint converter does, and raises on any name or
leaf left unmapped.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# Buffers with no flax counterpart besides BN's `num_batches_tracked`: the
# IEF mean parameters, fixed by the model's construction.
_NOT_IN_FLAX = ("init_pose", "init_shape", "init_cam")

_BN_LEAF = {
    "weight": ("scale", "params"),
    "bias": ("bias", "params"),
    "running_mean": ("mean", "batch_stats"),
    "running_var": ("var", "batch_stats"),
}
_RES_BODY = {"0": "conv0", "1": "bn0", "3": "conv1", "4": "bn1"}


def _layer(path: Tuple[str, ...], leaf: str, is_conv: bool):
    """(flax path, leaf, collection) of a conv/dense weight or a BN leaf."""
    if is_conv:
        return path, "kernel", "params"
    flax_leaf, coll = _BN_LEAF[leaf]
    return path, flax_leaf, coll


def flax_path(key: str) -> Optional[Tuple[Tuple[str, ...], str, str]]:
    """Map a port state-dict key to (flax module path, leaf, collection)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] in ("conv1", "bn1"):
        return _layer(("trunk", parts[0]), leaf, parts[0] == "conv1")

    m = re.match(r"layer(\d)$", parts[0])
    if m:
        base = ("trunk", parts[0], f"block{parts[1]}")
        sub = parts[2]
        if sub == "downsample":
            is_conv = parts[3] == "0"
            return _layer(base + ("downsample_conv" if is_conv else "downsample_bn",), leaf, is_conv)
        return _layer(base + (sub,), leaf, sub.startswith("conv"))

    if parts[0] in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        return ("head", parts[0]), "kernel" if leaf == "weight" else "bias", "params"

    m = re.match(r"Reconstruct_(\w+)$", parts[0])
    if m:
        dec = f"reconstruct_{m.group(1)}"
        stage, idx = parts[1], parts[2]
        if re.match(r"decDepth\d$", stage):
            base = (dec, f"dec{stage[-1]}")
            if idx == "0":
                return base + ("reduce",), "kernel", "params"
            if idx == "1":  # ResBlock body 0/1/3/4
                name = _RES_BODY[parts[4]]
                return _layer(base + ("res", name), leaf, name.startswith("conv"))
            if idx == "2":  # upsampler: 0 conv, 2 BN
                is_conv = parts[3] == "0"
                return _layer(base + ("up", "conv" if is_conv else "bn"), leaf, is_conv)
        if stage == "decDepth":  # 0 reduce, 1/2 ResBlocks, 3 upsampler, 4 projection
            if idx == "0":
                return (dec, "final_reduce"), "kernel", "params"
            if idx in ("1", "2"):
                name = _RES_BODY[parts[4]]
                return _layer((dec, f"final_res{int(idx) - 1}", name), leaf, name.startswith("conv"))
            if idx == "3":
                is_conv = parts[3] == "0"
                return _layer((dec, "final_up", "conv" if is_conv else "bn"), leaf, is_conv)
            if idx == "4":
                return (dec, "proj"), "kernel", "params"
    return None


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))  # [kh, kw, I, O] -> [O, I, kh, kw]
    if leaf == "kernel" and arr.ndim == 2:
        return np.transpose(arr, (1, 0))  # [I, O] -> [O, I]
    return arr


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax `variables` into `module` in place; returns the module.

    Raises ValueError for a module key with no mapping or no flax leaf, a
    shape that disagrees, or a flax leaf that no module key takes.
    """
    flat = {}
    for coll in ("params", "batch_stats"):
        flat.update({(coll,) + k: v for k, v in _flatten(variables.get(coll, {})).items()})
    used = set()
    for key, target in module.state_dict().items():
        if key.endswith("num_batches_tracked") or key in _NOT_IN_FLAX:
            continue
        mapped = flax_path(key)
        if mapped is None:
            raise ValueError(f"load_jax_variables: no flax mapping for '{key}'")
        path, leaf, coll = mapped
        src = (coll,) + path + (leaf,)
        if src not in flat:
            raise ValueError(f"load_jax_variables: '{key}' maps to {'/'.join(src)}, absent from the variables")
        arr = _to_torch_layout(np.array(flat[src], dtype=np.float32), leaf)  # a writable copy
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_variables: '{key}' has shape {tuple(target.shape)}, flax {arr.shape}")
        target.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        used.add(src)
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise ValueError(f"load_jax_variables: {len(unused)} flax leaves not taken by the module: {unused[:8]}")
    return module
