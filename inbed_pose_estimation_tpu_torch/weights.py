"""Load the JAX package's flax variables into a port module.

`load_jax_variables(module, variables)` takes the flax tree
{"params": ..., "batch_stats": ...} as nested dicts of numpy arrays and
writes it into the module's parameters and buffers: conv kernels
[kh, kw, I, O] -> [O, I, kh, kw], dense [I, O] -> [O, I], and BN
scale / bias / mean / var -> weight / bias / running_mean / running_var.
It maps the reference state-dict names of the concat, multi-trunk and
fusion families the same way the JAX package's checkpoint converter does,
with one exception: a multi-trunk model's `feat_extraction_<mod>` trunk is
flax's `trunk<i>` with i the position of <mod> in the model's feed order
(the converter's fixed table rgb/ir/depth/pm -> trunk0..3 misplaces the two
trunks of ir_depth_featatt_cashmrV2).  It raises on any name or leaf left
unmapped.  `jax_state_entries` gives the same mapped arrays for
a tolerant load, leaving out what the variables lack.

Bodies-At-Rest has a map of its own, as the converter's `bar` switch has,
since its `decpose` / `decshape` / `deccam` collide with the IEF head's
names: `CNN_packtanh[_mode2].{0,4,7,10}` -> `stack_mode{1,2}/conv0..3`,
`CNN_fc1[_mode2].0` -> `head_mode{1,2}/fc1` and the decoders ->
`head_mode{1,2}/*`.  A model's kind picks the map.  Two things differ from
the converter:
  * fc1's input rows are permuted between flax's (h, w, c) flatten order
    and the port's (c, h, w) (`fc1_rows_from_flax` / `fc1_rows_to_flax`),
    for the weights and for Adam's moments, so that the port computes what
    JAX computes from the same variables.  The converter only transposes
    fc1 (`train/checkpoint.py::_dense_w`), so a reference-layout `.pt`
    reaches JAX with its rows out of order; the port loads such a `.pt` as
    it is (ROADMAP Queue 3);
  * the mode-2 stack and head of bodiesAtRest4mod may be absent as a whole
    from the variables and the Adam state: the JAX trainer never builds
    them.  They then keep their values, with zero moments.

`load_jax_adam_state` carries optax's Adam moments into a
`torch.optim.Adam` over the same module.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence, Tuple

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


def _conv_leaf(leaf: str) -> str:
    return "kernel" if leaf == "weight" else "bias"


def _res_block(base: Tuple[str, ...], parts) -> Tuple[Tuple[str, ...], str, str]:
    """A ResBlock's `body.<i>.<leaf>` under the flax module `base`."""
    name = _RES_BODY[parts[1]]
    return _layer(base + (name,), parts[2], name.startswith("conv"))


def _fusion_decoder(parts) -> Optional[Tuple[Tuple[str, ...], str, str]]:
    """The fusion models' dec1 (feat_up's convs at Sequential indices 0, 2,
    4, 6) and dec{IR,Depth,PM}{2,3} (recover_<head>: down, res_in; mix,
    res_mix, proj)."""
    leaf = parts[-1]
    if parts[0] == "dec1":
        return ("feat_up", f"conv{int(parts[1]) // 2}"), _conv_leaf(leaf), "params"
    m = re.match(r"dec(IR|Depth|PM)([23])$", parts[0])
    if not m:
        return None
    base = (f"recover_{m.group(1).lower()}",)
    if m.group(2) == "2":  # 0 strided conv, 1 ResBlock
        if parts[1] == "0":
            return base + ("down",), _conv_leaf(leaf), "params"
        return _res_block(base + ("res_in",), parts[2:])
    if parts[1] == "1":  # 0 conv, 1 ResBlock, 2 PixelShuffle, 3 projection
        return _res_block(base + ("res_mix",), parts[2:])
    return base + ({"0": "mix", "3": "proj"}[parts[1]],), _conv_leaf(leaf), "params"


# Bodies-At-Rest's Sequential indices of its four convs (tanh, dropout and
# the max pool between them have no parameters).
_BAR_CONVS = {"0": "conv0", "4": "conv1", "7": "conv2", "10": "conv3"}
# Its flax modules that a JAX train state lacks as a whole.
_BAR_OPTIONAL = ("stack_mode2", "head_mode2")


def _bodies_at_rest_path(parts) -> Optional[Tuple[Tuple[str, ...], str, str]]:
    mode = "mode2" if parts[0].endswith("_mode2") else "mode1"
    base = parts[0].removesuffix("_mode2")
    leaf = _conv_leaf(parts[-1])
    if base == "CNN_packtanh" and parts[1] in _BAR_CONVS:
        return (f"stack_{mode}", _BAR_CONVS[parts[1]]), leaf, "params"
    if base == "CNN_fc1" and parts[1] == "0":
        return (f"head_{mode}", "fc1"), leaf, "params"
    if base in ("decpose", "decshape", "deccam"):
        return (f"head_{mode}", base), leaf, "params"
    return None


def fc1_rows_from_flax(w: np.ndarray, chw: Tuple[int, int, int]) -> np.ndarray:
    """A flax fc1 kernel [h*w*c, O] (NHWC flatten) -> the port's weight
    [O, c*h*w] (NCHW flatten)."""
    c, h, wd = chw
    return np.ascontiguousarray(w.reshape(h, wd, c, -1).transpose(2, 0, 1, 3).reshape(c * h * wd, -1).T)


def fc1_rows_to_flax(w: np.ndarray, chw: Tuple[int, int, int]) -> np.ndarray:
    """The inverse of `fc1_rows_from_flax`: [O, c*h*w] -> [h*w*c, O]."""
    c, h, wd = chw
    return np.ascontiguousarray(w.T.reshape(c, h, wd, -1).transpose(1, 2, 0, 3).reshape(h * wd * c, -1))


def flax_path(key: str, trunks: Sequence[str] = (), bodies_at_rest: bool = False
              ) -> Optional[Tuple[Tuple[str, ...], str, str]]:
    """Map a port state-dict key to (flax module path, leaf, collection).

    `trunks` are a multi-trunk model's trunk names (rgb / ir / depth / pm)
    in feed order: `feat_extraction_<mod>` maps to `trunk<i>` at <mod>'s
    position there.  `bodies_at_rest` switches to Bodies-At-Rest's map."""
    parts = key.split(".")
    leaf = parts[-1]
    if bodies_at_rest:
        return _bodies_at_rest_path(parts)
    # Nested models: the fusion encoder, the frozen pipelines' two stages.
    prefix = {"encoder_1": "encoder", "guide": "guide", "main": "main"}.get(parts[0])
    if prefix is not None:
        mapped = flax_path(".".join(parts[1:]), trunks)
        return None if mapped is None else ((prefix,) + mapped[0], mapped[1], mapped[2])
    m = re.match(r"feat_extraction_(\w+)$", parts[0])
    if m:
        mapped = flax_path(".".join(parts[1:]))
        if m.group(1) not in trunks or mapped is None or mapped[0][0] != "trunk":
            return None
        return (f"trunk{list(trunks).index(m.group(1))}",) + mapped[0][1:], mapped[1], mapped[2]
    if parts[0] == "cross_att":
        if leaf == "gamma":
            return ("cross_att",), "gamma", "params"
        return ("cross_att", parts[1][:-len("_conv")]), _conv_leaf(leaf), "params"
    if parts[0] == "dec1" or re.match(r"dec(IR|Depth|PM)[23]$", parts[0]):
        return _fusion_decoder(parts)

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


def _to_torch_layout(arr: np.ndarray, leaf: str, path: Tuple[str, ...] = (), fc1_chw=None) -> np.ndarray:
    """A flax leaf in the port's layout; `fc1_chw` is a Bodies-At-Rest
    model's (c, h, w), whose fc1 kernel (at `path`) has its rows permuted."""
    if leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))  # [kh, kw, I, O] -> [O, I, kh, kw]
    if leaf == "kernel" and arr.ndim == 2:
        if fc1_chw is not None and path[-1] == "fc1":
            return fc1_rows_from_flax(arr, fc1_chw)
        return np.transpose(arr, (1, 0))  # [I, O] -> [O, I]
    return arr


def _model_map(module: nn.Module):
    """(trunk names, is it Bodies-At-Rest, its fc1 (c, h, w)) of `module`."""
    chw = getattr(module, "fc1_chw", None)
    return getattr(module, "trunk_names", ()), chw is not None, chw


def _absent_optional(path: Tuple[str, ...], present_roots: set, bar: bool) -> bool:
    """Is `path` under a Bodies-At-Rest module that the tree lacks as a
    whole (the mode-2 stack and head of a JAX train state)?"""
    return bar and path[0] in _BAR_OPTIONAL and path[0] not in present_roots


def _entries(module: nn.Module, variables: Mapping, strict: bool) -> dict:
    """{state-dict key: flax leaf in the module's layout} for every key of
    `module` with a flax counterpart.  `strict` raises ValueError for a key
    with no mapping or no leaf and for a leaf that no key takes; otherwise
    those are left out."""
    flat = {}
    for coll in ("params", "batch_stats"):
        flat.update({(coll,) + k: v for k, v in _flatten(variables.get(coll, {})).items()})
    out, used = {}, set()
    trunks, bar, chw = _model_map(module)
    roots = {k[1] for k in flat}
    for key in module.state_dict():
        if key.endswith("num_batches_tracked") or key.rsplit(".", 1)[-1] in _NOT_IN_FLAX:
            continue
        mapped = flax_path(key, trunks, bar)
        if mapped is None:
            if strict:
                raise ValueError(f"load_jax_variables: no flax mapping for '{key}'")
            continue
        path, leaf, coll = mapped
        src = (coll,) + path + (leaf,)
        if src not in flat:
            if strict and not _absent_optional(path, roots, bar):
                raise ValueError(f"load_jax_variables: '{key}' maps to {'/'.join(src)}, absent from the variables")
            continue
        out[key] = _to_torch_layout(np.array(flat[src], dtype=np.float32), leaf, path, chw)  # a writable copy
        used.add(src)
    unused = sorted("/".join(k) for k in set(flat) - used)
    if strict and unused:
        raise ValueError(f"load_jax_variables: {len(unused)} flax leaves not taken by the module: {unused[:8]}")
    return out


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax `variables` into `module` in place; returns the module.

    Raises ValueError for a module key with no mapping or no flax leaf (but
    for Bodies-At-Rest's mode-2 modules absent as a whole, which keep their
    values), a shape that disagrees, or a flax leaf that no module key
    takes.
    """
    state = module.state_dict()
    for key, arr in _entries(module, variables, strict=True).items():
        target = state[key]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_variables: '{key}' has shape {tuple(target.shape)}, flax {arr.shape}")
        target.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return module


def jax_state_entries(module: nn.Module, variables: Mapping) -> dict:
    """The entries of `module.state_dict()` that the flax `variables` hold,
    as numpy arrays in the module's layout; keys without a mapping or a flax
    leaf are left out and shapes are not checked (a tolerant load picks the
    ones that fit)."""
    return _entries(module, variables, strict=False)


def _adam_moments(opt_state):
    """The ScaleByAdamState (count, mu, nu) of an optax Adam state: the
    state itself, or the first element of optax.adam's chain tuple."""
    return opt_state if hasattr(opt_state, "mu") else opt_state[0]


@torch.no_grad()
def load_jax_adam_state(module: nn.Module, optimizer: torch.optim.Adam, opt_state) -> torch.optim.Adam:
    """Write optax Adam moments into `optimizer`, an Adam over the
    parameters of `module` that require gradients: mu -> exp_avg, nu ->
    exp_avg_sq (kernels transposed as `load_jax_variables` does) and count
    -> step.

    A frozen parameter (a FrozenGuidedFusion's guide) has no Adam state in
    the port; JAX keeps its moments, at zero since its gradient is zero,
    and they are left unread.  Bodies-At-Rest's mode-2 parameters, which a
    JAX train state lacks, get zero moments.  Raises ValueError for a
    trainable parameter with no flax mapping or no moment, a shape that
    disagrees, or a moment leaf that no parameter takes.
    """
    adam = _adam_moments(opt_state)
    mu, nu = _flatten(adam.mu), _flatten(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    owner = {id(p) for group in optimizer.param_groups for p in group["params"]}
    trunks, bar, chw = _model_map(module)
    roots = {k[0] for k in mu}
    used = set()
    for key, param in module.named_parameters():
        mapped = flax_path(key, trunks, bar)
        if mapped is None or mapped[2] != "params":
            raise ValueError(f"load_jax_adam_state: no flax parameter for '{key}'")
        path, leaf, _ = mapped
        src = path + (leaf,)
        if not param.requires_grad:
            used.add(src)
            continue
        if id(param) not in owner:
            raise ValueError(f"load_jax_adam_state: parameter '{key}' is not in the optimizer")
        if _absent_optional(path, roots, bar):
            optimizer.state[param] = {"step": step.clone(), "exp_avg": torch.zeros_like(param),
                                      "exp_avg_sq": torch.zeros_like(param)}
            continue
        if src not in mu or src not in nu:
            raise ValueError(f"load_jax_adam_state: '{key}' maps to {'/'.join(src)}, absent from the Adam state")
        moments = []
        for tree in (mu, nu):
            arr = _to_torch_layout(np.array(tree[src], dtype=np.float32), leaf, path, chw)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"load_jax_adam_state: '{key}' has shape {tuple(param.shape)}, flax {arr.shape}")
            moments.append(torch.from_numpy(np.ascontiguousarray(arr)).to(param.device))
        optimizer.state[param] = {"step": step.clone(), "exp_avg": moments[0], "exp_avg_sq": moments[1]}
        used.add(src)
    unused = sorted("/".join(k) for k in set(mu) - used)
    if unused:
        raise ValueError(f"load_jax_adam_state: {len(unused)} moment leaves not taken by the module: {unused[:8]}")
    return optimizer
