"""Model registry: the registered architecture names and how each is fed.

Every name the JAX package registers has its spec here; `build_model`
builds the concat-input family that `HMRCore` serves and raises
`NotImplementedError` for the families not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from ..smpl.assets import mean_params
from .hmr import HMRCore

MODALITY_SETS = {
    "rgb": ("img",),
    "ir": ("ir_img",),
    "depth": ("depth_img",),
    "pm": ("pm_img",),
    "all4": ("img", "ir_img", "depth_img", "pm_img"),
    "ir_depth": ("ir_img", "depth_img"),
    "ir_pm": ("ir_img", "pm_img"),
    "rgb_depth": ("img", "depth_img"),
    "rgb_pm": ("img", "pm_img"),
    "ir_depth_pm": ("ir_img", "depth_img", "pm_img"),
}

# Channels of each modality in the batch.
MODALITY_CHANNELS = {"img": 3, "ir_img": 1, "depth_img": 1, "pm_img": 1}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    input_mode: str              # "concat" | "multi" | "pm_contact" | "fusion"
    modalities: Tuple[str, ...]  # batch keys in feed order
    cascade: bool = False        # the eval pipeline runs the num_cas_iters cascade
    recon_heads: Tuple[str, ...] = ()
    # recon head -> input slot it replaces between cascade stages
    cascade_feed_map: Tuple[Tuple[str, int], ...] = (("depth", 2),)

    @property
    def in_channels(self) -> int:
        return sum(MODALITY_CHANNELS[m] for m in self.modalities)


_SPECS = {
    "hmr": ModelSpec("hmr", "concat", MODALITY_SETS["rgb"]),
    "hmr4mod": ModelSpec("hmr4mod", "concat", MODALITY_SETS["all4"]),
    "irhmr": ModelSpec("irhmr", "concat", MODALITY_SETS["ir"]),
    "depthhmr": ModelSpec("depthhmr", "concat", MODALITY_SETS["depth"]),
    "pmhmr": ModelSpec("pmhmr", "concat", MODALITY_SETS["pm"]),
    "mulhmr": ModelSpec("mulhmr", "concat", MODALITY_SETS["ir_depth_pm"]),
    "rechmr": ModelSpec("rechmr", "concat", MODALITY_SETS["all4"], recon_heads=("depth",)),
    "cashmr": ModelSpec("cashmr", "concat", MODALITY_SETS["all4"], cascade=True, recon_heads=("depth",)),
    "cashmrV2": ModelSpec("cashmrV2", "concat", MODALITY_SETS["all4"], cascade=True, recon_heads=("depth",)),
    "rec3hmr": ModelSpec("rec3hmr", "concat", MODALITY_SETS["all4"], recon_heads=("depth", "ir", "pm")),
    "cas3hmr": ModelSpec("cas3hmr", "concat", MODALITY_SETS["all4"], cascade=True, recon_heads=("depth", "ir", "pm")),
    "featcat": ModelSpec("featcat", "multi", ("img", "ir_img")),
    "featcat_cashmr": ModelSpec("featcat_cashmr", "multi", MODALITY_SETS["all4"], cascade=True, recon_heads=("depth",)),
    "featatt_cashmr": ModelSpec("featatt_cashmr", "multi", MODALITY_SETS["all4"], cascade=True, recon_heads=("depth",)),
    "ir_depth_featatt_cashmrV2": ModelSpec(
        "ir_depth_featatt_cashmrV2", "multi", MODALITY_SETS["ir_depth"],
        cascade=True, recon_heads=("depth", "ir"), cascade_feed_map=(("ir", 0), ("depth", 1)),
    ),
    "ir_depth_fusion": ModelSpec("ir_depth_fusion", "fusion", MODALITY_SETS["ir_depth"]),
    "ir_pm_fusion": ModelSpec("ir_pm_fusion", "fusion", MODALITY_SETS["ir_pm"]),
    "rgb_depth_fusion": ModelSpec("rgb_depth_fusion", "fusion", MODALITY_SETS["rgb_depth"]),
    "rgb_pm_fusion": ModelSpec("rgb_pm_fusion", "fusion", MODALITY_SETS["rgb_pm"]),
    "ir_depth_pm_fusion": ModelSpec("ir_depth_pm_fusion", "fusion", MODALITY_SETS["ir_depth_pm"]),
    "ir_depth_pm_rgb_fusion": ModelSpec(
        "ir_depth_pm_rgb_fusion", "fusion", ("ir_img", "depth_img", "pm_img", "img"),
    ),
    "bodiesAtRest": ModelSpec("bodiesAtRest", "pm_contact", ("pm_img",)),
    "bodiesAtRest4mod": ModelSpec("bodiesAtRest4mod", "pm_contact", MODALITY_SETS["all4"]),
}


def model_names() -> list[str]:
    return sorted(_SPECS)


def get_spec(name: str) -> ModelSpec:
    if name not in _SPECS:
        raise ValueError(f"Unknown model '{name}'. Known: {model_names()}")
    return _SPECS[name]


def build_model(name: str, smpl_mean_params: Optional[str] = None, device: str | torch.device = "cuda"):
    """Build a registered concat-family model on `device`, in eval mode.

    Returns (module, spec).  Multi-trunk, fusion and Bodies-At-Rest models
    raise NotImplementedError: they are ROADMAP Queue 1 item 9.
    """
    spec = get_spec(name)
    dev = resolve_device(device)
    if spec.input_mode != "concat":
        raise NotImplementedError(
            f"model '{name}' ({spec.input_mode} input) is not ported yet: ROADMAP Queue 1 item 9"
        )
    mp = mean_params(smpl_mean_params)
    module = HMRCore(spec.in_channels, mp["pose"], mp["shape"], mp["cam"], recon_heads=spec.recon_heads)
    return module.to(dev).eval(), spec
