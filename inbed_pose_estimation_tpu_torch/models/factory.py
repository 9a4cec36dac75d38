"""Model registry: the registered architecture names and how each is fed.

Every name the JAX package registers has its spec here, and `build_model`
builds each of them; `hmr2_vith4mod` (HMR 2.0, `models/vit.py`) is the
port's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..constants import IMG_RES
from ..device import resolve_device
from ..smpl.assets import mean_params
from .bodies_at_rest import BodiesAtRest
from .fusion import FrozenGuidedFusion, TwoStageFusion
from .hmr import MODALITY_CHANNELS, HMRCore, MultiTrunkCore
from .layers import set_compute_dtype
from .vit import HMR2, WIDTHS as VIT_WIDTHS

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


@dataclass(frozen=True)
class ModelSpec:
    name: str
    input_mode: str              # "concat" | "multi" | "pm_contact" | "fusion"
    modalities: Tuple[str, ...]  # batch keys in feed order
    cascade: bool = False        # the eval pipeline runs the num_cas_iters cascade
    recon_heads: Tuple[str, ...] = ()
    # recon head -> input slot it replaces between cascade stages
    cascade_feed_map: Tuple[Tuple[str, int], ...] = (("depth", 2),)
    # the network the concat input feeds: "resnet50" (HMRCore, or the
    # input mode's own model) or a key of `vit.WIDTHS` (HMR2 at its widths)
    trunk: str = "resnet50"

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
    # Port-only: HMR 2.0's ViT-H/16 and transformer-decoder head on the
    # four modalities joined on channels (arXiv:2305.20091).
    "hmr2_vith4mod": ModelSpec("hmr2_vith4mod", "concat", MODALITY_SETS["all4"], trunk="vit_h16"),
}


# The fusion models' recovered modalities and the input slot of each.
RECOVER = {
    "ir_depth_fusion": (("ir", "depth"), (0, 1)),
    "ir_pm_fusion": (("ir", "pm"), (0, 1)),
    "rgb_depth_fusion": (("depth",), (1,)),
    "rgb_pm_fusion": (("pm",), (1,)),
}
# The pipelines of a frozen ir_depth_fusion guide and a second fusion stage.
FROZEN_GUIDED = ("ir_depth_pm_fusion", "ir_depth_pm_rgb_fusion")
# Bodies-At-Rest: the first stack's input channels (the modalities and the
# two contact channels).
BAR_CHANNELS = {"bodiesAtRest": 3, "bodiesAtRest4mod": 8}


def model_names() -> list[str]:
    return sorted(_SPECS)


def get_spec(name: str) -> ModelSpec:
    if name not in _SPECS:
        raise ValueError(f"Unknown model '{name}'. Known: {model_names()}")
    return _SPECS[name]


def build_model(name: str, smpl_mean_params: Optional[str] = None, device: str | torch.device = "cuda",
                dropout_rate: Optional[float] = None, img_res: int = IMG_RES, dtype: torch.dtype = torch.float32,
                remat_decoder: bool = False):
    """Build a registered model on `device`, in eval mode.  `dropout_rate`
    is the rate of its dropout in training mode; None keeps the family's:
    0.5 in the IEF heads, 0.1 in Bodies-At-Rest's tanh stack.  `img_res`
    sizes Bodies-At-Rest's fc1 (the other families pool to a fixed width).
    `img_res` also sizes the ViT's position embedding.
    `dtype` is the compute dtype (float32 or bfloat16; the parameters are
    float32 either way, `layers.set_compute_dtype`).  `remat_decoder`
    checkpoints the decoders of the concat and multi families (`--remat
    decoder`); the fusion family and Bodies-At-Rest take it and ignore it,
    as in JAX.

    Returns (module, spec):
      concat: HMRCore on the channel-concatenated modalities, with the
        spec's decoders; for a `trunk` of `vit.WIDTHS`, HMR2 at those
        widths (`dropout_rate`, when given, is the top drop-path rate);
      multi: MultiTrunkCore, one trunk per modality, cross attention for
        featatt_cashmr and ir_depth_featatt_cashmrV2, decoder skips from
        trunk min(2, n - 1);
      fusion: TwoStageFusion (the recovered modalities and their slots
        below), or FrozenGuidedFusion for ir_depth_pm_fusion and
        ir_depth_pm_rgb_fusion;
      pm_contact: BodiesAtRest over 3 (bodiesAtRest) or 8
        (bodiesAtRest4mod) channels; bodiesAtRest4mod also carries the
        mode-2 refinement stack, as the JAX package's eval builds it.
    """
    spec = get_spec(name)
    dev = resolve_device(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")
    if spec.input_mode == "pm_contact":
        module = BodiesAtRest(BAR_CHANNELS[name], img_res, with_mode2=name == "bodiesAtRest4mod",
                              dropout_rate=0.1 if dropout_rate is None else dropout_rate)
        return set_compute_dtype(module, dtype).to(dev).eval(), spec
    rate = 0.5 if dropout_rate is None else dropout_rate
    mp = mean_params(smpl_mean_params)
    means = (mp["pose"], mp["shape"], mp["cam"])
    if spec.trunk in VIT_WIDTHS:
        module = HMR2(spec.in_channels, *means, widths=VIT_WIDTHS[spec.trunk], img_res=img_res,
                      drop_path_rate=dropout_rate)
    elif spec.input_mode == "concat":
        module = HMRCore(spec.in_channels, *means, recon_heads=spec.recon_heads, dropout_rate=rate,
                         remat_decoder=remat_decoder)
    elif spec.input_mode == "multi":
        module = MultiTrunkCore(spec.modalities, *means, recon_heads=spec.recon_heads,
                                cross_attention=name in ("featatt_cashmr", "ir_depth_featatt_cashmrV2"),
                                skip_trunk=min(2, len(spec.modalities) - 1), dropout_rate=rate,
                                remat_decoder=remat_decoder)
    elif name in FROZEN_GUIDED:
        module = FrozenGuidedFusion(*means, with_rgb=name == "ir_depth_pm_rgb_fusion", dropout_rate=rate)
    else:
        heads, slots = RECOVER[name]
        module = TwoStageFusion([MODALITY_CHANNELS[m] for m in spec.modalities], *means, recover_heads=heads,
                                recover_slots=slots, dropout_rate=rate)
    return set_compute_dtype(module, dtype).to(dev).eval(), spec
