"""ir_depth_pm_fusion: an (ir, depth) two-stage fusion guide, then a
5-slot main fusion over (ir_rec, depth_rec, pm, ir, depth) that starts
from the guide's stage-2 estimate."""

from __future__ import annotations

from . import nets, params as P


def params(config):
    """Every parameter and buffer of the guide and the main stage."""
    recover = tuple((h, s) for h, s in config["recover"])
    return (P.two_stage_fusion("guide.", tuple(config["guide_channels"]), recover)
            + P.two_stage_fusion("main.", tuple(config["main_channels"]), recover))


def network(w, config, inputs, assets, masks=None, bands=False):
    """The main stage's output, with its recovered images under `recon`,
    each stage's body mask under `taps` and, with `bands`, the band of
    each stage's own mask under `bands`.  `masks` ({"guide", "main"}) are
    the program's body masks for the stages to follow instead of their
    own."""
    masks = masks or {}
    recover = tuple((h, s) for h, s in config["recover"])
    ir, depth, pm = inputs
    g2, g_rec, g_mask, g_band = nets.two_stage_fusion(w, "guide.", (ir, depth), assets, recover,
                                                      mask=masks.get("guide"), bands=bands)
    main_in = (g_rec["ir"], g_rec["depth"], pm, ir, depth)
    out2, recovered, mask, band = nets.two_stage_fusion(w, "main.", main_in, assets, recover,
                                                        init=(g2["pose6d"], g2["betas"], g2["cam"]),
                                                        mask=masks.get("main"), bands=bands)
    out2["recon"] = dict(recovered)
    out2["taps"] = {"guide": g_mask, "main": mask}
    if bands:
        out2["bands"] = {"guide": g_band, "main": band}
    return out2
