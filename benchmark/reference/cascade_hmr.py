"""cashmrV2 (CASHMR): HMR over the modalities joined on the channel axis,
`num_cas_iters` passes, each pass's recovered images fed back into their
slots (`cascade_feed`); the last pass skips its decoder unless
`final_recon`."""

from __future__ import annotations

import torch

from . import nets, params as P


def params(config):
    """Every parameter and buffer of the network."""
    return P.hmr_core("", sum(config["channels"]), tuple(config["recon_heads"]))


def network(w, config, inputs, assets, masks=None, bands=False):
    """The last pass's output on a modality tuple (no mask: `masks` and
    `bands` are unused)."""
    current = list(inputs)
    n = config["num_cas_iters"]
    feed = dict(config["cascade_feed"])
    for stage in range(n):
        last = stage == n - 1
        heads = () if last and not config["final_recon"] else tuple(config["recon_heads"])
        out = nets.hmr(w, "", torch.cat(current, 1), heads)
        for head, slot in feed.items():
            if head in out["recon"]:
                current[slot] = out["recon"][head]
    return out
