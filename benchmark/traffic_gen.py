"""The one traffic generator: a pool of distinct inputs from a traffic
file's parameters and the configuration's modalities.

A traffic file (`traffic/<name>.json`) gives `batch` (frames a call),
`pool` (distinct calls drawn) and the driver's own keys.  Each pool entry
is a tuple of float32 NCHW host tensors, one per modality in the
configuration's feed order (`modalities`, `channels`, `img_res`), as the
eval loader yields normalized crops: standard normal values, drawn on the
device from the seed in one call and copied to pageable host memory.
The same seed gives the same pool.
"""

from __future__ import annotations

import torch

from .weights import generator


def make_pool(config, traffic, seed: int, device):
    B, P, R = traffic["batch"], traffic["pool"], config["img_res"]
    channels = config["channels"]
    per_call = B * sum(channels) * R * R
    flat = torch.randn(P * per_call, device=device, generator=generator(seed, "traffic", device)).cpu()
    pool = []
    for p in range(P):
        at, mods = p * per_call, []
        for c in channels:
            n = B * c * R * R
            mods.append(flat[at:at + n].view(B, c, R, R))
            at += n
        pool.append(tuple(mods))
    return pool
