"""featatt_cashmr (FeatAttCASHMR): one ResNet-50 trunk per modality, their
x4 maps fused by spatial cross attention, the depth decoder on the fused
map with the skips of one trunk, IEF on the pooled fused features, in a
cascade of `num_cas_iters` passes that feeds the recovered depth back.

One pass, for the modalities' pyramids p_j = (x0..x4)_j, j = 0..n-1, with
each x4_j a [B, C, 7, 7] map read as N = 49 tokens of C = 2048 channels:

  q_i = query(x4_i), k_i = key(x4_i), v_j = value(x4_j)
        (1x1 convolutions C -> C with bias, shared by all modalities)
  att_i[n, m] = softmax over m of  sum_c q_i[c, n] k_i[c, m]   (no scaling)
  out_j[c, n] = x4_j[c, n] + sum_i gamma_i * sum_m att_i[n, m] v_j[c, m]
  x4 = (out_0, ..., out_{n-1}) joined on channels        [B, n * C, 7, 7]
  recon.depth = decoder(x0..x3 of trunk `skip_trunk`, x4), its first level
                1x1 from n * C channels
  IEF on mean over positions of x4 (n * C features) and the estimate

The recovered depth replaces input slot 2 (`cascade_feed`) for the next
pass; the last pass skips its decoder unless `final_recon`.

The one departure from the published code (models/hmr.py:1113-1168,
Cross_Attn): its accumulator loop over the modalities (`adding`,
:1135-1145) assigns the sum anew on each modality, so only the last
attention map and no input feature would survive.  The JAX package, which
is this repository's oracle, sums every map as written above, and so does
this reference.  The decoder's first level takes the fused width while its
skips keep one trunk's widths, as in the JAX package: the published
decoder expected fused skips and would not have run.
"""

from __future__ import annotations

import torch

from . import nets, params as P

# A modality's batch key -> its trunk's name in the parameter names.
TRUNK_NAME = {"img": "rgb", "ir_img": "ir", "depth_img": "depth", "pm_img": "pm"}
WIDTH = 2048


def trunk_prefixes(config):
    return [f"feat_extraction_{TRUNK_NAME[m]}." for m in config["modalities"]]


def params(config):
    """Every parameter and buffer of the network, named as the program's
    state dict names them."""
    n = len(config["modalities"])
    out = []
    for prefix, c in zip(trunk_prefixes(config), config["channels"]):
        out += P.resnet50(prefix, c)
    for role in ("query", "key", "value"):
        out += P.conv(f"cross_att.{role}_conv", WIDTH, WIDTH, 1, bias=True)
    # Drawn as BatchNorm gains (0.25-0.75), not at their initial zero, where
    # the attention would add nothing and the check could not see it.
    out.append(("cross_att.gamma", (n,), "bn_weight", n))
    for head in config["recon_heads"]:
        out += P.reconstruct(f"Reconstruct_{head}.", in_features=n * WIDTH)
    return out + P.ief("", feat_dim=n * WIDTH) + P.mean_params("")


def _tokens(w, name, x):
    """A 1x1 convolution of x [B, C, H, W], as [B, C, H*W]."""
    return nets.conv(w, name, x).flatten(2)


def cross_attention(w, x4s):
    """The fused map of the modalities' x4 maps (the equations above)."""
    B, C, H, W = x4s[0].shape
    atts = [torch.softmax(torch.bmm(_tokens(w, "cross_att.query_conv", x).transpose(1, 2),
                                    _tokens(w, "cross_att.key_conv", x)), dim=-1) for x in x4s]
    gamma = w["cross_att.gamma"]
    outs = []
    for x in x4s:
        v = _tokens(w, "cross_att.value_conv", x).transpose(1, 2)  # [B, N, C]
        out = x.flatten(2).transpose(1, 2)
        for i, att in enumerate(atts):
            out = out + gamma[i] * torch.bmm(att, v)
        outs.append(out.transpose(1, 2).reshape(B, C, H, W))
    return torch.cat(outs, 1)


def network(w, config, inputs, assets, masks=None, bands=False):
    """The last pass's output on a modality tuple (no mask: `masks` and
    `bands` are unused)."""
    current = list(inputs)
    n = config["num_cas_iters"]
    feed = dict(config["cascade_feed"])
    prefixes = trunk_prefixes(config)
    for stage in range(n):
        last = stage == n - 1
        heads = () if last and not config["final_recon"] else tuple(config["recon_heads"])
        pyramids = [nets.pyramid(w, prefix, x) for prefix, x in zip(prefixes, current)]
        x4 = cross_attention(w, [p[4] for p in pyramids])
        skips = pyramids[config["skip_trunk"]][:4] + (x4,)
        out = nets.regress(w, "", x4)
        out["recon"] = {h: nets.decode(w, f"Reconstruct_{h}.", skips) for h in heads}
        for head, slot in feed.items():
            if head in out["recon"]:
                current[slot] = out["recon"][head]
    return out
