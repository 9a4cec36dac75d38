"""The blocks of the benchmark's architectures in plain PyTorch, in eval
mode, from a dict of tensors named as in `params.py`, and the eval step
over an architecture's network.  Each architecture is a module of this
package named as a configuration's `architecture`, with `params(config)`
and `network(w, config, inputs, assets, masks, bands)`.

Written from the reference repository's model descriptions, with no
import of the program under test:

  ResNet-50 trunk  stem conv 7x7/2 (its pre-BN output is the skip x0), BN,
                   ReLU, max pool 3x3/2, bottleneck stages of 3, 4, 6, 3
                   blocks; BatchNorm on its running statistics.
  depth decoder    x4 -> 1024 -> 512 -> 256 -> 128, each level a 1x1 conv,
                   a ResBlock and an upsampler (conv 3x3 to 4n, pixel
                   shuffle 2, BN), the trunk's skip joined before each
                   later level; then a 1x1 conv over x0's join, two
                   ResBlocks, an upsampler and a 3x3 projection to 1 channel.
  IEF head         3 iterations of fc1 -> fc2 -> (decpose, decshape,
                   deccam) added to the estimate; pose read as 6D and
                   turned into rotations by Gram-Schmidt.
  two-stage fusion an encoder (HMR without decoder) on the joined inputs;
                   the body mask of its SMPL estimate; per recovered
                   modality a gated encoder and a decoder over the
                   upsampled x4 and x0; the encoder again on the recovered
                   inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import smpl as smpl_ref
from .params import DECODER_LEVELS, HEAD_NAME, RESNET50_STAGES

BN_EPS = 1e-5
# How far (in pixels of the splat) a vertex may sit from where the
# reference puts it before its body-mask pixel counts as a different one:
# float32 skinning orders move vertices by ~1e-5 px at 224^2.
MASK_EDGE_PX = 1e-3


def conv(w, name, x, stride=1, padding=0):
    return F.conv2d(x, w[f"{name}.weight"], w.get(f"{name}.bias"), stride, padding)


def bn(w, name, x):
    return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"], w[f"{name}.weight"],
                        w[f"{name}.bias"], False, 0.0, BN_EPS)


def linear(w, name, x):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def bottleneck(w, name, x, stride, project):
    h = F.relu(bn(w, f"{name}.bn1", conv(w, f"{name}.conv1", x)))
    h = F.relu(bn(w, f"{name}.bn2", conv(w, f"{name}.conv2", h, stride, 1)))
    h = bn(w, f"{name}.bn3", conv(w, f"{name}.conv3", h))
    residual = bn(w, f"{name}.downsample.1", conv(w, f"{name}.downsample.0", x, stride)) if project else x
    return F.relu(h + residual)


def pyramid(w, prefix, x):
    """(x0..x4): x0 the stem conv before BN, x1..x4 the stages' outputs."""
    x0 = conv(w, f"{prefix}conv1", x, 2, 3)
    h = F.max_pool2d(F.relu(bn(w, f"{prefix}bn1", x0)), 3, stride=2, padding=1)
    outs = [x0]
    for i, (_, blocks, stride) in enumerate(RESNET50_STAGES, start=1):
        for b in range(blocks):
            h = bottleneck(w, f"{prefix}layer{i}.{b}", h, stride if b == 0 else 1, b == 0)
        outs.append(h)
    return tuple(outs)


def resblock(w, name, x):
    h = F.relu(bn(w, f"{name}.body.1", conv(w, f"{name}.body.0", x, 1, 1)))
    return bn(w, f"{name}.body.4", conv(w, f"{name}.body.3", h, 1, 1)) + x


def upsample(w, name, x):
    return bn(w, f"{name}.2", F.pixel_shuffle(conv(w, f"{name}.0", x, 1, 1), 2))


def decode(w, prefix, p):
    """The depth decoder on the pyramid p = (x0..x4)."""
    skips = (None, p[3], p[2], p[1])
    h = p[4]
    for i in range(1, len(DECODER_LEVELS) + 1):
        if skips[i - 1] is not None:
            h = torch.cat((skips[i - 1], h), 1)
        level = f"{prefix}decDepth{i}"
        h = upsample(w, f"{level}.2", resblock(w, f"{level}.1", conv(w, f"{level}.0", h)))
    h = conv(w, f"{prefix}decDepth.0", torch.cat((p[0], h), 1))
    h = resblock(w, f"{prefix}decDepth.2", resblock(w, f"{prefix}decDepth.1", h))
    return conv(w, f"{prefix}decDepth.4", upsample(w, f"{prefix}decDepth.3", h), 1, 1)


def rot6d_to_rotmat(x):
    """[B, 144] -> [B*24, 3, 3]; the 6 numbers are the first two columns."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = F.normalize(a1, dim=-1, eps=1e-12)
    b2 = F.normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1, dim=-1, eps=1e-12)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def regress(w, prefix, x4, init=None, n_iter=3):
    """IEF from `init` (pose6d, betas, cam) or the mean parameters:
    {pose6d, rotmat, betas, cam}."""
    batch = x4.shape[0]
    if init is None:
        init = tuple(w[f"{prefix}init_{k}"].expand(batch, -1) for k in ("pose", "shape", "cam"))
    pose, shape, cam = init
    xf = x4.mean(dim=(2, 3))
    for _ in range(n_iter):
        xc = torch.cat([xf, pose, shape, cam], dim=1)
        xc = linear(w, f"{prefix}fc2", linear(w, f"{prefix}fc1", xc))
        pose = linear(w, f"{prefix}decpose", xc) + pose
        shape = linear(w, f"{prefix}decshape", xc) + shape
        cam = linear(w, f"{prefix}deccam", xc) + cam
    return {"pose6d": pose, "rotmat": rot6d_to_rotmat(pose).reshape(batch, 24, 3, 3), "betas": shape, "cam": cam}


def hmr(w, prefix, x, recon_heads=(), init=None):
    """One HMR pass; `recon` holds each named decoder's image."""
    p = pyramid(w, prefix, x)
    out = regress(w, prefix, p[4], init)
    out["recon"] = {h: decode(w, f"{prefix}Reconstruct_{h}.", p) for h in recon_heads}
    out["pyramid"] = p
    return out


def feat_up(w, prefix, x4):
    h = x4
    for i in range(4):
        h = F.pixel_shuffle(conv(w, f"{prefix}dec1.{2 * i}", h, 1, 1), 2)
    return h


def two_stage_fusion(w, prefix, inputs, assets, recover, init=None, mask=None, bands=False):
    """(stage-2 output, recovered images, mask used, (lo, hi) band of the
    reference's mask when `bands`).  With `mask` given (the program's mask
    of this stage), the stages after the mask follow it instead of the
    reference's own."""
    H = inputs[0].shape[2]
    out1 = hmr(w, f"{prefix}encoder_1.", torch.cat(list(inputs), 1), (), init)
    x0, x4 = out1["pyramid"][0], out1["pyramid"][4]
    verts, _ = smpl_ref.lbs(assets, out1["betas"], out1["rotmat"])
    band = smpl_ref.body_mask_band(verts, out1["cam"], H, MASK_EDGE_PX) if bands else None
    if mask is None:
        mask = smpl_ref.render_body_mask(verts, out1["cam"], img_res=H).clamp(0.0, 1.0)
    up = feat_up(w, prefix, x4)
    recovered = {}
    for head, slot in recover:
        name = HEAD_NAME[head]
        h = resblock(w, f"{prefix}dec{name}2.1", conv(w, f"{prefix}dec{name}2.0", inputs[slot] * mask, 2, 1))
        h = resblock(w, f"{prefix}dec{name}3.1", conv(w, f"{prefix}dec{name}3.0", torch.cat([up, h, x0], 1), 1, 1))
        recovered[head] = conv(w, f"{prefix}dec{name}3.3", F.pixel_shuffle(h, 2), 1, 1)
    slot_head = {s: h for h, s in recover}
    stage2_in = [recovered[slot_head[i]] if i in slot_head else x for i, x in enumerate(inputs)]
    out2 = hmr(w, f"{prefix}encoder_1.", torch.cat(stage2_in, 1))
    return out2, recovered, mask, band


@torch.no_grad()
def infer(network, w, config, inputs, assets, masks=None, bands=False):
    """The eval step: `network` (an architecture module's), SMPL vertices,
    pelvis-centred H36M J17.
    Returns {rotmat, betas, cam, vertices, keypoints_3d_17, recon.<image>,
    tap.<stage> (the body mask each fusion stage used) and band.<stage>
    (the (lo, hi) band of the reference's own mask, with `bands`)}."""
    out = network(w, config, inputs, assets, masks, bands)
    verts, _ = smpl_ref.lbs(assets, out["betas"], out["rotmat"])
    result = {"rotmat": out["rotmat"], "betas": out["betas"], "cam": out["cam"], "vertices": verts,
              "keypoints_3d_17": smpl_ref.regress_j17(assets, verts)}
    for k, v in out["recon"].items():
        result[f"recon.{k}"] = v
    for k, v in out.get("taps", {}).items():
        result[f"tap.{k}"] = v
    for k, v in out.get("bands", {}).items():
        result[f"band.{k}"] = v
    return result
