"""FLOPs of the benchmark's architectures, from their shapes.

Counted as torch's FlopCounterMode counts them (two per multiply-add of a
convolution, matrix product or einsum contraction; bias adds, norms,
pooling and element-wise work not counted), so that a test can hold each
count to FlopCounterMode run over the plain reference at a small size.
The counts never come from the program under test: a kernel that replaces
a layer leaves them as they are.
"""

from __future__ import annotations

from .reference.params import DECODER_LEVELS, IEF_IN_EXTRA, NPOSE, RESNET50_STAGES


def out_size(h, k, stride=1, padding=0):
    return (h + 2 * padding - k) // stride + 1


def conv(B, cin, cout, k, h_out):
    return 2 * B * cout * h_out * h_out * cin * k * k


def resblock(B, n, h):
    return 2 * conv(B, n, n, 3, h)


def resnet50(B, cin, res):
    """(FLOPs, resolutions of x0..x4)."""
    h0 = out_size(res, 7, 2, 3)
    flops = conv(B, cin, 64, 7, h0)
    h = out_size(h0, 3, 2, 1)
    sizes = [h0]
    inplanes = 64
    for planes, blocks, stride in RESNET50_STAGES:
        for b in range(blocks):
            s = stride if b == 0 else 1
            h_out = out_size(h, 3, s, 1)
            flops += conv(B, inplanes, planes, 1, h) + conv(B, planes, planes, 3, h_out) \
                + conv(B, planes, planes * 4, 1, h_out)
            if b == 0:
                flops += conv(B, inplanes, planes * 4, 1, out_size(h, 1, s, 0))
            inplanes, h = planes * 4, h_out
        sizes.append(h)
    return flops, sizes


def decoder(B, sizes, in_features=2048):
    flops, h = 0, sizes[4]
    for (cin, n), skip in zip(DECODER_LEVELS, (None, 3, 2, 1)):
        width = in_features if cin is None else cin
        if skip is not None:
            h = sizes[skip]
        flops += conv(B, width, n, 1, h) + resblock(B, n, h) + conv(B, n, 4 * n, 3, h)
    h = sizes[0]
    flops += conv(B, 128 + 64, 128, 1, h) + 2 * resblock(B, 128, h) + conv(B, 128, 512, 3, h)
    return flops + conv(B, 128, 1, 3, 2 * h)


def ief(B, feat_dim=2048, n_iter=3):
    per = (feat_dim + IEF_IN_EXTRA) * 1024 + 1024 * 1024 + 1024 * (NPOSE + 10 + 3)
    return 2 * B * per * n_iter


def hmr(B, cin, res, decode):
    flops, sizes = resnet50(B, cin, res)
    flops += ief(B)
    if decode:
        flops += decoder(B, sizes)
    return flops, sizes


def lbs(B, smpl):
    V, J, K, P = smpl["num_vertices"], smpl["num_joints"], smpl["num_betas"], smpl["num_pose_blend"]
    return 2 * B * (V * 3 * K + J * V * 3 + P * V * 3 + (J - 1) * 64 + J * 9 + V * J * 9 + V * J * 3 + V * 9)


def j17(B, smpl):
    return 2 * B * smpl["num_h36m_joints"] * smpl["num_vertices"] * 3


def projection(B, smpl):
    return 2 * B * smpl["num_vertices"] * 9


def two_stage_fusion(B, slot_channels, recover, res, smpl):
    """Both encoder passes, the body mask's SMPL and projection, the
    upsampled x4 and each recovered modality's decoder."""
    f1, sizes = hmr(B, sum(slot_channels), res, False)
    f2, _ = hmr(B, sum(slot_channels), res, False)
    flops = f1 + f2 + lbs(B, smpl) + projection(B, smpl)
    h = sizes[4]
    for i in range(4):
        flops += conv(B, 2048 if i == 0 else 128, 512, 3, h)
        h *= 2
    half = out_size(res, 3, 2, 1)
    for _, slot in recover:
        flops += conv(B, slot_channels[slot], 64, 3, half) + resblock(B, 64, half)
        flops += conv(B, 256, 256, 3, half) + resblock(B, 256, half) + conv(B, 64, 1, 3, 2 * half)
    return flops
