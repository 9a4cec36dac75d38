"""HMR 2.0's network (Goel et al., "Humans in 4D", ICCV 2023,
arXiv:2305.20091): a ViT-H/16 trunk (ViTPose, arXiv:2204.12484; 4D-Humans
`hmr2/models/backbones/vit.py`) and a transformer-decoder SMPL head
(`hmr2/models/heads/smpl_head.py::SMPLTransformerDecoderHead` over
`hmr2/models/components/pose_transformer.py::TransformerDecoder`).

The trunk, on x [B, C, H, W], with D = hidden_size:

  x = patch_embed.proj(x)   Conv2d(C, D, 16, stride 16, padding 2), read
                            as T tokens [B, T, D] (14 x 14 at 224^2)
  x = x + pos_embed[:, 1:] + pos_embed[:, :1]      pos_embed [1, T + 1, D]
  each block:  x = x + drop_path(attn(norm1(x)))
               x = x + drop_path(mlp(norm2(x)))
    attn  qkv Linear(D, 3D) with bias; per head of D / heads channels
          softmax((q * d^-1/2) k^T) v; proj Linear(D, D)
    mlp   fc1 Linear(D, intermediate_size), exact GELU, fc2 back to D
    norm1, norm2 LayerNorm(eps 1e-6); drop path in training only, its
    rate rising linearly from 0 to drop_path_rate over the blocks
  context = last_norm(x)                            LayerNorm(eps 1e-6)

The head, with d = head_hidden_size:

  x = to_token_embedding(zeros [B, 1, 1]) + pos_embedding      [B, 1, d]
  each layer:  x = x + SelfAttn(LN(x))
               x = x + CrossAttn(LN(x), context)
               x = x + FF(LN(x))
    attention of head_num_attention_heads heads of head_dim_head: no bias
    on to_qkv, to_q and to_kv (to_kv maps the D-wide context), to_out
    Linear with bias; softmax((q k^T) * head_dim_head^-1/2) v
    FF  Linear(d, head_mlp_dim), exact GELU, Linear back to d
    LN  LayerNorm(eps 1e-5); the context is not normed; no final norm
  pose6d, betas, cam = mean + decpose / decshape / deccam(x[:, 0]),
  ief_iters (1) times; rotmat = geometry.rot6d_to_rotmat(pose6d)

Departures from HMR 2.0, as this system runs it: the input is the four
modalities joined on channels (6 channels, not RGB's 3) at 224^2 (not a
256 x 192 crop), so 196 tokens, not 192; and the 6D pose is read in this
system's layout (`rot6d_to_rotmat`'s 3 x 2), where HMR 2.0 reads it as
`reshape(-1, 2, 3).permute(0, 2, 1)`, so a released checkpoint would
permute decpose's rows and the mean pose.

Parameter names are HMR 2.0's state dict's (`backbone.*`, `smpl_head.*`;
the mean parameters are the buffers `smpl_head.init_body_pose`,
`init_betas`, `init_cam`).  The model takes `HMRCore`'s call and returns
an `HMROutput` with no recovered images.  Spans: `hmr.vit` around the
trunk, `hmr.vit_attn` around each block's attention core (scores,
softmax, values; nested in `hmr.vit`), `hmr.token_head` around the head
and its readout.  `attention_calls` counts the attention cores run, by
(route, kind): kind "self" or "cross".
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import torch
from torch import nn

from ..constants import IMG_RES
from ..geometry import rot6d_to_rotmat
from ..utils.profiling import span
from .heads import NPOSE, dropout
from .hmr import HMROutput
from .layers import Conv2d, Linear


@dataclass(frozen=True)
class ViTHMRWidths:
    """The sizes of a ViT trunk and its decoder head, under the keys of the
    benchmark's configuration file."""
    patch_size: int = 16
    patch_padding: int = 2
    hidden_size: int = 1280
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    intermediate_size: int = 5120
    layer_norm_eps: float = 1e-6
    drop_path_rate: float = 0.55
    head_hidden_size: int = 1024
    head_num_layers: int = 6
    head_num_attention_heads: int = 8
    head_dim_head: int = 64
    head_mlp_dim: int = 1024
    head_layer_norm_eps: float = 1e-5
    ief_iters: int = 1


# A `ModelSpec.trunk` of this family -> the widths it is built at.
WIDTHS = {"vit_h16": ViTHMRWidths()}

# Attention cores run, by (route, kind); raised where each runs.
attention_calls: collections.Counter = collections.Counter()


def attend(q, k, v, kind: str, scale=None):
    """softmax(q k^T, times `scale` when given) v over [B, heads, N, d]:
    explicit products and softmax, which keep float32 with TF32 off."""
    attention_calls[("plain", kind)] += 1
    scores = q @ k.transpose(-2, -1)
    if scale is not None:
        scores = scores * scale
    return torch.softmax(scores, dim=-1) @ v


def drop_path(x, rate: float, generator=None):
    """Stochastic depth: each row of x kept whole with probability
    1 - rate and scaled by 1 / (1 - rate), else zeroed; the per-row mask is
    drawn as `heads.dropout` draws its masks (from `generator`, the global
    batch's under data parallel)."""
    if rate == 0.0:
        return x
    return x * dropout(x.new_ones((x.shape[0],) + (1,) * (x.dim() - 1)), rate, generator)


def _heads(t, heads):
    """[B, N, heads * d] -> [B, heads, N, d]."""
    B, N, _ = t.shape
    return t.reshape(B, N, heads, -1).transpose(1, 2)


def _merge(t):
    """[B, heads, N, d] -> [B, N, heads * d]."""
    B, H, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, H * d)


class Attention(nn.Module):
    """ViTPose's self attention: qkv (with bias), heads, proj."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        with span("hmr.vit_attn"):
            out = attend(q * self.scale, k, v, "self")
        return self.proj(_merge(out))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    """A pre-norm transformer block; `drop_path_rate` applies in training."""

    def __init__(self, w: ViTHMRWidths, drop_path_rate: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(w.hidden_size, eps=w.layer_norm_eps)
        self.attn = Attention(w.hidden_size, w.num_attention_heads)
        self.norm2 = nn.LayerNorm(w.hidden_size, eps=w.layer_norm_eps)
        self.mlp = Mlp(w.hidden_size, w.intermediate_size)
        self.drop_path_rate = drop_path_rate

    def forward(self, x, generator=None):
        rate = self.drop_path_rate if self.training else 0.0
        x = x + drop_path(self.attn(self.norm1(x)), rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


def token_grid(w: ViTHMRWidths, img_res: int) -> int:
    """Tokens along one side of the patch grid at `img_res`."""
    return (img_res + 2 * w.patch_padding - w.patch_size) // w.patch_size + 1


class ViT(nn.Module):
    """The trunk: image [B, C, H, W] -> context tokens [B, T, hidden_size]."""

    def __init__(self, in_channels: int, w: ViTHMRWidths, img_res: int = IMG_RES, drop_path_rate=None):
        super().__init__()
        D = w.hidden_size
        self.patch_embed = nn.ModuleDict({"proj": Conv2d(in_channels, D, w.patch_size, stride=w.patch_size,
                                                         padding=w.patch_padding)})
        self.pos_embed = nn.Parameter(torch.zeros(1, token_grid(w, img_res) ** 2 + 1, D))
        top = w.drop_path_rate if drop_path_rate is None else drop_path_rate
        n = w.num_hidden_layers
        self.blocks = nn.ModuleList(Block(w, top * i / max(n - 1, 1)) for i in range(n))
        self.last_norm = nn.LayerNorm(D, eps=w.layer_norm_eps)
        # ViTPose's initialization.
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        for m in self.blocks.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    def forward(self, x, generator=None):
        with span("hmr.vit"):
            x = self.patch_embed["proj"](x).flatten(2).transpose(1, 2)
            x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
            for block in self.blocks:
                x = block(x, generator)
            return self.last_norm(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class TokenSelfAttention(nn.Module):
    """pose_transformer's Attention: to_qkv (no bias), heads, to_out."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.to_qkv = Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(Linear(heads * dim_head, dim))

    def forward(self, x):
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out(_merge(attend(q, k, v, "self", self.scale)))


class TokenCrossAttention(nn.Module):
    """pose_transformer's CrossAttention: to_q on the tokens, to_kv on the
    context (both without bias), heads, to_out."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.to_kv = Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(Linear(heads * dim_head, dim))

    def forward(self, x, context):
        k, v = (_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))
        q = _heads(self.to_q(x), self.heads)
        return self.to_out(_merge(attend(q, k, v, "cross", self.scale)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # Index 2 is HMR 2.0's dropout, at rate 0; the Linears keep their
        # names net.0 and net.3.
        self.net = nn.Sequential(Linear(dim, hidden), nn.GELU(), nn.Identity(), Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class TransformerDecoder(nn.Module):
    """One query token through `head_num_layers` layers of self attention,
    cross attention to the context and a feed-forward, each pre-norm."""

    def __init__(self, w: ViTHMRWidths):
        super().__init__()
        d, eps = w.head_hidden_size, w.head_layer_norm_eps
        self.to_token_embedding = Linear(1, d)
        self.pos_embedding = nn.Parameter(torch.randn(1, 1, d))
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(d, TokenSelfAttention(d, w.head_num_attention_heads, w.head_dim_head), eps),
            PreNorm(d, TokenCrossAttention(d, w.hidden_size, w.head_num_attention_heads, w.head_dim_head), eps),
            PreNorm(d, FeedForward(d, w.head_mlp_dim), eps),
        ]) for _ in range(w.head_num_layers))

    def forward(self, token, context):
        x = self.to_token_embedding(token) + self.pos_embedding
        for self_attn, cross_attn, ff in self.transformer.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context) + x
            x = ff(x) + x
        return x


class SMPLTransformerDecoderHead(nn.Module):
    """Context tokens -> (pose6d, betas, cam) from the SMPL mean parameters,
    and the rotations."""

    def __init__(self, w: ViTHMRWidths, mean_pose, mean_shape, mean_cam):
        super().__init__()
        self.transformer = TransformerDecoder(w)
        d = w.head_hidden_size
        self.decpose = Linear(d, NPOSE)
        self.decshape = Linear(d, 10)
        self.deccam = Linear(d, 3)
        for layer in (self.decpose, self.decshape, self.deccam):
            nn.init.xavier_uniform_(layer.weight, gain=0.01)
        self.ief_iters = w.ief_iters
        for name, value in (("init_body_pose", mean_pose), ("init_betas", mean_shape), ("init_cam", mean_cam)):
            self.register_buffer(name, torch.as_tensor(value, dtype=torch.float32).reshape(1, -1))

    def forward(self, context) -> HMROutput:
        with span("hmr.token_head"):
            B = context.shape[0]
            pose6d, betas, cam = (t.expand(B, -1) for t in (self.init_body_pose, self.init_betas, self.init_cam))
            for _ in range(self.ief_iters):
                x = self.transformer(context.new_zeros(B, 1, 1), context)[:, 0]
                pose6d = self.decpose(x) + pose6d
                betas = self.decshape(x) + betas
                cam = self.deccam(x) + cam
            rotmat = rot6d_to_rotmat(pose6d).reshape(B, 24, 3, 3)
            return HMROutput(rotmat=rotmat, betas=betas, cam=cam, pose6d=pose6d, recon={})


class HMR2(nn.Module):
    """HMR 2.0: `backbone` (the ViT trunk) and `smpl_head` (the decoder
    head), with `HMRCore`'s call.  In training mode the trunk's drop path
    draws from `generator`; in eval mode nothing is drawn."""

    def __init__(self, in_channels: int, mean_pose, mean_shape, mean_cam, widths: ViTHMRWidths = WIDTHS["vit_h16"],
                 img_res: int = IMG_RES, drop_path_rate=None):
        super().__init__()
        self.backbone = ViT(in_channels, widths, img_res, drop_path_rate)
        self.smpl_head = SMPLTransformerDecoderHead(widths, mean_pose, mean_shape, mean_cam)

    def forward(self, x, compute_recon: bool = True, generator=None) -> HMROutput:
        """x: [B, C, H, W].  `compute_recon` is taken and ignored: the model
        recovers no image."""
        return self.smpl_head(self.backbone(x, generator))
