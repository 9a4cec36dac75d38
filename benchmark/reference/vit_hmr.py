"""vit_hmr: HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023,
arXiv:2305.20091; 4D-Humans `hmr2/models/backbones/vit.py`, the ViTPose
ViT of arXiv:2204.12484, and `hmr2/models/heads/smpl_head.py::
SMPLTransformerDecoderHead` over `hmr2/models/components/
pose_transformer.py::TransformerDecoder`), on the modalities joined on the
channel axis, in one pass.

The trunk, with D = hidden_size and T the patch grid's tokens:

  x = patch_embed.proj(x)   conv patch_size x patch_size, stride
                            patch_size, padding patch_padding, C -> D,
                            with bias; read as tokens [B, T, D]
  x = x + pos_embed[:, 1:] + pos_embed[:, :1]        pos_embed [1, T + 1, D]
  each of num_hidden_layers blocks:
     h = LN(x, norm1);  q, k, v = heads of qkv(h)  (Linear(D, 3D), bias;
         num_attention_heads heads of d = D / heads)
     x = x + proj(softmax((q * d^-1/2) k^T) v)       proj Linear(D, D)
     x = x + fc2(gelu(fc1(LN(x, norm2))))   fc1 D -> intermediate_size,
                                           exact (erf) GELU
  context = LN(x, last_norm)        every LN here with eps layer_norm_eps

Drop path (rates 0 .. drop_path_rate over the blocks) acts in training
only, so not here.

The head, with d = head_hidden_size, h = head_num_attention_heads heads of
e = head_dim_head:

  x = to_token_embedding(zeros [B, 1, 1]) + pos_embedding     Linear(1, d)
  each of head_num_layers layers, every LN with eps head_layer_norm_eps:
     y = LN(x);  q, k, v = heads of to_qkv(y)  (Linear(d, 3he), no bias)
     x = softmax((q k^T) * e^-1/2) v -> to_out (Linear(he, d), bias) + x
     y = LN(x);  q = heads of to_q(y) (no bias);
         k, v = heads of to_kv(context) (Linear(D, 2he), no bias; the
         context is not normed)
     x = softmax((q k^T) * e^-1/2) v -> to_out + x
     x = net.3(gelu(net.0(LN(x)))) + x      Linear(d, head_mlp_dim), back
  (no final norm)
  pose6d, betas, cam = mean parameters + decpose, decshape, deccam
  (Linear(d, 144 / 10 / 3)) of x[:, 0], ief_iters (1) times
  rotmat = Gram-Schmidt of pose6d read as 24 (3 x 2) matrices

Departures from HMR 2.0: the input is the four modalities joined on
channels (6 channels, not RGB's 3) at 224^2, not a 256 x 192 crop, so
14 x 14 = 196 tokens and pos_embed [1, 197, D], not 192 and [1, 193, D];
and the 6D pose is read in this system's layout, the 3 x 2 matrix of the
first two columns, where HMR 2.0 reads `reshape(-1, 2, 3).permute(0, 2,
1)`: a released checkpoint would permute decpose's rows and the mean pose.

Weights are drawn by `benchmark/weights.py`'s kinds: the convolution and
the Linears as `conv` / `linear`, their biases as `bias`; the LayerNorm
gains as `bn_weight`, the LayerNorm biases and both position embeddings as
`bn_bias`; decpose, decshape and deccam as `head`; the mean parameters
(`smpl_head.init_body_pose`, `init_betas`, `init_cam`) as
`params.mean_params` draws them.  Names are HMR 2.0's state dict's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nets, params as P

MEAN_NAMES = ("init_body_pose", "init_betas", "init_cam")
TOKEN = "smpl_head.transformer."


def token_grid(config) -> int:
    """Tokens along one side of the patch grid."""
    return (config["img_res"] + 2 * config["patch_padding"] - config["patch_size"]) // config["patch_size"] + 1


def _layer_norm(name, n):
    return [(f"{name}.weight", (n,), "bn_weight", n), (f"{name}.bias", (n,), "bn_bias", n)]


def _no_bias(name, cout, cin):
    return [(f"{name}.weight", (cout, cin), "linear", cin)]


def params(config):
    """Every parameter and buffer of the network, named as the program's
    state dict names them."""
    D, M, k = config["hidden_size"], config["intermediate_size"], config["patch_size"]
    out = P.conv("backbone.patch_embed.proj", D, sum(config["channels"]), k, bias=True)
    out.append(("backbone.pos_embed", (1, token_grid(config) ** 2 + 1, D), "bn_bias", D))
    for i in range(config["num_hidden_layers"]):
        b = f"backbone.blocks.{i}"
        out += _layer_norm(f"{b}.norm1", D) + P.linear(f"{b}.attn.qkv", 3 * D, D) + P.linear(f"{b}.attn.proj", D, D)
        out += _layer_norm(f"{b}.norm2", D) + P.linear(f"{b}.mlp.fc1", M, D) + P.linear(f"{b}.mlp.fc2", D, M)
    out += _layer_norm("backbone.last_norm", D)

    d, inner, mlp = config["head_hidden_size"], config["head_num_attention_heads"] * config["head_dim_head"], \
        config["head_mlp_dim"]
    out += P.linear(f"{TOKEN}to_token_embedding", d, 1) + [(f"{TOKEN}pos_embedding", (1, 1, d), "bn_bias", d)]
    for i in range(config["head_num_layers"]):
        layer = f"{TOKEN}transformer.layers.{i}"
        out += _layer_norm(f"{layer}.0.norm", d) + _no_bias(f"{layer}.0.fn.to_qkv", 3 * inner, d)
        out += P.linear(f"{layer}.0.fn.to_out.0", d, inner)
        out += _layer_norm(f"{layer}.1.norm", d) + _no_bias(f"{layer}.1.fn.to_kv", 2 * inner, D)
        out += _no_bias(f"{layer}.1.fn.to_q", inner, d) + P.linear(f"{layer}.1.fn.to_out.0", d, inner)
        out += _layer_norm(f"{layer}.2.norm", d) + P.linear(f"{layer}.2.fn.net.0", mlp, d)
        out += P.linear(f"{layer}.2.fn.net.3", d, mlp)
    out += (P.linear("smpl_head.decpose", P.NPOSE, d, "head") + P.linear("smpl_head.decshape", 10, d, "head")
            + P.linear("smpl_head.deccam", 3, d, "head"))
    return out + [(f"smpl_head.{name}", shape, kind, fan_in)
                  for name, (_, shape, kind, fan_in) in zip(MEAN_NAMES, P.mean_params(""))]


def layer_norm(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def attention(q, k, v, scale=None):
    """softmax(q k^T, times `scale` when given) v over [B, heads, N, d]."""
    scores = q @ k.transpose(-2, -1)
    if scale is not None:
        scores = scores * scale
    return torch.softmax(scores, dim=-1) @ v


def _heads(t, heads):
    B, N, _ = t.shape
    return t.reshape(B, N, heads, -1).transpose(1, 2)


def _merge(t):
    B, H, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, H * d)


def vit(w, config, x):
    """The trunk: image [B, C, H, W] -> context [B, T, D]."""
    D, H, eps = config["hidden_size"], config["num_attention_heads"], config["layer_norm_eps"]
    x = nets.conv(w, "backbone.patch_embed.proj", x, config["patch_size"], config["patch_padding"])
    x = x.flatten(2).transpose(1, 2)
    pos = w["backbone.pos_embed"]
    x = x + pos[:, 1:] + pos[:, :1]
    for i in range(config["num_hidden_layers"]):
        b = f"backbone.blocks.{i}"
        h = layer_norm(w, f"{b}.norm1", x, eps)
        B, N, _ = h.shape
        q, k, v = nets.linear(w, f"{b}.attn.qkv", h).reshape(B, N, 3, H, -1).permute(2, 0, 3, 1, 4)
        x = x + nets.linear(w, f"{b}.attn.proj", _merge(attention(q * (D // H) ** -0.5, k, v)))
        h = layer_norm(w, f"{b}.norm2", x, eps)
        x = x + nets.linear(w, f"{b}.mlp.fc2", F.gelu(nets.linear(w, f"{b}.mlp.fc1", h)))
    return layer_norm(w, "backbone.last_norm", x, eps)


def token_decoder(w, config, context):
    """One zero token through the decoder's layers: [B, 1, d]."""
    heads, eps = config["head_num_attention_heads"], config["head_layer_norm_eps"]
    scale = config["head_dim_head"] ** -0.5
    x = nets.linear(w, f"{TOKEN}to_token_embedding", context.new_zeros(context.shape[0], 1, 1))
    x = x + w[f"{TOKEN}pos_embedding"]
    for i in range(config["head_num_layers"]):
        layer = f"{TOKEN}transformer.layers.{i}"
        y = layer_norm(w, f"{layer}.0.norm", x, eps)
        q, k, v = (_heads(t, heads) for t in F.linear(y, w[f"{layer}.0.fn.to_qkv.weight"]).chunk(3, dim=-1))
        x = nets.linear(w, f"{layer}.0.fn.to_out.0", _merge(attention(q, k, v, scale))) + x
        y = layer_norm(w, f"{layer}.1.norm", x, eps)
        k, v = (_heads(t, heads) for t in F.linear(context, w[f"{layer}.1.fn.to_kv.weight"]).chunk(2, dim=-1))
        q = _heads(F.linear(y, w[f"{layer}.1.fn.to_q.weight"]), heads)
        x = nets.linear(w, f"{layer}.1.fn.to_out.0", _merge(attention(q, k, v, scale))) + x
        y = layer_norm(w, f"{layer}.2.norm", x, eps)
        x = nets.linear(w, f"{layer}.2.fn.net.3", F.gelu(nets.linear(w, f"{layer}.2.fn.net.0", y))) + x
    return x


def token_head(w, config, context):
    """{pose6d, rotmat, betas, cam} from the context."""
    B = context.shape[0]
    pose, betas, cam = (w[f"smpl_head.{name}"].expand(B, -1) for name in MEAN_NAMES)
    for _ in range(config["ief_iters"]):
        x = token_decoder(w, config, context)[:, 0]
        pose = nets.linear(w, "smpl_head.decpose", x) + pose
        betas = nets.linear(w, "smpl_head.decshape", x) + betas
        cam = nets.linear(w, "smpl_head.deccam", x) + cam
    return {"pose6d": pose, "rotmat": nets.rot6d_to_rotmat(pose).reshape(B, 24, 3, 3), "betas": betas, "cam": cam}


def network(w, config, inputs, assets, masks=None, bands=False):
    """One pass on a modality tuple (no mask: `masks` and `bands` are
    unused)."""
    out = token_head(w, config, vit(w, config, torch.cat(list(inputs), 1)))
    out["recon"] = {}
    return out
