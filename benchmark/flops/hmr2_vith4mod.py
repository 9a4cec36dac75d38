"""FLOPs of one hmr2_vith4mod eval call: HMR 2.0's ViT trunk over the
joined modalities and its transformer-decoder head, in one pass; then SMPL
and the H36M joints.  `network` is what runs inside the model's forward
calls; `step` the whole call; `vit` the trunk's share of `network`
(patch embedding and blocks); `vit_attn` the blocks' attention cores
(query-key and attention-value products) inside `vit`."""

from benchmark import arch_flops as A
from benchmark.reference.params import NPOSE
from benchmark.reference.vit_hmr import token_grid


def attention_core(B, heads, n_q, n_k, d):
    """One attention's q k^T and attention-value products."""
    return 2 * 2 * B * heads * n_q * n_k * d


def linear(rows, cin, cout):
    return 2 * rows * cin * cout


def vit(B, config):
    """(the trunk's FLOPs, its attention cores' FLOPs, its tokens)."""
    D, M, H, k = config["hidden_size"], config["intermediate_size"], config["num_attention_heads"], config["patch_size"]
    g = token_grid(config)
    T = g * g
    attn = config["num_hidden_layers"] * attention_core(B, H, T, T, D // H)
    block = linear(B * T, D, 3 * D) + linear(B * T, D, D) + linear(B * T, D, M) + linear(B * T, M, D)
    flops = A.conv(B, sum(config["channels"]), D, k, g) + config["num_hidden_layers"] * block + attn
    return flops, attn, T


def token_head(B, config, T):
    d, D, mlp = config["head_hidden_size"], config["hidden_size"], config["head_mlp_dim"]
    h, e = config["head_num_attention_heads"], config["head_dim_head"]
    inner = h * e
    layer = (linear(B, d, 3 * inner) + attention_core(B, h, 1, 1, e) + linear(B, inner, d)
             + linear(B, d, inner) + linear(B * T, D, 2 * inner) + attention_core(B, h, 1, T, e) + linear(B, inner, d)
             + linear(B, d, mlp) + linear(B, mlp, d))
    per_iter = linear(B, 1, d) + config["head_num_layers"] * layer + linear(B, d, NPOSE + 10 + 3)
    return config["ief_iters"] * per_iter


def count(config, traffic):
    B = traffic["batch"]
    trunk, attn, T = vit(B, config)
    network = config["num_cas_iters"] * (trunk + token_head(B, config, T))
    step = network + A.lbs(B, config["smpl"]) + A.j17(B, config["smpl"])
    return {"network": network, "step": step, "vit": config["num_cas_iters"] * trunk,
            "vit_attn": config["num_cas_iters"] * attn}
