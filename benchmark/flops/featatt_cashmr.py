"""FLOPs of one featatt_cashmr eval call: `num_cas_iters` passes, each of
one ResNet-50 per modality, the cross attention over their x4 maps and
IEF on the fused features, the depth decoder from the fused width in
every pass but the last (unless `final_recon`); then SMPL and the H36M
joints.  `network` is what runs inside the model's forward calls; `step`
the whole call; `cross_att` the cross attention's share of `network`."""

from benchmark import arch_flops as A
from benchmark.reference.multi_trunk_cascade import WIDTH


def cross_attention(B, n, h):
    """Per pass: query, key and value 1x1 convolutions of each modality's
    x4, one query-key product per modality and one attention-value product
    for each pair of modalities."""
    tokens = h * h
    return 3 * n * A.conv(B, WIDTH, WIDTH, 1, h) + (n + n * n) * 2 * B * tokens * tokens * WIDTH


def count(config, traffic):
    B, res, channels = traffic["batch"], config["img_res"], config["channels"]
    n_mod, n = len(channels), config["num_cas_iters"]
    network = cross_att = 0
    for stage in range(n):
        sizes = None
        for c in channels:
            flops, sizes = A.resnet50(B, c, res)
            network += flops
        att = cross_attention(B, n_mod, sizes[4])
        cross_att += att
        network += att + A.ief(B, n_mod * WIDTH)
        if stage < n - 1 or config["final_recon"]:
            network += A.decoder(B, sizes, n_mod * WIDTH)
    step = network + A.lbs(B, config["smpl"]) + A.j17(B, config["smpl"])
    return {"network": network, "step": step, "cross_att": cross_att}
