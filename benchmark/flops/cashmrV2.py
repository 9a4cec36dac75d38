"""FLOPs of one cashmrV2 eval call: `num_cas_iters` passes of HMR over the
joined modalities, the last without its decoder (unless `final_recon`),
then SMPL and the H36M joints.  `network` is what runs inside the model's
forward calls; `step` the whole call."""

from benchmark import arch_flops as A


def count(config, traffic):
    B, res, cin = traffic["batch"], config["img_res"], sum(config["channels"])
    n = config["num_cas_iters"]
    network = 0
    for stage in range(n):
        decode = stage < n - 1 or config["final_recon"]
        network += A.hmr(B, cin, res, decode)[0]
    step = network + A.lbs(B, config["smpl"]) + A.j17(B, config["smpl"])
    return {"network": network, "step": step}
