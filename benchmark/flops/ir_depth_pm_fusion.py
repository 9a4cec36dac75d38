"""FLOPs of one ir_depth_pm_fusion eval call: the frozen (ir, depth) guide
and the 5-slot main fusion, each two encoder passes, its body mask's SMPL
and projection, the upsampled x4 and the recovered ir and depth decoders;
then SMPL and the H36M joints.  `network` is the model's forward (the
SMPL of its masks included); `step` the whole call."""

from benchmark import arch_flops as A


def count(config, traffic):
    B, res, smpl = traffic["batch"], config["img_res"], config["smpl"]
    recover = [tuple(r) for r in config["recover"]]
    network = (A.two_stage_fusion(B, config["guide_channels"], recover, res, smpl)
               + A.two_stage_fusion(B, config["main_channels"], recover, res, smpl))
    step = network + A.lbs(B, smpl) + A.j17(B, smpl)
    return {"network": network, "step": step}
