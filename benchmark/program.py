"""The system under test, built from the benchmark's weights and assets.

This is the only module of the benchmark that imports the program,
`inbed_pose_estimation_tpu_torch`, and it takes from it only the entry
that the eval CLI drives: `build_model` and
`evaluation/pipeline.py::make_inference_fn`, called as `eval_gpu.py`
calls it (`num_cas_iters` passes, the last without its decoder).
"""

from __future__ import annotations

import torch


def build_inference(run):
    """(model, infer): the registered model with the run's weights loaded
    strictly, and the eval step over it, with the body masks of the
    configuration's `mask_taps` stages kept in each answer.  `run.wrap`,
    when set, wraps the step (tests break the timed path with it)."""
    from inbed_pose_estimation_tpu_torch.constants import JOINT_MAP_ARRAY
    from inbed_pose_estimation_tpu_torch.evaluation.pipeline import make_inference_fn
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.smpl.model import SMPLModel

    cfg, dev, assets = run.config, run.device, run.assets
    with dev:
        model, spec = build_model(cfg["model"], device=dev, img_res=cfg["img_res"])
    model.load_state_dict(run.weights, strict=True)

    def host(name):
        return assets[name].cpu().numpy()

    smpl = SMPLModel(v_template=host("v_template"), shapedirs=host("shapedirs"), posedirs=host("posedirs"),
                     J_regressor=host("J_regressor"), lbs_weights=host("lbs_weights"), parents=assets["parents"],
                     J_regressor_extra=host("J_regressor_extra"), joint_map=JOINT_MAP_ARRAY,
                     faces=host("faces")).to(dev)
    infer = make_inference_fn(model, spec, smpl, j_regressor_h36m=host("j_regressor_h36m"),
                              num_cas_iters=cfg["num_cas_iters"], final_recon=cfg["final_recon"], device=dev)
    infer = _with_mask_taps(model, infer, cfg.get("mask_taps", ()))
    if run.wrap is not None:
        infer = run.wrap(infer)
    return model, infer


def _with_mask_taps(model, infer, stages):
    """The step with each named fusion stage's body mask kept under the
    answer's `taps` (a forward hook on that stage reads its output's
    `mask`; the check follows these masks, see check.py)."""
    if not stages:
        return infer
    taps = {}
    for stage in stages:
        model.get_submodule(stage).register_forward_hook(
            lambda module, args, output, stage=stage: taps.__setitem__(stage, output.mask))

    def tapped(inputs):
        taps.clear()
        out = infer(inputs)
        out["taps"] = dict(taps)
        return out
    return tapped


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def to_host(out: dict) -> dict:
    """An answer's tensors (and its `recon` dict's) copied to the host."""
    return {k: ({kk: vv.detach().cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.detach().cpu())
            for k, v in out.items()}
