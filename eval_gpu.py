#!/usr/bin/env python3
"""Evaluation CLI of the PyTorch port (`inbed_pose_estimation_tpu_torch`).

    python eval_gpu.py --model cashmrV2 --checkpoint <ckpt> [--dataset ...]

The same flags and defaults as `eval.py`, plus `--device` (default cuda; it
raises without a card unless `--device cpu` is given) and
`--fast_preprocess` (the native host crop, as in `train_gpu.py`).  Scores the
slp-4mod cover2 / uncover / cover1 splits unless `--dataset` names one, with
MPJPE, PA-MPJPE, PVE and the body-mask accuracy and F1, and prints each
split's images/s.  `--result_file DIR` writes, as `eval.py` does, the fits
npz and the image dumps (mesh overlays, recovered modalities, masks) of
the first 8 samples of each batch.  Takes the JAX package's native `.npz` checkpoints and
reference `.pt` files; without `--checkpoint` the weights are random from a
fixed seed.  The frozen-guided fusion pipelines (ir_depth_pm_fusion,
ir_depth_pm_rgb_fusion) take their guide from
`--pretrained_fusion_checkpoint`, an ir_depth_fusion `.pt` or `.npz`,
grafted after `--checkpoint`.  `--crop_cache DIR` reads the images through
a crop cache built by `python -m
inbed_pose_estimation_tpu_torch.tools.build_crop_cache`.  Paths come from INBED_DATA_ROOT,
INBED_NPZ_PATH and INBED_ASSET_DIR.
"""

from __future__ import annotations

import argparse

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--model", type=str, default="hmr", help="model architecture name")
parser.add_argument("--checkpoint", default=None, help="Path to network checkpoint (.npz or .pt)")
parser.add_argument("--dataset", default=None, help="Evaluate a single split instead of the default three")
parser.add_argument("--log_freq", default=50, type=int)
parser.add_argument("--batch_size", default=32, type=int)
parser.add_argument("--shuffle", default=False, action="store_true")
parser.add_argument("--num_workers", default=8, type=int)
parser.add_argument("--result_file", default=None, help="If set, save detections under this dir")
parser.add_argument("--num_cas_iters", default=2, type=int)
parser.add_argument("--img_res", default=224, type=int)
parser.add_argument("--no_masks", default=False, action="store_true")
parser.add_argument("--crop_cache", default=None,
                    help="Directory of a pre-decoded crop cache (python -m "
                         "inbed_pose_estimation_tpu_torch.tools.build_crop_cache): memmap patch reads in place of "
                         "the 9 image reads a sample, bit-exact")
parser.add_argument("--fast_preprocess", default=False, action="store_true",
                    help="Crop, resize and normalize with the native C++ host kernel (not bit-identical to the "
                         "reference resampler); eval.py has no such flag")
parser.add_argument("--device_preprocess", default=False, action="store_true",
                    help="Crop, resize and normalize on the device from the raw uint8 frames")
parser.add_argument("--allow_synthetic_assets", default=False, action="store_true",
                    help="Run with synthetic SMPL/regressor stand-ins when real assets are missing "
                         "(metrics NOT reference-comparable)")
parser.add_argument("--pretrained_fusion_checkpoint", default=None,
                    help="An ir_depth_fusion checkpoint (.pt or JAX .npz) grafted as the frozen guide of "
                         "ir_depth_pm_fusion / ir_depth_pm_rgb_fusion, after --checkpoint")
parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")

DEFAULT_SPLITS = ("slp-4mod-cover2", "slp-4mod-uncover", "slp-4mod-cover1")


def main(argv=None) -> dict:
    """Run the CLI on `argv`; returns {split: run_evaluation's result dict}."""
    args = parser.parse_args(argv)

    import torch

    from inbed_pose_estimation_tpu_torch import config
    from inbed_pose_estimation_tpu_torch.data import BaseDataset
    from inbed_pose_estimation_tpu_torch.device import resolve_device
    from inbed_pose_estimation_tpu_torch.evaluation import run_evaluation
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.smpl import load_smpl_model, synthetic_smpl_model
    from inbed_pose_estimation_tpu_torch.train.checkpoint import load_checkpoint, load_guide, load_torch_checkpoint
    from inbed_pose_estimation_tpu_torch.utils.assets_check import check_assets

    dev = resolve_device(args.device)
    # Synthetic stand-ins are for tests, not for metrics: fail unless waived.
    check_assets(allow_synthetic=args.allow_synthetic_assets, smpl_model_dir=config.asset("smpl_model_dir"),
                 smpl_mean_params=config.asset("smpl_mean_params"),
                 j_regressor_h36m=config.asset("j_regressor_h36m"))

    torch.manual_seed(0)  # the weights of a run without --checkpoint
    model, spec = build_model(args.model, smpl_mean_params=config.asset("smpl_mean_params"), device=dev,
                              img_res=args.img_res)
    try:
        smpl_model = load_smpl_model(config.asset("smpl_model_dir"), "neutral", device=dev)
    except (FileNotFoundError, OSError, KeyError):
        smpl_model = synthetic_smpl_model(0, device=dev)

    # Male and female models for the splits scored against gendered meshes.
    smpl_gendered = None
    try:
        smpl_gendered = tuple(load_smpl_model(config.asset("smpl_model_dir"), g, device=dev)
                              for g in ("male", "female"))
    except (FileNotFoundError, OSError, KeyError):
        if args.allow_synthetic_assets:
            # Distinct seeds, so that the gender switch shows in the numbers.
            smpl_gendered = (synthetic_smpl_model(1, device=dev), synthetic_smpl_model(2, device=dev))
            print("WARNING: gendered SMPL models are SYNTHETIC stand-ins (seeds 1/2, unrelated to the neutral "
                  "model) — gendered-GT metrics (3dpw-style MPJPE/PA/PVE) are meaningless outside tests.")

    meta = {}
    if args.checkpoint:
        if args.checkpoint.endswith(".pt"):
            meta = load_torch_checkpoint(args.checkpoint, model)
        else:
            load_checkpoint(args.checkpoint, model)
    # The explicit guide last, over whatever guide --checkpoint held.
    if args.pretrained_fusion_checkpoint:
        load_guide(model, args.pretrained_fusion_checkpoint)
    elif meta.get("main_only"):
        print("WARNING: no --pretrained_fusion_checkpoint — the reference .pt holds the main stage only, so the "
              "frozen ir_depth_fusion guide keeps its random weights; metrics are meaningless for this pipeline")

    use_device_pre = args.device_preprocess and spec.input_mode in ("concat", "multi")
    if args.device_preprocess and not use_device_pre:
        print(f"--device_preprocess ignored for input mode '{spec.input_mode}'")

    class _Opt:
        img_res = args.img_res
        device_preprocess = use_device_pre
        crop_cache = args.crop_cache
        fast_preprocess = args.fast_preprocess

    results = {}
    for split in [args.dataset] if args.dataset else DEFAULT_SPLITS:
        ds = BaseDataset(_Opt(), split, is_train=False)
        results[split] = run_evaluation(
            model, spec, split, ds, smpl_model, smpl_gendered=smpl_gendered, result_file=args.result_file,
            batch_size=args.batch_size, img_res=args.img_res, num_workers=args.num_workers, shuffle=args.shuffle,
            log_freq=args.log_freq, num_cas_iters=args.num_cas_iters, eval_masks_enabled=not args.no_masks,
            device_preprocess=use_device_pre, device=dev)
        t = results[split]["timing"]
        print(f"{split}: {t['images']} images in {t['seconds']:.3f} s ({t['images_per_s']:.2f} images/s; "
              f"waiting on the loader {t['loader_wait_s']:.3f} s, mask branch {t['mask_s']:.3f} s, "
              f"image dumps {t['dump_s']:.3f} s)")
    if args.result_file:
        print(f"wrote {args.result_file}/smpl_fits/<split>_fits.npz and the image dumps under "
              + ", ".join(f"{args.result_file}/{split}/" for split in results))
    return results


if __name__ == "__main__":
    main()
