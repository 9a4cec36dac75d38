"""Training CLI options: the JAX package's `train/options.py` parser with the
same names and defaults, `--from_json`, the `config.json` dump, and
`--device` (cuda by default).

Options that do nothing in the JAX package do nothing here either
(`--ngpu`, `--pin_memory`, `--mod1_epoch` outside Bodies-At-Rest).  Options
the port does not implement stop `parse_args` with a message that names
their ROADMAP item: `--dtype bfloat16` and `--remat`.
"""

from __future__ import annotations

import argparse
import json
import os

# (option, is it set to something the port lacks?, why).
_NOT_PORTED = (
    ("dtype", lambda v: v != "float32",
     "--dtype bfloat16 is not ported yet: ROADMAP Queue 1 item 11 (bfloat16 and rematerialization)"),
    ("remat", bool, "--remat is not ported yet: ROADMAP Queue 1 item 11 (bfloat16 and rematerialization)"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="inbed_pose_estimation_tpu_torch training")
    req = p.add_argument_group("Required")
    req.add_argument("--name", required=True, help="Name of the experiment")

    gen = p.add_argument_group("General")
    gen.add_argument("--time_to_run", type=int, default=3600000,
                     help="Total time to run in seconds (graceful checkpoint+exit)")
    gen.add_argument("--resume", dest="resume", default=False, action="store_true",
                     help="Resume from latest checkpoint (incl. mid-epoch position)")
    gen.add_argument("--num_workers", type=int, default=8, help="Host decode threads")
    gen.add_argument("--ngpu", type=int, default=1, help="(parity flag; unused)")
    gen.add_argument("--pin_memory", dest="pin_memory", default=True, action="store_true")
    gen.add_argument("--no_pin_memory", dest="pin_memory", action="store_false")
    gen.add_argument("--allow_synthetic_assets", default=False, action="store_true",
                     help="Run with synthetic SMPL/prior stand-ins when real "
                          "assets are missing (training NOT reference-comparable)")

    io = p.add_argument_group("io")
    io.add_argument("--log_dir", default="logs", help="Directory to store logs")
    io.add_argument("--checkpoint", default=None, help="Path to checkpoint")
    io.add_argument("--from_json", default=None, help="Load options from json file")
    io.add_argument("--pretrained_checkpoint", default=None,
                    help="Load a pretrained checkpoint at the beginning of training")
    io.add_argument("--pretrained_fusion_checkpoint", default=None,
                    help="An ir_depth_fusion checkpoint (.pt or JAX .npz) grafted as the frozen guide of "
                         "ir_depth_pm_fusion / ir_depth_pm_rgb_fusion")

    tr = p.add_argument_group("Training Options")
    tr.add_argument("--model", default="cashmrV2", help="Model architecture name")
    tr.add_argument("--data_train", default="slp-4mod-train")
    tr.add_argument("--data_test", default="slp-4mod-uncover+slp-4mod-cover1+slp-4mod-cover2",
                    help="'+'-joined eval split names")
    tr.add_argument("--num_epochs", type=int, default=200)
    tr.add_argument("--lr", type=float, default=5e-5)
    tr.add_argument("--batch_size", type=int, default=64)
    tr.add_argument("--summary_steps", type=int, default=25)
    tr.add_argument("--test_steps", type=int, default=200000)
    tr.add_argument("--checkpoint_steps", type=int, default=200000)
    tr.add_argument("--img_res", type=int, default=224)
    tr.add_argument("--rot_factor", type=float, default=15)
    tr.add_argument("--noise_factor", type=float, default=0.4)
    tr.add_argument("--scale_factor", type=float, default=0.15)
    tr.add_argument("--ignore_3d", default=False, action="store_true")
    tr.add_argument("--shape_loss_weight", type=float, default=0)
    tr.add_argument("--keypoint_loss_weight", type=float, default=5.0)
    tr.add_argument("--pose_loss_weight", type=float, default=1.0)
    tr.add_argument("--beta_loss_weight", type=float, default=0.001)
    tr.add_argument("--openpose_train_weight", type=float, default=0.0)
    tr.add_argument("--gt_train_weight", type=float, default=1.0)
    tr.add_argument("--run_smplify", default=False, action="store_true")
    tr.add_argument("--smplify_threshold", type=float, default=100.0)
    tr.add_argument("--num_smplify_iters", type=int, default=100)
    tr.add_argument("--no_render", default=False, action="store_true")
    tr.add_argument("--num_cas_iters", type=int, default=2)
    tr.add_argument("--mod1_epoch", type=int, default=50)
    shuf = tr.add_mutually_exclusive_group()
    shuf.add_argument("--shuffle_train", dest="shuffle_train", action="store_true")
    shuf.add_argument("--no_shuffle_train", dest="shuffle_train", action="store_false")
    p.set_defaults(shuffle_train=True)

    rt = p.add_argument_group("Runtime Options")
    rt.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="Model compute dtype (bfloat16 is not ported yet)")
    rt.add_argument("--seed", type=int, default=0)
    rt.add_argument("--remat", nargs="?", const="stage", default=False, choices=["stage", "decoder"],
                    help="Rematerialize on backward (not ported yet)")
    rt.add_argument("--fast_preprocess", default=False, action="store_true",
                    help="Crop, resize, rotate, noise and normalize with the native C++ host kernel "
                         "(ops/native/preprocess.cc, built with g++ at first use; not bit-identical to the "
                         "reference resampler)")
    rt.add_argument("--crop_cache", default=None,
                    help="Directory of a pre-decoded crop cache (python -m "
                         "inbed_pose_estimation_tpu_torch.tools.build_crop_cache): memmap patch reads in place "
                         "of the 9 image reads a sample, bit-exact")
    rt.add_argument("--uint8_feed", default=True, action=argparse.BooleanOptionalAction,
                    help="Ship post-crop uint8 images to the card and apply noise and normalization there "
                         "(4x fewer bytes to copy; equal to the float32 feed to one ulp).  --no-uint8_feed "
                         "restores the host-normalized float32 feed")
    rt.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parse `argv`, merge `--from_json` (every key but `name`), refuse what
    the port does not implement, and create <log_dir>/<name>/ with its
    `tensorboard/` (the summary_dir) and `checkpoints/` directories and the
    merged `config.json`."""
    args = build_parser().parse_args(argv)
    if args.from_json:
        with open(args.from_json) as f:
            json_args = json.load(f)
        for k, v in json_args.items():
            if k != "name":
                setattr(args, k, v)
    for name, unported, why in _NOT_PORTED:
        if unported(getattr(args, name)):
            raise SystemExit(why)
    args.log_dir = os.path.join(os.path.abspath(args.log_dir), args.name)
    args.summary_dir = os.path.join(args.log_dir, "tensorboard")
    args.checkpoint_dir = os.path.join(args.log_dir, "checkpoints")
    for d in (args.log_dir, args.summary_dir, args.checkpoint_dir):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(args.log_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=4)
    return args
