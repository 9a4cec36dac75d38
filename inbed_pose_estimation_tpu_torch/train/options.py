"""Training options: the options of the JAX package's `build_parser` that
the port's train step reads, with the same names and defaults, so a
configuration means the same in both.  `batch_size` is the size of the
batches the caller builds.  Options of the epoch loop, the data side and
the runtime (`--dtype`, `--remat`, `--uint8_feed`, ...) are not accepted
until the port implements them (ROADMAP Queue 1 items 6-7).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="inbed_pose_estimation_tpu_torch training step")
    tr = p.add_argument_group("Training Options")
    tr.add_argument("--lr", type=float, default=5e-5)
    tr.add_argument("--batch_size", type=int, default=64)
    tr.add_argument("--img_res", type=int, default=224)
    tr.add_argument("--shape_loss_weight", type=float, default=0)
    tr.add_argument("--keypoint_loss_weight", type=float, default=5.0)
    tr.add_argument("--beta_loss_weight", type=float, default=0.001)
    tr.add_argument("--openpose_train_weight", type=float, default=0.0)
    tr.add_argument("--gt_train_weight", type=float, default=1.0)
    tr.add_argument("--run_smplify", default=False, action="store_true")
    tr.add_argument("--smplify_threshold", type=float, default=100.0)
    tr.add_argument("--num_smplify_iters", type=int, default=100)
    tr.add_argument("--num_cas_iters", type=int, default=2)
    return p
