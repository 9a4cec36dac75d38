#!/usr/bin/env python3
"""Training CLI of the PyTorch port (`inbed_pose_estimation_tpu_torch`).

    python train_gpu.py --name exp --model cashmrV2 --run_smplify ...

The same flags and defaults as `train.py`, plus `--device` (default cuda;
it raises without a card unless `--device cpu` is given).  Trains on the
augmented `--data_train` split, writes `epoch_<E>_<B>.pt` checkpoints and
the fits store to <log_dir>/<name>/checkpoints/, scalars to
<log_dir>/<name>/tensorboard/scalars.jsonl, scores the `--data_test` splits
at each epoch's end, and resumes with `--resume`.  The frozen-guided
fusion pipelines take their guide from `--pretrained_fusion_checkpoint`;
Bodies-At-Rest switches to its mode-1 step at `--mod1_epoch`.
`--crop_cache DIR` reads the images through a crop cache, and
`--fast_preprocess` crops with the native host kernel.  Paths come from
INBED_DATA_ROOT, INBED_NPZ_PATH and INBED_ASSET_DIR.
"""

from __future__ import annotations


def setup(argv=None):
    """Parse `argv` and build what `main` runs: (options, trainer, eval_fn)."""
    from inbed_pose_estimation_tpu_torch.train.options import parse_args

    options = parse_args(argv)

    import torch

    from inbed_pose_estimation_tpu_torch import config
    from inbed_pose_estimation_tpu_torch.data import BaseDataset, MixedDataset
    from inbed_pose_estimation_tpu_torch.device import resolve_device
    from inbed_pose_estimation_tpu_torch.evaluation import run_evaluation
    from inbed_pose_estimation_tpu_torch.fitting import load_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.smpl import load_smpl_model, synthetic_smpl_model
    from inbed_pose_estimation_tpu_torch.train import ScalarWriter, Trainer
    from inbed_pose_estimation_tpu_torch.utils.assets_check import check_assets

    dev = resolve_device(options.device)
    # Synthetic stand-ins are for tests, not for training: fail unless waived.
    check_assets(allow_synthetic=options.allow_synthetic_assets, smpl_model_dir=config.asset("smpl_model_dir"),
                 smpl_mean_params=config.asset("smpl_mean_params"),
                 gmm_prior_file=config.asset("gmm_prior") if options.run_smplify else None)

    torch.manual_seed(options.seed)  # the initial weights
    model, spec = build_model(options.model, smpl_mean_params=config.asset("smpl_mean_params"), device=dev,
                              img_res=options.img_res)
    try:
        smpl_model = load_smpl_model(config.asset("smpl_model_dir"), "neutral", device=dev)
    except (FileNotFoundError, OSError, KeyError):
        smpl_model = synthetic_smpl_model(0, device=dev)
    prior = load_gmm_prior(config.asset("gmm_prior"), device=dev)  # the synthetic prior when the file is missing
    train_ds = MixedDataset(options, ignore_3d=options.ignore_3d, is_train=True)
    test_datasets = {s: BaseDataset(options, s, is_train=False) for s in options.data_test.split("+") if s}

    def eval_fn(trainer):
        for name, ds in test_datasets.items():
            run_evaluation(model, spec, name, ds, smpl_model, checkpoint_dir=options.checkpoint_dir,
                           batch_size=min(options.batch_size, 32), img_res=options.img_res,
                           num_workers=options.num_workers, num_cas_iters=options.num_cas_iters,
                           eval_masks_enabled=not options.no_render, device=dev)

    trainer = Trainer(options, model, spec, smpl_model, prior, train_ds,
                      summary_writer=ScalarWriter(options.summary_dir), device=dev)
    return options, trainer, eval_fn


def main(argv=None):
    """Run the CLI on `argv`; returns the trainer."""
    _, trainer, eval_fn = setup(argv)
    trainer.train(eval_fn=eval_fn)
    trainer.fits_store.array = trainer.state.fits
    trainer.fits_store.save()
    return trainer


if __name__ == "__main__":
    main()
