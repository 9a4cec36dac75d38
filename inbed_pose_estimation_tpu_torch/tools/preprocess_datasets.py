"""Write the SLP 4-modality index npz files from a raw danaLab tree.

    python -m inbed_pose_estimation_tpu_torch.tools.preprocess_datasets --eval_files
        # slp_4mod_{uncover,cover1,cover2}.npz over the test subjects 85-101
    python -m inbed_pose_estimation_tpu_torch.tools.preprocess_datasets --train_files
        # slp_4mod_train.npz over the train subjects 1-84, all three covers

The port's counterpart of the repository's `preprocess_datasets.py` (the
reference's preprocess_datasets.py:29-57), with the same flags and files.
The tree is read from <INBED_DATA_ROOT>/SLP/SLP/danaLab and the files are
written to INBED_NPZ_PATH, where the port's datasets read them.
"""

from __future__ import annotations

import argparse

from .. import config
from .preprocess import TEST_SUBJECTS, TRAIN_SUBJECTS, slp_multi_mod

EVAL_FILES = (("slp_4mod_uncover.npz", ["uncover"]), ("slp_4mod_cover1.npz", ["cover1"]),
              ("slp_4mod_cover2.npz", ["cover2"]))


def main(argv=None) -> list:
    """Run the tool on `argv`; returns the paths written."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--train_files", default=False, action="store_true")
    p.add_argument("--eval_files", default=False, action="store_true")
    args = p.parse_args(argv)

    slp_root = config.dataset_folder("slp-4mod-train")
    out_path = config.npz_path()
    written = []
    if args.eval_files:
        for out_name, cover in EVAL_FILES:
            slp_multi_mod(slp_root, out_path, out_name, cover, TEST_SUBJECTS)
            written.append(f"{out_path}/{out_name}")
    if args.train_files:
        slp_multi_mod(slp_root, out_path, "slp_4mod_train.npz", ["uncover", "cover1", "cover2"], TRAIN_SUBJECTS)
        written.append(f"{out_path}/slp_4mod_train.npz")
    return written


if __name__ == "__main__":
    main()
