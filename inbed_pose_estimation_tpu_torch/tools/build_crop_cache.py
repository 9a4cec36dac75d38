"""Build a split's crop cache (`data/crop_cache.py`).

    python -m inbed_pose_estimation_tpu_torch.tools.build_crop_cache \
        --dataset slp-4mod-train --out CACHE_DIR [--eval] [--scale_factor 0.15]

Decodes each of the 9 images a sample reads once and stores the patch that
the widest augmented crop can touch; `train_gpu.py --crop_cache CACHE_DIR`
and `eval_gpu.py --crop_cache CACHE_DIR` then read them in place of the
image files, bit-exact.  The same flags and on-disk format as the JAX
package's tool: a cache built by either is read by both.  Paths come from
INBED_DATA_ROOT and INBED_NPZ_PATH.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> str:
    """Run the tool on `argv`; returns the patch file's path."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True, help="Split name, e.g. slp-4mod-train or slp-4mod-uncover")
    p.add_argument("--out", required=True, help="Cache output directory")
    p.add_argument("--eval", action="store_true", help="Build for the eval split (default: train split)")
    p.add_argument("--img_res", type=int, default=224)
    p.add_argument("--scale_factor", type=float, default=0.15,
                   help="Augmentation scale range the margin must cover "
                        "(must be >= the --scale_factor used in training)")
    p.add_argument("--progress_every", type=int, default=500)
    args = p.parse_args(argv)

    from ..data.crop_cache import build_crop_cache
    from ..data.dataset import BaseDataset

    class _Opt:
        img_res = args.img_res
        scale_factor = args.scale_factor

    ds = BaseDataset(_Opt(), args.dataset, is_train=not args.eval)
    t0 = time.time()
    path = build_crop_cache(ds, args.out, scale_margin=1.0 + args.scale_factor, progress_every=args.progress_every)
    print(f"built {path} ({len(ds)} samples) in {time.time() - t0:.1f}s")
    return path


if __name__ == "__main__":
    main()
