"""The host input pipeline alone: an interleaved A/B of the loader's
configurations on the port's `BaseDataset`.

The port of the JAX package's `tools/loader_bench.py`, with its protocol,
flags and output.  It times only the production of training batches
(decode, crop and resize, augmentation, collate) that `--crop_cache` and
`--fast_preprocess` change, with no device in the loop, so it takes no
`--device`.  The configurations are built once, then timed in interleaved
rounds, the order turned by one configuration each round (A, B, C, then
B, C, A, ...), so that slow drift in the host's load falls on all of them
and no configuration always reads the files that another one has just
pulled into the page cache; the augmentation generator is reseeded every
round, so that every configuration draws the same augmentations.  Each
batch is one synchronous, timed call; the line reports the median and
interquartile range per batch over all rounds.  A crop cache that the
dataset refuses (missing, stale, unreadable or built for a narrower
augmentation range) raises, where the JAX tool timed disk reads under the
name "cache".

    INBED_DATA_ROOT=... INBED_NPZ_PATH=... python -m inbed_pose_estimation_tpu_torch.tools.loader_bench
        [--dataset slp-4mod-train] [--batch_size 32] [--batches 6] [--rounds 5] [--crop_cache DIR]
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="slp-4mod-train")
    ap.add_argument("--img_res", type=int, default=224)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--batches", type=int, default=6, help="batches per round per config")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--crop_cache", default=None, help="cache dir for the cache configs")
    # The train CLI's defaults, so that a cache built for a train run is accepted.
    ap.add_argument("--noise_factor", type=float, default=0.4)
    ap.add_argument("--rot_factor", type=float, default=15.0)
    ap.add_argument("--scale_factor", type=float, default=0.15)
    return ap


def build_dataset(ds_name: str, img_res: int, cache_dir, fast: bool, noise_factor, rot_factor, scale_factor):
    """The training feed of `ds_name` (uint8, augmented) in one configuration."""
    from ..data import BaseDataset

    options = types.SimpleNamespace(img_res=img_res, noise_factor=noise_factor, rot_factor=rot_factor,
                                    scale_factor=scale_factor, ignore_3d=False, uint8_feed=True,
                                    fast_preprocess=fast, crop_cache=cache_dir)
    return BaseDataset(options, ds_name, is_train=True)


def time_config(ds, indices_per_batch, seed: int) -> list:
    """Seconds to produce each of the given batches, one synchronous call
    each, with the augmentations drawn from a generator seeded `seed`."""
    from ..data.loader import collate

    rng = np.random.default_rng(seed)
    times = []
    for indices in indices_per_batch:
        t0 = time.perf_counter()
        batch = collate([ds.__getitem__(int(i), rng=rng) for i in indices])
        _ = batch["img"].ravel()[0]
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> dict:
    """Print the result line and return it."""
    args = build_parser().parse_args(argv)
    specs = [("disk", None, False), ("disk+fast", None, True)]
    if args.crop_cache:
        specs += [("cache", args.crop_cache, False), ("cache+fast", args.crop_cache, True)]
    datasets = {name: build_dataset(args.dataset, args.img_res, cache, fast, args.noise_factor, args.rot_factor,
                                    args.scale_factor) for name, cache, fast in specs}
    for name, cache, _ in specs:
        if cache is not None and datasets[name]._cache is None:
            raise ValueError(f"loader_bench: configuration '{name}': the crop cache in {cache} was refused for "
                             f"{args.dataset} (see the line above); it would time disk reads")
    n = len(datasets["disk"])
    rng = np.random.default_rng(0)

    # One warm-up batch a configuration (imports, file handles, memmap page-in).
    warm = rng.integers(0, n, size=args.batch_size)
    for ds in datasets.values():
        time_config(ds, [warm], seed=999)

    names = list(datasets)
    results = {name: [] for name in names}
    for r in range(args.rounds):
        batches = [rng.integers(0, n, size=args.batch_size) for _ in range(args.batches)]
        for name in names[r % len(names):] + names[:r % len(names)]:
            results[name] += time_config(datasets[name], batches, seed=1000 + r)

    out = {}
    for name, ts in results.items():
        ms = np.asarray(ts) * 1e3
        out[name] = {"median_ms": float(np.median(ms)),
                     "iqr_ms": [float(np.percentile(ms, 25)), float(np.percentile(ms, 75))], "n": len(ms)}
    base = out["disk"]["median_ms"]
    for name in out:
        out[name]["speedup_vs_disk"] = base / out[name]["median_ms"]
    line = {"batch_size": args.batch_size, "img_res": args.img_res, "dataset": args.dataset, "configs": out}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
