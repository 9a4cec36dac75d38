"""Body masks of SLP's uncovered RGB frames, for the eval driver's mask scores.

    python -m inbed_pose_estimation_tpu_torch.tools.get_mask [--slp_root DIR] [--subjects 1-101]
        [--device cuda]

The port of the repository's root script `get_mask.py` (the reference's
get_mask.py:32-105), with its flags, its files and its printed lines. For
each subject lo..hi of `--subjects` (`00001`..) that has `RGB/uncover`,
every readable frame's mask is written as uint8 0 / 255 to
`<subject>/masks/uncover/`, under the frame's name without `image_`: the
file that `evaluation/evaluate.py::_gt_mask_path` reads as the frame's
ground truth. A subject without `RGB/uncover` and a frame that cannot be
read are skipped. The root is `--slp_root`, or the SLP image root of the
port's `config.py` (<INBED_DATA_ROOT>/SLP/SLP/danaLab).

The segmenter is chosen as the root script chooses it: torchvision's
deeplabv3_resnet101 (`deeplab_segmenter`) when `import torchvision`
succeeds, otherwise the background-difference fallback (`fallback_mask`),
host numpy and scipy, whose masks are byte for byte the root script's.
`--device` is the deeplab model's device, so only that branch reads it.
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np

from .. import config
from ..data.image_io import read_rgb_u8, write

# deeplabv3's Pascal VOC label of a person.
PERSON_CLASS = 15


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--slp_root", default=None, help="SLP danaLab root (default: config)")
    p.add_argument("--subjects", default="1-101", help="subject range, e.g. 1-101")
    p.add_argument("--device", default="cuda", help="the deeplab model's device: cuda (default) or cpu")
    return p


def default_root() -> str:
    """The SLP image root of the port's config: <INBED_DATA_ROOT>/SLP/SLP/danaLab."""
    return config.dataset_folder("slp")


def fallback_mask(img: np.ndarray) -> np.ndarray:
    """Background-difference segmentation of an RGB frame [H, W, 3]: the
    distance of each pixel's grey from the median grey of the frame's
    10-pixel border, blurred (sigma 3) and thresholded at the larger of its
    mean + std and 10.  Works when the bed background dominates the
    frame's borders.  Returns uint8 [H, W], 0 or 255."""
    from scipy.ndimage import gaussian_filter

    gray = img.mean(axis=2)
    border = np.concatenate([gray[:10].ravel(), gray[-10:].ravel(),
                             gray[:, :10].ravel(), gray[:, -10:].ravel()])
    bg = np.median(border)
    diff = gaussian_filter(np.abs(gray - bg), 3)
    thr = max(diff.mean() + diff.std(), 10.0)
    return (diff > thr).astype(np.uint8) * 255


def deeplab_segmenter(device: str = "cuda"):
    """The person class of torchvision's deeplabv3_resnet101 (ImageNet
    normalization) as a function of an RGB frame [H, W, 3] uint8 -> uint8
    [H, W], 0 or 255.

    One departure from the root script, which does not change the masks:
    the model is built once, here, on `device`, where the root script
    builds it again for every frame on the CPU.  The constructor call is
    the root script's; its weights come from torchvision's own store.
    Untested: torchvision is installed neither where the tests run nor on
    the card's machine."""
    import torch
    import torchvision

    from ..device import resolve_device

    dev = resolve_device(device)
    model = torchvision.models.segmentation.deeplabv3_resnet101(pretrained=True).eval().to(dev)
    mean = torch.tensor([0.485, 0.456, 0.406], device=dev).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev).view(1, 3, 1, 1)

    def segment(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(img.astype(np.float32) / 255.0).permute(2, 0, 1)[None].to(dev)
        with torch.no_grad():
            out = model((x - mean) / std)["out"][0]
        return (out.argmax(0) == PERSON_CLASS).cpu().numpy().astype(np.uint8) * 255

    return segment


def main(argv=None) -> list:
    """Run the tool on `argv`; returns the mask paths written."""
    args = build_parser().parse_args(argv)
    root = args.slp_root or default_root()
    lo, hi = (int(x) for x in args.subjects.split("-"))

    try:
        import torchvision  # noqa: F401
    except ImportError:
        segment = fallback_mask
        print("torchvision unavailable: using background-difference fallback")
    else:
        print("Using deeplabv3_resnet101 segmentation")
        segment = deeplab_segmenter(args.device)

    written = []
    for s in range(lo, hi + 1):
        sub = f"{s:05d}"
        rgb_dir = join(root, sub, "RGB", "uncover")
        if not os.path.isdir(rgb_dir):
            continue
        out_dir = join(root, sub, "masks", "uncover")
        os.makedirs(out_dir, exist_ok=True)
        for fn in sorted(os.listdir(rgb_dir)):
            img = read_rgb_u8(join(rgb_dir, fn))
            if img is None:
                continue
            path = join(out_dir, fn.replace("image_", ""))
            write(path, segment(img))
            written.append(path)
        print(f"subject {sub}: masks written to {out_dir}")
    return written


if __name__ == "__main__":
    main()
