"""Pre-decoded crop cache: each image a split reads, decoded once.

The port's copy of the JAX package's `data/crop_cache.py`, with the same
on-disk format, so that a cache built by either package is read by the
other and a build from the same tree writes the same `.bin` bytes and the
same index arrays.

A sample reads 9 images (4 covered modalities, their 4 uncovered
counterparts and the uncovered body mask).  For each one the cache stores
the uint8 pixels of a patch that covers the widest crop box the
augmentation can draw (scale <= 1 + scale_factor, |rot| <= 2 * rot_factor),
clamped to the image, in one flat file (`<split>_<train|test>.bin`) with an
npz index beside it.  At read time the patch is pasted into a zero canvas of
the image's shape and goes through the unchanged processing path, which is
bit-exact by construction:
  * `crop()` reads only pixels inside its box, which the margin keeps
    inside the patch;
  * pixels outside the image are zero in the canvas and in `crop()`'s own
    padding;
  * the contrast stretch's min / max runs over that box only.
When the cover -> uncover rewrite leaves a path as it is (uncover splits),
the uncovered entry points at the covered patch's bytes.

The index records the margin it was built for and a fingerprint of the npz
index and of the source files' sizes and mtimes; `data.dataset.BaseDataset`
refuses a cache that is missing, unreadable, of another length, stale or
too narrow for the options' augmentation, says so, and reads from disk.

Build with `python -m inbed_pose_estimation_tpu_torch.tools.build_crop_cache`.
"""

from __future__ import annotations

import hashlib
import json
import os
from os.path import join
from typing import Dict, Optional, Tuple

import numpy as np

from .image_io import read_gray_u8, read_rgb_u8

# Modality order in the packed file: the covered reads, the uncovered ones
# and the uncovered body mask.
MODALITIES = (
    "img", "ir", "depth", "pm",
    "img_unc", "ir_unc", "depth_unc", "pm_unc", "mask_unc",
)


def patch_half_extent(scale: float, scale_margin: float, rotating: bool) -> int:
    """Widest half-side of the crop box around its centre: 100 * scale *
    margin, times sqrt(2) when the crop may rotate (`crop()` pads the box to
    its diagonal), rounded up, plus 6 pixels for the corners' rounding."""
    half = 100.0 * float(scale) * float(scale_margin)
    if rotating:
        half *= np.sqrt(2.0)
    return int(np.ceil(half)) + 6


def cache_paths(cache_dir: str, dataset_name: str, is_train: bool) -> Tuple[str, str]:
    """(the patch file, the index file) of a split's cache."""
    stem = join(cache_dir, f"{dataset_name}_{'train' if is_train else 'test'}")
    return stem + ".bin", stem + ".idx.npz"


def index_fingerprint(center, scale, imgname) -> str:
    """SHA-1 of the npz index fields the patch extents depend on."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(center, np.float64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(scale, np.float64)).tobytes())
    h.update("\n".join(str(n) for n in imgname).encode())
    return h.hexdigest()


def _unc(path: str) -> str:
    return path.replace("cover1", "uncover").replace("cover2", "uncover")


def source_paths(dataset) -> list:
    """Every file a cache build of `dataset` can read, sorted and without
    repeats: the four covered modalities, their uncovered rewrites and the
    uncovered body mask, whatever the dataset's has-IR / depth / PM flags."""
    paths = set()
    for i in range(len(dataset)):
        img_p, ir_p, depth_p, pm_p = (join(dataset.img_dir, str(names[i])) for names in (
            dataset.imgname, dataset.irimgname, dataset.depthname, dataset.pmname))
        for p in (img_p, ir_p, depth_p, pm_p):
            paths.add(p)
            paths.add(_unc(p))
        paths.add(_unc(pm_p).replace("PM_aligned", "masks"))
    return sorted(paths)


def dataset_fingerprint(dataset) -> str:
    """`index_fingerprint` with each source file's size and mtime (or
    "missing") folded in, so that an image rewritten under the same name
    makes the cache stale."""
    h = hashlib.sha1()
    h.update(index_fingerprint(dataset.center, dataset.scale, dataset.imgname).encode())
    for p in source_paths(dataset):
        try:
            st = os.stat(p)
            h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}\n".encode())
        except OSError:
            h.update(f"{p}:missing\n".encode())
    return h.hexdigest()


def _read_u8(path: str, gray: bool) -> np.ndarray:
    img = read_gray_u8(path) if gray else read_rgb_u8(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _sample_reads(dataset, i: int) -> Dict[str, Tuple[str, bool]]:
    """{modality: (path, grayscale?)}: the reads `BaseDataset` makes for
    sample i.  A covered modality the index lacks falls back to the RGB
    read; the uncovered reads and the mask are always grayscale reads of the
    rewritten paths (but the RGB one)."""
    img_p, ir_p, depth_p, pm_p = (join(dataset.img_dir, str(names[i])) for names in (
        dataset.imgname, dataset.irimgname, dataset.depthname, dataset.pmname))
    reads = {"img": (img_p, False)}
    for key, path, has in (("ir", ir_p, dataset.hasIR), ("depth", depth_p, dataset.hasDEPTH),
                           ("pm", pm_p, dataset.hasPM)):
        reads[key] = (path, True) if has else (img_p, False)
    reads.update({
        "img_unc": (_unc(img_p), False),
        "ir_unc": (_unc(ir_p), True),
        "depth_unc": (_unc(depth_p), True),
        "pm_unc": (_unc(pm_p), True),
        "mask_unc": (_unc(pm_p).replace("PM_aligned", "masks"), True),
    })
    return reads


def build_crop_cache(dataset, cache_dir: str, scale_margin: Optional[float] = None, progress_every: int = 0) -> str:
    """Decode `dataset` (a `BaseDataset`) into `<cache_dir>/<name>_<split>`;
    returns the patch file's path.

    `scale_margin` defaults to 1 + the dataset options' scale_factor; eval
    splits get the same margin, so one cache serves both."""
    if scale_margin is None:
        scale_margin = 1.0 + float(getattr(dataset.options, "scale_factor", 0.15))
    os.makedirs(cache_dir, exist_ok=True)
    bin_path, idx_path = cache_paths(cache_dir, dataset.dataset, dataset.is_train)

    n, m_count = len(dataset), len(MODALITIES)
    offsets = np.zeros((n, m_count), np.int64)
    shapes = np.zeros((n, m_count, 3), np.int32)
    orig_shapes = np.zeros((n, m_count, 2), np.int32)
    # Each patch's (x0, y0): the margin box clamped to the image, since
    # pixels outside it are zero in the canvas and in crop()'s padding.
    origins = np.zeros((n, m_count, 2), np.int32)

    pos = 0
    with open(bin_path, "wb") as f:
        for i in range(n):
            half = patch_half_extent(dataset.scale[i], scale_margin, rotating=True)
            cx, cy = (int(round(float(v))) for v in dataset.center[i][:2])
            x0, y0, x1, y1 = cx - half, cy - half, cx + half, cy + half
            written: Dict[Tuple[str, bool], int] = {}
            for m, (path, gray) in enumerate(_sample_reads(dataset, i)[k] for k in MODALITIES):
                j = written.get((path, gray))
                if j is not None:  # the same read as an earlier entry
                    offsets[i, m], shapes[i, m] = offsets[i, j], shapes[i, j]
                    orig_shapes[i, m], origins[i, m] = orig_shapes[i, j], origins[i, j]
                    continue
                img = _read_u8(path, gray)
                H, W = img.shape[:2]
                px0, py0 = max(0, x0), max(0, y0)
                px1, py1 = min(W, max(px0, x1)), min(H, max(py0, y1))
                patch = np.ascontiguousarray(img[py0:py1, px0:px1])
                if patch.ndim == 2:
                    patch = patch[:, :, None]
                offsets[i, m], shapes[i, m] = pos, patch.shape
                orig_shapes[i, m], origins[i, m] = (H, W), (px0, py0)
                f.write(patch.tobytes())
                pos += patch.nbytes
                written[(path, gray)] = m
            if progress_every and (i + 1) % progress_every == 0:
                print(f"crop cache: {i + 1}/{n} samples, {pos / 1e6:.1f} MB")

    np.savez(
        idx_path, offsets=offsets, shapes=shapes, orig_shapes=orig_shapes, origins=origins,
        total_bytes=np.int64(pos),
        meta=np.bytes_(json.dumps({
            "dataset": dataset.dataset,
            "is_train": bool(dataset.is_train),
            "num_samples": int(n),
            "scale_margin": float(scale_margin),
            "rot_covered": True,
            "modalities": list(MODALITIES),
            "index_fingerprint": dataset_fingerprint(dataset),
        }).encode()),
    )
    return bin_path


class CropCache:
    """A split's cache, memory-mapped: `full(index, modality)` gives the
    float32 canvas that stands in for the image read from disk."""

    def __init__(self, cache_dir: str, dataset_name: str, is_train: bool):
        bin_path, idx_path = cache_paths(cache_dir, dataset_name, is_train)
        with np.load(idx_path) as idx:
            self.meta = json.loads(bytes(idx["meta"]).decode())
            self.offsets, self.shapes = idx["offsets"], idx["shapes"]
            self.orig_shapes, self.origins = idx["orig_shapes"], idx["origins"]
            total = int(idx["total_bytes"])
        self.buf = np.memmap(bin_path, dtype=np.uint8, mode="r", shape=(total,))
        self._mod_index = {m: i for i, m in enumerate(MODALITIES)}

    def __len__(self) -> int:
        return int(self.meta["num_samples"])

    def covers(self, options) -> bool:
        """Does the cache's margin cover the scale range of `options`'
        augmentation (1 + scale_factor, a factor of 0 honoured)?"""
        sf = 1.0 + float(getattr(options, "scale_factor", 0.15))
        return sf <= float(self.meta["scale_margin"]) + 1e-9

    def matches_index(self, dataset) -> bool:
        """Are the npz index and the source files as they were at the build?
        A cache without a recorded fingerprint is refused."""
        want = self.meta.get("index_fingerprint")
        return want is not None and want == dataset_fingerprint(dataset)

    def full(self, index: int, modality: str) -> np.ndarray:
        """The image's float32 canvas [H, W] or [H, W, 3]: the patch's pixels
        in place, zero elsewhere."""
        m = self._mod_index[modality]
        off = int(self.offsets[index, m])
        ph, pw, pc = (int(s) for s in self.shapes[index, m])
        patch = self.buf[off:off + ph * pw * pc].reshape(ph, pw, pc)
        H, W = (int(v) for v in self.orig_shapes[index, m])
        x0, y0 = (int(v) for v in self.origins[index, m])
        gray = pc == 1
        canvas = np.zeros((H, W) if gray else (H, W, 3), np.float32)
        if ph and pw:
            canvas[y0:y0 + ph, x0:x0 + pw] = patch[..., 0] if gray else patch
        return canvas

    def orig_shape(self, index: int) -> np.ndarray:
        return self.orig_shapes[index, 0].copy()
