"""SLP multi-modal dataset: npz index reader and per-sample host decode,
for evaluation and for training.

The port's copy of the JAX package's `BaseDataset` and `MixedDataset`.  It
loads the npz index (imgname / irimgname / depthname / pmname, center,
scale, pose, shape, S, part, openpose, gender), reads the 4 covered images,
their 4 uncovered counterparts and the uncover body mask through the
reference's filename rewriting (cover1/cover2 -> uncover, PM_aligned ->
masks), draws the training augmentation (flip, channel noise, rotation,
scale) as the JAX package does, crops on the host exactly as it does, and
emits a dict of numpy arrays.  Images leave as [C, H, W], as the reference's
torch dataset emitted them (the JAX package emits [H, W, C]); every other
key keeps the JAX package's shape.  Three image feeds:
  * float (eval, and training with `uint8_feed` off): noised, normalized
    float32;
  * uint8 (training with `options.uint8_feed`): the post-crop, post-flip
    uint8 images and the drawn noise factors `pixel_noise` [3], decoded on
    the card by `data.device_preprocess.decode_uint8_batch` (4x fewer bytes
    to copy);
  * raw (eval with `options.device_preprocess`): the uint8 frames and the
    crop box, for the device crop.
Two host options, as in the JAX package:
  * `options.crop_cache` (a directory from `tools/build_crop_cache.py`):
    the 9 image reads of a sample come from the split's crop cache, and the
    items are bitwise those read from disk.  A cache that is missing,
    unreadable, of another length, stale or built for a narrower
    augmentation is refused with the JAX package's message, and the images
    are read from disk;
  * `options.fast_preprocess`: each crop goes through the native kernel
    (`ops/native`), rotation included, in place of the Pillow crop; not
    bit-exact with it, bit-exact with the JAX package's build.  It raises
    when the kernel cannot be built.
"""

from __future__ import annotations

from os.path import join
from typing import Optional

import numpy as np
from scipy import ndimage
from scipy.ndimage import gaussian_filter

from .. import config, constants
from ..ops import native
from .crop_cache import CropCache
from .image_io import read_gray, read_rgb
from .transforms import crop, flip_img, flip_kp, flip_pose, rot_aa, transform


def _normalize(img01: np.ndarray, mean, std) -> np.ndarray:
    return (img01 - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _chw(img: np.ndarray) -> np.ndarray:
    """[H, W, C, ...] -> [C, H, W, ...]: the channel axis to the front."""
    return np.ascontiguousarray(np.moveaxis(img, 2, 0))


class BaseDataset:
    """Map-style dataset over an npz index (an eval split unless
    `is_train`)."""

    def __init__(self, options=None, dataset: str = "slp-4mod-uncover", ignore_3d: bool = False,
                 use_augmentation: bool = True, is_train: bool = False):
        self.dataset = dataset
        self.is_train = is_train
        self.options = options
        self.use_augmentation = use_augmentation
        self.img_res = int(getattr(options, "img_res", constants.IMG_RES) or constants.IMG_RES)
        # Raw-decode mode: uint8 frames and the crop box only, for the
        # device crop (data/device_preprocess.py); eval only.
        self.return_raw = bool(getattr(options, "device_preprocess", False)) and not is_train
        # uint8 training feed: post-crop/flip uint8 images and the noise
        # factors; the train step applies noise and normalization on the
        # card, which agrees with the float feed to one float32 ulp (the
        # host multiplies the noise in float64, the card in float32).
        self.uint8_feed = bool(getattr(options, "uint8_feed", False)) and is_train
        # The native crop, built now so that a missing compiler stops here.
        self._native = native.library() if getattr(options, "fast_preprocess", False) else None
        self.img_dir = config.dataset_folder(dataset)
        self.data = np.load(config.dataset_file(dataset, is_train=is_train), allow_pickle=True)
        self.imgname = self.data["imgname"]

        def _names(key):
            if key in self.data:
                return self.data[key], True
            return self.data["imgname"], False

        self.irimgname, self.hasIR = _names("irimgname")
        self.depthname, self.hasDEPTH = _names("depthname")
        self.pmname, self.hasPM = _names("pmname")
        self.maskname = self.data["maskname"] if "maskname" in self.data else None
        self.partname = self.data["partname"] if "partname" in self.data else None

        self.scale = self.data["scale"]
        self.center = self.data["center"]

        if "pose" in self.data:
            self.pose = self.data["pose"].astype(np.float64)
            self.betas = self.data["shape"].astype(np.float64)
            self.has_smpl = self.data["has_smpl"] if "has_smpl" in self.data else np.ones(len(self.imgname))
        else:
            self.pose = None
            self.betas = None
            self.has_smpl = np.zeros(len(self.imgname))
        if ignore_3d:
            self.has_smpl = np.zeros(len(self.imgname))

        self.pose_3d = self.data["S"] if "S" in self.data else None
        self.has_pose_3d = int(self.pose_3d is not None and not ignore_3d)

        kp_gt = self.data["part"] if "part" in self.data else np.zeros((len(self.imgname), 24, 3))
        kp_op = self.data["openpose"] if "openpose" in self.data else np.zeros((len(self.imgname), 25, 3))
        self.keypoints = np.concatenate([kp_op, kp_gt], axis=1)

        if "gender" in self.data:
            self.gender = np.asarray(self.data["gender"]).astype(np.int32)
        else:
            self.gender = -1 * np.ones(len(self.imgname), np.int32)
        self.length = self.scale.shape[0]
        cache_dir = getattr(options, "crop_cache", None)
        self._cache = self._open_cache(cache_dir) if cache_dir and not self.return_raw else None

    def _open_cache(self, cache_dir: str) -> Optional[CropCache]:
        """The split's crop cache, or None (and why) when it is refused."""
        try:
            cc = CropCache(cache_dir, self.dataset, self.is_train)
        except FileNotFoundError:
            print(f"crop cache: no cache for {self.dataset} ({'train' if self.is_train else 'test'}) in "
                  f"{cache_dir}; reading from disk")
            return None
        except Exception as e:  # a corrupt or partial cache is refused like a stale one
            print(f"crop cache: unreadable ({type(e).__name__}: {e}); reading from disk")
            return None
        if len(cc) != self.length:
            print(f"crop cache: stale ({len(cc)} samples cached, split has {self.length}); reading from disk")
        elif not cc.matches_index(self):
            print("crop cache: stale (npz index or source image files changed since the cache was built); "
                  "reading from disk")
        elif self.is_train and self.use_augmentation and not cc.covers(self.options):
            print("crop cache: built for a smaller augmentation range than options request; reading from disk")
        else:
            return cc
        return None

    def augm_params(self, rng: Optional[np.random.Generator] = None):
        """(flip, channel noise [3], rotation in degrees, scale), drawn from
        `rng` (an unseeded generator when None) in the JAX package's order;
        no augmentation at eval or with `use_augmentation` off."""
        rng = rng or np.random.default_rng()
        flip, pn, rot, sc = 0, np.ones(3), 0.0, 1.0
        if self.is_train and self.use_augmentation:
            noise_factor = getattr(self.options, "noise_factor", 0.4)
            rot_factor = getattr(self.options, "rot_factor", 15.0)
            scale_factor = getattr(self.options, "scale_factor", 0.15)
            if rng.uniform() <= 0.5:
                flip = 1
            pn = rng.uniform(1 - noise_factor, 1 + noise_factor, 3)
            rot = min(2 * rot_factor, max(-2 * rot_factor, rng.normal() * rot_factor))
            sc = min(1 + scale_factor, max(1 - scale_factor, rng.normal() * scale_factor + 1))
            if rng.uniform() <= 0.6:
                rot = 0.0
        return flip, pn, rot, sc

    def _native_processing(self, img, center, scale, rot, flip, pn, as_uint8):
        """One image [H, W] or [H, W, C] through the native kernel: [res,
        res, C] in [0, 1] noised with `pn`, or with `as_uint8` the
        un-noised crop requantized to bytes (np.rint)."""
        img_u8 = np.ascontiguousarray(img).astype(np.uint8).reshape(*img.shape[:2], -1)
        C = img_u8.shape[-1]
        out = native.preprocess_batch(
            img_u8[None], np.asarray(center, np.float32)[None], np.asarray([scale], np.float32),
            np.asarray([float(flip)], np.float32), np.asarray(np.ones(3) if as_uint8 else pn, np.float32)[None, :3],
            self.img_res, np.zeros(C, np.float32), np.ones(C, np.float32), num_threads=1,
            rots=np.asarray([float(rot)], np.float32))[0]
        return np.rint(out * 255.0).astype(np.uint8) if as_uint8 else out

    def rgb_processing(self, rgb_img, center, scale, rot, flip, pn, as_uint8=False):
        """[H, W, 3]: noised in [0, 1], or the uint8 crop with `as_uint8`."""
        if self._native is not None:
            return self._native_processing(rgb_img, center, scale, rot, flip, pn, as_uint8)
        img = crop(rgb_img, center, scale, [self.img_res, self.img_res], rot=rot)
        if flip:
            img = np.ascontiguousarray(flip_img(img))
        if as_uint8:
            return img.astype(np.uint8)
        img = img.astype(np.float32)
        for c in range(3):
            img[:, :, c] = np.clip(img[:, :, c] * pn[c], 0, 255)
        return img / 255.0

    def gray_processing(self, gray_img, center, scale, rot, flip, pn, as_uint8=False):
        """[H, W, 1]: noised in [0, 1], or the uint8 crop with `as_uint8`."""
        if self._native is not None:
            return self._native_processing(gray_img, center, scale, rot, flip, pn, as_uint8)
        img = crop(gray_img, center, scale, [self.img_res, self.img_res], rot=rot)
        if flip:
            img = np.ascontiguousarray(flip_img(img))
        if as_uint8:
            return img.astype(np.uint8)[:, :, None]
        img = img.astype(np.float32)
        img = np.clip(img * pn[0], 0, 255)
        return img[:, :, None] / 255.0

    def j2d_processing(self, kp, center, scale, r, f):
        kp = kp.copy()
        for i in range(kp.shape[0]):
            kp[i, 0:2] = transform(kp[i, 0:2] + 1, center, scale, [self.img_res, self.img_res], rot=r)
        kp[:, :-1] = 2.0 * kp[:, :-1] / self.img_res - 1.0
        if f:
            kp = flip_kp(kp)
        return kp.astype(np.float32)

    def j3d_processing(self, S, r, f):
        S = S.copy()
        rot_mat = np.eye(3)
        if r != 0:
            rot_rad = -r * np.pi / 180
            sn, cs = np.sin(rot_rad), np.cos(rot_rad)
            rot_mat[0, :2] = [cs, -sn]
            rot_mat[1, :2] = [sn, cs]
        S[:, :-1] = np.einsum("ij,kj->ki", rot_mat, S[:, :-1])
        if f:
            S = flip_kp(S)
        return S.astype(np.float32)

    def pose_processing(self, pose, r, f):
        pose = pose.copy()
        pose[:3] = rot_aa(pose[:3], r)
        if f:
            pose = flip_pose(pose)
        return pose.astype(np.float32)

    def gen_contact(self, pm_img, mask, sigma=1, edges=True):
        """Pressure contact and its Sobel edge magnitude, [H, W, 2]."""
        pm_contact = np.copy(pm_img)
        pm_contact[pm_contact > 0] = 1
        pm_contact[mask == 0] = 0
        pm_contact = gaussian_filter(pm_contact, sigma=sigma)
        if not edges:
            return pm_contact
        sx = ndimage.sobel(pm_contact, axis=0, mode="constant")
        sy = ndimage.sobel(pm_contact, axis=1, mode="constant")
        p_map = np.hypot(sx, sy)
        denom = np.max(p_map)
        if denom > 0:
            p_map = p_map / denom
        return np.concatenate((pm_contact, p_map), axis=-1)

    def _labels(self, index, pose, center, scale, rot, flip):
        """The keys both modes emit besides the images."""
        return {
            "pose": self.pose_processing(pose, rot, flip),
            "imgname": join(self.img_dir, str(self.imgname[index])),
            "pose_3d": (self.j3d_processing(self.pose_3d[index].copy(), rot, flip) if self.has_pose_3d
                        else np.zeros((24, 4), np.float32)),
            "keypoints": self.j2d_processing(self.keypoints[index].copy(), center, scale, rot, flip),
            "has_smpl": np.float32(self.has_smpl[index]),
            "has_pose_3d": np.float32(self.has_pose_3d),
            "scale": np.float32(scale),
            "center": center.astype(np.float32),
            "is_flipped": np.float32(flip),
            "rot_angle": np.float32(rot),
            "gender": self.gender[index],
            "sample_index": index,
            "dataset_name": self.dataset,
        }

    def __getitem__(self, index, rng: Optional[np.random.Generator] = None):
        scale = self.scale[index].copy()
        center = self.center[index].copy()
        flip, pn, rot, sc = self.augm_params(rng)

        imgname = join(self.img_dir, str(self.imgname[index]))
        irname = join(self.img_dir, str(self.irimgname[index]))
        depthname = join(self.img_dir, str(self.depthname[index]))
        pmname = join(self.img_dir, str(self.pmname[index]))

        cache = self._cache
        if cache is not None:
            img, ir_img, depth_img, pm_img = (cache.full(index, m) for m in ("img", "ir", "depth", "pm"))
        else:
            img = read_rgb(imgname)
            ir_img = read_gray(irname) if self.hasIR else read_rgb(imgname)
            depth_img = read_gray(depthname) if self.hasDEPTH else read_rgb(imgname)
            pm_img = read_gray(pmname) if self.hasPM else read_rgb(imgname)
        orig_shape = np.array(img.shape)[:2]

        if self.has_smpl[index]:
            pose = self.pose[index].copy()
            betas = self.betas[index].copy()
        else:
            pose = np.zeros(72)
            betas = np.zeros(10)

        if self.return_raw:
            # No host crop, no uncover or mask reads: the device crop takes
            # the frames and the box (eval only, no augmentation).
            item = {
                "raw_img": _chw(img.astype(np.uint8)),
                "raw_ir_img": ir_img.astype(np.uint8)[None],
                "raw_depth_img": depth_img.astype(np.uint8)[None],
                "raw_pm_img": pm_img.astype(np.uint8)[None],
            }
            item.update(self._labels(index, pose, center, sc * scale, rot, flip))
            item["betas"] = betas.astype(np.float32)
            item["orig_shape"] = orig_shape
            return item

        u8 = self.uint8_feed
        box = (center, sc * scale, rot, flip, pn)
        img = self.rgb_processing(img, *box, as_uint8=u8)
        ir_img = self.gray_processing(ir_img, *box, as_uint8=u8)
        depth_img = self.gray_processing(depth_img, *box, as_uint8=u8)
        pm_img = self.gray_processing(pm_img, *box, as_uint8=u8)

        # Uncovered counterparts through the reference's filename rewriting.
        def unc(p):
            return p.replace("cover1", "uncover").replace("cover2", "uncover")

        if cache is not None:
            unc_raw = [cache.full(index, m) for m in ("img_unc", "ir_unc", "depth_unc", "pm_unc", "mask_unc")]
        else:
            unc_raw = [read_rgb(unc(imgname)), read_gray(unc(irname)), read_gray(unc(depthname)),
                       read_gray(unc(pmname)), read_gray(unc(pmname).replace("PM_aligned", "masks"))]
        img_unc = self.rgb_processing(unc_raw[0], *box)  # float in both feeds
        ir_unc, depth_unc, pm_unc, mask_unc = (self.gray_processing(raw, *box, as_uint8=u8) for raw in unc_raw[1:])

        if u8:
            # The contact map takes the noised [0, 1] views, derived with
            # the card's decode arithmetic.
            pm_f = np.clip(pm_img.astype(np.float32) * pn[0], 0, 255) / 255.0
            mask_f = np.clip(mask_unc.astype(np.float32) * pn[0], 0, 255) / 255.0
            pm_contact = self.gen_contact(pm_f, mask_f, sigma=1, edges=True)
            item = {
                "img": img, "ir_img": ir_img, "depth_img": depth_img, "pm_img": pm_img,
                "img_uncover": img_unc, "ir_img_uncover": ir_unc, "depth_img_uncover": depth_unc,
                "pm_img_uncover": pm_unc, "mask_uncover": mask_unc,
            }
        else:
            pm_contact = self.gen_contact(pm_img, mask_unc, sigma=1, edges=True)
            item = {
                "img": _normalize(img, constants.IMG_NORM_MEAN, constants.IMG_NORM_STD),
                "ir_img": _normalize(ir_img, constants.IR_NORM_MEAN, constants.IR_NORM_STD),
                "depth_img": _normalize(depth_img, constants.DEPTH_NORM_MEAN, constants.DEPTH_NORM_STD),
                "pm_img": _normalize(pm_img, constants.PM_NORM_MEAN, constants.PM_NORM_STD),
                "img_uncover": img_unc,
                "ir_img_uncover": _normalize(ir_unc, constants.IR_NORM_MEAN, constants.IR_NORM_STD),
                "depth_img_uncover": _normalize(depth_unc, constants.DEPTH_NORM_MEAN, constants.DEPTH_NORM_STD),
                "pm_img_uncover": _normalize(pm_unc, constants.PM_NORM_MEAN, constants.PM_NORM_STD),
                "mask_uncover": mask_unc.astype(np.float32),
            }
        item["pm_contact"] = pm_contact.astype(np.float32)
        item = {k: _chw(v) for k, v in item.items()}
        if u8:
            item["pixel_noise"] = np.asarray(pn[:3], np.float32)
        item.update(self._labels(index, pose, center, sc * scale, rot, flip))
        item["betas"] = betas.astype(np.float32)
        item["orig_shape"] = orig_shape
        item["maskname"] = str(self.maskname[index]) if self.maskname is not None else ""
        item["partname"] = str(self.partname[index]) if self.partname is not None else ""
        return item

    def __len__(self):
        return self.length


class MixedDataset:
    """A mixture of datasets, `options.data_train` = "name" or
    "name1:ratio1+name2:ratio2+...": each index of the virtual range
    [0, len) draws its source by the normalized partition, so an epoch
    realizes the mixture.  Items carry global sample indices (the source's
    block offset in the fits store plus its local index), with one
    [N_i, 82] block per source in `fits_layout` order."""

    def __init__(self, options, **kwargs):
        spec = getattr(options, "data_train", "slp-4mod-train")
        parts = []
        for token in spec.split("+"):
            if ":" in token:
                name, ratio = token.split(":")
                parts.append((name, float(ratio)))
            else:
                parts.append((token, 1.0))
        total = sum(r for _, r in parts)
        self.partition = [(name, r / total) for name, r in parts]

        self.datasets = [BaseDataset(options, name, **kwargs) for name, _ in self.partition]
        self.length = max(len(ds) for ds in self.datasets)
        self.fits_layout = [(name, len(ds)) for (name, _), ds in zip(self.partition, self.datasets)]
        self.fits_offsets = np.cumsum([0] + [n for _, n in self.fits_layout])[:-1]
        bounds = np.cumsum([r for _, r in self.partition])
        self._bounds = bounds / bounds[-1]

    def __getitem__(self, index):
        frac = (index % self.length) / self.length
        ds_idx = min(int(np.searchsorted(self._bounds, frac, side="right")), len(self.datasets) - 1)
        ds = self.datasets[ds_idx]
        item = ds[index % len(ds)]
        item["sample_index"] = int(self.fits_offsets[ds_idx]) + int(item["sample_index"])
        return item

    def __len__(self):
        return self.length
