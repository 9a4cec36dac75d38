"""SLP multi-modal evaluation dataset: npz index reader and per-sample host
decode.

The port's copy of the JAX package's `BaseDataset` for `is_train=False`.
It loads the npz index (imgname / irimgname / depthname / pmname, center,
scale, pose, shape, S, part, openpose, gender), reads the 4 covered images,
their 4 uncovered counterparts and the uncover body mask through the
reference's filename rewriting (cover1/cover2 -> uncover, PM_aligned ->
masks), crops them on the host exactly as the JAX package does, and emits a
dict of numpy arrays.  Images leave as [C, H, W] float32, as the reference's
torch dataset emitted them (the JAX package emits [H, W, C]); every other
key keeps the JAX package's shape.  With `options.device_preprocess` it
emits the raw uint8 frames ([C, H, W]) and the crop box instead, for
`data.device_preprocess`.
"""

from __future__ import annotations

from os.path import join

import numpy as np
from scipy import ndimage
from scipy.ndimage import gaussian_filter

from .. import config, constants
from .image_io import read_gray, read_rgb
from .transforms import crop, flip_img, flip_kp, flip_pose, rot_aa, transform

_TRAINER_SLICE = "is not ported yet: ROADMAP Queue 1 item 6 (the trainer driver)"


def _normalize(img01: np.ndarray, mean, std) -> np.ndarray:
    return (img01 - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _chw(img: np.ndarray) -> np.ndarray:
    """[H, W, C, ...] -> [C, H, W, ...]: the channel axis to the front."""
    return np.ascontiguousarray(np.moveaxis(img, 2, 0))


class BaseDataset:
    """Map-style evaluation dataset over an npz index."""

    def __init__(self, options=None, dataset: str = "slp-4mod-uncover", ignore_3d: bool = False,
                 is_train: bool = False):
        if is_train:
            raise NotImplementedError(f"BaseDataset(is_train=True) {_TRAINER_SLICE}")
        for flag in ("fast_preprocess", "uint8_feed", "crop_cache"):
            if getattr(options, flag, None):
                raise NotImplementedError(f"BaseDataset option '{flag}' {_TRAINER_SLICE}")
        self.dataset = dataset
        self.img_res = int(getattr(options, "img_res", constants.IMG_RES) or constants.IMG_RES)
        # Raw-decode mode: uint8 frames and the crop box only, for the
        # device crop (data/device_preprocess.py).
        self.return_raw = bool(getattr(options, "device_preprocess", False))
        self.img_dir = config.dataset_folder(dataset)
        self.data = np.load(config.dataset_file(dataset, is_train=False), allow_pickle=True)
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

    def augm_params(self):
        """(flip, channel noise, rotation, scale): no augmentation at eval."""
        return 0, np.ones(3), 0.0, 1.0

    def rgb_processing(self, rgb_img, center, scale, rot, flip, pn):
        img = crop(rgb_img, center, scale, [self.img_res, self.img_res], rot=rot)
        if flip:
            img = np.ascontiguousarray(flip_img(img))
        img = img.astype(np.float32)
        for c in range(3):
            img[:, :, c] = np.clip(img[:, :, c] * pn[c], 0, 255)
        return img / 255.0  # [H, W, 3]

    def gray_processing(self, gray_img, center, scale, rot, flip, pn):
        img = crop(gray_img, center, scale, [self.img_res, self.img_res], rot=rot)
        if flip:
            img = np.ascontiguousarray(flip_img(img))
        img = img.astype(np.float32)
        img = np.clip(img * pn[0], 0, 255)
        return img[:, :, None] / 255.0  # [H, W, 1]

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

    def __getitem__(self, index):
        scale = self.scale[index].copy()
        center = self.center[index].copy()
        flip, pn, rot, sc = self.augm_params()

        imgname = join(self.img_dir, str(self.imgname[index]))
        irname = join(self.img_dir, str(self.irimgname[index]))
        depthname = join(self.img_dir, str(self.depthname[index]))
        pmname = join(self.img_dir, str(self.pmname[index]))

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

        img = self.rgb_processing(img, center, sc * scale, rot, flip, pn)
        ir_img = self.gray_processing(ir_img, center, sc * scale, rot, flip, pn)
        depth_img = self.gray_processing(depth_img, center, sc * scale, rot, flip, pn)
        pm_img = self.gray_processing(pm_img, center, sc * scale, rot, flip, pn)

        # Uncovered counterparts through the reference's filename rewriting.
        def unc(p):
            return p.replace("cover1", "uncover").replace("cover2", "uncover")

        img_unc = self.rgb_processing(read_rgb(unc(imgname)), center, sc * scale, rot, flip, pn)
        ir_unc = self.gray_processing(read_gray(unc(irname)), center, sc * scale, rot, flip, pn)
        depth_unc = self.gray_processing(read_gray(unc(depthname)), center, sc * scale, rot, flip, pn)
        pm_unc = self.gray_processing(read_gray(unc(pmname)), center, sc * scale, rot, flip, pn)
        mask_unc = self.gray_processing(read_gray(unc(pmname).replace("PM_aligned", "masks")),
                                        center, sc * scale, rot, flip, pn)
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
            "pm_contact": pm_contact.astype(np.float32),
        }
        item = {k: _chw(v) for k, v in item.items()}
        item.update(self._labels(index, pose, center, sc * scale, rot, flip))
        item["betas"] = betas.astype(np.float32)
        item["orig_shape"] = orig_shape
        item["maskname"] = str(self.maskname[index]) if self.maskname is not None else ""
        item["partname"] = str(self.partname[index]) if self.partname is not None else ""
        return item

    def __len__(self):
        return self.length
