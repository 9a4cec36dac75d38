"""Host-side crop and augmentation kernels (numpy + Pillow).

The port's copy of the JAX package's `data/transforms.py`, which reproduces
the reference's `scipy.misc.imresize` semantics: bytescale to uint8, then a
Pillow resize.  Crops are bit-identical to the JAX package's.  The rotated
crop (`rot != 0`) is training-only and not ported yet.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from .. import constants

_ROTATED_CROP = "the rotated crop (rot != 0) is training-only and not ported yet: ROADMAP Queue 1 item 6"


def get_transform(center, scale, res, rot=0):
    """Bbox-to-crop affine [3, 3]: the box is (center, h = 200 * scale)."""
    h = 200 * scale
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / h
    t[1, 1] = float(res[0]) / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot = -rot
        rot_mat = np.zeros((3, 3))
        rot_rad = rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform(pt, center, scale, res, invert=0, rot=0):
    """Map a 1-based pixel location into the crop (or back, with `invert`)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = np.array([pt[0] - 1, pt[1] - 1, 1.0])
    new_pt = t @ new_pt
    return new_pt[:2].astype(int) + 1


def _bytescale(arr: np.ndarray) -> np.ndarray:
    """scipy 1.2 `pilutil.bytescale` with the reference's default arguments:
    a per-array [min, max] -> [0, 255] stretch, `255 / range` computed first
    and then multiplied, rounded half up.  uint8 passes through."""
    if arr.dtype == np.uint8:
        return arr
    cmin = arr.min()
    cmax = arr.max()
    cscale = cmax - cmin
    if cscale == 0:
        cscale = 1
    scale = float(255) / cscale
    bytedata = (arr - cmin) * scale
    return (bytedata.clip(0, 255) + 0.5).astype(np.uint8)


def _imresize_uint8(img: np.ndarray, size, interp="bilinear") -> np.ndarray:
    """`scipy.misc.imresize` work-alike: bytescale to uint8, Pillow resize to
    `size` = (height, width).  Returns uint8."""
    arr = _bytescale(img)
    mode = {"bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[interp]
    out = Image.fromarray(arr).resize((int(size[1]), int(size[0])), mode)
    return np.asarray(out)


def crop(img: np.ndarray, center, scale, res, rot=0) -> np.ndarray:
    """Crop around (center, 200 * scale) and resize to `res`; uint8 out."""
    if rot != 0:
        raise NotImplementedError(_ROTATED_CROP)
    ul = np.array(transform([1, 1], center, scale, res, invert=1)) - 1
    br = np.array(transform([res[0] + 1, res[1] + 1], center, scale, res, invert=1)) - 1

    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if img.ndim > 2:
        new_shape += [img.shape[2]]
    new_img = np.zeros(new_shape, dtype=img.dtype)

    new_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(img.shape[1], br[0])
    old_y = max(0, ul[1]), min(img.shape[0], br[1])
    new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = img[old_y[0]:old_y[1], old_x[0]:old_x[1]]
    return _imresize_uint8(new_img, res)


def uncrop(img: np.ndarray, center, scale, orig_shape) -> np.ndarray:
    """Invert `crop` for mask and part evaluation: nearest-neighbour resize
    back to the box, pasted into a zero uint8 image of `orig_shape`."""
    res = img.shape[:2]
    ul = np.array(transform([1, 1], center, scale, res, invert=1)) - 1
    br = np.array(transform([res[0] + 1, res[1] + 1], center, scale, res, invert=1)) - 1
    crop_shape = [br[1] - ul[1], br[0] - ul[0]]
    new_img = np.zeros(tuple(int(s) for s in orig_shape[:2]) + img.shape[2:], dtype=np.uint8)
    new_x = max(0, -ul[0]), min(br[0], orig_shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], orig_shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(orig_shape[1], br[0])
    old_y = max(0, ul[1]), min(orig_shape[0], br[1])
    img = _imresize_uint8(img, crop_shape, interp="nearest")
    new_img[old_y[0]:old_y[1], old_x[0]:old_x[1]] = img[new_y[0]:new_y[1], new_x[0]:new_x[1]]
    return new_img


def rot_aa(aa: np.ndarray, rot: float) -> np.ndarray:
    """Rotate a global-orientation axis-angle by an in-plane rotation of
    `rot` degrees (through the rotation matrix, also when rot is 0)."""

    def rodrigues(v):
        theta = np.linalg.norm(v)
        if theta < 1e-10:
            return np.eye(3)
        k = v / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)

    def inv_rodrigues(R):
        w = np.sqrt(max(1 + np.trace(R), 1e-12)) / 2
        xyz = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (4 * w)
        s = np.linalg.norm(xyz)
        if s < 1e-10:
            return np.zeros(3)
        angle = 2 * np.arctan2(s, w)
        return xyz / s * angle

    rad = np.deg2rad(-rot)
    Rz = np.array([[np.cos(rad), -np.sin(rad), 0], [np.sin(rad), np.cos(rad), 0], [0, 0, 1]])
    return inv_rodrigues(Rz @ rodrigues(np.asarray(aa, np.float64))).astype(aa.dtype)


def flip_img(img: np.ndarray) -> np.ndarray:
    """Mirror an [H, W, ...] image left to right."""
    return np.fliplr(img)


def flip_kp(kp: np.ndarray) -> np.ndarray:
    """Mirror 24 or 49 keypoints [N, 2 or 3]."""
    if len(kp) == 24:
        perm = constants.J24_FLIP_PERM
    elif len(kp) == 49:
        perm = constants.J49_FLIP_PERM
    else:
        raise ValueError(f"unsupported keypoint count {len(kp)}")
    kp = kp[perm]
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose(pose: np.ndarray) -> np.ndarray:
    """Mirror an SMPL axis-angle pose [72]."""
    pose = pose[constants.SMPL_POSE_FLIP_PERM]
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose
