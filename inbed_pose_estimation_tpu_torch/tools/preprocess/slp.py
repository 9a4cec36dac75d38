"""SLP npz-index extractors (offline host tools).

The port's copy of the JAX package's `tools/preprocess/slp.py`, which
re-implements the reference extractors:
  * slp_single_mod (reference: datasets/preprocess/slp.py:17-115) — RGB or
    IR single-modality indexes with OpenPose matching,
  * slp_multi_mod (reference: datasets/preprocess/slp_depth.py:121-269) —
    the 4-modality extractor behind slp_4mod_*.npz: records
    imgname/irimgname/depthname/pmname for the aligned modality dirs, bbox
    from the 14 GT joints x1.2 / 200, pseudo-3D z sampled from the
    *uncovered* depth image at the joint pixels with the bed-depth fallback
    (178/180) and z-inversion, S24 packing over the 17-joint selection with
    joint 15's confidence zeroed, gender from danaLab_data_gender.csv.

Subject splits (slp_depth.py:307-318): train 1-84, test 85-101.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np

from ...data.image_io import read_gray_u8
from .read_openpose import read_openpose

GLOBAL_IDX_17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]


def _load_joints_gt(subject_dir: str) -> np.ndarray:
    """joints_gt_RGB.mat -> [3, 14, 45] (x, y, occluded-flag)."""
    import scipy.io as sio

    return sio.loadmat(join(subject_dir, "joints_gt_RGB.mat"))["joints_gt"]


def _bbox_center_scale(part14: np.ndarray, scale_factor: float = 1.2):
    bbox = [part14[:, 0].min(), part14[:, 1].min(), part14[:, 0].max(), part14[:, 1].max()]
    center = [(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2]
    scale = scale_factor * max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 200
    return center, scale


def _pseudo_3d(part14: np.ndarray, occl: np.ndarray, depth_uncover: np.ndarray) -> np.ndarray:
    """[17, 3] pseudo-3D: xy from 2D joints (normalized by 1024/2), z from
    the uncovered depth image (slp_depth.py:173-224)."""
    poses = np.zeros((15, 3))
    poses[:14, :2] = part14
    bed_depth = (178, 180)
    H, W = depth_uncover.shape[:2]
    for i in range(14):
        y = int(np.clip(part14[i, 1], 0, H - 1))
        x = int(np.clip(part14[i, 0], 0, W - 1))
        poses[i, 2] = depth_uncover[y, x] / 255.0
        if occl[i] == 0:
            poses[i, 2] = bed_depth[0 if i < 6 else 1] / 255.0
        poses[i, 2] = 1 - poses[i, 2]
    poses[14, :2] = (part14[2, :2] + part14[3, :2]) / 2
    poses[14, 2] = (poses[2, 2] + poses[3, 2]) / 2

    c = np.array([1024 / 2.0, 1024 / 2.0], np.float32)
    poses[:, :2] = poses[:, :2] / c - 1.0

    S15 = poses.reshape(-1, 3)
    S15[14] = (S15[2] + S15[3]) / 2
    S17 = np.zeros((17, 3))
    S17[:15] = S15
    S17[16] = (S15[12] + S15[13]) / 2
    S17 -= S17[14]
    return S17


def slp_multi_mod(dataset_path: str, out_path: str, out_name: str, cover_types, sub_list,
                  imgs_per_cover: int = 45):
    imgnames, irnames, depthnames, pmnames = [], [], [], []
    centers, scales, parts, Ss, openposes, genders = [], [], [], [], [], []

    gender_file = join(os.path.dirname(dataset_path), "danaLab_data_gender.csv")
    gender_all = np.loadtxt(gender_file) if os.path.exists(gender_file) else np.zeros(200)

    for sub_ind in sub_list:
        sub = f"{sub_ind:05d}"
        joints = _load_joints_gt(join(dataset_path, sub))
        for cover in cover_types:
            openpose_dir = join(dataset_path, sub, "openpose")
            for img_i in range(imgs_per_cover):
                name = f"{img_i + 1:06d}.png"
                imgnames.append(join(sub, "RGB/" + cover, "image_" + name))
                irnames.append(join(sub, "IR_aligned/" + cover, name))
                depthnames.append(join(sub, "depth_aligned/" + cover, name))
                pmnames.append(join(sub, "PM_aligned/" + cover, name))

                part14 = joints[:2, :, img_i].T
                center, scale = _bbox_center_scale(part14)
                part = np.zeros((24, 3))
                part[:14] = np.hstack([part14, np.ones((14, 1))])

                json_file = join(openpose_dir, "image_" + name.replace(".png", "_keypoints.json"))
                openpose = read_openpose(json_file, part, "lsp")

                depth_unc = read_gray_u8(join(dataset_path, sub, "depth_aligned/uncover", name))
                if depth_unc is None:
                    depth_unc = np.full((1024, 1024), 180, np.uint8)
                S17 = _pseudo_3d(part14, joints[2, :, img_i], depth_unc)
                S24 = np.zeros((24, 4))
                S24[GLOBAL_IDX_17, :3] = S17
                S24[GLOBAL_IDX_17, 3] = 1
                S24[GLOBAL_IDX_17[15], 3] = 0  # joint 15 confidence zeroed

                centers.append(center)
                scales.append(scale)
                parts.append(part)
                Ss.append(S24)
                openposes.append(openpose)
                genders.append(int(gender_all[sub_ind - 1]))

    os.makedirs(out_path, exist_ok=True)
    np.savez(
        join(out_path, out_name),
        imgname=np.array(imgnames), irimgname=np.array(irnames),
        depthname=np.array(depthnames), pmname=np.array(pmnames),
        center=np.array(centers), scale=np.array(scales),
        part=np.array(parts), S=np.array(Ss),
        openpose=np.array(openposes), gender=np.array(genders),
    )


def slp_single_mod(dataset_path: str, out_path: str, out_name: str, img_types, sub_list,
                   imgs_per_cover: int = 45):
    """Single-modality (RGB or IR) index (datasets/preprocess/slp.py:17-115)."""
    imgnames, centers, scales, parts, openposes = [], [], [], [], []

    for sub_ind in sub_list:
        sub = f"{sub_ind:05d}"
        joints = _load_joints_gt(join(dataset_path, sub))
        for img_type in img_types:
            for img_i in range(imgs_per_cover):
                name = f"{img_i + 1:06d}.png"
                imgnames.append(join(sub, img_type, "image_" + name))
                part14 = joints[:2, :, img_i].T
                center, scale = _bbox_center_scale(part14)
                part = np.zeros((24, 3))
                part[:14] = np.hstack([part14, np.ones((14, 1))])
                json_file = join(
                    dataset_path, sub, "openpose", "image_" + name.replace(".png", "_keypoints.json")
                )
                openposes.append(read_openpose(json_file, part, "lsp"))
                centers.append(center)
                scales.append(scale)
                parts.append(part)

    os.makedirs(out_path, exist_ok=True)
    np.savez(
        join(out_path, out_name),
        imgname=np.array(imgnames), center=np.array(centers), scale=np.array(scales),
        part=np.array(parts), openpose=np.array(openposes),
    )


TRAIN_SUBJECTS = range(1, 85)
TEST_SUBJECTS = range(85, 102)
