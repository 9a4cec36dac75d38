"""Synthetic SLP-style dataset for tests and end-to-end runs without the SLP
download.  The port's copy of the JAX package's generator: the same seed
writes the same files and index arrays.

It writes a tree laid out like SLP's danaLab folders:
  <root>/<subj>/RGB/<cover>/image_XXXXXX.png          3 channels
  <root>/<subj>/IR_aligned/<cover>/image_XXXXXX.png   1 channel
  <root>/<subj>/depth_aligned/<cover>/image_XXXXXX.png
  <root>/<subj>/PM_aligned/<cover>/XXXXXX.png
  <root>/<subj>/masks/uncover/XXXXXX.png
and index npz files with imgname / irimgname / depthname / pmname / center /
scale / part / openpose / S / gender, as the SLP preprocessing writes them,
plus a 3DPW-layout split with SMPL ground truth and gender.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np

from .image_io import write


def make_synthetic_slp(root: str, num_subjects: int = 1, samples_per_subject: int = 4,
                       img_hw: tuple[int, int] = (120, 160), seed: int = 0,
                       covers: tuple[str, ...] = ("uncover", "cover1")) -> dict:
    """Write the images; return the index arrays, one row per (subject,
    sample, cover)."""
    rng = np.random.default_rng(seed)
    H, W = img_hw
    imgnames, irnames, depthnames, pmnames = [], [], [], []
    centers, scales, parts, opens, Ss, genders = [], [], [], [], [], []

    for s in range(1, num_subjects + 1):
        subj = f"{s:05d}"
        for sub in ("RGB", "IR_aligned", "depth_aligned", "PM_aligned"):
            for cover in set(covers) | {"uncover"}:
                os.makedirs(join(root, subj, sub, cover), exist_ok=True)
        os.makedirs(join(root, subj, "masks", "uncover"), exist_ok=True)

        for i in range(1, samples_per_subject + 1):
            fid = f"{i:06d}"
            # A body blob on a dark background.
            cy, cx = H // 2 + rng.integers(-8, 8), W // 2 + rng.integers(-10, 10)
            yy, xx = np.mgrid[0:H, 0:W]
            blob = np.exp(-(((yy - cy) / (H * 0.3)) ** 2 + ((xx - cx) / (W * 0.15)) ** 2))
            base = (blob * 200).astype(np.uint8)

            for cover in set(covers) | {"uncover"}:
                noise = rng.integers(0, 30, (H, W), dtype=np.uint8)
                write(join(root, subj, "RGB", cover, f"image_{fid}.png"), np.stack([base | noise] * 3, -1))
                write(join(root, subj, "IR_aligned", cover, f"image_{fid}.png"), base + noise // 2)
                write(join(root, subj, "depth_aligned", cover, f"image_{fid}.png"), 255 - base)
                write(join(root, subj, "PM_aligned", cover, f"{fid}.png"), (blob > 0.4).astype(np.uint8) * 120)
            write(join(root, subj, "masks", "uncover", f"{fid}.png"), (blob > 0.3).astype(np.uint8) * 255)

            for cover in covers:
                imgnames.append(join(subj, "RGB", cover, f"image_{fid}.png"))
                irnames.append(join(subj, "IR_aligned", cover, f"image_{fid}.png"))
                depthnames.append(join(subj, "depth_aligned", cover, f"image_{fid}.png"))
                pmnames.append(join(subj, "PM_aligned", cover, f"{fid}.png"))
                centers.append([cx, cy])
                scales.append(1.2 * max(H, W) / 200.0)
                # 24 ground-truth 2D joints scattered over the blob, confidence 1.
                kp = np.zeros((24, 3), np.float32)
                kp[:, 0] = cx + rng.normal(0, W * 0.1, 24)
                kp[:, 1] = cy + rng.normal(0, H * 0.2, 24)
                kp[:, 2] = 1.0
                parts.append(kp)
                opens.append(np.zeros((25, 3), np.float32))
                S = np.zeros((24, 4), np.float32)
                S[:, :3] = rng.normal(0, 0.3, (24, 3))
                S[:, 3] = 1.0
                Ss.append(S)
                genders.append(s % 2)

    return {
        "imgname": np.array(imgnames),
        "irimgname": np.array(irnames),
        "depthname": np.array(depthnames),
        "pmname": np.array(pmnames),
        "center": np.array(centers, np.float32),
        "scale": np.array(scales, np.float32),
        "part": np.array(parts, np.float32),
        "openpose": np.array(opens, np.float32),
        "S": np.array(Ss, np.float32),
        "gender": np.array(genders, np.int32),
    }


def make_synthetic_3dpw(root: str, num_samples: int = 4, img_hw: tuple[int, int] = (120, 160),
                        seed: int = 0) -> dict:
    """Write a 3DPW-layout split (imageFiles/<seq>/image_XXXXX.jpg) and return
    its index arrays: imgname / center / scale / pose / shape / gender /
    has_smpl and no packed S, so that its evaluation takes the gendered
    ground-truth path."""
    rng = np.random.default_rng(seed)
    H, W = img_hw
    seq = "courtyard_synthetic_00"
    os.makedirs(join(root, "imageFiles", seq), exist_ok=True)
    imgnames, centers, scales, poses, shapes, genders = [], [], [], [], [], []
    for i in range(num_samples):
        cy, cx = H // 2 + rng.integers(-8, 8), W // 2 + rng.integers(-10, 10)
        yy, xx = np.mgrid[0:H, 0:W]
        blob = np.exp(-(((yy - cy) / (H * 0.3)) ** 2 + ((xx - cx) / (W * 0.15)) ** 2))
        name = join("imageFiles", seq, f"image_{i:05d}.jpg")
        write(join(root, name), np.stack([(blob * 200).astype(np.uint8)] * 3, -1))
        imgnames.append(name)
        centers.append([cx, cy])
        scales.append(1.1 * max(H, W) / 200.0)
        poses.append(rng.normal(0, 0.2, 72).astype(np.float32))
        shapes.append(rng.normal(0, 0.5, 10).astype(np.float32))
        genders.append(i % 2)
    return {
        "imgname": np.array(imgnames),
        "center": np.array(centers, np.float32),
        "scale": np.array(scales, np.float32),
        "pose": np.array(poses, np.float32),
        "shape": np.array(shapes, np.float32),
        "gender": np.array(genders, np.int32),
        "has_smpl": np.ones(num_samples, np.float32),
    }


def write_synthetic_environment(base_dir: str, num_subjects: int = 1, samples_per_subject: int = 4, seed: int = 0,
                                img_hw: tuple[int, int] = (120, 160)) -> dict:
    """Write the SLP tree, its split indexes (slp-4mod-uncover / -cover1 /
    -cover2 / -train) and the 3dpw split under `base_dir`.

    Returns {"data_root", "npz_path"}: point INBED_DATA_ROOT and
    INBED_NPZ_PATH at them.
    """
    data_root = join(base_dir, "dataset")
    slp_root = join(data_root, "SLP", "SLP", "danaLab")
    npz_dir = join(base_dir, "dataset_extras")
    os.makedirs(npz_dir, exist_ok=True)

    index = make_synthetic_slp(slp_root, num_subjects, samples_per_subject, seed=seed,
                               covers=("uncover", "cover1"), img_hw=img_hw)
    np.savez(join(npz_dir, "slp_4mod_train.npz"), **index)

    uncover_rows = [i for i, n in enumerate(index["imgname"]) if "uncover" in n]
    cover1_rows = [i for i, n in enumerate(index["imgname"]) if "cover1" in n]
    for name, rows in [
        ("slp_4mod_uncover.npz", uncover_rows),
        ("slp_4mod_cover1.npz", cover1_rows),
        ("slp_4mod_cover2.npz", cover1_rows),
    ]:
        np.savez(join(npz_dir, name), **{k: v[rows] for k, v in index.items()})

    pw3d_index = make_synthetic_3dpw(join(data_root, "3DPW"), num_samples=max(3, samples_per_subject), seed=seed)
    np.savez(join(npz_dir, "3dpw_test.npz"), **pw3d_index)
    return {"data_root": data_root, "npz_path": npz_dir}


def write_synthetic_danalab(data_root: str, num_imgs: int = 2, covers: tuple[str, ...] = ("uncover", "cover1"),
                            seed: int = 0) -> dict:
    """Write a raw danaLab tree of one subject, as SLP ships it, for the
    offline index tool: <data_root>/SLP/SLP/danaLab/00001/ with
    joints_gt_RGB.mat [3, 14, num_imgs] (x, y, visibility; joint 3 occluded,
    so the pseudo-3D depth takes the bed's), 1024 x 1024 RGB / IR_aligned /
    depth_aligned / PM_aligned frames for each cover (a blocky texture, so
    that the joints' boxes lie on the frame and the files stay small), the
    uncovered depth as per-pixel noise (what the depth lookup at the joints
    reads), the uncovered body masks, one OpenPose detection (frame 1; the
    others have none) and danaLab_data_gender.csv beside the tree.

    Returns {"slp_root", "joints" [3, 14, num_imgs], "depth_uncover"
    [1024, 1024] uint8}.
    """
    import json

    import scipy.io as sio

    rng = np.random.default_rng(seed)
    slp_root = join(data_root, "SLP", "SLP", "danaLab")
    sub = join(slp_root, "00001")
    joints = np.zeros((3, 14, num_imgs))
    joints[0] = rng.uniform(300, 700, (14, num_imgs))
    joints[1] = rng.uniform(200, 800, (14, num_imgs))
    joints[2] = 1.0
    joints[2, 3, :] = 0.0
    os.makedirs(sub, exist_ok=True)
    sio.savemat(join(sub, "joints_gt_RGB.mat"), {"joints_gt": joints})

    for mod, cover_list in (("RGB", covers), ("IR_aligned", covers), ("depth_aligned", covers),
                            ("PM_aligned", covers), ("masks", ("uncover",))):
        for cover in cover_list:
            os.makedirs(join(sub, mod, cover), exist_ok=True)
            for i in range(num_imgs):
                img = np.repeat(np.repeat(rng.integers(0, 255, (64, 64), np.uint8), 16, 0), 16, 1)
                name = f"{i + 1:06d}.png"
                if mod == "RGB":
                    name, img = "image_" + name, np.stack([img] * 3, -1)
                write(join(sub, mod, cover, name), img)
    depth_unc = rng.integers(100, 200, (1024, 1024), np.uint8)
    os.makedirs(join(sub, "depth_aligned", "uncover"), exist_ok=True)
    for i in range(num_imgs):
        write(join(sub, "depth_aligned", "uncover", f"{i + 1:06d}.png"), depth_unc)

    os.makedirs(join(sub, "openpose"), exist_ok=True)
    kp = np.zeros((25, 3), np.float32)
    kp[:, 2] = 1.0
    kp[:, 0] = rng.uniform(300, 700, 25)
    kp[:, 1] = rng.uniform(200, 800, 25)
    with open(join(sub, "openpose", "image_000001_keypoints.json"), "w") as f:
        json.dump({"people": [{"pose_keypoints_2d": kp.reshape(-1).tolist()}]}, f)
    np.savetxt(join(slp_root, os.pardir, "danaLab_data_gender.csv"), np.ones(200))
    return {"slp_root": slp_root, "joints": joints, "depth_uncover": depth_unc}
