"""Standard SPIN-style npz extractors for the auxiliary datasets.

The port's copy of the JAX package's `tools/preprocess/extras.py`: offline
host tools mirroring the reference preprocessors
(reference: datasets/preprocess/{lsp_dataset,lsp_dataset_original,hr_lspet,
mpii,coco,pw3d,mpi_inf_3dhp,h36m}.py — SURVEY.md §2.1 "Preprocess: others").
Each emits the common schema: imgname, center, scale, part[24,3]
(+ S[24,4] / pose/shape for 3D datasets).  Heavy external readers (pycdf,
h5py) import lazily so the framework never requires them.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np


def _save(out_path, out_name, **arrays):
    os.makedirs(out_path, exist_ok=True)
    np.savez(join(out_path, out_name), **{k: np.asarray(v) for k, v in arrays.items()})


def lsp_dataset_extract(dataset_path, out_path, out_name="lsp_dataset_test.npz"):
    """LSP test set: 2D-only, joints.mat [3, 14, 2000], images 1001-2000."""
    import scipy.io as sio

    joints = sio.loadmat(join(dataset_path, "joints.mat"))["joints"]
    imgnames, centers, scales, parts = [], [], [], []
    for i in range(1000, 2000):
        imgnames.append(join("images", f"im{i + 1:04d}.jpg"))
        part14 = joints[:2, :, i].T
        bbox = [part14[:, 0].min(), part14[:, 1].min(), part14[:, 0].max(), part14[:, 1].max()]
        centers.append([(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2])
        scales.append(0.9 * max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 200)
        part = np.zeros((24, 3))
        part[:14] = np.hstack([part14, (joints[2, :, i] == 0).reshape(14, 1)])
        parts.append(part)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales, part=parts)


def lsp_dataset_original_extract(dataset_path, out_path, out_name="lsp_dataset_original_train.npz"):
    import scipy.io as sio

    joints = sio.loadmat(join(dataset_path, "joints.mat"))["joints"]
    imgnames, centers, scales, parts = [], [], [], []
    for i in range(1000):
        imgnames.append(join("images", f"im{i + 1:04d}.jpg"))
        part14 = joints[:2, :, i].T
        vis = joints[2, :, i]
        bbox = [part14[:, 0].min(), part14[:, 1].min(), part14[:, 0].max(), part14[:, 1].max()]
        centers.append([(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2])
        scales.append(1.4 * max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 200)
        part = np.zeros((24, 3))
        part[:14] = np.hstack([part14, vis.reshape(14, 1)])
        parts.append(part)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales, part=parts)


def hr_lspet_extract(dataset_path, out_path, out_name="hr-lspet_train.npz"):
    import scipy.io as sio

    joints = sio.loadmat(join(dataset_path, "joints.mat"))["joints"]  # [14, 3, N]
    imgnames, centers, scales, parts = [], [], [], []
    for i in range(joints.shape[2]):
        vis = joints[:, 2, i]
        part14 = joints[:, :2, i]
        if vis.sum() < 2:
            continue
        v = part14[vis > 0]
        bbox = [v[:, 0].min(), v[:, 1].min(), v[:, 0].max(), v[:, 1].max()]
        imgnames.append(f"im{i + 1:05d}.png")
        centers.append([(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2])
        scales.append(1.1 * max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 200)
        part = np.zeros((24, 3))
        part[:14] = np.hstack([part14, vis.reshape(14, 1)])
        parts.append(part)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales, part=parts)


# MPII 16-joint order -> 24-joint GT superset rows.
MPII_TO_J24 = [0, 1, 2, 3, 4, 5, 14, 15, 12, 13, 6, 7, 8, 9, 10, 11]


def mpii_extract(annot_file, out_path, out_name="mpii_train.npz"):
    """MPII from the standardized annotation h5 (train.h5)."""
    import h5py

    imgnames, centers, scales, parts = [], [], [], []
    with h5py.File(annot_file, "r") as f:
        centers_h = f["center"][:]
        scales_h = f["scale"][:]
        partsh = f["part"][:]
        vis = f["visible"][:]
        names = [n.decode() if isinstance(n, bytes) else str(n) for n in f["imgname"][:]]
    for i in range(len(names)):
        imgnames.append(join("images", names[i]))
        centers.append(centers_h[i])
        scales.append(scales_h[i])
        part = np.zeros((24, 3))
        part[MPII_TO_J24] = np.hstack([partsh[i], vis[i].reshape(-1, 1)])
        parts.append(part)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales, part=parts)


# COCO 17-keypoint order -> 24-joint GT superset rows (12 shared joints).
COCO_TO_J24 = [19, 20, 21, 22, 23, 9, 8, 10, 7, 11, 6, 3, 2, 4, 1, 5, 0]


def coco_extract(annot_json, out_path, out_name="coco_2014_train.npz"):
    import json

    with open(annot_json) as f:
        coco = json.load(f)
    img_by_id = {im["id"]: im for im in coco["images"]}
    imgnames, centers, scales, parts = [], [], [], []
    for ann in coco["annotations"]:
        kp = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
        if (kp[:, 2] > 0).sum() < 12:
            continue
        bbox = ann["bbox"]
        imgnames.append(join("train2014", img_by_id[ann["image_id"]]["file_name"]))
        centers.append([bbox[0] + bbox[2] / 2, bbox[1] + bbox[3] / 2])
        scales.append(1.2 * max(bbox[2], bbox[3]) / 200)
        part = np.zeros((24, 3))
        for src, dst in enumerate(COCO_TO_J24):
            if dst < 24:
                part[dst] = [kp[src, 0], kp[src, 1], float(kp[src, 2] > 0)]
        parts.append(part)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales, part=parts)


def pw3d_extract(dataset_path, out_path, out_name="3dpw_test.npz"):
    """3DPW test sequences: SMPL GT from the sequence pickles."""
    import pickle

    imgnames, centers, scales, poses, shapes, genders = [], [], [], [], [], []
    seq_dir = join(dataset_path, "sequenceFiles", "test")
    for seq_file in sorted(os.listdir(seq_dir)):
        with open(join(seq_dir, seq_file), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        seq = data["sequence"]
        for p_id in range(len(data["poses"])):
            valid = np.asarray(data["campose_valid"][p_id]).astype(bool)
            pose_seq = data["poses"][p_id]
            beta = data["betas"][p_id][:10]
            j2d_seq = data["poses2d"][p_id]
            gender = 0 if str(data["genders"][p_id]) == "m" else 1
            for t in range(pose_seq.shape[0]):
                if not valid[t]:
                    continue
                j2d = j2d_seq[t].T  # [18, 3]
                vis = j2d[:, 2] > 0.3
                if vis.sum() < 6:
                    continue
                v = j2d[vis]
                bbox = [v[:, 0].min(), v[:, 1].min(), v[:, 0].max(), v[:, 1].max()]
                imgnames.append(join("imageFiles", seq, f"image_{t:05d}.jpg"))
                centers.append([(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2])
                scales.append(1.2 * max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 200)
                poses.append(pose_seq[t])
                shapes.append(beta)
                genders.append(gender)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales,
          pose=poses, shape=shapes, gender=genders, has_smpl=np.ones(len(imgnames)))


def mpi_inf_3dhp_extract(dataset_path, out_path, out_name="mpi_inf_3dhp_valid.npz"):
    """MPI-INF-3DHP test set from the mat annotations (17-joint 3D GT)."""
    import scipy.io as sio

    imgnames, centers, scales, parts, Ss = [], [], [], [], []
    for ts in range(1, 7):
        annot = sio.loadmat(join(dataset_path, f"TS{ts}", "annot_data.mat"))
        valid = annot["valid_frame"].squeeze().astype(bool)
        j2d = annot["annot2"]
        j3d = annot["univ_annot3"]
        for t in np.flatnonzero(valid):
            kp = j2d[t].reshape(-1, 2) if j2d[t].ndim > 1 else j2d[t]
            bbox = [kp[:, 0].min(), kp[:, 1].min(), kp[:, 0].max(), kp[:, 1].max()]
            imgnames.append(join(f"TS{ts}", "imageSequence", f"img_{t + 1:06d}.jpg"))
            centers.append([(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2])
            scales.append(1.2 * max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 200)
            part = np.zeros((24, 3))
            parts.append(part)
            S = np.zeros((24, 4))
            Ss.append(S)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales, part=parts, S=Ss)


# H36M 17-joint (h36m layout) selection indices used by the reference
# (datasets/preprocess/h36m.py): the 32-joint CDF pose is reduced to 17.
H36M_32_TO_17 = [0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27]


def h36m_extract(dataset_path, out_path, out_name="h36m_valid_protocol2.npz",
                 protocol=2, subjects=("S9", "S11"), sample_rate=5):
    """H36M validation extractor (reference: datasets/preprocess/h36m.py).

    Reads the CDF pose annotations (requires spacepy/pycdf — offline-only,
    lazily imported) and emits imgname/center/scale/S/part in the standard
    schema, sampling every `sample_rate`-th frame like the reference.
    """
    from spacepy import pycdf  # heavyweight, offline tool only

    imgnames, centers, scales, Ss, parts = [], [], [], [], []
    for subject in subjects:
        pose_dir = join(dataset_path, subject, "MyPoseFeatures", "D3_Positions_mono")
        pos2d_dir = join(dataset_path, subject, "MyPoseFeatures", "D2_Positions")
        for seq in sorted(os.listdir(pose_dir)):
            if not seq.endswith(".cdf"):
                continue
            with pycdf.CDF(join(pose_dir, seq)) as cdf:
                poses_3d = np.asarray(cdf["Pose"])[0]
            with pycdf.CDF(join(pos2d_dir, seq)) as cdf:
                poses_2d = np.asarray(cdf["Pose"])[0]
            action = seq.replace(".cdf", "")
            for t in range(0, poses_3d.shape[0], sample_rate):
                j3d = poses_3d[t].reshape(-1, 3)[H36M_32_TO_17] / 1000.0
                j2d = poses_2d[t].reshape(-1, 2)[H36M_32_TO_17]
                bbox = [j2d[:, 0].min(), j2d[:, 1].min(), j2d[:, 0].max(), j2d[:, 1].max()]
                imgnames.append(join("images", f"{subject}_{action}_{t + 1:06d}.jpg"))
                centers.append([(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2])
                scales.append(1.2 * max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 200)
                S = np.zeros((24, 4))
                S24_idx = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]
                S[S24_idx, :3] = j3d - j3d[0]
                S[S24_idx, 3] = 1
                Ss.append(S)
                part = np.zeros((24, 3))
                parts.append(part)
    _save(out_path, out_name, imgname=imgnames, center=centers, scale=scales,
          S=Ss, part=parts)


def mpi_inf_3dhp_extract_frames(dataset_path, subjects=range(1, 9), seqs=range(1, 3),
                                cameras=(0, 1, 2, 4, 5, 6, 7, 8)):
    """Extract frames from MPI-INF-3DHP training videos to jpg
    (reference: datasets/preprocess/mpi_inf_3dhp_extract_frames_from_video.py).
    Uses cv2.VideoCapture; writes <seq>/imageFrames/video_<c>/frame_XXXXXX.jpg.
    """
    import cv2

    for s in subjects:
        for seq in seqs:
            seq_dir = join(dataset_path, f"S{s}", f"Seq{seq}")
            for c in cameras:
                video = join(seq_dir, "imageSequence", f"video_{c}.avi")
                if not os.path.exists(video):
                    continue
                out_dir = join(seq_dir, "imageFrames", f"video_{c}")
                os.makedirs(out_dir, exist_ok=True)
                cap = cv2.VideoCapture(video)
                t = 0
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    t += 1
                    cv2.imwrite(join(out_dir, f"frame_{t:06d}.jpg"), frame)
                cap.release()


def h36m_train_extract(dataset_path, out_path, out_name="h36m_train.npz",
                       subjects=("S1", "S5", "S6", "S7", "S8"), sample_rate=5):
    """H36M training extractor (reference: datasets/preprocess/h36m_train.py):
    same CDF reading as h36m_extract over the training subjects."""
    return h36m_extract(dataset_path, out_path, out_name=out_name,
                        subjects=subjects, sample_rate=sample_rate)
