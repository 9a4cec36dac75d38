"""OpenPose detection matcher (reference: datasets/preprocess/read_openpose.py:4-41);
the port's copy of the JAX package's `tools/preprocess/read_openpose.py`.

Given a frame's OpenPose JSON and the GT 2D keypoints, pick the detected
person whose re-projected joints best match the GT, and return the [25, 3]
keypoints (zeros when the JSON is missing — the reference tolerates absent
detections the same way via its json existence check)."""

from __future__ import annotations

import json
import os

import numpy as np

# Mapping from 14 LSP-order GT joints to the matching OpenPose joint rows.
LSP_TO_OPENPOSE = [11, 10, 9, 12, 13, 14, 4, 3, 2, 5, 6, 7, 1, 0]


def read_openpose(json_file: str, gt_part: np.ndarray, dataset: str = "lsp") -> np.ndarray:
    if not os.path.exists(json_file):
        return np.zeros((25, 3), np.float32)
    with open(json_file) as f:
        data = json.load(f)
    people = data.get("people", [])
    if not people:
        return np.zeros((25, 3), np.float32)

    gt = gt_part[:14, :2]
    conf = gt_part[:14, 2] if gt_part.shape[1] > 2 else np.ones(14)
    best, best_err = None, np.inf
    for person in people:
        kp = np.asarray(person["pose_keypoints_2d"], np.float32).reshape(25, 3)
        mapped = kp[LSP_TO_OPENPOSE, :2]
        valid = (conf > 0) & (kp[LSP_TO_OPENPOSE, 2] > 0)
        if valid.sum() == 0:
            continue
        err = np.linalg.norm(mapped[valid] - gt[valid], axis=1).mean()
        if err < best_err:
            best_err, best = err, kp
    return best if best is not None else np.zeros((25, 3), np.float32)
