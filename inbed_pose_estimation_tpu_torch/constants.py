"""Camera, image, joint-layout and normalization constants.

The port's own copy of the reference specification (the same values as
the JAX package's `constants.py`); they are data and must match exactly
for metric parity.
"""

from __future__ import annotations

import numpy as np

FOCAL_LENGTH = 5000.0
IMG_RES = 224

# Per-modality normalization statistics measured on SLP.
IMG_NORM_MEAN = (0.387, 0.391, 0.376)
IMG_NORM_STD = (0.214, 0.226, 0.212)
DEPTH_NORM_MEAN = (0.7444,)
DEPTH_NORM_STD = (0.1147,)
IR_NORM_MEAN = (0.1748,)
IR_NORM_STD = (0.1151,)
PM_NORM_MEAN = (0.00457,)
PM_NORM_STD = (0.0253,)

# 49-joint superset: 25 OpenPose joints followed by 24 ground-truth joints.
JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)", "Spine (H36M)",
    "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye",
    "Left Ear", "Right Ear",
]
JOINT_IDS = {name: i for i, name in enumerate(JOINT_NAMES)}

# Superset joint -> row of the extended SMPL joint set (45 smplx joints +
# 9 extra regressed joints at indices 45..53).
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17, "OP RElbow": 19,
    "OP RWrist": 21, "OP LShoulder": 16, "OP LElbow": 18, "OP LWrist": 20,
    "OP MidHip": 0, "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7, "OP REye": 25,
    "OP LEye": 26, "OP REar": 27, "OP LEar": 28, "OP LBigToe": 29,
    "OP LSmallToe": 30, "OP LHeel": 31, "OP RBigToe": 32,
    "OP RSmallToe": 33, "OP RHeel": 34,
    "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45, "Left Hip": 46,
    "Left Knee": 4, "Left Ankle": 7, "Right Wrist": 21, "Right Elbow": 19,
    "Right Shoulder": 17, "Left Shoulder": 16, "Left Elbow": 18,
    "Left Wrist": 20, "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50, "Spine (H36M)": 51,
    "Jaw (H36M)": 52, "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}
# Gather order that emits the 49-joint superset.
JOINT_MAP_ARRAY = np.array([JOINT_MAP[n] for n in JOINT_NAMES], dtype=np.int32)

# H36M regressor rows -> the 17 evaluation joints.
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
# Rows of the packed 24-joint 3D ground truth (`S`) -> the 17 evaluation joints.
J24_TO_J17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]

# Left/right mirror of the 24 SMPL joints, and of the 72 axis-angle pose
# entries (three per joint).
SMPL_JOINTS_FLIP_PERM = [
    0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
    21, 20, 23, 22,
]
SMPL_POSE_FLIP_PERM = [3 * j + k for j in SMPL_JOINTS_FLIP_PERM for k in range(3)]
# Left/right mirror of the 24 ground-truth 2D joints and of the 49-joint superset.
J24_FLIP_PERM = [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16, 17, 18, 19, 21, 20, 23, 22]
J49_FLIP_PERM = [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17, 22, 23, 24, 19, 20, 21] + [
    25 + i for i in J24_FLIP_PERM
]

NUM_SMPL_JOINTS = 24
NUM_BETAS = 10
NUM_VERTICES = 6890
