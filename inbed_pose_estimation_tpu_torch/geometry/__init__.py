from .camera import estimate_translation, perspective_projection, weak_perspective_to_cam_t, weak_perspective_to_cam_t_np
from .procrustes import compute_similarity_transform, reconstruction_error
from .rotations import (
    aa_rotate_z,
    batch_rodrigues,
    flip_pose,
    quat_to_rotmat,
    rot6d_to_rotmat,
    rotmat_to_aa,
    rotmat_to_quat,
    rotmat_to_rot6d,
)

__all__ = [
    "aa_rotate_z",
    "batch_rodrigues",
    "compute_similarity_transform",
    "estimate_translation",
    "flip_pose",
    "perspective_projection",
    "quat_to_rotmat",
    "reconstruction_error",
    "rot6d_to_rotmat",
    "rotmat_to_aa",
    "rotmat_to_quat",
    "rotmat_to_rot6d",
    "weak_perspective_to_cam_t",
    "weak_perspective_to_cam_t_np",
]
