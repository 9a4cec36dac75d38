from .procrustes import compute_similarity_transform, reconstruction_error
from .rotations import batch_rodrigues, quat_to_rotmat, rot6d_to_rotmat

__all__ = [
    "batch_rodrigues",
    "compute_similarity_transform",
    "quat_to_rotmat",
    "reconstruction_error",
    "rot6d_to_rotmat",
]
