"""Offline index extractors: SLP's danaLab tree (`slp`), OpenPose matching
(`read_openpose`) and the auxiliary datasets (`extras`)."""
from .slp import TEST_SUBJECTS, TRAIN_SUBJECTS, slp_multi_mod, slp_single_mod
from .read_openpose import read_openpose

__all__ = [
    "TEST_SUBJECTS",
    "TRAIN_SUBJECTS",
    "slp_multi_mod",
    "slp_single_mod",
    "read_openpose",
]
