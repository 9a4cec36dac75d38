from .assets import SMPL_PARENTS, load_smpl_model, mean_params, synthetic_smpl_arrays, synthetic_smpl_model
from .model import SMPLModel, SMPLOutput, lbs, smpl_forward

__all__ = [
    "SMPLModel",
    "SMPLOutput",
    "SMPL_PARENTS",
    "lbs",
    "load_smpl_model",
    "mean_params",
    "smpl_forward",
    "synthetic_smpl_arrays",
    "synthetic_smpl_model",
]
