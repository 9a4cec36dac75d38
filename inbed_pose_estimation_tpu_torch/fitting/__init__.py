from .losses import angle_prior, body_fitting_loss, camera_fitting_loss, gmof
from .prior import GMMPrior, load_gmm_prior, max_mixture_nll, synthetic_gmm_prior
from .smplify import SMPLifyResult, adam, make_fitting_loss, make_smplify

__all__ = [
    "GMMPrior",
    "SMPLifyResult",
    "adam",
    "angle_prior",
    "body_fitting_loss",
    "camera_fitting_loss",
    "gmof",
    "load_gmm_prior",
    "make_fitting_loss",
    "make_smplify",
    "max_mixture_nll",
    "synthetic_gmm_prior",
]
