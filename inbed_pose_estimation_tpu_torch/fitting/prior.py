"""Max-of-mixture Gaussian pose prior: an 8-component GMM over the 69-dim
body pose, its negative log likelihood taken as the minimum over the
components, one quadratic form per component.

`load_gmm_prior` reads the reference's gmm_08.pkl when it is present;
`synthetic_gmm_prior(seed)` draws a well-conditioned mixture of the same
shapes with the same numpy code as the JAX package, so both packages build
the same mixture for one seed.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class GMMPrior(NamedTuple):
    means: torch.Tensor        # [K, 69]
    precisions: torch.Tensor   # [K, 69, 69]
    nll_weights: torch.Tensor  # [1, K]


def _from_arrays(means, covs, weights, device) -> GMMPrior:
    precisions = np.stack([np.linalg.inv(c) for c in covs]).astype(np.float32)
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
    const = (2 * np.pi) ** (69 / 2.0)
    nll_weights = np.asarray(weights / (const * (sqrdets / sqrdets.min())))[None].astype(np.float32)
    return GMMPrior(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                      for a in (means, precisions, nll_weights)))


def load_gmm_prior(path: str | None = None, num_gaussians: int = 8, device: str | torch.device = "cuda") -> GMMPrior:
    """The mixture in the pickle at `path` (a dict of means / covars /
    weights, or an sklearn GMM), or `synthetic_gmm_prior` when it is missing.

    The pickle must come from a trusted source: unpickling runs code.
    """
    dev = resolve_device(device)
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            gmm = pickle.load(f, encoding="latin1")
        if isinstance(gmm, dict):
            means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
        else:
            means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_
        return _from_arrays(*(np.asarray(a).astype(np.float32) for a in (means, covs, weights)), dev)
    return synthetic_gmm_prior(num_gaussians, device=dev)


def synthetic_gmm_prior(num_gaussians: int = 8, dim: int = 69, seed: int = 0,
                        device: str | torch.device = "cuda") -> GMMPrior:
    """Deterministic well-conditioned mixture with the real shapes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 0.3, (num_gaussians, dim)).astype(np.float32)
    covs = []
    for _ in range(num_gaussians):
        A = rng.normal(0, 0.05, (dim, dim))
        covs.append((A @ A.T + np.eye(dim) * 0.5).astype(np.float32))
    weights = rng.dirichlet(np.ones(num_gaussians)).astype(np.float32)
    return _from_arrays(means, np.stack(covs), weights, dev)


def max_mixture_nll(prior: GMMPrior, body_pose: torch.Tensor) -> torch.Tensor:
    """Negative log likelihood [B] of body poses [B, 69] (axis-angle, no
    global orientation): the minimum over components of
    0.5 d^T P_k d - log w_k, up to the reference's constant."""
    diff = body_pose[:, None, :] - prior.means[None]                     # [B, K, 69]
    prec_diff = torch.einsum("kij,bkj->bki", prior.precisions, diff)
    quad = torch.sum(prec_diff * diff, dim=-1)                           # [B, K]
    loglik = 0.5 * quad - torch.log(prior.nll_weights)
    return loglik.amin(dim=1)
