"""SMPL assets: the real model pickle when present, a deterministic synthetic
model otherwise, and the IEF mean parameters.

`synthetic_smpl_model(seed)` runs the same numpy code as the JAX package's
synthetic model, so the two give identical arrays for one seed.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import constants
from ..device import resolve_device
from .model import SMPLModel

# Standard SMPL kinematic tree (parent of each of the 24 joints).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21],
    dtype=np.int32,
)

V = constants.NUM_VERTICES


def _to_np(x) -> np.ndarray:
    """Dense numpy from possibly chumpy / scipy.sparse arrays."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray(), dtype=np.float64)
    if hasattr(x, "r"):  # chumpy
        return np.asarray(x.r, dtype=np.float64)
    return np.asarray(x)


def load_smpl_model(model_dir: str, gender: str = "neutral", j_regressor_extra_path: str | None = None,
                    device: str | torch.device = "cuda") -> SMPLModel:
    """Load a real SMPL pickle (basicModel_*_lbs_10_207_0_v1.0.0.pkl layout).

    The pickle must come from a trusted source: unpickling runs code.
    """
    dev = resolve_device(device)
    names = {
        "neutral": ["SMPL_NEUTRAL.pkl", "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl"],
        "male": ["SMPL_MALE.pkl", "basicmodel_m_lbs_10_207_0_v1.0.0.pkl"],
        "female": ["SMPL_FEMALE.pkl", "basicModel_f_lbs_10_207_0_v1.0.0.pkl"],
    }[gender]
    path = next((os.path.join(model_dir, n) for n in names if os.path.exists(os.path.join(model_dir, n))), None)
    if path is None:
        raise FileNotFoundError(f"No SMPL {gender} model under {model_dir}")
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    posedirs = _to_np(data["posedirs"])  # [V, 3, 207]
    if j_regressor_extra_path and os.path.exists(j_regressor_extra_path):
        jre = np.load(j_regressor_extra_path)
    else:
        jre = np.zeros((9, V))
    return SMPLModel(
        v_template=_to_np(data["v_template"]),
        shapedirs=_to_np(data["shapedirs"])[:, :, : constants.NUM_BETAS],
        posedirs=posedirs.reshape(-1, posedirs.shape[-1]).T,  # [207, V*3]
        J_regressor=_to_np(data["J_regressor"]),
        lbs_weights=_to_np(data["weights"]),
        parents=SMPL_PARENTS,
        J_regressor_extra=jre,
        joint_map=constants.JOINT_MAP_ARRAY,
        faces=_to_np(data["f"]),
    ).to(dev)


def synthetic_smpl_arrays(seed: int = 0, num_vertices: int = V) -> dict[str, np.ndarray]:
    """Deterministic synthetic SMPL arrays with the real shapes and a valid tree.

    A vertical "body" point cloud, so that joint regression and skinning give
    well-conditioned geometry; blendshape magnitudes at real-SMPL scale (cm).
    """
    rng = np.random.default_rng(seed)
    nv = num_vertices

    v_template = rng.normal(0.0, 0.12, size=(nv, 3))
    v_template[:, 1] = np.linspace(-1.0, 1.0, nv) + rng.normal(0, 0.02, nv)

    shapedirs = rng.normal(0.0, 0.01, size=(nv, 3, constants.NUM_BETAS))
    posedirs = rng.normal(0.0, 0.001, size=(207, nv * 3))

    # Each joint averages a small band of vertices.
    J_regressor = np.zeros((24, nv))
    for j, cfrac in enumerate(np.linspace(0.05, 0.95, 24)):
        idx = int(cfrac * nv)
        lo, hi = max(0, idx - 20), min(nv, idx + 20)
        J_regressor[j, lo:hi] = 1.0 / (hi - lo)

    # Soft assignment of each vertex to the nearest joint bands along y.
    joint_pos = np.array([np.linspace(-1, 1, 24)]).T
    d2 = (v_template[:, 1:2] - joint_pos.T) ** 2  # [nv, 24]
    w = np.exp(-d2 / 0.02)
    lbs_weights = w / w.sum(axis=1, keepdims=True)

    J_regressor_extra = np.zeros((9, nv))
    for j in range(9):
        lo = (j * 37) % (nv - 40)
        J_regressor_extra[j, lo: lo + 40] = 1.0 / 40

    faces = rng.integers(0, nv, size=(100, 3)).astype(np.int32)

    return dict(
        v_template=v_template.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=J_regressor.astype(np.float32),
        lbs_weights=lbs_weights.astype(np.float32),
        parents=SMPL_PARENTS.copy(),
        J_regressor_extra=J_regressor_extra.astype(np.float32),
        joint_map=constants.JOINT_MAP_ARRAY.copy(),
        faces=faces,
    )


def synthetic_smpl_model(seed: int = 0, num_vertices: int = V, device: str | torch.device = "cuda") -> SMPLModel:
    """`SMPLModel` of `synthetic_smpl_arrays(seed)` on `device`."""
    dev = resolve_device(device)
    return SMPLModel(**synthetic_smpl_arrays(seed, num_vertices)).to(dev)


def mean_params(path: str | None = None) -> dict[str, np.ndarray]:
    """SMPL mean parameters for the IEF initialization.

    Loads smpl_mean_params.npz when `path` exists; otherwise identity
    rotations in the 6D convention ([1, 0, 0, 1, 0, 0] per joint), zero
    shape and the weak-perspective init cam = [0.9, 0, 0].
    """
    if path and os.path.exists(path):
        d = np.load(path)
        return {k: d[k].astype(np.float32).reshape(-1) for k in ("pose", "shape", "cam")}
    return {
        "pose": np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 24),
        "shape": np.zeros(10, np.float32),
        "cam": np.array([0.9, 0.0, 0.0], np.float32),
    }
