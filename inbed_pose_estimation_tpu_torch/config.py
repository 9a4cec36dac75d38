"""Dataset and asset paths.

The same tables as the JAX package's `config.py`, read from the environment
when called, not when imported: `INBED_DATA_ROOT` (image roots),
`INBED_NPZ_PATH` (split index files) and `INBED_ASSET_DIR` (SMPL models,
regressors, mean parameters), so that a caller can point the port at
another tree without reloading a module.
"""

from __future__ import annotations

import os
from os.path import join

# Image root of each dataset, below the data root.
_DATASET_DIRS = {
    "slp": "SLP/SLP/danaLab",
    "h36m": "human36m",
    "lsp": "lsp",
    "lsp_original": "lsp_original",
    "lspet": "lspextend_hr",
    "mpii": "mpii",
    "coco": "coco",
    "mpi_inf_3dhp": "mpi_inf_3dhp",
    "3dpw": "3DPW",
    "upi_s1h": "upi_s1h",
}

# Index npz of each split name: [0] eval splits, [1] train splits.
_SPLIT_FILES = (
    {
        **{f"slp-{mod}-{cover}": f"slp_{mod}_{cover}_test.npz"
           for mod in ("rgb", "ir") for cover in ("uncover", "cover1", "cover2")},
        **{f"slp-{cover}": f"slp_multi_mod_{cover}_test.npz" for cover in ("uncover", "cover1", "cover2")},
        **{f"slp-4mod-{cover}": f"slp_4mod_{cover}.npz" for cover in ("uncover", "cover1", "cover2")},
        "slp-4mod-train": "slp_4mod_train.npz",
        "h36m-p1": "h36m_valid_protocol1.npz",
        "h36m-p2": "h36m_valid_protocol2.npz",
        "lsp": "lsp_dataset_test.npz",
        "mpi-inf-3dhp": "mpi_inf_3dhp_valid.npz",
        "3dpw": "3dpw_test.npz",
    },
    {
        "slp": "slp_rgb_uncover_train.npz",
        "slp-rgb": "slp_rgb_train.npz",
        "slp-ir": "slp_ir_train.npz",
        "slp-multi": "slp_multi_mod_train.npz",
        "slp-4mod-train": "slp_4mod_train.npz",
        "h36m": "h36m_train.npz",
        "lsp-orig": "lsp_dataset_original_train.npz",
        "mpii": "mpii_train.npz",
        "coco": "coco_2014_train.npz",
        "lspet": "hr-lspet_train.npz",
        "mpi-inf-3dhp": "mpi_inf_3dhp_train.npz",
    },
)

# Split name -> dataset directory key; every slp-* split lives under "slp".
_SPLIT_DIRS = {
    "h36m": "h36m", "h36m-p1": "h36m", "h36m-p2": "h36m", "lsp-orig": "lsp_original", "lsp": "lsp",
    "lspet": "lspet", "mpi-inf-3dhp": "mpi_inf_3dhp", "mpii": "mpii", "coco": "coco", "3dpw": "3dpw",
    "upi-s1h": "upi_s1h",
}

_ASSET_FILES = {
    "cube_parts": "cube_parts.npy",
    "j_regressor_extra": "J_regressor_extra.npy",
    "j_regressor_h36m": "J_regressor_h36m.npy",
    "vertex_texture": "vertex_texture.npy",
    "static_fits": "static_fits",
    "smpl_mean_params": "smpl_mean_params.npz",
    "smpl_model_dir": "smpl",
    "gmm_prior": "gmm_08.pkl",
}


def data_root() -> str:
    return os.environ.get("INBED_DATA_ROOT", "../../Dataset/pose/")


def npz_path() -> str:
    return os.environ.get("INBED_NPZ_PATH", "data/dataset_extras")


def asset_dir() -> str:
    return os.environ.get("INBED_ASSET_DIR", "data")


def dataset_file(split: str, is_train: bool = False) -> str:
    """The index npz of `split` (an eval split unless `is_train`)."""
    return join(npz_path(), _SPLIT_FILES[int(is_train)][split])


def dataset_folder(split: str) -> str:
    """The image root that `split`'s index names are relative to."""
    key = "slp" if split.startswith("slp") else _SPLIT_DIRS[split]
    return join(data_root(), _DATASET_DIRS[key])


def asset(name: str) -> str:
    """Path of an asset: one of cube_parts, j_regressor_extra,
    j_regressor_h36m, vertex_texture, static_fits, smpl_mean_params,
    smpl_model_dir, gmm_prior."""
    return join(asset_dir(), _ASSET_FILES[name])
