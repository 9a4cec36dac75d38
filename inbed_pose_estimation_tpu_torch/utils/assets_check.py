"""Parity-critical asset validation for the CLIs.

The library keeps deterministic synthetic stand-ins for every asset (SMPL
pickle, mean parameters, J_regressor_h36m, the GMM prior) so that tests run
without them, but a production run with a missing or mistyped asset
directory must not print confident, meaningless metrics.  The CLIs call
`check_assets` first and fail with the full missing list unless
`--allow_synthetic_assets` is passed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


def _smpl_ok(model_dir: Optional[str]) -> bool:
    if not model_dir:
        return False
    try:
        from ..smpl.assets import load_smpl_model

        load_smpl_model(model_dir, "neutral", device="cpu")
        return True
    except (FileNotFoundError, OSError, KeyError, ValueError):
        return False


def asset_status(
    smpl_model_dir: Optional[str],
    smpl_mean_params: Optional[str] = None,
    j_regressor_h36m: Optional[str] = None,
    gmm_prior_file: Optional[str] = None,
) -> Dict[str, bool]:
    """Which parity-critical assets load (True) and which would fall back to
    a synthetic stand-in (False).  Pass None to skip a check."""
    status = {"smpl_model": _smpl_ok(smpl_model_dir)}
    for name, path in (
        ("smpl_mean_params", smpl_mean_params),
        ("j_regressor_h36m", j_regressor_h36m),
        ("gmm_prior", gmm_prior_file),
    ):
        if path is not None:
            status[name] = bool(path) and os.path.exists(path)
    return status


def check_assets(allow_synthetic: bool = False, **paths) -> Dict[str, bool]:
    """Validate assets; raise SystemExit with the full missing list unless
    everything loads or the caller opted into synthetic stand-ins."""
    status = asset_status(**paths)
    missing: List[str] = [k for k, ok in status.items() if not ok]
    if missing and not allow_synthetic:
        raise SystemExit(
            f"Missing/unloadable parity-critical assets: {', '.join(missing)}. "
            "Metrics computed on synthetic stand-ins are meaningless — fix "
            "the asset paths (INBED_* env vars) or pass "
            "--allow_synthetic_assets to run with synthetic assets anyway."
        )
    if missing:
        print(
            f"WARNING: running with SYNTHETIC stand-ins for: {', '.join(missing)} "
            "(--allow_synthetic_assets). Metrics are NOT comparable to the reference."
        )
    return status
