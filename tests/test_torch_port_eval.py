"""PyTorch port, the eval driver against the JAX package's on the CPU: the
same synthetic tree, the same weights (flax variables loaded through
`weights.load_jax_variables`), `run_evaluation` in both packages, then the
results npz, log.txt and the `eval_gpu.py` CLI.

Configuration of tests/test_e2e_eval.py: cashmrV2, RES 64, batch 2,
PRNGKey(0) init; 3 samples per split, so that the tail batch is padded."""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu import config as j_config
from inbed_pose_estimation_tpu.data.dataset import BaseDataset as JBaseDataset
from inbed_pose_estimation_tpu.data.synthetic import write_synthetic_environment as j_write_env
from inbed_pose_estimation_tpu.evaluation.evaluate import run_evaluation as j_run_evaluation
from inbed_pose_estimation_tpu.geometry.rotations import rotmat_to_aa as j_rotmat_to_aa
from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic_smpl
from inbed_pose_estimation_tpu_torch import config
from inbed_pose_estimation_tpu_torch.data import BaseDataset
from inbed_pose_estimation_tpu_torch.evaluation import run_evaluation
from inbed_pose_estimation_tpu_torch.geometry import batch_rodrigues
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.weights import load_jax_variables

RES, B = 64, 2
SPLITS = ("slp-4mod-uncover", "3dpw")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Port against JAX on the CPU.  MPJPE / PA-MPJPE / PVE: 1e-3 mm (readings:
# slp-4mod-uncover 0 and 0; 3dpw 0, 1.5e-5 and 9.9e-6; slp-4mod-uncover
# through the device crop 7.9e-5 and 9.9e-6).  K3 differs from JAX's in 0
# pixels on identical inputs (tests/test_torch_port_data.py) and the mask
# scores read a difference of 0 on these splits, with and without the device
# crop, so they are held to 1e-9.
POSE_ATOL_MM = 1e-3
MASK_ATOL = 1e-9


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    env = j_write_env(str(tmp_path_factory.mktemp("evaltree")), num_subjects=1, samples_per_subject=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INBED_DATA_ROOT", env["data_root"])
        mp.setenv("INBED_NPZ_PATH", env["npz_path"])
        mp.setenv("INBED_ASSET_DIR", os.path.join(env["data_root"], "no_assets"))
        for split in SPLITS:
            mp.setitem(j_config.DATASET_FOLDERS, split, config.dataset_folder(split))
            mp.setitem(j_config.DATASET_FILES[0], split, config.dataset_file(split))
        yield env


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, spec, variables, port model, port spec)} for the
    models the splits are scored with, at PRNGKey(0)."""
    out = {}
    for name, ch in (("cashmrV2", 6), ("hmr", 3)):
        model, spec = j_build_model(name)
        variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0),
                                                                           jnp.zeros((1, RES, RES, ch))))
        port, port_spec = build_model(name, device="cpu")
        load_jax_variables(port, variables)
        out[name] = (model, spec, variables, port, port_spec)
    return out


class _Opt:
    img_res = RES

    def __init__(self, device_preprocess=False):
        self.device_preprocess = device_preprocess


def _both(tree, models, split, device_preprocess=False, **kw):
    name = "cashmrV2" if split.startswith("slp") else "hmr"
    model, spec, variables, port, port_spec = models[name]
    common = dict(batch_size=B, img_res=RES, num_workers=1, log_freq=0, num_cas_iters=2,
                  device_preprocess=device_preprocess)
    gendered = (j_synthetic_smpl(1), j_synthetic_smpl(2))
    want = j_run_evaluation(model, spec, variables, split, JBaseDataset(_Opt(device_preprocess), split, is_train=False),
                            j_synthetic_smpl(0), smpl_gendered=gendered, **common)
    got = run_evaluation(port, port_spec, split, BaseDataset(_Opt(device_preprocess), split, is_train=False),
                         synthetic_smpl_model(0, device="cpu"),
                         smpl_gendered=(synthetic_smpl_model(1, device="cpu"), synthetic_smpl_model(2, device="cpu")),
                         device="cpu", **common, **kw)
    return got, want


def _assert_results_close(got, want, pose_atol):
    assert set(got) == set(want) | {"timing"}
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
            continue
        atol = pose_atol if k in ("mpjpe", "pa_mpjpe", "pve") else MASK_ATOL
        assert abs(got[k] - v) <= atol, (k, got[k], v)


@pytest.mark.parametrize("split", SPLITS)
def test_run_evaluation_matches_jax(tree, models, split):
    got, want = _both(tree, models, split)
    _assert_results_close(got, want, POSE_ATOL_MM)
    assert np.isfinite(got["mpjpe"]) and got["pa_mpjpe"] <= got["mpjpe"]
    if split == "3dpw":  # gendered ground-truth meshes: PVE over has_smpl rows
        assert got["pve"] is not None and got["mask_accuracy"] is None
    else:
        assert got["pve"] is None and 0 < got["mask_f1"] <= 1
    assert got["timing"]["images"] == 3 and got["timing"]["batches"] == 2


def test_run_evaluation_device_preprocess_matches_jax(tree, models):
    """The raw frames through the device crop (K5) in both packages; the two
    crops agree to 1e-5 per pixel (test_torch_port_data.py), not bitwise."""
    got, want = _both(tree, models, "slp-4mod-uncover", device_preprocess=True)
    _assert_results_close(got, want, POSE_ATOL_MM)


def test_results_npz_and_log(tree, models, tmp_path):
    """--result_file's npz: the reference schema, `pose` the axis-angle of
    `rotmat` (held against the JAX package's rotmat_to_aa), `pred_joints`
    consistent with the MPJPE; and the log.txt line (hmr: the cheapest
    model, since --result_file runs the last stage's decoder too)."""
    _, _, _, port, spec = models["hmr"]
    split = "slp-4mod-uncover"
    ds = BaseDataset(_Opt(), split, is_train=False)
    res = run_evaluation(port, spec, split, ds, synthetic_smpl_model(0, device="cpu"), result_file=str(tmp_path),
                         checkpoint_dir=str(tmp_path), epoch=3, batch_idx=5, batch_size=B, img_res=RES,
                         num_workers=1, log_freq=0, device="cpu")
    fits = np.load(tmp_path / "smpl_fits" / f"{split}_fits.npz")
    n = len(ds)
    assert {k: fits[k].shape for k in fits.files} == {
        "pred_joints": (n, 17, 3), "pose": (n, 72), "betas": (n, 10), "camera": (n, 3), "rotmat": (n, 24, 3, 3)}
    np.testing.assert_allclose(fits["pose"], np.asarray(j_rotmat_to_aa(jnp.asarray(fits["rotmat"], jnp.float32)))
                               .reshape(n, 72), atol=1e-5)
    back = batch_rodrigues(torch.from_numpy(fits["pose"].reshape(n * 24, 3)).float()).reshape(n, 24, 3, 3)
    np.testing.assert_allclose(back.numpy(), fits["rotmat"], atol=2e-5)
    gt = np.stack([ds[i]["pose_3d"] for i in range(n)])[:, [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17],
                                                           :3]
    mpjpe = 1000 * np.linalg.norm(fits["pred_joints"] - gt, axis=-1).mean()
    assert abs(mpjpe - res["mpjpe"]) < 1e-3
    log = (tmp_path / "log.txt").read_text().splitlines()
    assert log[0].endswith("\t[epoch: 3], batch_idx: 5")
    assert log[1].startswith(f"{split}\tMPJPE: {res['mpjpe']}\tReconstruction Error: {res['pa_mpjpe']}\tFB Accuracy: ")


def test_eval_gpu_asset_gate_exits_1(tree, tmp_path):
    env = dict(os.environ, INBED_ASSET_DIR=str(tmp_path / "missing"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "eval_gpu.py"), "--model", "cashmrV2",
                           "--img_res", str(RES), "--device", "cpu"],
                          capture_output=True, text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 1, proc.stderr
    assert "parity-critical assets" in proc.stderr


def test_eval_gpu_runs_on_the_cpu(tree, tmp_path, capsys):
    import eval_gpu

    results = eval_gpu.main(["--model", "hmr", "--img_res", str(RES), "--batch_size", str(B), "--device", "cpu",
                             "--allow_synthetic_assets", "--num_workers", "1", "--dataset", "slp-4mod-uncover",
                             "--result_file", str(tmp_path)])
    out = capsys.readouterr().out
    r = results["slp-4mod-uncover"]
    assert np.isfinite(r["mpjpe"]) and r["pa_mpjpe"] <= r["mpjpe"] and r["mask_f1"] is not None
    assert f"slp-4mod-uncover: MPJPE: {r['mpjpe']}" in out and "images/s" in out
    assert f"the image dumps under {tmp_path}/slp-4mod-uncover/" in out
    assert (tmp_path / "smpl_fits" / "slp-4mod-uncover_fits.npz").exists()
    # eval.py's dumps for every sample (hmr recovers no modality): the mesh
    # overlay, its side and top views and the predicted mask, readable PNGs.
    kinds = ("shape", "shape_side", "shape_top", "mask")
    names = sorted(f"{i:06d}_{k}.png" for i in range(r["timing"]["images"]) for k in kinds)
    assert sorted(os.listdir(tmp_path / "slp-4mod-uncover")) == names
    for name in names:
        img = cv2.imread(str(tmp_path / "slp-4mod-uncover" / name), cv2.IMREAD_UNCHANGED)
        assert img.shape[:2] == (RES, RES), name
    assert r["timing"]["dump_s"] > 0
    # --pretrained_fusion_checkpoint is ported (tests/test_torch_port_trainer.py
    # drives it through this CLI); so is --crop_cache: a directory without
    # the split's cache is refused with the JAX package's message and the
    # images are read from disk (tests/test_torch_port_crop_cache.py runs a
    # real cache).
    cached = eval_gpu.main(["--model", "hmr", "--img_res", str(RES), "--batch_size", str(B), "--device", "cpu",
                            "--allow_synthetic_assets", "--num_workers", "1", "--dataset", "slp-4mod-uncover",
                            "--crop_cache", str(tmp_path / "no_cache")])["slp-4mod-uncover"]
    assert "crop cache: no cache for slp-4mod-uncover (test)" in capsys.readouterr().out
    for k in ("mpjpe", "pa_mpjpe", "mask_f1"):
        assert cached[k] == r[k], k
