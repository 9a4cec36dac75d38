"""PyTorch port, the offline host tools against the JAX package on the CPU:
a one-subject, 2-frame raw danaLab tree through both packages' SLP index
extractors (the npz keys, dtypes and arrays equal), OpenPose matching,
the heatmap helpers bit for bit on seeded inputs, and the port's
`tools.preprocess_datasets` against the repository's
`preprocess_datasets.py` on that tree, whose index the port's dataset then
reads."""

import functools
import json
import os
import sys

import numpy as np
import pytest

import preprocess_datasets as j_preprocess_datasets
from inbed_pose_estimation_tpu import config as j_config
from inbed_pose_estimation_tpu.data import heatmap as j_heatmap
from inbed_pose_estimation_tpu.tools.preprocess.read_openpose import read_openpose as j_read_openpose
from inbed_pose_estimation_tpu.tools.preprocess.slp import slp_multi_mod as j_slp_multi_mod
from inbed_pose_estimation_tpu.tools.preprocess.slp import slp_single_mod as j_slp_single_mod
from inbed_pose_estimation_tpu_torch.data import BaseDataset, heatmap
from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_danalab
from inbed_pose_estimation_tpu_torch.tools import preprocess_datasets
from inbed_pose_estimation_tpu_torch.tools.preprocess import read_openpose, slp_multi_mod, slp_single_mod

N_IMGS = 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    data_root = str(tmp_path_factory.mktemp("slp_raw"))
    return data_root, write_synthetic_danalab(data_root, num_imgs=N_IMGS)


def _assert_same_npz(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("extractor,kinds", [
    ("multi", ["uncover", "cover1", "cover2"]),
    ("single", ["RGB/uncover", "IR/cover1"]),
])
def test_slp_extractors_match_jax(tree, tmp_path, extractor, kinds):
    _, made = tree
    port, jax_fn = (slp_multi_mod, j_slp_multi_mod) if extractor == "multi" else (slp_single_mod, j_slp_single_mod)
    port(made["slp_root"], str(tmp_path / "port"), "index.npz", kinds, [1], imgs_per_cover=N_IMGS)
    jax_fn(made["slp_root"], str(tmp_path / "jax"), "index.npz", kinds, [1], imgs_per_cover=N_IMGS)
    _assert_same_npz(tmp_path / "port" / "index.npz", tmp_path / "jax" / "index.npz")
    data = np.load(tmp_path / "port" / "index.npz")
    assert len(data["imgname"]) == len(kinds) * N_IMGS
    assert np.abs(data["openpose"][0]).max() > 0 and np.abs(data["openpose"][1]).max() == 0


def _people(case, rng):
    if case == "missing":
        return None
    if case == "no_people":
        return []
    kps = [rng.uniform(0, 100, (25, 3)) for _ in range(3)]
    if case == "unconfident":  # no joint both confident and detected
        for kp in kps:
            kp[:, 2] = 0
    return [{"pose_keypoints_2d": kp.reshape(-1).tolist()} for kp in kps]


@pytest.mark.parametrize("case", ["missing", "no_people", "three_people", "unconfident"])
def test_read_openpose_matches_jax(tmp_path, case):
    rng = np.random.default_rng(7)
    gt = np.concatenate([rng.uniform(0, 100, (24, 2)), (rng.uniform(0, 1, (24, 1)) > 0.3)], -1)
    path = str(tmp_path / "kp.json")
    people = _people(case, rng)
    if people is not None:
        with open(path, "w") as f:
            json.dump({"people": people}, f)
    got, want = read_openpose(path, gt), j_read_openpose(path, gt)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (np.abs(got).max() > 0) == (case == "three_people")


@pytest.mark.parametrize("scale,rot,inv", [(1.3, 0.0, False), (np.array([0.8, 1.1]), 30.0, False), (2.0, -45.0, True)])
def test_affine_transform_matches_jax(scale, rot, inv):
    center = np.array([120.5, 88.25])
    t = heatmap.get_affine_transform(center, scale, rot, (64, 48), inv=inv)
    assert np.array_equal(t, j_heatmap.get_affine_transform(center, scale, rot, (64, 48), inv=inv))
    pt = [30.0, 70.0]
    assert np.array_equal(heatmap.affine_transform_point(pt, t), j_heatmap.affine_transform_point(pt, t))


@pytest.mark.parametrize("center,sigma", [((20.3, 14.6), 2.0), ((-2.0, 30.0), 3.0), ((47.6, 0.4), 1.5),
                                          ((80.0, 10.0), 2.0)])
def test_draw_gaussian_matches_jax(center, sigma):
    base = np.random.default_rng(8).uniform(0, 0.5, (32, 48)).astype(np.float32)
    got = heatmap.draw_gaussian(base.copy(), center, sigma)
    want = j_heatmap.draw_gaussian(base.copy(), center, sigma)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_preprocess_datasets_matches_the_root_script(tree, tmp_path, monkeypatch):
    """Both tools with --eval_files --train_files on subject 1's 2 poses
    (each tool's subject lists and pose count patched to them): the
    same four npz files; the port's dataset reads an item of one."""
    data_root, made = tree
    monkeypatch.setattr(j_config, "SLP_ROOT", made["slp_root"])
    monkeypatch.setattr(j_config, "DATASET_NPZ_PATH", str(tmp_path / "jax"))
    monkeypatch.setattr(j_preprocess_datasets, "TEST_SUBJECTS", [1])
    monkeypatch.setattr(j_preprocess_datasets, "TRAIN_SUBJECTS", [1])
    monkeypatch.setattr(j_preprocess_datasets, "slp_multi_mod",
                        functools.partial(j_slp_multi_mod, imgs_per_cover=N_IMGS))
    monkeypatch.setattr(sys, "argv", ["preprocess_datasets.py", "--eval_files", "--train_files"])
    j_preprocess_datasets.main()

    monkeypatch.setenv("INBED_DATA_ROOT", data_root)
    monkeypatch.setenv("INBED_NPZ_PATH", str(tmp_path / "port"))
    monkeypatch.setattr(preprocess_datasets, "TEST_SUBJECTS", [1])
    monkeypatch.setattr(preprocess_datasets, "TRAIN_SUBJECTS", [1])
    monkeypatch.setattr(preprocess_datasets, "slp_multi_mod", functools.partial(slp_multi_mod, imgs_per_cover=N_IMGS))
    written = preprocess_datasets.main(["--eval_files", "--train_files"])
    names = ["slp_4mod_uncover.npz", "slp_4mod_cover1.npz", "slp_4mod_cover2.npz", "slp_4mod_train.npz"]
    assert [os.path.basename(p) for p in written] == names
    for name in names:
        _assert_same_npz(tmp_path / "port" / name, tmp_path / "jax" / name)

    class _Opt:
        img_res = 64
        device_preprocess = False

    ds = BaseDataset(_Opt(), "slp-4mod-uncover", is_train=False)
    item = ds[0]
    assert len(ds) == N_IMGS and item["img"].shape == (3, 64, 64) and item["pose_3d"].shape == (24, 4)
    assert np.isfinite(item["depth_img"]).all()
