"""PyTorch port, the crop cache and the native host crop against the JAX
package on the CPU: the two packages' build tools write the same cache,
each package reads the other's, items through the cache are bitwise items
from disk (train with the float and uint8 feeds over flips and rotations,
with patches cut from inside the frames too, and eval) in the port and
against JAX, the refusals print the JAX
package's messages and read from disk; `preprocess_batch` is bitwise the
JAX package's build, items under `fast_preprocess` equal JAX's, and the
port raises where the library cannot be built.  RES 64."""

import os
import pathlib

import numpy as np
import pytest

from inbed_pose_estimation_tpu import config as j_config
from inbed_pose_estimation_tpu.data.crop_cache import CropCache as JCropCache
from inbed_pose_estimation_tpu.data.dataset import BaseDataset as JBaseDataset
from inbed_pose_estimation_tpu.data.synthetic import write_synthetic_environment as j_write_env
from inbed_pose_estimation_tpu.ops import native as j_native
from inbed_pose_estimation_tpu.tools.build_crop_cache import main as j_build_tool
from inbed_pose_estimation_tpu_torch import config
from inbed_pose_estimation_tpu_torch.data import crop_cache as cc
from inbed_pose_estimation_tpu_torch.data.dataset import BaseDataset
from inbed_pose_estimation_tpu_torch.ops import native
from inbed_pose_estimation_tpu_torch.tools.build_crop_cache import main as build_tool
from torch_threads import one_torch_thread  # noqa: F401

RES = 64
TRAIN, EVAL = "slp-4mod-train", "slp-4mod-cover1"
# The train split again with boxes a third of the size, so that the cache's
# patches are smaller than the frames and the margin decides what a crop
# can read (the synthetic boxes are 1.2x the frame).
SMALL = "slp-multi"
# Augmentation draws (default_rng seeds, as tests/test_torch_port_data.py
# picks them): flipped and rotated, rotated only, flipped only, neither.
AUG_SEEDS = (12, 0, 2, 5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's synthetic tree with SMALL's index beside it, both
    packages' split tables pointed at it, and each package's cache of the
    three splits built from it."""
    base = tmp_path_factory.mktemp("cctree")
    env = j_write_env(str(base / "tree"), num_subjects=1, samples_per_subject=3)
    with np.load(os.path.join(env["npz_path"], "slp_4mod_train.npz")) as train:
        small = {k: train[k] for k in train.files}
    small["scale"] = small["scale"] / 3
    np.savez(os.path.join(env["npz_path"], "slp_multi_mod_train.npz"), **small)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INBED_DATA_ROOT", env["data_root"])
        mp.setenv("INBED_NPZ_PATH", env["npz_path"])
        mp.setitem(j_config.DATASET_FOLDERS, TRAIN, config.dataset_folder(TRAIN))
        mp.setitem(j_config.DATASET_FOLDERS, EVAL, config.dataset_folder(EVAL))
        mp.setitem(j_config.DATASET_FILES[1], TRAIN, config.dataset_file(TRAIN, is_train=True))
        mp.setitem(j_config.DATASET_FOLDERS, SMALL, config.dataset_folder(SMALL))
        mp.setitem(j_config.DATASET_FILES[1], SMALL, config.dataset_file(SMALL, is_train=True))
        mp.setitem(j_config.DATASET_FILES[0], EVAL, config.dataset_file(EVAL))
        caches = {"port": str(base / "port_cache"), "jax": str(base / "jax_cache")}
        for tool, out in ((build_tool, caches["port"]), (j_build_tool, caches["jax"])):
            for split, extra in ((TRAIN, []), (EVAL, ["--eval"]), (SMALL, [])):
                tool(["--dataset", split, "--out", out, "--img_res", str(RES)] + extra)
        yield caches


class _Opt:
    img_res = RES
    noise_factor, rot_factor, scale_factor = 0.4, 15.0, 0.15

    def __init__(self, crop_cache=None, uint8_feed=False, fast_preprocess=False):
        self.crop_cache, self.uint8_feed, self.fast_preprocess = crop_cache, uint8_feed, fast_preprocess


def _nhwc(item):
    return {k: np.moveaxis(v, 0, 2) if isinstance(v, np.ndarray) and v.ndim >= 3 and k not in ("pose_3d", "keypoints")
            else v for k, v in item.items()}


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k, v in b.items():
        if isinstance(v, np.ndarray):
            assert a[k].dtype == v.dtype, k
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            assert a[k] == v, k


@pytest.mark.parametrize("split", [TRAIN, EVAL, SMALL])
def test_tools_write_the_same_cache(tree, split):
    """The same patch bytes and the same index arrays and metadata (the npz
    containers differ only in their zip timestamps)."""
    suffix = "test" if split == EVAL else "train"
    port, jax_ = (pathlib.Path(tree[k]) / f"{split}_{suffix}" for k in ("port", "jax"))
    assert port.with_suffix(".bin").read_bytes() == jax_.with_suffix(".bin").read_bytes()
    with np.load(f"{port}.idx.npz") as a, np.load(f"{jax_}.idx.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert os.path.getsize(port.with_suffix(".bin")) > 0


@pytest.mark.parametrize("split", [TRAIN, EVAL])
def test_each_package_reads_the_others_cache(tree, split):
    is_train = split == TRAIN
    ours = BaseDataset(_Opt(tree["jax"]), split, is_train=is_train)
    theirs = JBaseDataset(_Opt(tree["port"]), split, is_train=is_train)
    assert ours._cache is not None and theirs._cache is not None
    port_cache, jax_cache = cc.CropCache(tree["port"], split, is_train), JCropCache(tree["port"], split, is_train)
    for m in cc.MODALITIES:
        np.testing.assert_array_equal(port_cache.full(1, m), jax_cache.full(1, m), err_msg=m)
    np.testing.assert_array_equal(port_cache.orig_shape(0), jax_cache.orig_shape(0))


@pytest.mark.parametrize("seed", AUG_SEEDS)
@pytest.mark.parametrize("feed", ["float", "uint8"])
def test_train_items_through_the_cache_are_bitwise(tree, feed, seed):
    """Train items, augmentation drawn from the same generator: through the
    cache, from disk, and the JAX package's through its cache."""
    u8 = feed == "uint8"
    cached = BaseDataset(_Opt(tree["port"], uint8_feed=u8), TRAIN, is_train=True)
    disk = BaseDataset(_Opt(uint8_feed=u8), TRAIN, is_train=True)
    theirs = JBaseDataset(_Opt(tree["jax"], uint8_feed=u8), TRAIN, is_train=True)
    assert cached._cache is not None and theirs._cache is not None and len(cached) == 6
    for i in range(len(cached)):
        a = cached.__getitem__(i, rng=np.random.default_rng(seed))
        _assert_items_equal(a, disk.__getitem__(i, rng=np.random.default_rng(seed)))
        _assert_items_equal(_nhwc(a), theirs.__getitem__(i, rng=np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", AUG_SEEDS)
def test_patches_smaller_than_the_frames_cover_every_crop(tree, seed):
    """SMALL's patches are cut from inside the frames: the margin (the
    widest scale draw, and the box's diagonal for a rotation) must hold
    every pixel the augmented crop reads, bitwise against disk and JAX."""
    cached = BaseDataset(_Opt(tree["port"]), SMALL, is_train=True)
    disk = BaseDataset(_Opt(), SMALL, is_train=True)
    theirs = JBaseDataset(_Opt(tree["jax"]), SMALL, is_train=True)
    patch, frame = cached._cache.shapes[..., :2], cached._cache.orig_shapes
    assert (patch < frame).any(axis=-1).all()  # every patch is cut from its frame
    for i in range(len(cached)):
        a = cached.__getitem__(i, rng=np.random.default_rng(seed))
        _assert_items_equal(a, disk.__getitem__(i, rng=np.random.default_rng(seed)))
        _assert_items_equal(_nhwc(a), theirs.__getitem__(i, rng=np.random.default_rng(seed)))


def test_eval_items_through_the_cache_are_bitwise(tree):
    cached = BaseDataset(_Opt(tree["port"]), EVAL, is_train=False)
    disk = BaseDataset(_Opt(), EVAL, is_train=False)
    theirs = JBaseDataset(_Opt(tree["jax"]), EVAL, is_train=False)
    assert cached._cache is not None and len(cached) == 3
    for i in range(len(cached)):
        _assert_items_equal(cached[i], disk[i])
        _assert_items_equal(_nhwc(cached[i]), theirs[i])


def _refusal(tree, tmp_path, how):
    """A copy of the port's train cache made unusable in one way; returns
    its directory and the options that read it."""
    src, dst = pathlib.Path(tree["port"]), tmp_path / how
    dst.mkdir()
    opt = _Opt(str(dst))
    if how == "missing":
        return opt
    for f in src.glob(f"{TRAIN}_train.*"):
        (dst / f.name).write_bytes(f.read_bytes())
    idx = dst / f"{TRAIN}_train.idx.npz"
    if how == "unreadable":
        idx.write_bytes(b"not an npz")
    elif how in ("stale_length", "stale_index"):
        with np.load(idx) as data:
            arrays = {k: data[k] for k in data.files}
        if how == "stale_length":
            arrays["meta"] = np.bytes_(bytes(arrays["meta"]).replace(b'"num_samples": 6', b'"num_samples": 5'))
        else:
            arrays["meta"] = np.bytes_(bytes(arrays["meta"]).replace(b'"index_fingerprint": "',
                                                                     b'"index_fingerprint": "0'))
        np.savez(idx, **arrays)
    elif how == "narrow":
        opt.scale_factor = 0.25  # wider than the cache's margin of 1.15
    return opt


@pytest.mark.parametrize("how", ["missing", "unreadable", "stale_length", "stale_index", "narrow"])
def test_refused_caches_print_jax_messages_and_read_from_disk(tree, tmp_path, capsys, how):
    opt = _refusal(tree, tmp_path, how)
    ours = BaseDataset(opt, TRAIN, is_train=True)
    said = capsys.readouterr().out
    theirs = JBaseDataset(opt, TRAIN, is_train=True)
    assert ours._cache is None and theirs._cache is None
    assert said.startswith("crop cache: ") and said == capsys.readouterr().out
    disk = BaseDataset(_Opt(), TRAIN, is_train=True)
    disk.options.scale_factor = opt.scale_factor
    _assert_items_equal(ours.__getitem__(2, rng=np.random.default_rng(0)),
                        disk.__getitem__(2, rng=np.random.default_rng(0)))


def test_raw_frames_ignore_the_cache(tree):
    """--device_preprocess's raw frames do not go through the cache, as in
    the JAX package."""
    opt = _Opt(tree["port"])
    opt.device_preprocess = True
    assert BaseDataset(opt, EVAL, is_train=False)._cache is None


def test_preprocess_batch_is_the_jax_build_bitwise():
    """Colour and single-channel batches with flips, rotations, channel
    noise and a normalization, and one thread against several."""
    rng = np.random.default_rng(0)
    for channels in (3, 1):
        images = rng.integers(0, 256, (5, 300, 200, channels), dtype=np.uint8)
        args = (images, rng.uniform(40, 160, (5, 2)), rng.uniform(0.4, 1.3, 5), np.array([0, 1, 0, 1, 1.0]),
                rng.uniform(0.6, 1.4, (5, 3)), RES, rng.uniform(0, 0.5, channels), rng.uniform(0.2, 1, channels))
        rots = np.array([0.0, 12.0, -25.0, 30.0, 0.0])
        got = native.preprocess_batch(*args, rots=rots, num_threads=3)
        want = j_native.preprocess_batch(*args, rots=rots, num_threads=3)
        assert got.shape == (5, RES, RES, channels) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(native.preprocess_batch(*args, rots=rots, num_threads=1), got)
        assert np.abs(got).max() > 0.1
    with pytest.raises(ValueError, match="mean and std"):
        native.preprocess_batch(images, *args[1:6], np.zeros(3), np.ones(3))


@pytest.mark.parametrize("seed", [12, 5])
@pytest.mark.parametrize("feed", ["float", "uint8"])
def test_fast_preprocess_items_match_jax(tree, feed, seed):
    """BaseDataset(fast_preprocess=True) against the JAX package's, through
    the cache and from disk: every key bitwise."""
    assert j_native.available()
    u8 = feed == "uint8"
    ours = BaseDataset(_Opt(tree["port"], uint8_feed=u8, fast_preprocess=True), TRAIN, is_train=True)
    disk = BaseDataset(_Opt(uint8_feed=u8, fast_preprocess=True), TRAIN, is_train=True)
    theirs = JBaseDataset(_Opt(uint8_feed=u8, fast_preprocess=True), TRAIN, is_train=True)
    plain = BaseDataset(_Opt(uint8_feed=u8), TRAIN, is_train=True)
    for i in (0, 3):
        a = ours.__getitem__(i, rng=np.random.default_rng(seed))
        _assert_items_equal(_nhwc(a), theirs.__getitem__(i, rng=np.random.default_rng(seed)))
        _assert_items_equal(a, disk.__getitem__(i, rng=np.random.default_rng(seed)))
        # Not the Pillow crop: the native kernel resamples otherwise.
        assert not np.array_equal(a["pm_img"], plain.__getitem__(i, rng=np.random.default_rng(seed))["pm_img"])


def test_fast_preprocess_raises_without_a_compiler(tree, tmp_path, monkeypatch):
    """No g++: the dataset raises where the JAX package falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        BaseDataset(_Opt(fast_preprocess=True), TRAIN, is_train=True)
    assert not (tmp_path / "build").exists()
