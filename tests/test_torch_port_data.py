"""PyTorch port, data side of the eval and train drivers, against the JAX
package on the CPU: the synthetic tree, dataset items (host crop and raw
frames; train items with their augmentation, float and uint8 feeds), crop
(rotated too) and uncrop, the uint8 feed's decode, `MixedDataset`, the
loader, the device crop (K5), the mesh rasterizer (K3), the part renderer,
checkpoints, config and the asset gate.  Images are [C, H, W] in the port
and [H, W, C] in the JAX package; they are transposed only here."""

import filecmp
import os
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu import config as j_config
from inbed_pose_estimation_tpu.data import transforms as j_tf
from inbed_pose_estimation_tpu.data.dataset import BaseDataset as JBaseDataset
from inbed_pose_estimation_tpu.data.dataset import MixedDataset as JMixedDataset
from inbed_pose_estimation_tpu.data.device_preprocess import crop_resize as j_crop_resize
from inbed_pose_estimation_tpu.data.device_preprocess import decode_uint8_batch as j_decode_uint8_batch
from inbed_pose_estimation_tpu.data.device_preprocess import make_device_preprocess as j_make_device_preprocess
from inbed_pose_estimation_tpu.data.loader import CheckpointDataLoader as JLoader
from inbed_pose_estimation_tpu.data.synthetic import write_synthetic_environment as j_write_env
from inbed_pose_estimation_tpu.ops import tri_raster as j_raster
from inbed_pose_estimation_tpu.render.part_renderer import PartRenderer as JPartRenderer
from inbed_pose_estimation_tpu_torch import config
from inbed_pose_estimation_tpu_torch.data import transforms as tf
from inbed_pose_estimation_tpu_torch.data.dataset import BaseDataset, MixedDataset
from inbed_pose_estimation_tpu_torch.data.device_preprocess import (
    crop_resize, decode_uint8_batch, make_device_preprocess,
)
from inbed_pose_estimation_tpu_torch.data.loader import CheckpointDataLoader, collate
from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_environment
from inbed_pose_estimation_tpu_torch.ops import tri_raster
from inbed_pose_estimation_tpu_torch.render import PartRenderer
from torch_threads import one_torch_thread  # noqa: F401

RES = 64
SPLITS = ("slp-4mod-uncover", "slp-4mod-cover1", "3dpw")
# Train splits: the tree's own, and a 4-row subset of it under a second
# name, so that a mixture has sources of two lengths.
TRAIN_SPLITS = ("slp-4mod-train", "slp-multi")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's synthetic tree (3 samples per subject), with both
    packages' split tables pointed at it for this module only."""
    env = j_write_env(str(tmp_path_factory.mktemp("jtree")), num_subjects=1, samples_per_subject=3)
    with np.load(os.path.join(env["npz_path"], "slp_4mod_train.npz")) as train:
        np.savez(os.path.join(env["npz_path"], "slp_multi_mod_train.npz"), **{k: train[k][:4] for k in train.files})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INBED_DATA_ROOT", env["data_root"])
        mp.setenv("INBED_NPZ_PATH", env["npz_path"])
        for split in SPLITS + TRAIN_SPLITS:
            mp.setitem(j_config.DATASET_FOLDERS, split, config.dataset_folder(split))
        for split in SPLITS:
            mp.setitem(j_config.DATASET_FILES[0], split, config.dataset_file(split))
        for split in TRAIN_SPLITS:
            mp.setitem(j_config.DATASET_FILES[1], split, config.dataset_file(split, is_train=True))
        yield env


class _Opt:
    img_res = RES

    def __init__(self, device_preprocess=False):
        self.device_preprocess = device_preprocess


def test_synthetic_environment_matches_jax(tmp_path):
    """The port's generator writes the JAX package's files and indexes."""
    ours = write_synthetic_environment(str(tmp_path / "port"), num_subjects=1, samples_per_subject=2)
    theirs = j_write_env(str(tmp_path / "jax"), num_subjects=1, samples_per_subject=2)
    for key in ("data_root", "npz_path"):
        a, b = pathlib.Path(ours[key]), pathlib.Path(theirs[key])
        files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()) and files
        for f in files:
            if f.suffix == ".npz":
                x, y = np.load(a / f), np.load(b / f)
                assert x.files == y.files
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{f}:{k}")
            else:
                assert filecmp.cmp(a / f, b / f, shallow=False), f


def _nhwc_like(port_item):
    """A port item in the JAX package's layout: channel axis back to 2."""
    out = {}
    for k, v in port_item.items():
        image = isinstance(v, np.ndarray) and v.ndim >= 3 and k not in ("pose_3d", "keypoints")
        out[k] = np.moveaxis(v, 0, 2) if image else v
    return out


@pytest.mark.parametrize("raw", [False, True], ids=["host_crop", "raw_frames"])
@pytest.mark.parametrize("split", SPLITS)
def test_dataset_items_match_jax_bitwise(tree, split, raw):
    ours = BaseDataset(_Opt(raw), split, is_train=False)
    theirs = JBaseDataset(_Opt(raw), split, is_train=False)
    assert len(ours) == len(theirs) == 3
    for i in range(len(ours)):
        a, b = _nhwc_like(ours[i]), theirs[i]
        assert set(a) == set(b)
        for k, v in b.items():
            if isinstance(v, str):
                assert a[k] == v, k
            else:
                assert np.asarray(a[k]).dtype == np.asarray(v).dtype, k
                np.testing.assert_array_equal(a[k], v, err_msg=k)
    if not raw and split.startswith("slp"):
        assert ours[0]["img"].shape == (3, RES, RES) and ours[0]["pm_contact"].shape[0] == 2


def test_dataset_rejects_what_the_trainer_slice_owns(tree, tmp_path, capsys):
    """The JAX package's dataset options are ported, in training and in
    eval: `fast_preprocess` builds the native crop; a `crop_cache` with no
    cache for the split is refused with the JAX package's message, and the
    items are those read from disk."""
    class Fast(_Opt):
        fast_preprocess = True

    class Cache(_Opt):
        crop_cache = str(tmp_path / "nowhere")

    for split, is_train in (("slp-4mod-train", True), ("slp-4mod-uncover", False)):
        assert BaseDataset(Fast(), split, is_train=is_train)._native is not None
        ours, theirs = BaseDataset(Cache(), split, is_train=is_train), JBaseDataset(Cache(), split, is_train=is_train)
        out = capsys.readouterr().out
        assert ours._cache is None and out.count("crop cache: no cache for") == 2
        assert out.splitlines()[0] == out.splitlines()[1]
        plain = BaseDataset(_Opt(), split, is_train=is_train)
        a, b = ours.__getitem__(0, rng=np.random.default_rng(1)), plain.__getitem__(0, rng=np.random.default_rng(1))
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(a[k], v, err_msg=k)


class _TrainOpt:
    img_res = RES
    noise_factor, rot_factor, scale_factor = 0.4, 15.0, 0.15

    def __init__(self, uint8_feed):
        self.uint8_feed = uint8_feed


def _draws(seed):
    """(flip, rot) that a train item draws from default_rng(seed)."""
    return JBaseDataset.augm_params(type("D", (), {"is_train": True, "use_augmentation": True,
                                                   "options": _TrainOpt(False)})(),
                                    np.random.default_rng(seed))[::2]


# Seeds whose draws are: flipped and rotated, rotated only, flipped only, neither.
AUG_SEEDS = {"flip_rot": 12, "rot": 0, "flip": 2, "none": 5}


def test_augmentation_seeds_cover_flip_and_rotation():
    for name, seed in AUG_SEEDS.items():
        flip, rot = _draws(seed)
        assert bool(flip) == ("flip" in name) and (rot != 0) == ("rot" in name), (name, flip, rot)


@pytest.mark.parametrize("uint8_feed", [False, True], ids=["float_feed", "uint8_feed"])
@pytest.mark.parametrize("aug", sorted(AUG_SEEDS))
def test_train_items_match_jax_bitwise(tree, aug, uint8_feed):
    """A train item with its augmentation drawn from the same generator in
    both packages: every key bitwise after the [C, H, W] transpose."""
    seed = AUG_SEEDS[aug]
    ours = BaseDataset(_TrainOpt(uint8_feed), "slp-4mod-train", is_train=True)
    theirs = JBaseDataset(_TrainOpt(uint8_feed), "slp-4mod-train", is_train=True)
    assert len(ours) == len(theirs) == 6
    for i in (1, 4):
        a = _nhwc_like(ours.__getitem__(i, rng=np.random.default_rng(seed)))
        b = theirs.__getitem__(i, rng=np.random.default_rng(seed))
        assert set(a) == set(b) and ("pixel_noise" in a) == uint8_feed
        assert (a["rot_angle"] != 0) == ("rot" in aug) and bool(a["is_flipped"]) == ("flip" in aug)
        for k, v in b.items():
            if isinstance(v, str):
                assert a[k] == v, k
            else:
                assert np.asarray(a[k]).dtype == np.asarray(v).dtype, k
                np.testing.assert_array_equal(a[k], v, err_msg=k)
        if uint8_feed:
            assert a["img"].dtype == np.uint8 and a["mask_uncover"].shape == (RES, RES, 1)


def test_train_item_without_augmentation_is_the_eval_crop(tree):
    """use_augmentation=False draws nothing: the item equals JAX's without a
    generator, with no flip, rotation, noise or rescale."""
    ours = BaseDataset(_TrainOpt(False), "slp-4mod-train", is_train=True, use_augmentation=False)
    theirs = JBaseDataset(_TrainOpt(False), "slp-4mod-train", is_train=True, use_augmentation=False)
    a, b = _nhwc_like(ours[2]), theirs[2]
    assert a["rot_angle"] == 0 and a["is_flipped"] == 0 and a["scale"] == np.float32(ours.scale[2])
    for k, v in b.items():
        if not isinstance(v, str):
            np.testing.assert_array_equal(a[k], v, err_msg=k)


U8_KEYS = ("img", "ir_img", "depth_img", "pm_img", "ir_img_uncover", "depth_img_uncover", "pm_img_uncover",
           "mask_uncover")


def test_decode_uint8_batch_matches_jax():
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, 256, (3, 3 if k == "img" else 1, 16, 16), dtype=np.uint8) for k in U8_KEYS}
    batch["pixel_noise"] = rng.uniform(0.6, 1.4, (3, 3)).astype(np.float32)
    batch["keypoints"] = rng.normal(0, 1, (3, 49, 3)).astype(np.float32)
    want = j_decode_uint8_batch({k: jnp.asarray(np.moveaxis(v, 1, 3) if k in U8_KEYS else v)
                                 for k, v in batch.items()})
    got = decode_uint8_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in U8_KEYS:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(np.moveaxis(got[k].numpy(), 1, 3), np.asarray(want[k]), err_msg=k)
    assert got["keypoints"] is not None and torch.equal(got["keypoints"], torch.from_numpy(batch["keypoints"]))
    floats = {"img": torch.zeros(1, 3, 4, 4)}
    assert decode_uint8_batch(floats) is floats  # the float feed passes through


def test_uint8_feed_decodes_to_the_float_feed(tree):
    """The contract of tests/test_data.py::test_uint8_feed_bit_identical_to_host_path
    for the port: the uint8 item decoded on the device equals the float
    item to one float32 ulp (the host multiplies the noise in float64), and
    every other key is equal."""
    seed = AUG_SEEDS["flip_rot"]
    a = BaseDataset(_TrainOpt(False), "slp-4mod-train", is_train=True).__getitem__(0, rng=np.random.default_rng(seed))
    b = BaseDataset(_TrainOpt(True), "slp-4mod-train", is_train=True).__getitem__(0, rng=np.random.default_rng(seed))
    decoded = decode_uint8_batch({k: torch.from_numpy(np.asarray(v))[None] for k, v in b.items()
                                  if k in U8_KEYS or k == "pixel_noise"})
    for k in U8_KEYS:
        assert b[k].dtype == np.uint8, k
        np.testing.assert_allclose(decoded[k][0].numpy(), a[k], rtol=3e-7, atol=1e-6, err_msg=k)
    for k in set(a) - set(U8_KEYS):
        if not isinstance(a[k], str):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mixed_dataset_matches_jax(tree):
    """Partition, length, fits layout and global sample indices of a
    two-source mixture, and its items (augmentation off) bitwise."""
    class Opt(_TrainOpt):
        data_train = "slp-4mod-train:0.3+slp-multi:0.7"

    ours = MixedDataset(Opt(False), is_train=True, use_augmentation=False)
    theirs = JMixedDataset(Opt(False), is_train=True, use_augmentation=False)
    assert ours.partition == theirs.partition == [("slp-4mod-train", 0.3), ("slp-multi", 0.7)]
    assert len(ours) == len(theirs) == 6
    assert ours.fits_layout == theirs.fits_layout == [("slp-4mod-train", 6), ("slp-multi", 4)]
    np.testing.assert_array_equal(ours.fits_offsets, theirs.fits_offsets)
    indices = []
    for i in range(len(ours)):
        a, b = _nhwc_like(ours[i]), theirs[i]
        indices.append(a["sample_index"])
        assert a["sample_index"] == b["sample_index"] and a["dataset_name"] == b["dataset_name"]
        np.testing.assert_array_equal(a["img"], b["img"])
    assert indices == [0, 1, 8, 9, 6, 7]  # index / 6 < 0.3: source 0; else source 1 from row 6, index % 4
    single = MixedDataset(_TrainOpt(False), is_train=True)
    assert single.partition == [("slp-4mod-train", 1.0)] and single.fits_layout == [("slp-4mod-train", 6)]


# (image shape, center, scale, res): inside, crossing the top-left edge,
# crossing the bottom-right edge, larger than the frame.
CROPS = [((120, 160), (80, 60), 0.4, (64, 64)), ((120, 160, 3), (10, 5), 0.5, (64, 64)),
         ((120, 160), (150, 110), 0.35, (32, 48)), ((120, 160, 3), (80, 60), 0.96, (64, 64))]


@pytest.mark.parametrize("shape,center,scale,res", CROPS)
def test_crop_and_uncrop_match_jax_bitwise(shape, center, scale, res):
    img = np.random.default_rng(len(shape)).uniform(0, 255, shape).astype(np.float32)
    got = tf.crop(img, center, scale, res)
    np.testing.assert_array_equal(got, j_tf.crop(img, center, scale, res))
    mask = (np.random.default_rng(1).uniform(size=res) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(tf.uncrop(mask, center, scale, shape[:2]),
                                  j_tf.uncrop(mask, center, scale, shape[:2]))


# Rotated crops: a box crossing the top-left edge of the frame and one
# crossing the bottom-right edge; the frame RGB or gray, uint8 or float.
ROT_BOXES = {"top_left": ((10, 5), 0.5, (64, 64)), "bottom_right": ((150, 110), 0.35, (32, 48))}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
@pytest.mark.parametrize("box", sorted(ROT_BOXES))
@pytest.mark.parametrize("rot", [-30.0, -7.5, 12.0, 30.0])
def test_rotated_crop_matches_jax_bitwise(rot, box, channels, dtype):
    shape = (120, 160, 3) if channels == 3 else (120, 160)
    img = np.random.default_rng(channels).uniform(0, 255, shape).astype(dtype)
    center, scale, res = ROT_BOXES[box]
    got = tf.crop(img, center, scale, res, rot=rot)
    assert got.dtype == np.uint8 and got.shape[:2] == res
    np.testing.assert_array_equal(got, j_tf.crop(img, center, scale, res, rot=rot))
    np.testing.assert_array_equal(tf._imrotate_uint8(img, rot), j_tf._imrotate_uint8(img, rot))
    assert not np.array_equal(got, tf.crop(img, center, scale, res))


def test_loader_matches_jax():
    """Permutation, batches, tail and the resume offset."""
    data = [{"x": np.full(2, i, np.float32), "name": f"s{i}"} for i in range(7)]
    for kw in ({"shuffle": True, "seed": 3}, {"shuffle": False, "drop_last": False},
               {"shuffle": True, "seed": 3, "checkpoint": {"dataset_perm": np.arange(7)[::-1], "batch_idx": 1}}):
        ours = CheckpointDataLoader(data, batch_size=3, num_workers=2, **kw)
        theirs = JLoader(data, batch_size=3, num_workers=2, **kw)
        np.testing.assert_array_equal(ours.dataset_perm, theirs.dataset_perm)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours) - (1 if "checkpoint" in kw else 0)
        for (ga, ba), (gb, bb) in zip(got, want):
            assert ga == gb and ba["name"] == bb["name"]
            np.testing.assert_array_equal(ba["x"], bb["x"])
    assert collate(data[:2])["x"].shape == (2, 2)


def test_loader_left_early_stops_its_producer():
    """An iterator closed after its first batch stops the producer: no
    sample is read after close() returns."""
    import time

    reads = []

    class Slow:
        def __len__(self):
            return 40

        def __getitem__(self, i):
            time.sleep(0.01)
            reads.append(i)
            return {"x": np.zeros(1)}

    it = iter(CheckpointDataLoader(Slow(), batch_size=4, num_workers=2, shuffle=False))
    assert next(it)[0] == 0
    it.close()
    n = len(reads)
    time.sleep(0.2)
    assert len(reads) == n < 40


# Boxes for the device crop on a 120 x 160 frame: inside, and crossing the
# top-left edge (ul truncates toward zero, not down).
K5_BOXES = {"inside": ([80.0, 60.0], 0.5), "top_left": ([15.0, 8.0], 0.45), "shrink": ([80.0, 60.0], 0.9)}


@pytest.mark.parametrize("box", sorted(K5_BOXES))
def test_crop_resize_matches_jax_scale_and_translate(box):
    center, scale = K5_BOXES[box]
    img = np.random.default_rng(0).uniform(0, 1, (120, 160, 3)).astype(np.float32)
    want = np.asarray(j_crop_resize(jnp.asarray(img), jnp.asarray(center), jnp.float32(scale), RES))
    got = crop_resize(torch.from_numpy(img).permute(2, 0, 1)[None], torch.tensor([center]),
                      torch.tensor([scale]), RES)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_device_preprocess_matches_jax():
    """The whole batch preprocess (uint8 frames, flip, noise, normalize);
    compared before the division by each modality's std."""
    rng = np.random.default_rng(1)
    raw = {"img": rng.integers(0, 256, (3, 120, 160, 3), dtype=np.uint8),
           "pm_img": rng.integers(0, 256, (3, 120, 160, 1), dtype=np.uint8)}
    center = np.array([[80, 60], [15, 8], [150, 100]], np.float32)
    scale, flip = np.array([0.5, 0.45, 0.6], np.float32), np.array([0, 1, 0], np.float32)
    noise = rng.uniform(0.6, 1.4, (3, 3)).astype(np.float32)
    want = j_make_device_preprocess(res=RES)({k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(center),
                                             jnp.asarray(scale), jnp.asarray(flip), jnp.asarray(noise))
    got = make_device_preprocess(res=RES, device="cpu")({k: np.moveaxis(v, 3, 1) for k, v in raw.items()},
                                                         center, scale, flip, noise)
    for key, std in (("img", 0.226), ("pm_img", 0.0253)):
        diff = np.abs(np.moveaxis(got[key].numpy(), 1, 3) - np.asarray(want[key])) * std
        assert diff.max() <= 1e-5, (key, diff.max())


def _mesh_uvz(seed, res=RES, n=12):
    """A folded grid mesh projected over the canvas: vertices [n*n, 3] (some
    off the canvas, some behind the camera) and 2 (n-1)^2 faces."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.linspace(-0.2, 1.1, n), np.linspace(-0.1, 1.05, n)), -1).reshape(-1, 2) * res
    uv = g + rng.normal(0, 1.5, g.shape)
    z = rng.uniform(2, 9, (n * n, 1))
    z[rng.choice(n * n, 5, replace=False)] = -1.0
    idx = np.arange(n * n).reshape(n, n)
    quads = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]], -1).reshape(-1, 4)
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [1, 3, 2]]])
    labels = rng.integers(1, 7, n * n).astype(np.int32)
    return np.concatenate([uv, z], 1).astype(np.float32), faces.astype(np.int32), labels


@pytest.mark.parametrize("with_labels", [False, True], ids=["mask", "mask_and_parts"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_sample_matches_jax(seed, with_labels):
    """K3 on identical inputs: the number of pixels that differ from the
    JAX package's raster (0 on the CPU: both take the same float sign
    tests), and the parts where labels are given."""
    uvz, faces, labels = _mesh_uvz(seed)
    lab = labels if with_labels else None
    jm, jp = j_raster.rasterize_sample(jnp.asarray(uvz), jnp.asarray(faces), RES,
                                       labels=None if lab is None else jnp.asarray(lab), tile=12)
    tm, tp = tri_raster.rasterize_sample(torch.from_numpy(uvz), torch.from_numpy(faces).long(), RES,
                                         labels=None if lab is None else torch.from_numpy(lab), tile=12)
    assert 0 < np.asarray(jm).sum() < RES * RES
    assert int((tm.numpy() != np.asarray(jm)).sum()) == 0
    assert int((tp.numpy() != np.asarray(jp)).sum()) == 0
    if with_labels:
        assert len(np.unique(tp.numpy())) > 3


def test_rasterize_batch_and_face_extent_match_jax():
    uvz = np.stack([_mesh_uvz(s)[0] for s in (2, 3, 4)])
    faces = _mesh_uvz(2)[1]
    jm, _ = j_raster.rasterize_mesh_batch(jnp.asarray(uvz), faces, RES, tile=16)
    tm, tp = tri_raster.rasterize_mesh_batch(torch.from_numpy(uvz), torch.from_numpy(faces), RES, tile=16)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tp.shape == (3, RES, RES) and not tp.any()
    np.testing.assert_allclose(float(tri_raster.projected_face_extent(torch.from_numpy(uvz),
                                                                      torch.from_numpy(faces).long())),
                               float(j_raster.projected_face_extent(jnp.asarray(uvz), jnp.asarray(faces))),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["triangles", "point_splat"])
@pytest.mark.parametrize("render_labels", [False, True])
def test_part_renderer_matches_jax(mode, render_labels):
    """Both branches of PartRenderer on the same mesh and camera."""
    from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_arrays

    a = synthetic_smpl_arrays(0, num_vertices=500)
    rng = np.random.default_rng(5)
    verts = (a["v_template"][None] * 0.8 + rng.normal(0, 0.01, (2, 500, 3))).astype(np.float32)
    cam = np.array([[0.8, 0.05, -0.1], [0.6, -0.1, 0.2]], np.float32)
    faces = _mesh_uvz(0, n=20)[1] % 500 if mode == "triangles" else None
    kw = dict(render_res=RES, num_vertices=500, template=a["v_template"], faces=faces, render_labels=render_labels)
    jm, jp = JPartRenderer(**kw)(verts, cam)
    tm, tp = PartRenderer(**kw, device="cpu")(torch.from_numpy(verts), torch.from_numpy(cam))
    assert np.asarray(jm).sum() > 20
    assert int((tm.numpy() != np.asarray(jm)).sum()) == 0
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_load_checkpoint_reads_jax_native_npz(tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint loads into
    the port with the same weights as load_jax_variables, and its metadata."""
    from inbed_pose_estimation_tpu.models import build_model as j_build_model
    from inbed_pose_estimation_tpu.train.checkpoint import save_checkpoint
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.train import load_checkpoint
    from inbed_pose_estimation_tpu_torch.weights import load_jax_variables

    model, _ = j_build_model("hmr")
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(1),
                                                                       jnp.zeros((1, RES, RES, 3))))
    path = save_checkpoint(str(tmp_path), variables, opt_state_flat={"leaf_00000": np.zeros(3)},
                           metadata={"dataset_perm": np.arange(5), "batch_size": 4}, epoch=2, batch_idx=7)
    assert os.path.basename(path) == "epoch_2_7.npz"
    port, _ = build_model("hmr", device="cpu")
    meta = load_checkpoint(path, port)
    assert meta["epoch"] == 2 and meta["batch_idx"] == 7 and meta["dataset_perm"] == list(range(5))
    want, _ = build_model("hmr", device="cpu")
    load_jax_variables(want, variables)
    for k, v in want.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_load_torch_checkpoint_strips_module_prefix(tmp_path):
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.train import load_torch_checkpoint

    torch.manual_seed(3)
    src, _ = build_model("hmr", device="cpu")
    state = {"module." + k: v for k, v in src.state_dict().items()}
    torch.save({"model": state, "epoch": 4, "batch_idx": 9, "dataset_perm": torch.arange(6)}, tmp_path / "a.pt")
    dst, _ = build_model("hmr", device="cpu")
    meta = load_torch_checkpoint(str(tmp_path / "a.pt"), dst)
    assert meta["epoch"] == 4 and meta["batch_idx"] == 9 and list(meta["dataset_perm"]) == list(range(6))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    del state["module.fc1.weight"]
    torch.save(state, tmp_path / "b.pt")  # a bare state dict, one key short: strict loading raises
    with pytest.raises(RuntimeError, match="fc1.weight"):
        load_torch_checkpoint(str(tmp_path / "b.pt"), dst)


def test_config_reads_the_environment_when_called(monkeypatch):
    monkeypatch.setenv("INBED_NPZ_PATH", "/a")
    monkeypatch.setenv("INBED_DATA_ROOT", "/b")
    monkeypatch.setenv("INBED_ASSET_DIR", "/c")
    assert config.dataset_file("slp-4mod-uncover") == "/a/slp_4mod_uncover.npz"
    assert config.dataset_file("slp-4mod-train", is_train=True) == "/a/slp_4mod_train.npz"
    assert config.dataset_folder("slp-4mod-cover1") == "/b/SLP/SLP/danaLab"
    assert config.dataset_folder("3dpw") == "/b/3DPW"
    assert config.asset("j_regressor_h36m") == "/c/J_regressor_h36m.npy"
    monkeypatch.setenv("INBED_ASSET_DIR", "/d")
    assert config.asset("smpl_model_dir") == "/d/smpl"


def test_j_regressor_defaults_to_the_asset_directory(tmp_path, monkeypatch):
    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m

    monkeypatch.setenv("INBED_ASSET_DIR", str(tmp_path))
    synthetic = load_j_regressor_h36m(num_vertices=50)
    real = np.random.default_rng(0).uniform(size=(17, 50)).astype(np.float32)
    np.save(tmp_path / "J_regressor_h36m.npy", real)
    np.testing.assert_array_equal(load_j_regressor_h36m(num_vertices=50), real)
    assert not np.array_equal(synthetic, real)


def test_asset_gate(tmp_path, capsys):
    from inbed_pose_estimation_tpu_torch.utils.assets_check import check_assets

    paths = dict(smpl_model_dir=str(tmp_path), smpl_mean_params=str(tmp_path / "m.npz"),
                 j_regressor_h36m=str(tmp_path / "j.npy"))
    with pytest.raises(SystemExit, match="smpl_model, smpl_mean_params, j_regressor_h36m"):
        check_assets(**paths)
    np.save(tmp_path / "j.npy", np.zeros(1))
    status = check_assets(allow_synthetic=True, **paths)
    assert status == {"smpl_model": False, "smpl_mean_params": False, "j_regressor_h36m": True}
    assert "SYNTHETIC stand-ins for: smpl_model, smpl_mean_params" in capsys.readouterr().out
