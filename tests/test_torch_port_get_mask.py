"""PyTorch port, the body-mask tool `tools/get_mask.py` against the
repository's root script `get_mask.py` on the CPU: one raw danaLab tree
(`write_synthetic_danalab`, 3 frames of 1024 x 1024, its masks removed),
with one unreadable `RGB/uncover` file and a subject range that names a
subject without a directory, goes through the root script in a
subprocess and through the port's `main` on a copy; the masks are byte
for byte equal under the same names.  Also: the fallback is chosen when
torchvision cannot be imported (and deeplab when it can), and the default
root is the JAX package's `config.SLP_ROOT` for the same INBED_DATA_ROOT."""

import importlib.util
import os
import shutil
import subprocess
import sys
import types
from os.path import join

import numpy as np
import pytest

from inbed_pose_estimation_tpu_torch.data.image_io import read_gray_u8, read_rgb_u8
from inbed_pose_estimation_tpu_torch.data.synthetic import write_synthetic_danalab
from inbed_pose_estimation_tpu_torch.tools import get_mask
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_IMGS = 3
# The root script with torchvision made unimportable, as it is on both
# machines, so that it takes the fallback wherever the test runs.
ROOT_SCRIPT = ("import runpy, sys; sys.modules['torchvision'] = None; sys.argv = ['get_mask.py'] + sys.argv[1:]; "
               "runpy.run_path('get_mask.py', run_name='__main__')")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two copies of one danaLab tree without masks, an unreadable frame in
    RGB/uncover; the root script has run on the first with --subjects 1-2
    (its stdout beside it)."""
    base = tmp_path_factory.mktemp("get_mask")
    slp = write_synthetic_danalab(str(base / "raw"), num_imgs=NUM_IMGS)["slp_root"]
    shutil.rmtree(join(slp, "00001", "masks"))
    with open(join(slp, "00001", "RGB", "uncover", "image_000099.png"), "wb") as f:
        f.write(b"not a png")
    roots = {"root_script": str(base / "root_script"), "port": str(base / "port")}
    for r in roots.values():
        shutil.copytree(slp, r)
    out = subprocess.run([sys.executable, "-c", ROOT_SCRIPT, "--slp_root", roots["root_script"], "--subjects", "1-2"],
                         cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return roots, out


def _masks(root):
    d = join(root, "00001", "masks", "uncover")
    return {fn: open(join(d, fn), "rb").read() for fn in sorted(os.listdir(d))}


def test_masks_are_the_root_scripts_byte_for_byte(trees, capsys, monkeypatch):
    roots, root_out = trees
    monkeypatch.setitem(sys.modules, "torchvision", None)
    written = get_mask.main(["--slp_root", roots["port"], "--subjects", "1-2"])
    want, got = _masks(roots["root_script"]), _masks(roots["port"])
    assert sorted(want) == sorted(got) == [f"{i:06d}.png" for i in range(1, NUM_IMGS + 1)]
    assert all(got[fn] == want[fn] for fn in want)
    assert written == [join(roots["port"], "00001", "masks", "uncover", fn) for fn in sorted(got)]
    # The same printed lines, but for the root each names.
    assert capsys.readouterr().out.replace(roots["port"], "ROOT") == root_out.replace(roots["root_script"], "ROOT")
    for fn in got:
        mask = read_gray_u8(join(roots["port"], "00001", "masks", "uncover", fn))
        frame = read_rgb_u8(join(roots["port"], "00001", "RGB", "uncover", "image_" + fn))
        assert mask.shape == frame.shape[:2] and set(np.unique(mask)) <= {0, 255}
        assert np.array_equal(mask, get_mask.fallback_mask(frame))
        assert 0 < (mask == 255).mean() < 1  # the threshold splits the frame


def test_fallback_is_chosen_without_torchvision(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torchvision", None)  # import raises ImportError
    assert get_mask.main(["--slp_root", str(tmp_path), "--subjects", "1-1"]) == []
    assert capsys.readouterr().out == "torchvision unavailable: using background-difference fallback\n"


def test_deeplab_is_chosen_with_torchvision(trees, tmp_path, monkeypatch, capsys):
    """With torchvision importable the deeplab segmenter is built once, on
    --device, and used for every frame (a stand-in here: torchvision is
    not installed)."""
    built, seen = [], []

    def segmenter(device):
        built.append(device)
        return lambda img: (seen.append(img.shape), np.zeros(img.shape[:2], np.uint8))[1]

    monkeypatch.setitem(sys.modules, "torchvision", types.ModuleType("torchvision"))
    monkeypatch.setattr(get_mask, "deeplab_segmenter", segmenter)
    root = str(tmp_path / "tree")
    shutil.copytree(trees[0]["port"], root)
    written = get_mask.main(["--slp_root", root, "--subjects", "1-1", "--device", "cpu"])
    assert built == ["cpu"] and len(seen) == len(written) == NUM_IMGS
    assert capsys.readouterr().out.splitlines()[0] == "Using deeplabv3_resnet101 segmentation"


def test_default_root_is_the_jax_config_slp_root(trees, tmp_path, monkeypatch, capsys):
    """The default root under INBED_DATA_ROOT is the JAX package's
    `config.SLP_ROOT` for the same variable (its config reads the variable
    when imported, so a fresh copy of it is executed here), and masks go
    there without --slp_root."""
    data_root = str(tmp_path / "data")
    shutil.copytree(trees[0]["port"], join(data_root, "SLP", "SLP", "danaLab"))
    monkeypatch.setenv("INBED_DATA_ROOT", data_root)
    monkeypatch.setitem(sys.modules, "torchvision", None)
    spec = importlib.util.spec_from_file_location("_jax_config_copy",
                                                  join(REPO, "inbed_pose_estimation_tpu", "config.py"))
    j_config = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_config)
    assert get_mask.default_root() == j_config.SLP_ROOT
    written = get_mask.main(["--subjects", "1-1"])
    assert written and all(p.startswith(join(j_config.SLP_ROOT, "00001", "masks", "uncover")) for p in written)
