"""PyTorch port, static rules: no file of the port imports JAX, flax, optax
or the JAX package, and entry points never fall back to the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import inbed_pose_estimation_tpu_torch as port
from inbed_pose_estimation_tpu_torch.device import resolve_device
from inbed_pose_estimation_tpu_torch.data.device_preprocess import make_device_preprocess
from inbed_pose_estimation_tpu_torch.evaluation import make_inference_fn, run_evaluation
from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.render import PartRenderer
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.train import build_parser, init_train_state, make_train_step

PORT_DIR = pathlib.Path(port.__file__).parent
REPO = PORT_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "inbed_pose_estimation_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "eval_gpu.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _cuda_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda_and_pins_f32(monkeypatch):
    _cuda_missing(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(ValueError):
        resolve_device("mps")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("entry", ["build_model", "synthetic_smpl_model", "make_inference_fn", "synthetic_gmm_prior",
                                   "make_train_step", "init_train_state", "run_evaluation", "make_device_preprocess",
                                   "PartRenderer", "eval_gpu.main"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    _cuda_missing(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "run_evaluation":
            model, spec = build_model("hmr", device="cpu")
            run_evaluation(model, spec, "slp-4mod-uncover", [], synthetic_smpl_model(0, device="cpu"))
        elif entry == "make_device_preprocess":
            make_device_preprocess(res=64)
        elif entry == "PartRenderer":
            PartRenderer(render_res=64, num_vertices=10)
        elif entry == "eval_gpu.main":
            import eval_gpu

            eval_gpu.main(["--model", "hmr", "--allow_synthetic_assets"])
        elif entry == "build_model":
            build_model("hmr")
        elif entry == "synthetic_smpl_model":
            synthetic_smpl_model(0)
        elif entry == "synthetic_gmm_prior":
            synthetic_gmm_prior()
        elif entry == "make_inference_fn":
            model, spec = build_model("hmr", device="cpu")
            make_inference_fn(model, spec, synthetic_smpl_model(0, device="cpu"), np.zeros((17, 6890), np.float32))
        else:
            model, spec = build_model("hmr", device="cpu")
            options = build_parser().parse_args([])
            if entry == "make_train_step":
                make_train_step(model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                                options)
            else:
                init_train_state(model, options, np.zeros((4, 82), np.float32))
