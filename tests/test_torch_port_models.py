"""PyTorch port, models and the eval slice: JAX flax variables loaded into
the port through `load_jax_variables`, then HMRCore outputs, the full
cashmrV2 inference path and the eval metrics compared with the JAX
package on the CPU (RES 64, batch 2, 2-pass cascade)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu.evaluation.evaluate import load_j_regressor_h36m as j_load_jreg
from inbed_pose_estimation_tpu.evaluation.pipeline import eval_metrics as j_eval_metrics
from inbed_pose_estimation_tpu.evaluation.pipeline import make_inference_fn as j_make_inference_fn
from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
from inbed_pose_estimation_tpu.train.checkpoint import convert_torch_state_dict
from inbed_pose_estimation_tpu_torch.evaluation import eval_metrics, load_j_regressor_h36m, make_inference_fn
from inbed_pose_estimation_tpu_torch.models import build_model, get_spec, model_names
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.weights import load_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

RES, B = 64, 2


def _perturb_bn(variables, seed):
    """Move BN leaves off their init values (scale 1, bias 0, mean 0, var 1),
    so that a swapped or dropped BN leaf shows in the outputs."""
    rng = np.random.default_rng(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.array(v, dtype=np.float32)
            if coll == "batch_stats" and k == "mean":
                v = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif coll == "batch_stats" and k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k == "bias" and "scale" in tree:
                v = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
            out[k] = v
        return out

    return {coll: walk(variables[coll], coll) for coll in ("params", "batch_stats")}


def _init(name, in_ch, seed):
    model, spec = j_build_model(name)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, RES, RES, in_ch)))
    variables = _perturb_bn(jax.tree_util.tree_map(np.asarray, variables), seed)
    port, port_spec = build_model(name, device="cpu")
    load_jax_variables(port, variables)
    return model, spec, variables, port, port_spec


@pytest.fixture(scope="module")
def cashmr():
    return _init("cashmrV2", 6, 0)


@pytest.fixture(scope="module")
def modalities():
    rng = np.random.default_rng(0)
    return [rng.normal(0, 1, (B, c, RES, RES)).astype(np.float32) for c in (3, 1, 1, 1)]


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def test_load_jax_variables_round_trip(cashmr):
    _, _, variables, port, _ = cashmr
    back = convert_torch_state_dict(port.state_dict(), on_unmapped="raise")
    ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert len(got) == len(ref)
    for path, value in ref:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], value)


def test_load_jax_variables_rejects_missing_and_extra_leaves(cashmr):
    _, _, variables, _, _ = cashmr
    port, _ = build_model("hmr4mod", device="cpu")  # no decoder: the decoder leaves are extra
    with pytest.raises(ValueError, match="not taken"):
        load_jax_variables(port, variables)
    port, _ = build_model("rec3hmr", device="cpu")  # three decoders: ir/pm leaves are missing
    with pytest.raises(ValueError, match="absent"):
        load_jax_variables(port, variables)


def _assert_hmr_close(jout, tout, with_depth):
    # Tolerances of tests/test_torch_parity.py (the torch-twin parity).
    np.testing.assert_allclose(tout.betas.numpy(), np.asarray(jout.betas), atol=2e-4)
    np.testing.assert_allclose(tout.cam.numpy(), np.asarray(jout.cam), atol=2e-4)
    np.testing.assert_allclose(tout.rotmat.numpy(), np.asarray(jout.rotmat), atol=5e-4)
    if with_depth:
        np.testing.assert_allclose(tout.recon["depth"].numpy()[:, 0], np.asarray(jout.recon["depth"])[..., 0], atol=5e-4)


def test_hmrcore_cashmrv2_matches_jax(cashmr, modalities):
    model, _, variables, port, _ = cashmr
    x = np.concatenate(modalities, axis=1)
    jout = model.apply(variables, _nhwc(x))
    with torch.no_grad():
        tout = port(torch.from_numpy(x))
    _assert_hmr_close(jout, tout, with_depth=True)


def test_hmrcore_hmr_matches_jax():
    model, _, variables, port, spec = _init("hmr", 3, 1)
    assert spec.in_channels == 3 and not spec.recon_heads
    x = np.random.default_rng(1).normal(0, 1, (B, 3, RES, RES)).astype(np.float32)
    jout = model.apply(variables, _nhwc(x))
    with torch.no_grad():
        tout = port(torch.from_numpy(x))
    _assert_hmr_close(jout, tout, with_depth=False)
    assert tout.recon == {}


@pytest.fixture(scope="module")
def smpl_and_jreg():
    return j_synthetic(0), synthetic_smpl_model(0, device="cpu"), load_j_regressor_h36m()


@pytest.mark.parametrize("final_recon", [True, False])
def test_inference_cashmrv2_matches_jax(cashmr, modalities, smpl_and_jreg, final_recon):
    model, spec, variables, port, port_spec = cashmr
    j_smpl, t_smpl, jreg = smpl_and_jreg
    np.testing.assert_array_equal(jreg, j_load_jreg(num_vertices=6890))
    j_infer = j_make_inference_fn(model, spec, j_smpl, j_regressor_h36m=jreg, num_cas_iters=2, final_recon=final_recon)
    jo = j_infer(variables, tuple(_nhwc(m) for m in modalities))
    t_infer = make_inference_fn(port, port_spec, t_smpl, jreg, num_cas_iters=2, final_recon=final_recon, device="cpu")
    to = t_infer(modalities)

    np.testing.assert_allclose(to["betas"].numpy(), np.asarray(jo["betas"]), atol=2e-4)
    np.testing.assert_allclose(to["cam"].numpy(), np.asarray(jo["cam"]), atol=2e-4)
    np.testing.assert_allclose(to["rotmat"].numpy(), np.asarray(jo["rotmat"]), atol=5e-4)
    # Measured on the CPU: max |diff| about 1e-6 m on vertices and joints;
    # 1e-3 m (1 mm) is the stated bound.
    np.testing.assert_allclose(to["vertices"].numpy(), np.asarray(jo["vertices"]), atol=1e-3)
    np.testing.assert_allclose(to["keypoints_3d_17"].numpy(), np.asarray(jo["keypoints_3d_17"]), atol=1e-3)
    assert set(to["recon"]) == set(jo["recon"]) == ({"depth"} if final_recon else set())
    if final_recon:
        np.testing.assert_allclose(to["recon"]["depth"].numpy()[:, 0], np.asarray(jo["recon"]["depth"])[..., 0], atol=5e-4)

    gt = np.asarray(jo["keypoints_3d_17"]) + np.random.default_rng(9).normal(0, 0.05, (B, 17, 3)).astype(np.float32)
    jm = j_eval_metrics(jo["keypoints_3d_17"], jnp.asarray(gt))
    tm = eval_metrics(to["keypoints_3d_17"], torch.from_numpy(gt))
    for k in ("mpjpe", "pa_mpjpe"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=1e-5, err_msg=k)


def test_factory_covers_registry():
    from inbed_pose_estimation_tpu.models import model_names as j_model_names

    assert model_names() == j_model_names()
    concat = [n for n in model_names() if get_spec(n).input_mode == "concat"]
    assert sorted(concat) == sorted(["hmr", "hmr4mod", "irhmr", "depthhmr", "pmhmr", "mulhmr", "rechmr",
                                     "cashmr", "cashmrV2", "rec3hmr", "cas3hmr"])
    assert len(model_names()) == 23
    for name in model_names():
        port, spec = build_model(name, device="cpu")
        assert not port.training and spec.name == name
    # Bodies-At-Rest: fc1 sized from the resolution, the mode-2 stack on
    # bodiesAtRest4mod only, as the JAX package's eval tree has it.
    for name, channels in (("bodiesAtRest", 3), ("bodiesAtRest4mod", 8)):
        port, spec = build_model(name, device="cpu", img_res=64)
        assert spec.input_mode == "pm_contact" and port.CNN_packtanh[0].in_channels == channels
        assert port.CNN_fc1[0].in_features == 384 * 2 * 2
        assert hasattr(port, "CNN_packtanh_mode2") == (name == "bodiesAtRest4mod")
    port, spec = build_model("cas3hmr", device="cpu")
    assert spec.in_channels == 6 and spec.cascade
    assert {k.split(".")[0] for k in port.state_dict()} >= {"Reconstruct_depth", "Reconstruct_ir", "Reconstruct_pm"}
