"""PyTorch port, Bodies-At-Rest (bodiesAtRest, bodiesAtRest4mod) against the
JAX package on the CPU, RES 64, batch 2: the model in modes "0", "1" and
"2" with seeded flax variables loaded through `weights.py`, fc1's row
permutation (at 224² shapes, numpy only) and the JAX converter's fault,
`make_inference_fn` with bodiesAtRest4mod's refinement, the mode-"0" and
mode-"1" train steps and the parameters after both, `run_evaluation` over
the synthetic tree, and checkpoints (a JAX `.npz` with optax leaves, a
reference-layout `.pt`).  Dropout is off on both sides where they are
compared (the JAX stack's through a stand-in for its `nn` module)."""

import os

import numpy as np
import pytest

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import optax
import torch

import inbed_pose_estimation_tpu.models.bodies_at_rest as j_bar
from inbed_pose_estimation_tpu import config as j_config
from inbed_pose_estimation_tpu.data.dataset import BaseDataset as JBaseDataset
from inbed_pose_estimation_tpu.data.synthetic import write_synthetic_environment as j_write_env
from inbed_pose_estimation_tpu.evaluation.evaluate import run_evaluation as j_run_evaluation
from inbed_pose_estimation_tpu.evaluation.pipeline import make_inference_fn as j_make_inference_fn
from inbed_pose_estimation_tpu.fitting import synthetic_gmm_prior as j_prior
from inbed_pose_estimation_tpu.geometry import perspective_projection as j_project
from inbed_pose_estimation_tpu.geometry import weak_perspective_to_cam_t as j_cam_t
from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.ops.mask_raster import render_body_mask as j_render_body_mask
from inbed_pose_estimation_tpu.ops.mask_raster import splat_points_to_mask as j_splat
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
from inbed_pose_estimation_tpu.smpl.model import smpl_forward as j_smpl_forward
from inbed_pose_estimation_tpu.train.checkpoint import convert_torch_state_dict, flatten_opt_state
from inbed_pose_estimation_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from inbed_pose_estimation_tpu.train.trainer import TrainState as JTrainState
from inbed_pose_estimation_tpu.train.trainer import make_train_step as j_make_train_step
from inbed_pose_estimation_tpu.train.trainer import step_feed_keys as j_step_feed_keys
from inbed_pose_estimation_tpu_torch import config
from inbed_pose_estimation_tpu_torch.data import BaseDataset
from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn, run_evaluation
from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import BodiesAtRest, build_model
from inbed_pose_estimation_tpu_torch.models.bodies_at_rest import stack_hw
from inbed_pose_estimation_tpu_torch.ops.mask_raster import render_body_mask
from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.train import init_train_state, make_train_step, step_feed_keys
from inbed_pose_estimation_tpu_torch.train import losses as L
from inbed_pose_estimation_tpu_torch.train.checkpoint import load_torch_checkpoint, resume_train_state
from inbed_pose_estimation_tpu_torch.weights import (
    fc1_rows_from_flax, fc1_rows_to_flax, flax_path, load_jax_adam_state, load_jax_variables,
)

RES, B = 64, 2
CHANNELS = {"bodiesAtRest": 3, "bodiesAtRest4mod": 8}
IDENTITY_6D = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 24)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch in this module: six test workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _NoDropout:
    """flax.linen for the JAX stack, with its dropout at rate 0."""

    def __getattr__(self, name):
        return getattr(flax_nn, name)

    @staticmethod
    def Dropout(rate, **kw):
        return flax_nn.Dropout(0.0, **kw)


def nhwc(x):
    return jnp.asarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


def jax_variables(name, seed, mode2=True):
    """Seeded flax params of the JAX model's tree (traced by
    `jax.eval_shape`, never run): kernels N(0, 1 / fan_in), biases N(0,
    0.05); the decoders' kernels x0.1 around biases at the identity pose,
    zero shape and a camera of scale 0.9, so that the bodies project into
    the image.  Mode 2's stack is there with `mode2` (the eval tree)."""
    jmodel, _ = j_build_model(name)
    c = CHANNELS[name]
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, c)), mode="0"))
    params = dict(shapes["params"])
    if mode2:
        params.update(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, c + 1)),
                                                         mode="2"))["params"])
    rng = np.random.default_rng(seed)
    bias0 = {"decpose": IDENTITY_6D, "decshape": np.zeros(10, np.float32),
             "deccam": np.array([0.9, 0.0, 0.0], np.float32)}

    def leaf(path, spec):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            scale = 1.0 / np.sqrt(np.prod(spec.shape[:-1])) * (0.1 if keys[-2] in bias0 else 1.0)
            return rng.standard_normal(spec.shape, dtype=np.float32) * np.float32(scale)
        base = bias0.get(keys[-2], np.zeros(spec.shape, np.float32))
        return (base + 0.05 * rng.standard_normal(spec.shape)).astype(np.float32)

    return jmodel, {"params": jax.tree_util.tree_map_with_path(leaf, params)}


def stacked_input(name, seed, extra=0):
    r = np.random.default_rng(seed)
    return r.normal(0, 1, (B, CHANNELS[name] + extra, RES, RES)).astype(np.float32)


def _close(tout, jout):
    np.testing.assert_allclose(tout.rotmat.numpy(), np.asarray(jout.rotmat), atol=5e-4)
    np.testing.assert_allclose(tout.betas.numpy(), np.asarray(jout.betas), atol=2e-4)
    np.testing.assert_allclose(tout.cam.numpy(), np.asarray(jout.cam), atol=2e-4)


@pytest.mark.parametrize("name,mode", [("bodiesAtRest", "0"), ("bodiesAtRest4mod", "0"), ("bodiesAtRest4mod", "1"),
                                       ("bodiesAtRest4mod", "2")])
def test_model_matches_jax(name, mode):
    jmodel, variables = jax_variables(name, 1, mode2=name == "bodiesAtRest4mod")
    port, _ = build_model(name, device="cpu", img_res=RES)
    load_jax_variables(port, variables)
    x = stacked_input(name, 2, extra=mode == "2")
    jout = jmodel.apply(variables, nhwc(x), mode=mode)
    with torch.no_grad():
        tout = port(torch.from_numpy(x), mode=mode)
    _close(tout, jout)
    assert tout.recon == {} and tout.pose6d.shape == (B, 144)
    assert port.with_mode2 == (name == "bodiesAtRest4mod")


def test_modes_and_widths():
    """fc1's input width from the resolution; mode "1" detaches; mode "2"
    needs the second stack."""
    assert stack_hw(224) == 12 and stack_hw(64) == 2
    assert BodiesAtRest(3, 224).CNN_fc1[0].in_features == 55296
    port, _ = build_model("bodiesAtRest", device="cpu", img_res=RES)
    x = torch.from_numpy(stacked_input("bodiesAtRest", 3))
    assert port(x, mode="0").betas.requires_grad and not port(x, mode="1").betas.requires_grad
    torch.testing.assert_close(port(x, mode="0").cam, port(x, mode="1").cam, rtol=0, atol=0)
    with pytest.raises(ValueError, match="with_mode2"):
        port(torch.cat([x, x[:, :1]], 1), mode="2")
    with pytest.raises(ValueError, match="unknown mode"):
        port(x, mode="3")


def test_fc1_row_permutation_at_224():
    """numpy only, at 224² shapes (55296 = 12·12·384 rows): a flax fc1
    kernel over NHWC-flattened features computes what the permuted weight
    computes over the same features NCHW-flattened, and the two maps are
    inverse."""
    rng = np.random.default_rng(0)
    c, h, w, out = 384, 12, 12, 8
    kernel = rng.standard_normal((h * w * c, out)).astype(np.float32)
    feats = rng.standard_normal((2, c, h, w)).astype(np.float32)
    weight = fc1_rows_from_flax(kernel, (c, h, w))
    assert weight.shape == (out, 55296)
    want = np.transpose(feats, (0, 2, 3, 1)).reshape(2, -1) @ kernel
    np.testing.assert_allclose(feats.reshape(2, -1) @ weight.T, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(fc1_rows_to_flax(weight, (c, h, w)), kernel)
    assert not np.array_equal(weight, kernel.T)


def test_weight_map_round_trip():
    """Every port key through `flax_path` (Bodies-At-Rest's map) onto the
    JAX tree, and back through `load_jax_variables`, leaf for leaf."""
    jmodel, variables = jax_variables("bodiesAtRest4mod", 4)
    port, _ = build_model("bodiesAtRest4mod", device="cpu", img_res=RES)
    load_jax_variables(port, variables)
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    assert len(flat) == len(port.state_dict()) == 32
    for key, value in port.state_dict().items():
        path, leaf, coll = flax_path(key, bodies_at_rest=True)
        assert coll == "params"
        want = flat[jax.tree_util.keystr(tuple(jax.tree_util.DictKey(p) for p in path + (leaf,)))]
        got = value.numpy()
        if leaf == "kernel":
            got = (fc1_rows_to_flax(got, port.fc1_chw) if path[-1] == "fc1" else
                   np.transpose(got, (2, 3, 1, 0)) if got.ndim == 4 else got.T)
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert flax_path("CNN_packtanh_mode2.7.bias", bodies_at_rest=True) == (("stack_mode2", "conv2"), "bias", "params")
    assert flax_path("decpose.weight", bodies_at_rest=True) == (("head_mode1", "decpose"), "kernel", "params")
    assert flax_path("decpose.weight") == (("head", "decpose"), "kernel", "params")  # the IEF head's


def test_jax_train_tree_loads_into_the_4mod_model():
    """The JAX trainer builds mode 1 only: its tree loads strictly into
    bodiesAtRest4mod, whose mode-2 stack keeps its values; a tree missing
    part of a module still raises."""
    _, variables = jax_variables("bodiesAtRest4mod", 5, mode2=False)
    port, _ = build_model("bodiesAtRest4mod", device="cpu", img_res=RES)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    load_jax_variables(port, variables)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]) == k.split(".")[0].endswith("_mode2"), k
    del variables["params"]["head_mode1"]["deccam"]
    with pytest.raises(ValueError, match="head_mode1/deccam"):
        load_jax_variables(port, variables)


def test_jax_converter_misorders_fc1():
    """The frozen JAX package's fault (ROADMAP Queue 3): its converter only
    transposes fc1, so a reference-layout `.pt` (channel-major flatten)
    reaches JAX with fc1's rows out of order and JAX computes something
    else; with the rows permuted, JAX computes what the port computes from
    the `.pt` as it is."""
    jmodel, _ = j_build_model("bodiesAtRest")
    torch.manual_seed(6)
    port, _ = build_model("bodiesAtRest", device="cpu", img_res=RES)
    for layer in (port.decpose, port.decshape, port.deccam):
        torch.nn.init.normal_(layer.weight, std=0.05)
    state = {f"module.{k}": v.numpy() for k, v in port.state_dict().items()}
    converted = convert_torch_state_dict(state, on_unmapped="raise")
    x = stacked_input("bodiesAtRest", 7)
    with torch.no_grad():
        want = port(torch.from_numpy(x), mode="0")
    wrong = jmodel.apply({"params": converted["params"]}, nhwc(x), mode="0")
    assert np.abs(np.asarray(wrong.betas) - want.betas.numpy()).max() > 1e-3
    fc1 = converted["params"]["head_mode1"]["fc1"]
    fc1["kernel"] = fc1_rows_to_flax(state["module.CNN_fc1.0.weight"], port.fc1_chw)
    _close(want, jmodel.apply({"params": converted["params"]}, nhwc(x), mode="0"))


@pytest.fixture(scope="module")
def smpl():
    return j_synthetic(0), synthetic_smpl_model(0, device="cpu")


@pytest.mark.parametrize("name", ["bodiesAtRest", "bodiesAtRest4mod"])
def test_inference_matches_jax(smpl, name):
    """The eval path; for bodiesAtRest4mod the refinement: its estimated map
    equals JAX's splat of JAX's joints, pixel for pixel, and mode 2 runs
    over it."""
    jmodel, variables = jax_variables(name, 8, mode2=name == "bodiesAtRest4mod")
    _, jspec = j_build_model(name)
    port, spec = build_model(name, device="cpu", img_res=RES)
    load_jax_variables(port, variables)
    r = np.random.default_rng(9)
    inputs = [r.normal(0, 1, (B, 3 if m == "img" else 1, RES, RES)).astype(np.float32) for m in spec.modalities]
    inputs.append(r.uniform(0, 1, (B, 2, RES, RES)).astype(np.float32))  # pm_contact
    jreg = load_j_regressor_h36m()
    jo = j_make_inference_fn(jmodel, jspec, smpl[0], j_regressor_h36m=jreg)(variables, tuple(nhwc(x) for x in inputs))
    to = make_inference_fn(port, spec, smpl[1], jreg, device="cpu")(inputs)
    for k in ("rotmat", "betas", "cam"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=2e-4, err_msg=k)
    np.testing.assert_allclose(to["vertices"].numpy(), np.asarray(jo["vertices"]), atol=1e-5)
    np.testing.assert_allclose(to["keypoints_3d_17"].numpy(), np.asarray(jo["keypoints_3d_17"]), atol=1e-5)
    if name == "bodiesAtRest":
        assert to["recon"] == {}
        return
    stacked = jnp.concatenate([nhwc(x) for x in inputs], axis=-1)
    out0 = jmodel.apply(variables, stacked, mode="0")
    joints = j_smpl_forward(smpl[0], out0.betas, rot_mats=out0.rotmat).joints
    cam_t = j_cam_t(out0.cam, 5000.0, RES)
    uv = j_project(joints, jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), cam_t, 5000.0, jnp.zeros((B, 2))) + 0.5 * RES
    want_map = np.asarray(j_splat(uv, RES, RES, dilation=5))[..., 0]
    got_map = to["recon"]["est_map"].numpy()[:, 0]
    np.testing.assert_array_equal(got_map, want_map)
    assert 0 < got_map.mean() < 1  # the joints land inside the image


# --- training ---------------------------------------------------------------

class Opt:
    img_res = RES
    lr = 5e-5
    run_smplify = False
    num_cas_iters = 2
    num_smplify_iters = 2
    smplify_threshold = 100.0
    shape_loss_weight = 0.0
    keypoint_loss_weight = 5.0
    beta_loss_weight = 0.001
    openpose_train_weight = 0.0
    gt_train_weight = 1.0


N_FITS = 16


def train_batch(spec, seed):
    """NCHW images of the keys one step reads; the contact channels in [0,
    1], the mask binary."""
    r = np.random.default_rng(seed)
    batch = {m: r.normal(0, 1, (B, 3 if m == "img" else 1, RES, RES)).astype(np.float32) for m in spec.modalities}
    batch.update({
        "pm_contact": r.uniform(0, 1, (B, 2, RES, RES)).astype(np.float32),
        "mask_uncover": (r.uniform(0, 1, (B, 1, RES, RES)) > 0.5).astype(np.float32),
        "keypoints": np.concatenate([r.uniform(-1, 1, (B, 49, 2)), np.ones((B, 49, 1))], -1).astype(np.float32),
        "pose": r.normal(0, 0.2, (B, 72)).astype(np.float32),
        "betas": r.normal(0, 0.5, (B, 10)).astype(np.float32),
        "pose_3d": np.concatenate([r.normal(0, 0.3, (B, 24, 3)), np.ones((B, 24, 1))], -1).astype(np.float32),
        "has_smpl": np.array([1.0, 0.0], np.float32),
        "has_pose_3d": np.ones(B, np.float32),
        "is_flipped": np.array([0.0, 1.0], np.float32),
        "rot_angle": np.array([0.0, 15.0], np.float32),
        "sample_index": np.array([3, 7], np.int32),
    })
    return batch


def _jbatch(batch):
    return {k: nhwc(v) if v.ndim == 4 else jnp.asarray(v) for k, v in batch.items()}


def _fits():
    return np.random.default_rng(11).normal(0, 0.2, (N_FITS, 82)).astype(np.float32)


def _flat_params(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_jax_leaves(named, chw):
    """The port's tensors by state-dict key as the JAX tree's leaves, in
    float64 (mode 1's only)."""
    out = {}
    for key, value in named.items():
        path, leaf, _ = flax_path(key, bodies_at_rest=True)
        if path[0].endswith("mode2"):
            continue
        arr = value.double().numpy()
        if leaf == "kernel":
            arr = (fc1_rows_to_flax(arr, chw) if path[-1] == "fc1" else
                   np.transpose(arr, (2, 3, 1, 0)) if arr.ndim == 4 else arr.T)
        out[jax.tree_util.keystr(tuple(jax.tree_util.DictKey(p) for p in path + (leaf,)))] = arr
    return out


@pytest.fixture(scope="module")
def runs(smpl):
    """run(side): the mode-"0" step then the mode-"1" step of
    bodiesAtRest4mod on a JAX train tree (mode 1 only), SMPLify off, from
    the same weights and batches, in JAX ("jax") or the port ("f32",
    "f64"): the losses and metrics, mode 0's gradients and the parameters
    after each step; computed once per module."""
    name = "bodiesAtRest4mod"
    cache = {}
    _, variables = jax_variables(name, 12, mode2=False)
    jspec = j_build_model(name)[1]
    batches = (train_batch(jspec, 13), train_batch(jspec, 14))

    def jax_run():
        mp = pytest.MonkeyPatch()
        mp.setattr(j_bar, "nn", _NoDropout())
        try:
            jmodel, jspec = j_build_model(name)
            steps = [j_make_train_step(jmodel, jspec, smpl[0], j_prior(), Opt(), bar_mode=m)[0] for m in "01"]
            params = variables["params"]
            (loss, (_, _, metrics)), grads = jax.jit(jax.value_and_grad(steps[0]._loss_fn, has_aux=True))(
                params, {}, jnp.asarray(_fits()), _jbatch(batches[0]), jax.random.PRNGKey(3))
            state = JTrainState(params=params, batch_stats={}, opt_state=optax.adam(Opt.lr).init(params),
                                fits=jnp.asarray(_fits()), rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32))
            out = {"loss0": float(loss), "metrics0": {k: float(v) for k, v in metrics.items()},
                   "grads0": _flat_params(grads), "params": [_flat_params(params)]}
            for step, batch in zip(steps, batches):
                state, m = jax.jit(step)(state, _jbatch(batch))
                out["params"].append(_flat_params(state.params))
            out["metrics1"] = {k: float(v) for k, v in m.items()}
        finally:
            mp.undo()
        return out

    def port_run(dtype):
        port, spec = build_model(name, device="cpu", dropout_rate=0.0, img_res=RES)
        load_jax_variables(port, variables)
        port.to(dtype)
        mode2 = {k: v.clone() for k, v in port.state_dict().items() if k.split(".")[0].endswith("_mode2")}
        state = init_train_state(port, Opt(), _fits(), device="cpu")
        prior = synthetic_gmm_prior(device="cpu")
        smpl_t = synthetic_smpl_model(0, device="cpu").to(dtype)
        prior = type(prior)(*(t.to(dtype) for t in prior))
        steps = [make_train_step(port, spec, smpl_t, prior, Opt(), device="cpu", bar_mode=m) for m in "01"]
        out = {"params": [_as_jax_leaves(port.state_dict(), port.fc1_chw)], "metrics": []}
        for step, batch in zip(steps, batches):
            assert set(batch) == step_feed_keys(spec) - {"pixel_noise"}
            state, metrics = step(state, batch)
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            grads = {key: p.grad for key, p in port.named_parameters()}
            if "grads0" not in out:
                out["grads0"] = _as_jax_leaves(grads, port.fc1_chw)
            else:
                out["grads1_zero"] = not any(bool(g.any()) for g in grads.values())
            out["params"].append(_as_jax_leaves(port.state_dict(), port.fc1_chw))
        out["mode2_unchanged"] = all(torch.equal(v, port.state_dict()[k]) for k, v in mode2.items())
        out["state"] = state
        return out

    def run(side):
        if side not in cache:
            cache[side] = jax_run() if side == "jax" else port_run(getattr(torch, f"float{side[1:]}"))
        return cache[side]

    return run


def _ratio(a32, ref, a64):
    """|a32 - ref| over float32's own error, |a32 - a64| + 1e-4 |a64|."""
    return np.linalg.norm(a32 - ref) / (np.linalg.norm(a32 - a64) + 1e-4 * np.linalg.norm(a64))


def test_train_steps_losses_match_jax(runs):
    """The mode-0 loss and its parts and the mode-1 loss (a step later),
    within 1e-4; JAX's and the port's feeds are the same keys."""
    ref, got = runs("jax"), runs("f32")
    assert step_feed_keys(build_model("bodiesAtRest", device="cpu", img_res=RES)[1]) == j_step_feed_keys(
        j_build_model("bodiesAtRest")[1])
    assert got["metrics"][0]["loss"] == pytest.approx(ref["loss0"], rel=1e-4)
    for k, v in ref["metrics0"].items():
        assert got["metrics"][0][k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    for k, v in ref["metrics1"].items():
        assert got["metrics"][1][k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    np.testing.assert_array_equal(got["state"].fits.numpy(), _fits())  # no SMPLify: the store is unchanged


def test_train_step_gradients_match_jax(runs):
    """Mode 0's gradient leaf by leaf within 3x float32's own error; mode
    1's gradients are all zero."""
    ref, g32, g64 = runs("jax")["grads0"], runs("f32")["grads0"], runs("f64")["grads0"]
    assert set(g32) == set(ref) == set(g64) and len(ref) == 16
    for k, r in ref.items():
        assert _ratio(g32[k], r, g64[k]) <= 3, k
        assert np.abs(r).max() > 0, k
    assert runs("f32")["grads1_zero"]


def test_params_after_mod1_switch_match_jax(runs):
    """The parameters after the mode-0 step, and after the mode-1 step
    that follows it (zero gradients, Adam still applying its moments):
    each leaf's move within 3x float32's own error; the mode-1 step moves
    every leaf; the mode-2 stack stays bitwise."""
    ref, p32, p64 = runs("jax")["params"], runs("f32")["params"], runs("f64")["params"]
    for after in (1, 2):
        for k in ref[0]:
            moved = [p[after][k] - p[0][k] for p in (p32, p64)]
            assert _ratio(moved[0], ref[after][k] - ref[0][k], moved[1]) <= 3, (after, k)
    for k in ref[0]:
        assert np.any(p32[2][k] != p32[1][k]), k
    assert runs("f32")["mode2_unchanged"]


def test_mask_term_matches_jax(smpl):
    """Mode 0's mask term, 0.1 x L1(body mask of the detached prediction,
    mask_uncover): the port's equals JAX's on the same vertices to 1e-6,
    and it is the difference between the mode-0 and mode-1 losses (x60)
    at the same weights."""
    name = "bodiesAtRest"
    _, variables = jax_variables(name, 15, mode2=False)
    port, spec = build_model(name, device="cpu", dropout_rate=0.0, img_res=RES)
    load_jax_variables(port, variables)
    batch = train_batch(spec, 16)
    losses = []
    for mode in "01":
        state = init_train_state(port, Opt(), _fits(), device="cpu")
        step = make_train_step(port, spec, smpl[1], synthetic_gmm_prior(device="cpu"), Opt(), device="cpu",
                               bar_mode=mode)
        snapshot = {k: v.clone() for k, v in port.state_dict().items()}
        losses.append(float(step(state, batch)[1]["loss"]))
        port.load_state_dict(snapshot)
    x = torch.from_numpy(np.concatenate([batch["pm_img"], batch["pm_contact"]], 1))
    with torch.no_grad():
        out = port.eval()(x, mode="0")
        verts = lbs(smpl[1], out.betas, out.rotmat)[0]
        term = 0.1 * float(L.recon_l1_loss(render_body_mask(verts, out.cam, img_res=RES),
                                           torch.from_numpy(batch["mask_uncover"])))
    jmask = j_render_body_mask(jnp.asarray(verts.numpy()), jnp.asarray(out.cam.numpy()), img_res=RES)
    jterm = 0.1 * float(jnp.abs(jmask - nhwc(batch["mask_uncover"])).mean())
    assert term == pytest.approx(jterm, abs=1e-6) and term > 0
    assert losses[0] - losses[1] == pytest.approx(60 * term, rel=1e-4)


# --- run_evaluation -----------------------------------------------------------

SPLIT = "slp-4mod-uncover"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    env = j_write_env(str(tmp_path_factory.mktemp("bartree")), num_subjects=1, samples_per_subject=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INBED_DATA_ROOT", env["data_root"])
        mp.setenv("INBED_NPZ_PATH", env["npz_path"])
        mp.setenv("INBED_ASSET_DIR", os.path.join(env["data_root"], "no_assets"))
        mp.setitem(j_config.DATASET_FOLDERS, SPLIT, config.dataset_folder(SPLIT))
        mp.setitem(j_config.DATASET_FILES[0], SPLIT, config.dataset_file(SPLIT))
        yield env


class _EvalOpt:
    img_res = RES


@pytest.mark.parametrize("name", ["bodiesAtRest", "bodiesAtRest4mod"])
def test_run_evaluation_matches_jax(tree, smpl, name):
    """Both names over the synthetic split (3 samples, batch 2: a padded
    tail), masks on: every metric within 1e-3 mm / 1e-9 of JAX's."""
    jmodel, variables = jax_variables(name, 17, mode2=name == "bodiesAtRest4mod")
    _, jspec = j_build_model(name)
    port, spec = build_model(name, device="cpu", img_res=RES)
    load_jax_variables(port, variables)
    common = dict(batch_size=B, img_res=RES, num_workers=1, log_freq=0)
    want = j_run_evaluation(jmodel, jspec, variables, SPLIT, JBaseDataset(_EvalOpt(), SPLIT, is_train=False),
                            smpl[0], **common)
    got = run_evaluation(port, spec, SPLIT, BaseDataset(_EvalOpt(), SPLIT, is_train=False), smpl[1], device="cpu",
                         **common)
    assert set(got) == set(want) | {"timing"}
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= (1e-3 if k in ("mpjpe", "pa_mpjpe", "pve") else 1e-9), (k, got[k], v)
    assert np.isfinite(got["mpjpe"]) and got["mask_f1"] is not None and got["timing"]["batches"] == 2


# --- checkpoints ----------------------------------------------------------------

def test_resume_from_jax_npz_with_optax_leaves(tmp_path):
    """A JAX `.npz` of bodiesAtRest4mod as the JAX trainer writes it (mode 1
    only, optax's leaves positional): the weights load, Adam's moments land
    on their parameters (fc1's rows permuted) with JAX's count, and the
    mode-2 parameters keep their values with zero moments."""
    _, variables = jax_variables("bodiesAtRest4mod", 18, mode2=False)
    params = variables["params"]
    rng = np.random.default_rng(19)
    opt_state = optax.adam(Opt.lr).init(params)
    inner = opt_state[0]._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params),
        nu=jax.tree_util.tree_map(lambda p: rng.uniform(0, 1, p.shape).astype(np.float32), params))
    opt_state = (inner,) + tuple(opt_state[1:])
    path = j_save_checkpoint(str(tmp_path), variables, opt_state_flat=flatten_opt_state(opt_state),
                             metadata={"total_step_count": 3}, epoch=1, batch_idx=0)
    port, _ = build_model("bodiesAtRest4mod", device="cpu", img_res=RES)
    mode2 = {k: v.clone() for k, v in port.state_dict().items() if k.split(".")[0].endswith("_mode2")}
    state = init_train_state(port, Opt(), _fits(), device="cpu")
    meta = resume_train_state(path, state)
    assert meta["total_step_count"] == 3
    for k, v in mode2.items():
        assert torch.equal(port.state_dict()[k], v), k
    chw = port.fc1_chw
    for key, param in port.named_parameters():
        st = state.optimizer.state[param]
        assert float(st["step"]) == 3.0
        if key.split(".")[0].endswith("_mode2"):
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any(), key
            continue
        path_, leaf, _ = flax_path(key, bodies_at_rest=True)
        mu = inner.mu[path_[0]][path_[1]][leaf]
        want = fc1_rows_from_flax(mu, chw) if path_[-1] == "fc1" and leaf == "kernel" else (
            np.transpose(mu, (3, 2, 0, 1)) if mu.ndim == 4 else mu.T if mu.ndim == 2 else mu)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), want, err_msg=key)
    # The same state through load_jax_adam_state directly.
    load_jax_adam_state(port, state.optimizer, opt_state)


def test_reference_pt_loads_strictly(tmp_path):
    """A reference-layout `.pt` (`module.` prefixes; the reference class
    holds both stacks): bodiesAtRest4mod loads it whole; bodiesAtRest,
    which has no mode-2 stack, leaves the `_mode2` entries out; a missing
    entry still raises."""
    torch.manual_seed(20)
    donor = BodiesAtRest(3, RES, with_mode2=True)
    path = tmp_path / "ref.pt"
    torch.save({"model": {f"module.{k}": v for k, v in donor.state_dict().items()}}, path)
    port, _ = build_model("bodiesAtRest", device="cpu", img_res=RES)
    load_torch_checkpoint(str(path), port)
    for k, v in port.state_dict().items():
        assert torch.equal(v, donor.state_dict()[k]), k
    torch.manual_seed(21)
    donor4, _ = build_model("bodiesAtRest4mod", device="cpu", img_res=RES)
    torch.save({"model": donor4.state_dict()}, path)
    port4, _ = build_model("bodiesAtRest4mod", device="cpu", img_res=RES)
    load_torch_checkpoint(str(path), port4)
    for k, v in port4.state_dict().items():
        assert torch.equal(v, donor4.state_dict()[k]), k
    torch.save({"model": {k: v for k, v in donor4.state_dict().items() if k != "deccam_mode2.bias"}}, path)
    with pytest.raises(RuntimeError, match="deccam_mode2.bias"):
        load_torch_checkpoint(str(path), port4)


def test_eval_gpu_runs_the_4mod_model_from_a_jax_train_npz(tree, tmp_path, capsys):
    """eval_gpu.py for bodiesAtRest4mod from a JAX trainer's `.npz` (mode 1
    only; the mode-2 stack keeps the seeded initial weights), with
    --device_preprocess ignored as the JAX CLI ignores it."""
    import eval_gpu

    _, variables = jax_variables("bodiesAtRest4mod", 22, mode2=False)
    path = j_save_checkpoint(str(tmp_path), variables, epoch=1, batch_idx=0)
    args = ["--model", "bodiesAtRest4mod", "--img_res", str(RES), "--batch_size", str(B), "--device", "cpu",
            "--allow_synthetic_assets", "--num_workers", "1", "--dataset", SPLIT, "--checkpoint", path,
            "--device_preprocess"]
    r = eval_gpu.main(args)[SPLIT]
    assert "--device_preprocess ignored for input mode 'pm_contact'" in capsys.readouterr().out
    assert np.isfinite(r["mpjpe"]) and r["pa_mpjpe"] <= r["mpjpe"] and r["mask_f1"] is not None
    assert eval_gpu.main(args)[SPLIT]["mpjpe"] == r["mpjpe"]  # the same seeded weights each run


def test_train_gpu_switches_to_mode_1_at_mod1_epoch(tree, tmp_path):
    """train_gpu.py for bodiesAtRest over 2 epochs with --mod1_epoch 1: mode
    "0" in epoch 0, mode "1" in epoch 1; resumed past the switch, it starts
    in mode "1"."""
    import train_gpu

    args = ["--name", "bar", "--log_dir", str(tmp_path), "--model", "bodiesAtRest", "--img_res", str(RES),
            "--batch_size", "3", "--num_epochs", "2", "--mod1_epoch", "1", "--num_workers", "1", "--summary_steps", "1",
            "--data_test", "", "--allow_synthetic_assets", "--device", "cpu"]
    trainer = train_gpu.main(args)
    modes = [(h["epoch"], h["mode"]) for h in trainer.history if h["kind"] == "bar_mode"]
    assert modes == [(0, "0"), (1, "1")] and trainer.step_count == 4
    assert all(np.isfinite(h["metrics"]["loss"]) for h in trainer.history if h["kind"] == "summary")
    resumed = train_gpu.main(args[:args.index("--num_epochs") + 1] + ["3"] + args[args.index("--num_epochs") + 2:]
                             + ["--resume"])
    assert [(h["epoch"], h["mode"]) for h in resumed.history if h["kind"] == "bar_mode"] == [(2, "1")]
    assert resumed.step_count == 6
