"""PyTorch port, the multi-trunk family (featcat, featcat_cashmr,
featatt_cashmr, ir_depth_featatt_cashmrV2) against the JAX package on the
CPU, RES 64, batch 2, seeded flax variables of the JAX model's tree
(BatchNorm moved off its init values, cross-attention gains non-zero) loaded
through
`load_jax_variables`: CrossAttention, SelfAttention (no model uses it),
MultiTrunkCore, `make_inference_fn`
with both recovered slots fed back, the weight maps with the 2-trunk order,
and the port's train step (fast, without JAX; slow, against JAX's)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

from inbed_pose_estimation_tpu.evaluation.pipeline import make_inference_fn as j_make_inference_fn
from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.models.attention import CrossAttention as JCrossAttention
from inbed_pose_estimation_tpu.models.attention import SelfAttention as JSelfAttention
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
from inbed_pose_estimation_tpu_torch.models import CrossAttention, SelfAttention, build_model
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.weights import flax_path, load_jax_variables
from tests.test_torch_port_models import _perturb_bn
from torch_threads import one_torch_thread  # noqa: F401

RES, B = 64, 2
CHANNELS = {"img": 3}
GAMMA = np.array([0.5, -0.3, 0.2, 0.4], np.float32)


def nhwc(x):
    return jnp.asarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


def modalities(spec, seed):
    r = np.random.default_rng(seed)
    return [r.normal(0, 1, (B, CHANNELS.get(m, 1), RES, RES)).astype(np.float32) for m in spec.modalities]


def jax_variables(init_fn, seed):
    """Seeded flax variables of the shapes `init_fn` (a flax `model.init`
    call) gives, traced by `jax.eval_shape` and never run: conv and dense
    kernels N(0, 1 / fan_in) as flax's default init draws them (the IEF's
    output layers x0.01), biases and BatchNorm means zero, scales and
    variances one; then BatchNorm moved off those values."""
    rng = np.random.default_rng(seed)
    heads = ("decpose", "decshape", "deccam")

    def leaf(path, spec):
        name = path[-1].key
        if name == "kernel":
            scale = 1.0 / np.sqrt(np.prod(spec.shape[:-1]))
            if any(getattr(p, "key", None) in heads for p in path):
                scale *= 0.01
            return rng.standard_normal(spec.shape, dtype=np.float32) * np.float32(scale)
        return (np.ones if name in ("scale", "var") else np.zeros)(spec.shape, np.float32)

    return _perturb_bn(jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn)), seed)


def to_flax(port):
    """The port's state dict as a flax tree, through `weights.flax_path`."""
    tree = {}
    trunks = getattr(port, "trunk_names", ())
    for key, value in port.state_dict().items():
        if key.endswith("num_batches_tracked") or key.rsplit(".", 1)[-1].startswith("init_"):
            continue
        path, leaf, coll = flax_path(key, trunks)
        arr = value.numpy()
        if leaf == "kernel":
            arr = np.transpose(arr, (2, 3, 1, 0)) if arr.ndim == 4 else arr.T
        node = tree.setdefault(coll, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, spec, variables, port, port spec), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            jmodel, spec = j_build_model(name)
            zeros = tuple(jnp.zeros((1, RES, RES, CHANNELS.get(m, 1))) for m in spec.modalities)
            variables = jax_variables(lambda: jmodel.init(jax.random.PRNGKey(0), zeros), 0)
            if "cross_att" in variables["params"]:  # at zero the attention is the identity
                variables["params"]["cross_att"]["gamma"] = GAMMA[:len(spec.modalities)]
            port, port_spec = build_model(name, device="cpu")
            load_jax_variables(port, variables)
            cache[name] = jmodel, spec, variables, port, port_spec
        return cache[name]

    return get


def _assert_out_close(jout, tout, heads):
    np.testing.assert_allclose(tout.betas.numpy(), np.asarray(jout.betas), atol=2e-4)
    np.testing.assert_allclose(tout.cam.numpy(), np.asarray(jout.cam), atol=2e-4)
    np.testing.assert_allclose(tout.rotmat.numpy(), np.asarray(jout.rotmat), atol=5e-4)
    assert set(tout.recon) == set(jout.recon) == set(heads)
    for h in heads:
        np.testing.assert_allclose(tout.recon[h].numpy()[:, 0], np.asarray(jout.recon[h])[..., 0], atol=5e-4)


def test_cross_attention_matches_jax():
    r = np.random.default_rng(3)
    feats = [r.normal(0, 1, (B, 16, 7, 7)).astype(np.float32) for _ in range(3)]
    jatt = JCrossAttention()
    variables = jax.tree_util.tree_map(np.asarray, jatt.init(jax.random.PRNGKey(1), [nhwc(f) for f in feats]))
    variables["params"]["gamma"] = GAMMA[:3]
    holder = nn.Module()
    holder.cross_att = CrossAttention(16, 3)
    load_jax_variables(holder, {"params": {"cross_att": variables["params"]}})
    want = np.asarray(jatt.apply(variables, [nhwc(f) for f in feats]))
    with torch.no_grad():
        got = holder.cross_att([torch.from_numpy(f) for f in feats])
    assert got.shape == (B, 48, 7, 7)
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), want, rtol=1e-5, atol=1e-5)
    # Every map mixes in: the output is far from the identity it is at gamma = 0.
    assert np.abs(want - np.concatenate([np.transpose(f, (0, 2, 3, 1)) for f in feats], -1)).max() > 0.1


def test_self_attention_matches_jax():
    """B=2, C=16, 4x4, float32, the flax variables through the weight map
    and gamma 0.5 on both sides, so that the attention term counts: within
    atol 1e-5 (and rtol 1e-5) of the JAX module."""
    x = np.random.default_rng(5).normal(0, 1, (2, 16, 4, 4)).astype(np.float32)
    jatt = JSelfAttention()
    variables = jax.tree_util.tree_map(np.asarray, jatt.init(jax.random.PRNGKey(2), nhwc(x)))
    variables["params"]["gamma"] = np.array([0.5], np.float32)
    att = load_jax_variables(SelfAttention(16), variables)
    assert att.gamma.item() == 0.5
    want = np.asarray(jatt.apply(variables, nhwc(x)))
    with torch.no_grad():
        got = att(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), want, rtol=1e-5, atol=1e-5)
    assert np.abs(want - np.transpose(x, (0, 2, 3, 1))).max() > 0.1  # far from the identity


def test_self_attention_is_the_identity_at_init():
    att = SelfAttention(8)
    x = torch.randn(B, 8, 7, 7)
    assert torch.equal(att(x), x)


def test_cross_attention_is_the_identity_at_init():
    att = CrossAttention(8, 2)
    feats = [torch.randn(B, 8, 7, 7), torch.randn(B, 8, 7, 7)]
    assert torch.equal(att(feats), torch.cat(feats, dim=1))


@pytest.mark.parametrize("name", ["featcat", "featatt_cashmr"])
def test_multi_trunk_core_matches_jax(models, name):
    jmodel, spec, variables, port, _ = models(name)
    mods = modalities(spec, 1)
    jout = jmodel.apply(variables, tuple(nhwc(m) for m in mods))
    with torch.no_grad():
        tout = port(tuple(torch.from_numpy(m) for m in mods))
    _assert_out_close(jout, tout, spec.recon_heads)
    assert port.fc1.in_features == 2048 * len(spec.modalities) + 144 + 13


@pytest.mark.parametrize("name", ["featatt_cashmr", "ir_depth_featatt_cashmrV2"])
def test_inference_matches_jax(models, name):
    """The eval path with the cascade: ir_depth_featatt_cashmrV2 feeds its
    recovered ir and depth back into slots 0 and 1."""
    jmodel, spec, variables, port, port_spec = models(name)
    mods = modalities(spec, 2)
    jreg = load_j_regressor_h36m()
    jo = j_make_inference_fn(jmodel, spec, j_synthetic(0), j_regressor_h36m=jreg, num_cas_iters=2)(
        variables, tuple(nhwc(m) for m in mods))
    to = make_inference_fn(port, port_spec, synthetic_smpl_model(0, device="cpu"), jreg, num_cas_iters=2,
                           device="cpu")(mods)
    for k, tol in (("betas", 2e-4), ("cam", 2e-4), ("rotmat", 5e-4), ("vertices", 1e-3), ("keypoints_3d_17", 1e-3)):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=tol, err_msg=k)
    assert set(to["recon"]) == set(jo["recon"]) == set(spec.recon_heads)
    for h in spec.recon_heads:
        np.testing.assert_allclose(to["recon"][h].numpy()[:, 0], np.asarray(jo["recon"][h])[..., 0], atol=5e-4)


@pytest.mark.parametrize("name", ["featcat", "featcat_cashmr", "featatt_cashmr", "ir_depth_featatt_cashmrV2"])
def test_load_jax_variables_round_trip(models, name):
    """The JAX model's variables into the port and back, leaf for leaf.
    featcat_cashmr, which no other test here runs, takes the JAX tree's
    shapes filled with zeros (every leaf and every port entry still has to
    meet its counterpart): the values' layouts are the other names'."""
    if name == "featcat_cashmr":
        jmodel, spec = j_build_model(name)
        zeros = tuple(jnp.zeros((1, RES, RES, CHANNELS.get(m, 1))) for m in spec.modalities)
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), zeros))
        variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        port, _ = build_model(name, device="cpu")
        load_jax_variables(port, variables)
    else:
        _, _, variables, port, _ = models(name)
    back = to_flax(port)
    ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert len(got) == len(ref)
    for path, value in ref:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], value)


def test_two_trunks_map_in_feed_order(models):
    """ir_depth_featatt_cashmrV2 feeds (ir, depth): its trunks are flax's
    trunk0 and trunk1, not the rgb/ir/depth/pm table's trunk1 and trunk2."""
    _, _, variables, port, _ = models("ir_depth_featatt_cashmrV2")
    assert port.trunk_names == ("ir", "depth")
    assert flax_path("feat_extraction_ir.conv1.weight", port.trunk_names) == (("trunk0", "conv1"), "kernel", "params")
    assert flax_path("feat_extraction_depth.layer4.2.bn3.running_var", port.trunk_names) == (
        ("trunk1", "layer4", "block2", "bn3"), "var", "batch_stats")
    assert flax_path("feat_extraction_pm.conv1.weight", port.trunk_names) is None
    for name, trunk in (("ir", "trunk0"), ("depth", "trunk1")):
        want = np.transpose(variables["params"][trunk]["conv1"]["kernel"], (3, 2, 0, 1))
        np.testing.assert_array_equal(getattr(port, f"feat_extraction_{name}").conv1.weight.detach().numpy(), want)
    assert {k.split(".")[0] for k in port.state_dict()} >= {"feat_extraction_ir", "feat_extraction_depth", "cross_att",
                                                            "Reconstruct_depth", "Reconstruct_ir"}


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


def train_batch(keys, seed):
    """A batch of the keys one step reads, NCHW images."""
    r = np.random.default_rng(seed)
    batch = {k: r.normal(0, 1, (B, CHANNELS.get(k, 1), RES, RES)).astype(np.float32)
             for k in keys if k.endswith(("img", "_uncover"))}
    if "mask_uncover" in batch:
        batch["mask_uncover"] = (r.uniform(0, 1, (B, 1, RES, RES)) > 0.5).astype(np.float32)
    batch.update({
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
    assert set(batch) == set(keys) - {"pixel_noise"}
    return batch


def test_port_step_trains_featatt_cashmr():
    """One step of the port alone: a finite loss, the trunks, decoder, head
    and attention gains move, and so do the BatchNorm statistics.  At their
    zero init the gains stop the gradient of the query, key and value convs,
    so those stay (with the mean-parameter buffers)."""
    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.train import init_train_state, make_train_step, step_feed_keys

    torch.manual_seed(0)
    model, spec = build_model("featatt_cashmr", device="cpu")
    state = init_train_state(model, Opt(), np.zeros((16, 82), np.float32), seed=1, device="cpu")
    step = make_train_step(model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                           Opt(), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = step(state, train_batch(step_feed_keys(spec), 5))
    assert state.step == 1 and all(bool(torch.isfinite(v)) for v in metrics.values())
    after = model.state_dict()
    still = {k for k, v in before.items() if torch.equal(v, after[k]) and not k.endswith("num_batches_tracked")}
    assert still == {f"cross_att.{c}_conv.{w}" for c in ("query", "key", "value") for w in ("weight", "bias")} | {
        "init_pose", "init_shape", "init_cam"}


@pytest.mark.slow
def test_step_matches_jax_featatt_cashmr(models):
    """The port's step against the JAX step on the same weights and batch,
    SMPLify and dropout off, 2 passes without the depth feedback: the loss
    and its parts within 1e-4 (measured up to 2.8e-5), the new BatchNorm
    statistics within 1e-3 + 1e-3 |v| (measured up to 1.5e-4).  The
    decoder's first level reduces 8192 fused channels over 2x2 pixels:
    there, with JAX's own init values, JAX's float32 statistics sat up to
    5.4e-4 from the port's float64 ones and the port's float32 ones 8.3e-5.

    Through the feedback this step is too ill-conditioned at RES 64, batch
    2 for a comparison in float32: pass 2 amplifies the rounding of pass
    1's recovered depth about 40-fold, and JAX's float32 step lands 6.5e-4
    (relative) from the port's float64 step on the loss, 2.8% on
    loss_shape, where the port's float32 step lands 8e-6 from it.
    """
    import dataclasses

    import inbed_pose_estimation_tpu.models.hmr as jhmr
    from inbed_pose_estimation_tpu.fitting import synthetic_gmm_prior as j_prior
    from inbed_pose_estimation_tpu.models.heads import IEFHead
    from inbed_pose_estimation_tpu.train.trainer import make_train_step as j_make_train_step
    from inbed_pose_estimation_tpu.train.trainer import step_feed_keys as j_step_feed_keys
    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.train import init_train_state, make_train_step, step_feed_keys

    _, _, variables, _, _ = models("featatt_cashmr")
    fits = np.random.default_rng(11).normal(0, 0.2, (16, 82)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
    try:
        jmodel, jspec = j_build_model("featatt_cashmr")
        batch = train_batch(j_step_feed_keys(jspec), 6)
        jbatch = {k: nhwc(v) if v.ndim == 4 else jnp.asarray(v) for k, v in batch.items()}
        loss_fn = j_make_train_step(jmodel, dataclasses.replace(jspec, cascade_feed_map=()), j_synthetic(0),
                                    j_prior(), Opt())[0]._loss_fn
        loss, (jstats, _, jmetrics) = jax.jit(loss_fn)(variables["params"], variables["batch_stats"],
                                                       jnp.asarray(fits), jbatch, jax.random.PRNGKey(3))
    finally:
        mp.undo()
    port, spec = build_model("featatt_cashmr", device="cpu", dropout_rate=0.0)
    load_jax_variables(port, variables)
    assert step_feed_keys(spec) == j_step_feed_keys(jspec)
    state = init_train_state(port, Opt(), fits, device="cpu")
    step = make_train_step(port, dataclasses.replace(spec, cascade_feed_map=()), synthetic_smpl_model(0, device="cpu"),
                           synthetic_gmm_prior(device="cpu"), Opt(), device="cpu")
    state, metrics = step(state, batch)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-4)
    for k, v in jmetrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-4), k
    got = to_flax(port)["batch_stats"]
    want = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jstats))[0]
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(got) == len(want)
    for path, v in want:
        np.testing.assert_allclose(got[jax.tree_util.keystr(path)], v, rtol=1e-3, atol=1e-3)
