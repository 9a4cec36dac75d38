"""PyTorch port, training pieces: the train losses, the fits store, the
options, train-mode BatchNorm and dropout, and Adam state carried over
from optax, against the JAX package on the CPU on the same seeded inputs
and weights (RES 64, batch 2)."""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.models.heads import IEFHead
from inbed_pose_estimation_tpu.train import fits_dict as jfits
from inbed_pose_estimation_tpu.train import losses as jL
from inbed_pose_estimation_tpu.train.checkpoint import convert_torch_state_dict
from inbed_pose_estimation_tpu.train.options import build_parser as j_build_parser
from inbed_pose_estimation_tpu.train.trainer import TrainState as JTrainState
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.models.backbone import BatchNorm2d
from inbed_pose_estimation_tpu_torch.models.heads import dropout
from inbed_pose_estimation_tpu_torch.train import (
    FitsStore, build_parser, fits_get, fits_set, parse_args, train_state_from_jax,
)
from inbed_pose_estimation_tpu_torch.train import losses as tL
from inbed_pose_estimation_tpu_torch.weights import flax_path, load_jax_adam_state, load_jax_variables
from torch_threads import one_torch_thread  # noqa: F401

RES, B = 64, 2


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _loss_inputs(seed):
    r = np.random.default_rng(seed)
    return {
        "kp2d": r.uniform(-1, 1, (4, 49, 2)).astype(np.float32),
        "gt_kp2d": np.concatenate([r.uniform(-1, 1, (4, 49, 2)), r.uniform(0, 1, (4, 49, 1))], -1).astype(np.float32),
        "kp3d": r.normal(0, 0.3, (4, 49, 3)).astype(np.float32),
        "gt_kp3d": np.concatenate([r.normal(0, 0.3, (4, 24, 3)), r.uniform(0, 1, (4, 24, 1))], -1).astype(np.float32),
        "mask": np.array([1, 0, 1, 1], np.float32),
        "none": np.zeros(4, np.float32),
        "verts": r.normal(0, 0.3, (4, 50, 3)).astype(np.float32),
        "verts2": r.normal(0, 0.3, (4, 50, 3)).astype(np.float32),
        "rotmat": r.normal(0, 0.5, (4, 24, 3, 3)).astype(np.float32),
        "betas": r.normal(0, 1, (4, 10)).astype(np.float32),
        "pose": r.normal(0, 0.3, (4, 72)).astype(np.float32),
        "betas2": r.normal(0, 1, (4, 10)).astype(np.float32),
        "img": r.normal(0, 1, (4, 1, 8, 8)).astype(np.float32),
        "img2": r.normal(0, 1, (4, 1, 8, 8)).astype(np.float32),
        "img_mask": (r.uniform(0, 1, (4, 1, 8, 8)) > 0.5).astype(np.float32),
        "cam": r.normal(0.5, 0.3, (4, 3)).astype(np.float32),
    }


LOSSES = {
    "keypoint_loss": (("kp2d", "gt_kp2d"), (0.3, 1.0)),
    "keypoint_3d_loss": (("kp3d", "gt_kp3d", "mask"), ()),
    "keypoint_3d_loss_no_rows": (("kp3d", "gt_kp3d", "none"), ()),
    "shape_loss": (("verts", "verts2", "mask"), ()),
    "smpl_losses": (("rotmat", "betas", "pose", "betas2", "mask"), ()),
    "recon_l1_loss": (("img", "img2"), ()),
    "recon_l1_loss_masked": (("img", "img2", "img_mask"), ()),
    "camera_scale_regularizer": (("cam",), ()),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_train_loss_matches_jax(name):
    keys, extra = LOSSES[name]
    fn = name.replace("_no_rows", "").replace("_masked", "")
    x = _loss_inputs(0)
    arrays = [x[k] for k in keys]
    ref = getattr(jL, fn)(*_j(*arrays), *extra)
    got = getattr(tL, fn)(*_t(*arrays), *extra)
    for r, g in zip(np.atleast_1d(ref) if fn != "smpl_losses" else ref, [got] if fn != "smpl_losses" else got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-5, atol=1e-7)


def _fits_case(seed):
    r = np.random.default_rng(seed)
    fits = r.normal(0, 0.3, (8, 82)).astype(np.float32)
    idx = np.array([1, 3, 5, 6], np.int64)
    rot = np.array([10.0, -20.0, 0.0, 90.0], np.float32)
    flip = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    return fits, idx, rot, flip


def test_fits_get_matches_jax():
    fits, idx, rot, flip = _fits_case(1)
    jp, jb = jfits.fits_get(*_j(fits, idx.astype(np.int32), rot, flip))
    tp, tb = fits_get(*_t(fits, idx, rot, flip))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_fits_set_matches_jax():
    fits, idx, rot, flip = _fits_case(2)
    r = np.random.default_rng(3)
    pose = r.normal(0, 0.3, (4, 72)).astype(np.float32)
    betas = r.normal(0, 0.3, (4, 10)).astype(np.float32)
    update = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    ref = np.asarray(jfits.fits_set(*_j(fits, idx.astype(np.int32), rot, flip, update, pose, betas)))
    tf = torch.from_numpy(fits.copy())
    got = fits_set(tf, *_t(idx, rot, flip, update, pose, betas))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[3], fits[3])  # update 0 keeps the row
    np.testing.assert_array_equal(tf.numpy(), fits)  # the old store is left as it was


def test_fits_get_set_roundtrip():
    """The round trip of tests/test_train_step.py::test_fits_get_set_roundtrip."""
    fits = np.random.default_rng(0).normal(0, 0.3, (8, 82)).astype(np.float32)
    idx = np.array([1, 3, 5])
    rot, flip = np.array([10.0, -20.0, 0.0], np.float32), np.array([1.0, 0.0, 1.0], np.float32)
    tfits = torch.from_numpy(fits)
    pose, betas = fits_get(tfits, *_t(idx, rot, flip))
    back = fits_set(tfits, *_t(idx, rot, flip), torch.ones(3), pose, betas)
    np.testing.assert_allclose(back.numpy(), fits, atol=1e-4)


def test_fits_store_layout_and_files(tmp_path):
    static = tmp_path / "static"
    static.mkdir()
    seed_rows = np.random.default_rng(4).normal(0, 1, (3, 82)).astype(np.float32)
    np.save(static / "b_fits.npy", seed_rows)
    store = FitsStore([("a", 2), ("b", 3)], checkpoint_dir=str(tmp_path / "ckpt"), static_fits_dir=str(static),
                      device="cpu")
    assert store.offsets == {"a": 0, "b": 2} and store.num_rows == 5
    np.testing.assert_array_equal(store.array[2:].numpy(), seed_rows)
    np.testing.assert_array_equal(store.array[:2].numpy(), 0.0)
    store.array = store.array + 1.0
    store.save()
    again = FitsStore([("a", 2), ("b", 3)], checkpoint_dir=str(tmp_path / "ckpt"), device="cpu")
    np.testing.assert_array_equal(again.array.numpy(), store.array.numpy())
    with pytest.raises(ValueError, match="rows"):
        FitsStore("b", 4, static_fits_dir=str(static), device="cpu")


STEP_OPTIONS = {"lr", "img_res", "num_cas_iters", "run_smplify", "num_smplify_iters", "smplify_threshold",
                "shape_loss_weight", "keypoint_loss_weight", "beta_loss_weight", "openpose_train_weight",
                "gt_train_weight"}


def test_options_match_jax():
    """Every option of the JAX parser, with its name and default, and the
    same value when set; the port adds only --device."""
    port = vars(build_parser().parse_args(["--name", "x"]))
    ref = vars(j_build_parser().parse_args(["--name", "x"]))
    assert STEP_OPTIONS <= set(port) and set(port) == set(ref) | {"device"} and port["device"] == "cuda"
    assert {k: v for k, v in port.items() if k != "device"} == ref
    args = ["--lr", "1e-4", "--img_res", "64", "--num_smplify_iters", "3", "--run_smplify", "--batch_size", "2",
            "--no-uint8_feed", "--no_shuffle_train", "--num_epochs", "3"]
    assert {k: v for k, v in vars(build_parser().parse_args(["--name", "x"] + args)).items() if k != "device"} == \
        vars(j_build_parser().parse_args(["--name", "x"] + args))


@pytest.mark.parametrize("arg", ["--dtype=bfloat16", "--remat", "--crop_cache=x", "--fast_preprocess"])
def test_options_reject_what_the_port_does_not_implement(arg, tmp_path):
    """Every option is ported now and passes through parse_args into
    config.json: bfloat16, --remat (bare: "stage"), --crop_cache and
    --fast_preprocess, with the Bodies-At-Rest names."""
    argv = ["--name", "x", "--log_dir", str(tmp_path), arg]
    args = parse_args(argv + ["--model", "bodiesAtRest4mod"])
    want = {"dtype": "bfloat16" if arg == "--dtype=bfloat16" else "float32",
            "remat": "stage" if arg == "--remat" else False,
            "crop_cache": "x" if arg.startswith("--crop_cache") else None,
            "fast_preprocess": arg == "--fast_preprocess", "model": "bodiesAtRest4mod"}
    assert {k: getattr(args, k) for k in want} == want
    config = json.loads((tmp_path / "x" / "config.json").read_text())
    assert {k: config[k] for k in want} == want


def test_batchnorm_running_var_is_biased():
    """Train mode: batch-statistics normalization as torch's, running mean
    as torch's, running variance updated with the biased batch variance."""
    x = torch.from_numpy(np.random.default_rng(5).normal(1, 2, (2, 3, 2, 2)).astype(np.float32))
    bn, ref = BatchNorm2d(3), torch.nn.BatchNorm2d(3)
    for m in (bn, ref):
        m.running_var.fill_(0.7)
        m.running_mean.fill_(0.2)
    torch.testing.assert_close(bn(x), ref(x))
    torch.testing.assert_close(bn.running_mean, ref.running_mean)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * torch.full((3,), 0.7) + 0.1 * var)
    assert not torch.allclose(bn.running_var, ref.running_var)
    ref.running_var.copy_(bn.running_var)
    bn.eval()
    torch.testing.assert_close(bn(x), ref.eval()(x))  # eval mode is torch's


def test_dropout_draws_from_the_generator():
    x = torch.ones(4, 1024)
    a = dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = dropout(x, 0.5, torch.Generator().manual_seed(1))
    c = dropout(x, 0.5, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    assert 0.4 < (a == 0).float().mean().item() < 0.6
    assert dropout(x, 0.0, None) is x


def _perturb_bn(variables, seed):
    """BN leaves moved off their init values, so that a swapped or dropped
    leaf shows."""
    rng = np.random.default_rng(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.array(v, dtype=np.float32)
            if coll == "batch_stats":
                v = v + rng.normal(0, 0.1, v.shape).astype(np.float32) if k == "mean" else \
                    rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            out[k] = v
        return out

    return {coll: walk(variables[coll], coll) for coll in ("params", "batch_stats")}


def test_train_mode_forward_and_batch_stats_match_flax(monkeypatch):
    """One train-mode forward with dropout off in both packages: the outputs,
    and the running statistics against flax's new batch_stats.  This pins
    the biased-variance update and momentum 0.1 == flax 0.9: an unbiased
    update would be off by 0.1 var / (n - 1), above 3e-3 wherever the batch
    has at most 64 values per channel (layer4 and the decoder's first
    level), where the test's bound is below 1e-4."""
    import inbed_pose_estimation_tpu.models.hmr as jhmr

    monkeypatch.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
    model, _ = j_build_model("cashmrV2")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 6)))
    variables = _perturb_bn(jax.tree_util.tree_map(np.asarray, variables), 0)
    port, _ = build_model("cashmrV2", device="cpu", dropout_rate=0.0)
    load_jax_variables(port, variables)

    x = np.random.default_rng(6).normal(0, 1, (4, 6, RES, RES)).astype(np.float32)
    jout, mut = model.apply(variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))), train=True,
                            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
    port.train()
    tout = port(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tout.betas.detach().numpy(), np.asarray(jout.betas), atol=2e-4)
    np.testing.assert_allclose(tout.cam.detach().numpy(), np.asarray(jout.cam), atol=2e-4)
    np.testing.assert_allclose(tout.rotmat.detach().numpy(), np.asarray(jout.rotmat), atol=5e-4)
    np.testing.assert_allclose(tout.recon["depth"].detach().numpy()[:, 0], np.asarray(jout.recon["depth"])[..., 0],
                               atol=5e-4)
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(convert_torch_state_dict(port.state_dict())["batch_stats"])[0]}
    ref = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))[0]
    assert len(got) == len(ref) > 100
    # 1e-5 absolute, plus 3e-5 of the value: the batch variance of the
    # deepest layers (8-16 values per channel at RES 64) carries float32
    # reassociation of ~50 convolutions, measured up to 2.9e-5 on values
    # near 1.9; 1e-5 holds everywhere else.
    for p, v in ref:
        np.testing.assert_allclose(got[jax.tree_util.keystr(p)], v, rtol=3e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(p))


def _random_like(tree, rng, scale):
    return jax.tree_util.tree_map(lambda a: (rng.normal(0, scale, np.shape(a))).astype(np.float32), tree)


def test_adam_state_carried_from_optax():
    """optax Adam moments (nonzero mu and nu, count 2) loaded into the
    port's torch Adam: the same gradient then moves the parameters alike."""
    model, _ = j_build_model("hmr")
    variables = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = variables["params"]
    rng = np.random.default_rng(7)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)

    @jax.jit
    def adam_step(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(2):
        params, opt_state = adam_step(_random_like(params, rng, 1e-2), opt_state, params)
    g = _random_like(params, rng, 1e-2)
    want = jax.tree_util.tree_map(np.asarray, adam_step(g, opt_state, params)[0])

    port, _ = build_model("hmr", device="cpu")
    jstate = JTrainState(params=params, batch_stats=variables["batch_stats"], opt_state=opt_state,
                         fits=np.zeros((4, 82), np.float32), rng=jax.random.PRNGKey(0), step=np.int32(2))

    class Opt:
        lr = 1e-3

    state = train_state_from_jax(port, jstate, Opt(), device="cpu")
    assert state.step == 2 and state.model is port and port.training
    flat_g = {tuple(str(k.key) for k in p): v for p, v in jax.tree_util.tree_flatten_with_path(g)[0]}
    for key, p in port.named_parameters():
        path, leaf, _ = flax_path(key)
        arr = flat_g[path + (leaf,)]
        arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T if arr.ndim == 2 else arr
        p.grad = torch.from_numpy(np.ascontiguousarray(arr))
    state.optimizer.step()
    got = convert_torch_state_dict(port.state_dict(), on_unmapped="raise")["params"]
    ref = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat_got) == len(ref)
    for p, v in ref:
        # 1e-7, or one float32 ulp of the value: the last add p + update
        # may round apart in the two frameworks (BN scales sit near 1).
        np.testing.assert_allclose(flat_got[jax.tree_util.keystr(p)], v, rtol=2.0 ** -23, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(p))


def test_adam_state_rejects_a_missing_moment():
    model, _ = j_build_model("hmr")
    params = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))["params"]
    opt_state = optax.adam(1e-3).init(params)
    port, _ = build_model("hmr4mod", device="cpu")  # 6 input channels: the stem kernel's shape differs
    optimizer = torch.optim.Adam(port.parameters())
    with pytest.raises(ValueError, match="shape"):
        load_jax_adam_state(port, optimizer, opt_state)
    adam = opt_state[0]
    mu = {**adam.mu, "head": {k: v for k, v in adam.mu["head"].items() if k != "deccam"}}
    port, _ = build_model("hmr", device="cpu")
    with pytest.raises(ValueError, match="absent"):
        load_jax_adam_state(port, torch.optim.Adam(port.parameters()), adam._replace(mu=mu))
    with pytest.raises(ValueError, match="not in the optimizer"):
        load_jax_adam_state(port, torch.optim.Adam(list(port.parameters())[1:]), opt_state)
