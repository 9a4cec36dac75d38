"""PyTorch port, the cashmrV2 training step against the JAX package's on
the CPU: the same weights, batch and fits store (RES 64, batch 2, 2-pass
cascade, dropout off in both), compared on the loss and its parts, every
gradient leaf and the new BatchNorm statistics; then the port's step with
SMPLify in the loop."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu.fitting import synthetic_gmm_prior as j_prior
from inbed_pose_estimation_tpu.models import build_model as j_build_model
from inbed_pose_estimation_tpu.models.heads import IEFHead
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
from inbed_pose_estimation_tpu.train.checkpoint import convert_torch_state_dict
from inbed_pose_estimation_tpu.train.trainer import make_train_step as j_make_train_step
from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import build_model
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.train import init_train_state, make_train_step, step_feed_keys
from inbed_pose_estimation_tpu_torch.weights import load_jax_variables

RES, B, N_FITS = 64, 2, 16
IMAGE_KEYS = ("img", "ir_img", "depth_img", "pm_img", "depth_img_uncover")


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


def _batch(seed):
    """NCHW images for the port; the JAX step takes them NHWC."""
    r = np.random.default_rng(seed)
    batch = {k: r.normal(0, 1, (B, 3 if k == "img" else 1, RES, RES)).astype(np.float32) for k in IMAGE_KEYS}
    batch.update({
        "keypoints": np.concatenate([r.uniform(-1, 1, (B, 49, 2)), np.ones((B, 49, 1))], -1).astype(np.float32),
        "pose": r.normal(0, 0.2, (B, 72)).astype(np.float32),
        "betas": r.normal(0, 0.5, (B, 10)).astype(np.float32),
        "pose_3d": np.concatenate([r.normal(0, 0.3, (B, 24, 3)), np.ones((B, 24, 1))], -1).astype(np.float32),
        "has_smpl": np.array([1.0, 0.0], np.float32),  # one sample from the ground truth, one from the fits
        "has_pose_3d": np.ones(B, np.float32),
        "is_flipped": np.array([0.0, 1.0], np.float32),
        "rot_angle": np.array([0.0, 15.0], np.float32),
        "sample_index": np.array([3, 7], np.int32),
    })
    return batch


def _nhwc(batch):
    return {k: jnp.asarray(np.transpose(v, (0, 2, 3, 1)) if k in IMAGE_KEYS else v) for k, v in batch.items()}


def _fits():
    return np.random.default_rng(11).normal(0, 0.2, (N_FITS, 82)).astype(np.float32)


def _perturb_bn_stats(variables, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda v: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32), variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: np.abs(v) + 0.5 if p[-1].key == "var" else v, stats)
    return {"params": variables["params"], "batch_stats": stats}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# The full step (2 passes) as cashmrV2 trains, and with the depth feedback
# cut (both passes see the same input).  Through the feedback the second
# pass reads the first pass's recovered depth, whose float32 rounding
# (about 2e-4 of values near 4.6 at RES 64) it carries into everything
# after; without it the step is as well conditioned as one pass.
CASES = {"two_pass": (("depth", 2),), "two_pass_no_feedback": ()}


@pytest.fixture(scope="module")
def runs():
    """run(side, case): the JAX step ("jax") or the port's ("f32", "f64"),
    each computed once per module."""
    import dataclasses

    import inbed_pose_estimation_tpu.models.hmr as jhmr

    cache = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
    jmodel, jspec = j_build_model("cashmrV2")
    mp.undo()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 6)))
    variables = _perturb_bn_stats(jax.tree_util.tree_map(np.asarray, variables), 1)

    def jax_run(case):
        mp.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
        try:
            spec = dataclasses.replace(jspec, cascade_feed_map=CASES[case])
            loss_fn = j_make_train_step(jmodel, spec, j_synthetic(0), j_prior(), Opt())[0]._loss_fn
            args = (variables["params"], variables["batch_stats"], jnp.asarray(_fits()), _nhwc(_batch(0)),
                    jax.random.PRNGKey(3))
            (loss, (bs, fits, metrics)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(*args)
        finally:
            mp.undo()
        return {"loss": float(loss), "batch_stats": _flat(bs), "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": _flat(grads), "fits": np.asarray(fits)}

    def port_run(case, dtype):
        model, spec = build_model("cashmrV2", device="cpu", dropout_rate=0.0)
        load_jax_variables(model, variables)
        model.to(dtype)
        spec = dataclasses.replace(spec, cascade_feed_map=CASES[case])
        state = init_train_state(model, Opt(), _fits(), device="cpu")
        prior = synthetic_gmm_prior(device="cpu")
        step = make_train_step(model, spec, synthetic_smpl_model(0, device="cpu").to(dtype),
                               type(prior)(*(t.to(dtype) for t in prior)), Opt(), device="cpu")
        batch = _batch(0)
        assert set(batch) == step_feed_keys(spec) - {"pixel_noise"}  # the float feed
        state, metrics = step(state, batch)
        grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
        return {"state": state, "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": _flat(convert_torch_state_dict(grads, on_unmapped="raise")["params"]),
                "batch_stats": _flat(convert_torch_state_dict(model.state_dict())["batch_stats"])}

    def run(side, case):
        if (side, case) not in cache:
            cache[side, case] = jax_run(case) if side == "jax" else port_run(case, getattr(torch, f"float{side[1:]}"))
        return cache[side, case]

    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_loss_and_metrics_match_jax(runs, case):
    ref, got = runs("jax", case), runs("f32", case)
    assert got["state"].step == 1
    # Through the feedback: measured up to 2.6e-4 (loss_regr_pose); without
    # it up to 1.1e-5.
    rel = 1e-4 if case == "two_pass_no_feedback" else 1e-3
    assert got["metrics"]["loss"] == pytest.approx(ref["loss"], rel=rel)
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=rel), k
    np.testing.assert_array_equal(got["state"].fits.numpy(), ref["fits"])  # no SMPLify: the store is unchanged


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_batch_stats_match_jax(runs, case):
    """Two train-mode passes update the running statistics twice, as the JAX
    step threads its batch_stats through both stages.  Bounds: measured up
    to 9e-5 (a layer4 variance near 2) without the feedback, 1.1e-3 with it."""
    ref, got = runs("jax", case)["batch_stats"], runs("f32", case)["batch_stats"]
    assert set(got) == set(ref)
    tol = 5e-5 if case == "two_pass_no_feedback" else 3e-3
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=k)


def _grad_err_over_float32_err(runs, case):
    """Per gradient leaf, through the reference names: the port's float32
    distance to JAX over float32's own error (the port's float32-to-float64
    distance plus 1e-4 of the leaf's norm)."""
    ref, g32, g64 = runs("jax", case)["grads"], runs("f32", case)["grads"], runs("f64", case)["grads"]
    assert set(g32) == set(ref) == set(g64) and len(g32) > 200
    return {k: np.linalg.norm(g32[k] - r) / (np.linalg.norm(g32[k] - g64[k]) + 1e-4 * np.linalg.norm(g64[k]))
            for k, r in ref.items()}


def test_step_gradients_match_jax(runs):
    """Gradients of the step without the feedback, leaf by leaf.

    float32 cannot give this step's gradient to 1e-3 of each leaf's largest
    |g|: behind a train-mode BatchNorm over 8-32 values per channel (RES 64,
    batch 2) the gradient is a small remainder of cancelling terms, and the
    port's own float32 step differs from its float64 step by up to 2.6% of
    a leaf's norm.  So each leaf is held to that yardstick: its distance to
    JAX within 3x float32's own error (measured: at most 1.6x).  The leaves
    that no BatchNorm follows (the IEF head, the decoder's projection) are
    also held to 1e-3 of their largest |g|.
    """
    case = "two_pass_no_feedback"
    ratios = _grad_err_over_float32_err(runs, case)
    for k, ratio in ratios.items():
        assert ratio <= 3, (k, ratio)
    ref, g32 = runs("jax", case)["grads"], runs("f32", case)["grads"]
    for k, r in ref.items():
        if "['head']" in k or "['proj']" in k:
            np.testing.assert_allclose(g32[k], r, rtol=0, atol=1e-3 * np.abs(r).max(), err_msg=k)


def test_step_gradients_through_feedback_match_jax(runs):
    """Gradients of the step as cashmrV2 trains, with pass 1's recovered
    depth fed into pass 2, so the gradient also flows back through that
    depth into pass 1: each leaf within 3x float32's own error, as without
    the feedback."""
    ratios = _grad_err_over_float32_err(runs, "two_pass")
    for k, ratio in ratios.items():
        assert ratio <= 3, (k, ratio)


def test_step_with_smplify_changes_fits():
    """The port's step with SMPLify in the loop (2 Adam steps per stage):
    a finite loss, and the fits of the batch's rows improve."""
    model, spec = build_model("cashmrV2", device="cpu")

    class OptS(Opt):
        run_smplify = True

    torch.manual_seed(0)
    state = init_train_state(model, OptS(), np.zeros((N_FITS, 82), np.float32), seed=1, device="cpu")
    step = make_train_step(model, spec, synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu"),
                           OptS(), device="cpu")
    batch = _batch(1)
    batch["has_smpl"] = np.zeros(B, np.float32)
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = step(state, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    rows = batch["sample_index"]
    assert not torch.equal(state.fits[rows], torch.zeros(B, 82))
    others = np.setdiff1d(np.arange(N_FITS), rows)
    assert torch.equal(state.fits[others], torch.zeros(len(others), 82))
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_step_rejects_other_input_modes():
    """Every input mode trains, Bodies-At-Rest too (in its modes "0" and
    "1"); a Bodies-At-Rest mode other than those is rejected."""
    model, spec = build_model("bodiesAtRest", device="cpu", img_res=RES)
    smpl, prior = synthetic_smpl_model(0, device="cpu"), synthetic_gmm_prior(device="cpu")
    with pytest.raises(ValueError, match="bar_mode"):
        make_train_step(model, spec, smpl, prior, Opt(), device="cpu", bar_mode="2")
    torch.manual_seed(0)
    state = init_train_state(model, Opt(), np.zeros((N_FITS, 82), np.float32), seed=1, device="cpu")
    r = np.random.default_rng(4)
    batch = {k: v for k, v in _batch(4).items() if k in step_feed_keys(spec)}
    batch["pm_contact"] = r.uniform(0, 1, (B, 2, RES, RES)).astype(np.float32)
    batch["mask_uncover"] = (r.uniform(0, 1, (B, 1, RES, RES)) > 0.5).astype(np.float32)
    before = [p.detach().clone() for p in model.parameters()]
    for mode in "01":
        state, metrics = make_train_step(model, spec, smpl, prior, Opt(), device="cpu", bar_mode=mode)(state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert state.step == 2 and all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


@pytest.mark.slow
def test_step_with_smplify_matches_jax():
    """The whole step with SMPLify in the loop (2 Adam steps per stage),
    against JAX, without the depth feedback (see CASES): loss, metrics and
    the new fits store.  Slow: the JAX side compiles SMPLify inside the step."""
    import dataclasses

    import inbed_pose_estimation_tpu.models.hmr as jhmr

    class OptS(Opt):
        run_smplify = True

    batch = _batch(2)
    batch["has_smpl"] = np.zeros(B, np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jhmr, "IEFHead", functools.partial(IEFHead, dropout_rate=0.0))
    try:
        model, spec = j_build_model("cashmrV2")
        variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0),
                                                                           jnp.zeros((1, RES, RES, 6))))
        step_fn, _ = j_make_train_step(model, dataclasses.replace(spec, cascade_feed_map=()), j_synthetic(0),
                                       j_prior(), OptS())
        loss, (_, jfits, jmetrics) = jax.jit(step_fn._loss_fn)(variables["params"], variables["batch_stats"],
                                                               jnp.asarray(_fits()), _nhwc(batch),
                                                               jax.random.PRNGKey(3))
    finally:
        mp.undo()
    port, pspec = build_model("cashmrV2", device="cpu", dropout_rate=0.0)
    load_jax_variables(port, variables)
    state = init_train_state(port, OptS(), _fits(), device="cpu")
    step = make_train_step(port, dataclasses.replace(pspec, cascade_feed_map=()), synthetic_smpl_model(0, device="cpu"),
                           synthetic_gmm_prior(device="cpu"), OptS(), device="cpu")
    state, metrics = step(state, batch)
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-4)
    for k, v in jmetrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-4), k
    assert not np.array_equal(np.asarray(jfits), _fits())
    np.testing.assert_allclose(state.fits.numpy(), np.asarray(jfits), atol=1e-4)
