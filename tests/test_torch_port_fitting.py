"""PyTorch port, fitting: the GMM prior, the SMPLify losses, the fitting
loss of given fits and the two-stage SMPLify against the JAX package on
the CPU, on the same seeded numpy inputs (B=2, 3 Adam steps per stage)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu import fitting as jfit
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
from inbed_pose_estimation_tpu_torch import fitting as tfit
from inbed_pose_estimation_tpu_torch.ops import skinning as sk
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from torch_threads import one_torch_thread  # noqa: F401

B, RES, N_ITERS = 2, 64, 3
RTOL = 1e-5


@pytest.fixture(scope="module")
def priors():
    return jfit.synthetic_gmm_prior(), tfit.synthetic_gmm_prior(device="cpu")


@pytest.fixture(scope="module")
def smpl_pair():
    return j_synthetic(0), synthetic_smpl_model(0, device="cpu")


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_synthetic_prior_equals_jax(priors):
    jp, tp = priors
    for name in ("means", "precisions", "nll_weights"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    assert tfit.load_gmm_prior(None, device="cpu").means.shape == (8, 69)


def test_max_mixture_nll_matches_jax(priors):
    jp, tp = priors
    pose = np.random.default_rng(0).normal(0, 0.4, (4, 69)).astype(np.float32)
    pose[0] = np.asarray(jp.means[3])  # at a component's mean
    ref = np.asarray(jfit.max_mixture_nll(jp, jnp.asarray(pose)))
    np.testing.assert_allclose(tfit.max_mixture_nll(tp, torch.from_numpy(pose)).numpy(), ref, rtol=RTOL)


def test_gmof_and_angle_prior_match_jax():
    x = np.random.default_rng(1).normal(0, 200, (3, 49, 2)).astype(np.float32)
    ref = np.asarray(jfit.gmof(jnp.asarray(x), 100.0))
    np.testing.assert_allclose(tfit.gmof(torch.from_numpy(x), 100.0).numpy(), ref, rtol=RTOL)
    pose = np.random.default_rng(2).normal(0, 0.5, (3, 69)).astype(np.float32)
    np.testing.assert_allclose(tfit.angle_prior(torch.from_numpy(pose)).numpy(),
                               np.asarray(jfit.angle_prior(jnp.asarray(pose))), rtol=RTOL)


def _fit_problem(seed):
    rng = np.random.default_rng(seed)
    body_pose = rng.normal(0, 0.3, (B, 69)).astype(np.float32)
    betas = rng.normal(0, 0.5, (B, 10)).astype(np.float32)
    joints = rng.normal(0, 0.4, (B, 49, 3)).astype(np.float32)
    cam_t = np.concatenate([rng.normal(0, 0.1, (B, 2)), rng.uniform(40, 60, (B, 1))], -1).astype(np.float32)
    cc = np.full((B, 2), RES / 2, np.float32)
    j2d = rng.uniform(0, RES, (B, 49, 2)).astype(np.float32)
    conf = rng.uniform(0, 1, (B, 49)).astype(np.float32)
    return body_pose, betas, joints, cam_t, cc, j2d, conf


@pytest.mark.parametrize("output", ["sum", "reprojection"])
def test_body_fitting_loss_matches_jax(priors, output):
    jp, tp = priors
    args = _fit_problem(3)
    ref = np.asarray(jfit.body_fitting_loss(*_j(*args), jp, output=output))
    got = tfit.body_fitting_loss(*_t(*args), tp, output=output).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("op_valid", [True, False])
def test_camera_fitting_loss_matches_jax(op_valid):
    _, _, joints, cam_t, cc, j2d, conf = _fit_problem(4)
    conf[:, 9] = 1.0 if op_valid else 0.0  # OP RHip decides which torso joints count
    est = cam_t + np.float32(0.5)
    ref = np.asarray(jfit.camera_fitting_loss(*_j(joints, cam_t, est, cc, j2d, conf)))
    got = tfit.camera_fitting_loss(*_t(joints, cam_t, est, cc, j2d, conf)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def _smplify_inputs(seed):
    rng = np.random.default_rng(seed)
    pose = rng.normal(0, 0.2, (B, 72)).astype(np.float32)
    betas = rng.normal(0, 0.3, (B, 10)).astype(np.float32)
    cam_t = np.concatenate([rng.normal(0, 0.05, (B, 2)), rng.uniform(40, 50, (B, 1))], -1).astype(np.float32)
    cc = np.full((B, 2), RES / 2, np.float32)
    kp = np.concatenate([rng.uniform(0, RES, (B, 49, 2)), rng.uniform(0.5, 1, (B, 49, 1))], -1).astype(np.float32)
    return pose, betas, cam_t, cc, kp


def test_fitting_loss_matches_jax_and_keeps_confidence(smpl_pair, priors):
    (jm, tm), (jp, tp) = smpl_pair, priors
    args = _smplify_inputs(5)
    ref = np.asarray(jfit.make_fitting_loss(jm, jp)(*_j(*args)))
    targs = _t(*args)
    conf_before = targs[-1][:, :, 2].clone()
    got = tfit.make_fitting_loss(tm, tp)(*targs).numpy()
    assert got.shape == (B, 49)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert torch.equal(targs[-1][:, :, 2], conf_before)


@pytest.fixture(scope="module")
def smplify_pair(smpl_pair, priors):
    (jm, tm), (jp, tp) = smpl_pair, priors
    args = _smplify_inputs(6)
    jres = jax.jit(jfit.make_smplify(jm, jp, step_size=1e-2, num_iters=N_ITERS))(*_j(*args))
    return jres, tfit.make_smplify(tm, tp, step_size=1e-2, num_iters=N_ITERS), args


def test_smplify_matches_jax(smplify_pair):
    jres, smplify, args = smplify_pair
    before = sk.launches
    tres = smplify(*_t(*args))
    assert sk.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    np.testing.assert_allclose(tres.betas.numpy(), np.asarray(jres.betas), atol=1e-4)
    np.testing.assert_allclose(tres.camera_translation.numpy(), np.asarray(jres.camera_translation), atol=1e-3)
    np.testing.assert_allclose(tres.reprojection_loss.numpy(), np.asarray(jres.reprojection_loss), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jres.reprojection_loss)).max())
    np.testing.assert_allclose(tres.vertices.numpy(), np.asarray(jres.vertices), atol=1e-4)
    np.testing.assert_allclose(tres.joints.numpy(), np.asarray(jres.joints), atol=1e-4)
    # It moved off its start.
    assert not np.allclose(tres.pose.numpy(), args[0])


def test_smplify_under_no_grad_leaves_no_grad_behind(smplify_pair):
    """The fit takes its own gradients: a caller's no_grad does not stop it,
    and it writes no `.grad` and keeps no graph on what it returns."""
    jres, smplify, args = smplify_pair
    targs = [t.requires_grad_(True) for t in _t(*args)]
    with torch.no_grad():
        tres = smplify(*targs)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    assert all(t.grad is None for t in targs)
    assert not any(t.requires_grad for t in tres)


def test_smplify_skin_argument_reaches_lbs(smpl_pair, priors):
    """`skin=` is the skinning every SMPL forward of the fit uses: 2N + 1 calls."""
    (_, tm), (_, tp) = smpl_pair, priors
    calls = []

    def counting_skin(*a):
        calls.append(1)
        return sk.skinning_reference(*a)

    tfit.make_smplify(tm, tp, num_iters=2, skin=counting_skin)(*_t(*_smplify_inputs(7)))
    assert len(calls) == 2 * 2 + 1


def test_adam_matches_optax():
    """The fit's functional Adam against optax.adam(1e-2) on a quadratic."""
    import optax

    rng = np.random.default_rng(8)
    target = rng.normal(0, 1, (3, 5)).astype(np.float32)
    x0 = rng.normal(0, 1, (3, 5)).astype(np.float32)

    def jloss(x):
        return jnp.sum((x - target) ** 4)

    tx = optax.adam(1e-2, b1=0.9, b2=0.999)
    x, state = jnp.asarray(x0), tx.init(jnp.asarray(x0))
    for _ in range(5):
        updates, state = tx.update(jax.grad(jloss)(x), state, x)
        x = optax.apply_updates(x, updates)
    (got,) = tfit.adam(lambda y: torch.sum((y - torch.from_numpy(target)) ** 4), [torch.from_numpy(x0)], 1e-2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(x), atol=1e-6)
