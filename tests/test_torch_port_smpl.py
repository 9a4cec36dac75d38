"""PyTorch port, SMPL: synthetic assets, skinning (plain version and its
closed-form gradient) and LBS / smpl_forward against the JAX package on
the CPU, on the same seeded numpy inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from inbed_pose_estimation_tpu.geometry import batch_rodrigues as j_rodrigues
from inbed_pose_estimation_tpu.ops.pallas_lbs import skinning as j_skinning
from inbed_pose_estimation_tpu.smpl import lbs as j_lbs
from inbed_pose_estimation_tpu.smpl import mean_params as j_mean_params
from inbed_pose_estimation_tpu.smpl import smpl_forward as j_smpl_forward
from inbed_pose_estimation_tpu.smpl import synthetic_smpl_model as j_synthetic
from inbed_pose_estimation_tpu_torch.ops import skinning as sk
from inbed_pose_estimation_tpu_torch.smpl import (
    lbs,
    mean_params,
    smpl_forward,
    synthetic_smpl_model,
)
from torch_threads import one_torch_thread  # noqa: F401


def _skin_inputs(seed, B, V):
    rng = np.random.default_rng(seed)
    v_posed = rng.normal(0, 0.3, (B, V, 3)).astype(np.float32)
    W = rng.dirichlet(np.ones(24), size=V).astype(np.float32)
    aa = rng.normal(0, 0.4, (B * 24, 3)).astype(np.float32)
    A_rot = np.array(j_rodrigues(jnp.asarray(aa))).reshape(B, 24, 3, 3)
    A_t = rng.normal(0, 0.2, (B, 24, 3)).astype(np.float32)
    return v_posed, W, A_rot, A_t


@pytest.fixture(scope="module")
def smpl_pair():
    return j_synthetic(0), synthetic_smpl_model(0, device="cpu")


def test_synthetic_assets_equal_jax(smpl_pair):
    jm, tm = smpl_pair
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
                 "J_regressor_extra", "joint_map", "faces"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), err_msg=name)
    assert tm.parents == tuple(int(p) for p in jm.parents)


def test_mean_params_equal_jax():
    ref, got = j_mean_params(None), mean_params(None)
    for k in ("pose", "shape", "cam"):
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("B,V", [(2, 700), (5, 1000), (1, 1)])
def test_skinning_reference_matches_jax_pallas_interpret(B, V):
    """V not a multiple of the TPU kernel's 512 tile; B=5 not a multiple of
    the CUDA kernel's batch chunk; B=V=1 the smallest call."""
    v, W, R, t = _skin_inputs(0, B, V)
    ref = np.asarray(j_skinning(*(jnp.asarray(a) for a in (v, W, R, t)), interpret=True))
    args = [torch.from_numpy(a) for a in (v, W, R, t)]
    np.testing.assert_allclose(sk.skinning_reference(*args).numpy(), ref, atol=1e-5)
    # The public wrapper on CPU tensors is the plain version, and launches nothing.
    before = sk.launches
    np.testing.assert_allclose(sk.skinning(*args).numpy(), ref, atol=1e-5)
    assert sk.launches == before


def test_affine_strides_address_strided_views():
    """The kernel reads A_rot[b,j,m,n] at data + b*rb + j*rj + m*rm + n*rn and
    A_t[b,j,m] at data + b*tb + j*tj + m*tm, with the strides the wrapper
    passes: on the world[..., :3, :3] / world[..., :3, 3] views lbs hands
    over and on contiguous copies, that formula must give every element."""
    world = torch.arange(3 * 24 * 16, dtype=torch.float32).reshape(3, 24, 4, 4)
    flat = world.reshape(-1)
    views = (world[..., :3, :3], world[..., :3, 3])
    for R, t in (views, tuple(a.contiguous() for a in views)):
        rb, rj, rm, rn, tb, tj, tm = sk.affine_strides(R, t)
        b, j, m, n = np.meshgrid(*(np.arange(d) for d in R.shape), indexing="ij")
        r_src = R.reshape(-1) if R.is_contiguous() else flat[R.storage_offset():]
        t_src = t.reshape(-1) if t.is_contiguous() else flat[t.storage_offset():]
        np.testing.assert_array_equal(r_src.numpy()[b * rb + j * rj + m * rm + n * rn], R.numpy())
        np.testing.assert_array_equal(t_src.numpy()[b[..., 0] * tb + j[..., 0] * tj + m[..., 0] * tm], t.numpy())
    assert sk.affine_strides(*views) == (384, 16, 4, 1, 384, 16, 4)


@pytest.mark.parametrize("B", [1, 5, 32, 33, 64, 200])
@pytest.mark.parametrize("V", [1, 701, 6890])
def test_batch_chunk_fills_one_wave(B, V):
    """A power of two up to MAX_CHUNK: the smallest whose grid fits in one
    wave of two blocks per SM (or MAX_CHUNK when none does)."""
    c = sk.batch_chunk(B, V)
    assert 1 <= c <= sk.MAX_CHUNK and c & (c - 1) == 0
    tiles = -(-V // sk.TILE_VERTICES)
    assert c == sk.MAX_CHUNK or tiles * -(-B // c) <= 2 * sk.NUM_SMS
    assert c == 1 or tiles * -(-B // (c // 2)) > 2 * sk.NUM_SMS
    if (B, V) in ((32, 6890), (64, 6890)):
        assert tiles * -(-B // c) == 256  # 124 SMs run two blocks, none three


def test_skinning_backward_matches_jax_vjp():
    """The autograd.Function's closed-form backward against jax.vjp of the
    JAX op (whose custom VJP is the same einsums), B=2, V=300."""
    v, W, R, t = _skin_inputs(1, 2, 300)
    g = np.random.default_rng(2).normal(0, 1, v.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: j_skinning(*a, interpret=True), *(jnp.asarray(a) for a in (v, W, R, t)))
    ref = vjp(jnp.asarray(g))

    args = [torch.from_numpy(a).requires_grad_(True) for a in (v, W, R, t)]
    sk.skinning(*args).backward(torch.from_numpy(g))
    for a, r, name in zip(args, ref, ("d_v", "d_W", "d_rot", "d_t")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4, err_msg=name)


def test_skinning_backward_matches_autograd_of_reference():
    v, W, R, t = _skin_inputs(3, 2, 300)
    g = torch.from_numpy(np.random.default_rng(4).normal(0, 1, v.shape).astype(np.float32))
    a1 = [torch.from_numpy(a).requires_grad_(True) for a in (v, W, R, t)]
    a2 = [torch.from_numpy(a).requires_grad_(True) for a in (v, W, R, t)]
    sk.skinning(*a1).backward(g)
    sk.skinning_reference(*a2).backward(g)
    for x, y in zip(a1, a2):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "weights"])
def test_skinning_rejects_bad_inputs(bad):
    v, W, R, t = (torch.from_numpy(a) for a in _skin_inputs(5, 2, 50))
    if bad == "dtype":
        v = v.double()
    elif bad == "shape":
        t = t[:, :23]
    else:
        W = W[:, :12]
    with pytest.raises((TypeError, ValueError)):
        sk.skinning(v, W, R, t)


def test_skinning_takes_float64_on_the_cpu():
    """The plain version in float64 (the yardstick of float32's own error
    in the train-step tests); mixed types are refused."""
    args = [torch.from_numpy(a).double() for a in _skin_inputs(6, 2, 50)]
    torch.testing.assert_close(sk.skinning(*args), sk.skinning_reference(*args), rtol=0, atol=0)
    assert sk.skinning(*args).dtype == torch.float64


def _pose(seed, B):
    rng = np.random.default_rng(seed)
    betas = rng.normal(0, 1.0, (B, 10)).astype(np.float32)
    aa = rng.normal(0, 0.3, (B, 72)).astype(np.float32)
    return betas, aa


def test_lbs_matches_jax_full_mesh(smpl_pair):
    jm, tm = smpl_pair
    betas, aa = _pose(6, 3)
    rot = np.array(j_rodrigues(jnp.asarray(aa.reshape(3, 24, 3))))
    jv, jj = j_lbs(jm, jnp.asarray(betas), jnp.asarray(rot), skin_impl="einsum")
    tv, tj = lbs(tm, torch.from_numpy(betas), torch.from_numpy(rot))
    assert tv.shape == (3, 6890, 3)
    # 23 chained 4x4 products and V-long contractions in float32 (metres).
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5)


@pytest.mark.parametrize("pose_input", ["pose_aa", "rot_mats"])
def test_smpl_forward_matches_jax(smpl_pair, pose_input):
    jm, tm = smpl_pair
    betas, aa = _pose(7, 2)
    if pose_input == "pose_aa":
        jkw, tkw = {"pose_aa": jnp.asarray(aa)}, {"pose_aa": torch.from_numpy(aa)}
    else:
        rot = np.array(j_rodrigues(jnp.asarray(aa.reshape(2, 24, 3))))
        jkw, tkw = {"rot_mats": jnp.asarray(rot)}, {"rot_mats": torch.from_numpy(rot)}
    jo = j_smpl_forward(jm, jnp.asarray(betas), **jkw)
    to = smpl_forward(tm, torch.from_numpy(betas), **tkw)
    assert to.joints.shape == (2, 49, 3)
    for name in ("vertices", "joints", "smpl_joints"):
        np.testing.assert_allclose(getattr(to, name).numpy(), np.asarray(getattr(jo, name)), atol=1e-5, err_msg=name)


def test_smpl_forward_needs_exactly_one_pose(smpl_pair):
    _, tm = smpl_pair
    with pytest.raises(ValueError):
        smpl_forward(tm, torch.zeros(1, 10))


@pytest.mark.parametrize("needs", [(True, False, True, True), (False, False, True, True),
                                   (True, True, False, False), (True, True, True, True)],
                         ids=["buffer_W", "fixed_shape", "W_only_plus_v", "all"])
def test_skinning_backward_computes_only_what_is_needed(needs):
    """The cotangents autograd asks for equal the full closed form; the
    others are None.  With W a buffer (SMPL's lbs_weights) W gets no
    gradient and d_W is never computed."""
    v, W, R, t = _skin_inputs(8, 2, 300)
    g = torch.from_numpy(np.random.default_rng(9).normal(0, 1, v.shape).astype(np.float32))
    full = sk.skinning_backward(*(torch.from_numpy(a) for a in (v, W, R, t)), g)
    args = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((v, W, R, t), needs)]
    sk.skinning(*args).backward(g)
    for a, n, ref, name in zip(args, needs, full, ("d_v", "d_W", "d_rot", "d_t")):
        if n:
            torch.testing.assert_close(a.grad, ref, rtol=0, atol=0, msg=name)
        else:
            assert a.grad is None, name
    part = sk.skinning_backward(*(torch.from_numpy(a) for a in (v, W, R, t)), g, needs=needs)
    assert [p is None for p in part] == [not n for n in needs]


def test_lbs_gradient_skips_the_weights(smpl_pair):
    """Through lbs the weights are a buffer: betas and rotations get their
    gradients, lbs_weights none, and the backward matches the plain einsum
    path's autograd."""
    _, tm = smpl_pair
    betas, aa = _pose(10, 2)
    grads = []
    for skin in (sk.skinning, sk.skinning_reference):
        b = torch.from_numpy(betas).requires_grad_(True)
        a = torch.from_numpy(aa).requires_grad_(True)
        out = smpl_forward(tm, b, pose_aa=a, skin=skin)
        (out.vertices.square().sum() + out.joints.sum()).backward()
        grads.append((b.grad, a.grad))
    assert tm.lbs_weights.grad is None and not tm.lbs_weights.requires_grad
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
