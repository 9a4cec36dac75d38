"""PyTorch port on the card: the CUDA skinning kernel against its plain
version, SMPLify through it, the training step on the card against the
CPU, and the uint8 feed decoded on the card.  Every test needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode); run them on the card with
`python -m pytest tests/test_torch_port_cuda.py -m cuda`."""

import numpy as np
import pytest
import torch

from inbed_pose_estimation_tpu_torch.geometry import batch_rodrigues
from inbed_pose_estimation_tpu_torch.ops import skinning as sk
from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the skinning kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, B, V, device):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(0, 0.3, (B, V, 3)).astype(np.float32))
    W = torch.from_numpy(rng.dirichlet(np.ones(24), size=V).astype(np.float32))
    R = batch_rodrigues(torch.from_numpy(rng.normal(0, 0.4, (B, 24, 3)).astype(np.float32)))
    t = torch.from_numpy(rng.normal(0, 0.2, (B, 24, 3)).astype(np.float32))
    return [a.to(device) for a in (v, W, R, t)]


@pytest.mark.parametrize("B,V", [(32, 6890), (64, 6890), (5, 6890), (33, 701), (3, 700), (1, 1)])
def test_kernel_matches_reference(cuda, B, V):
    args = _inputs(0, B, V, cuda)
    before = sk.launches
    out = sk.skinning(*args)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    # One float32 FMA chain against three einsums: rounding-level.
    torch.testing.assert_close(out, sk.skinning_reference(*args), atol=1e-5, rtol=0)


def test_kernel_gradients_match_autograd_of_reference(cuda):
    args = [a.requires_grad_(True) for a in _inputs(1, 2, 300, cuda)]
    ref_args = [a.detach().clone().requires_grad_(True) for a in args]
    g = torch.randn(2, 300, 3, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    sk.skinning(*args).backward(g)
    sk.skinning_reference(*ref_args).backward(g)
    for a, r in zip(args, ref_args):
        torch.testing.assert_close(a.grad, r.grad, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("B,V", [(32, 6890), (5, 701)])
def test_kernel_reads_strided_affines_in_place(cuda, B, V):
    """A_rot and A_t as lbs passes them, views of one [B, 24, 4, 4] tensor:
    the same output as their contiguous copies, in one launch."""
    v, W, R, t = _inputs(4, B, V, cuda)
    world = torch.zeros(B, 24, 4, 4, device=cuda)
    world[..., :3, :3], world[..., :3, 3] = R, t
    R_view, t_view = world[..., :3, :3], world[..., :3, 3]
    assert not (R_view.is_contiguous() or t_view.is_contiguous())
    before = sk.launches
    out = sk.skinning(v, W, R_view, t_view)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert torch.equal(out, sk.skinning(v, W, R, t))


def test_kernel_rejects_non_contiguous(cuda):
    v, W, R, t = _inputs(2, 2, 64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sk.skinning(v.transpose(0, 1).contiguous().transpose(0, 1), W, R, t)


def test_kernel_rejects_misaligned_weights(cuda):
    v, W, R, t = _inputs(5, 2, 64, cuda)
    shifted = torch.empty(64 * 24 + 1, device=cuda)[1:].view(64, 24)
    shifted.copy_(W)
    with pytest.raises(ValueError, match="16-byte"):
        sk.skinning(v, shifted, R, t)


def test_lbs_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    betas = torch.from_numpy(rng.normal(0, 1, (4, 10)).astype(np.float32))
    rot = batch_rodrigues(torch.from_numpy(rng.normal(0, 0.3, (4, 24, 3)).astype(np.float32)))
    cpu_v, cpu_j = lbs(synthetic_smpl_model(0, device="cpu"), betas, rot)
    gpu_v, gpu_j = lbs(synthetic_smpl_model(0, device=cuda), betas.to(cuda), rot.to(cuda))
    torch.testing.assert_close(gpu_v.cpu(), cpu_v, atol=1e-5, rtol=0)
    torch.testing.assert_close(gpu_j.cpu(), cpu_j, atol=1e-5, rtol=0)


def _smplify_args(B, device, seed=0):
    rng = np.random.default_rng(seed)
    pose = torch.from_numpy(rng.normal(0, 0.2, (B, 72)).astype(np.float32))
    kp = np.concatenate([rng.uniform(20, 204, (B, 49, 2)), rng.uniform(0.5, 1, (B, 49, 1))], -1).astype(np.float32)
    cam_t = torch.tensor([[0.0, 0.0, 2 * 5000.0 / (224 * 0.9)]]).expand(B, 3)
    return [a.to(device) for a in (pose, torch.zeros(B, 10), cam_t, torch.full((B, 2), 112.0), torch.from_numpy(kp))]


def test_smplify_kernel_matches_plain_at_b64(cuda):
    """SMPLify at the training batch, 5 Adam steps a stage, through the
    kernel and through the plain skinning on the same inputs."""
    from inbed_pose_estimation_tpu_torch.fitting import make_smplify, synthetic_gmm_prior

    smpl, prior = synthetic_smpl_model(0, device=cuda), synthetic_gmm_prior(device=cuda)
    args = _smplify_args(64, cuda)
    before = sk.launches
    got = make_smplify(smpl, prior, num_iters=5)(*args)
    torch.cuda.synchronize()
    assert sk.launches - before == 2 * 5 + 1
    want = make_smplify(smpl, prior, num_iters=5, skin=sk.skinning_reference)(*args)
    for name in ("pose", "betas", "camera_translation"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), atol=1e-4, rtol=0, msg=name)
    ref = want.reprojection_loss
    assert (got.reprojection_loss - ref).abs().max() <= 1e-4 * ref.abs().max()


def _small_step(device, dtype, feed_map, weights, num_smplify_iters=2, tf32=False):
    """One train step at RES 64, batch 2, SMPLify on, dropout off, from
    `weights`: (metrics, gradients, BatchNorm statistics) as float64 numpy.
    `tf32` lets the step's products and convolutions run in TF32."""
    import dataclasses

    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.train import build_parser, init_train_state, make_train_step

    options = build_parser().parse_args(["--name", "card", "--run_smplify", "--img_res", "64", "--batch_size", "2",
                                         "--num_smplify_iters", str(num_smplify_iters)])
    model, spec = build_model("cashmrV2", device=device, dropout_rate=0.0)
    model.load_state_dict(weights)
    model.to(dtype)
    spec = dataclasses.replace(spec, cascade_feed_map=feed_map)
    prior = synthetic_gmm_prior(device=device)
    r = np.random.default_rng(1)
    batch = {m: r.normal(0, 1, (2, 3 if m == "img" else 1, 64, 64)) for m in spec.modalities + ("depth_img_uncover",)}
    batch.update(keypoints=np.concatenate([r.uniform(-0.8, 0.8, (2, 49, 2)), np.ones((2, 49, 1))], -1),
                 pose=r.normal(0, 0.2, (2, 72)), betas=r.normal(0, 0.5, (2, 10)),
                 pose_3d=np.concatenate([r.normal(0, 0.3, (2, 24, 3)), np.ones((2, 24, 1))], -1),
                 has_smpl=np.array([1.0, 0.0]), has_pose_3d=np.ones(2), is_flipped=np.array([0.0, 1.0]),
                 rot_angle=np.array([10.0, -5.0]), sample_index=np.array([3, 9]))
    state = init_train_state(model, options, np.zeros((16, 82)), device=device)
    step = make_train_step(model, spec, synthetic_smpl_model(0, device=device).to(dtype),
                           type(prior)(*(t.to(dtype) for t in prior)), options, device=device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    state, metrics = step(state, batch)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    host = lambda t: t.detach().double().cpu().numpy()  # noqa: E731
    return ({k: float(v) for k, v in metrics.items()}, {k: host(p.grad) for k, p in model.named_parameters()},
            {k: host(b) for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))})


@pytest.mark.parametrize("feed", ["two_pass", "two_pass_no_feedback"])
def test_train_step_on_card_matches_cpu(cuda, feed):
    """The step on the card against the CPU on the same weights and batch:
    loss and metrics (relative); each gradient leaf's distance to the CPU's
    float64 step over float32's own error there (the CPU float32 step's
    distance plus 1e-4 of the leaf's norm: cuDNN's convolution algorithms
    round differently from the CPU's); and the BatchNorm statistics' error
    over tol + tol * |value|.  The limits are 2-3.5x the card's readings on
    these inputs (feedback: 3.1e-4, 1.37, 0.29 of 1e-3; no feedback:
    8.3e-6, 3.81, 0.66 of 3e-5), and the same step in TF32 must break one."""
    from inbed_pose_estimation_tpu_torch.models import build_model

    feed_map, limits, stat_tol = {
        "two_pass": ((("depth", 2),), {"metrics": 8e-4, "grads": 3.0}, 1e-3),
        "two_pass_no_feedback": ((), {"metrics": 2e-5, "grads": 8.0}, 5e-5),
    }[feed]
    torch.manual_seed(0)
    weights = build_model("cashmrV2", device="cpu", dropout_rate=0.0)[0].state_dict()
    cpu = _small_step("cpu", torch.float32, feed_map, weights)
    cpu64 = _small_step("cpu", torch.float64, feed_map, weights)

    def over_limits(card):
        return {
            "metrics": max(abs(card[0][k] / v - 1) for k, v in cpu[0].items() if v != 0) / limits["metrics"],
            "grads": max(np.linalg.norm(card[1][k] - cpu64[1][k])
                         / (np.linalg.norm(g - cpu64[1][k]) + 1e-4 * np.linalg.norm(cpu64[1][k]))
                         for k, g in cpu[1].items()) / limits["grads"],
            "bn_stats": max(float((np.abs(card[2][k] - v) / (stat_tol + stat_tol * np.abs(v))).max())
                            for k, v in cpu[2].items()),
        }

    readings = over_limits(_small_step(cuda, torch.float32, feed_map, weights))
    assert max(readings.values()) <= 1, readings
    tf32 = over_limits(_small_step(cuda, torch.float32, feed_map, weights, tf32=True))
    assert max(tf32.values()) > 1, tf32


def test_train_step_launches_the_kernel_6_plus_2n_times(cuda):
    from inbed_pose_estimation_tpu_torch.models import build_model

    torch.manual_seed(0)
    weights = build_model("cashmrV2", device="cpu", dropout_rate=0.0)[0].state_dict()
    before = sk.launches
    _small_step(cuda, torch.float32, (("depth", 2),), weights, num_smplify_iters=3)
    assert sk.launches - before == 6 + 2 * 3


def test_mesh_raster_on_card_matches_cpu(cuda):
    """K3 (plain torch) on the card against the CPU on the same inputs: a
    folded grid mesh over a 224^2 canvas, tile 28, with and without part
    labels; the number of differing pixels must be 0."""
    from inbed_pose_estimation_tpu_torch.ops.tri_raster import rasterize_mesh_batch

    rng = np.random.default_rng(7)
    n = 40
    g = np.stack(np.meshgrid(np.linspace(-10, 230, n), np.linspace(-5, 228, n)), -1).reshape(-1, 2)
    uvz = np.concatenate([g + rng.normal(0, 2, g.shape), rng.uniform(2, 9, (n * n, 1))], 1)[None].repeat(3, 0)
    uvz[1:, :, :2] += rng.normal(0, 3, (2, n * n, 2))
    idx = np.arange(n * n).reshape(n, n)
    quads = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]], -1).reshape(-1, 4)
    faces = torch.from_numpy(np.concatenate([quads[:, [0, 1, 2]], quads[:, [1, 3, 2]]]))
    labels = torch.from_numpy(rng.integers(1, 7, n * n))
    uvz = torch.from_numpy(uvz.astype(np.float32))
    for lab in (None, labels):
        cpu = rasterize_mesh_batch(uvz, faces, 224, labels=lab, tile=28)
        card = rasterize_mesh_batch(uvz.to(cuda), faces.to(cuda), 224, labels=None if lab is None else lab.to(cuda),
                                    tile=28)
        assert cpu[0].sum() > 1000
        for a, b in zip(card, cpu):
            assert int((a.cpu() != b).sum()) == 0


def test_body_mask_on_card_matches_cpu(cuda):
    """K2 (plain torch) on the card against the CPU on the same vertices:
    posed synthetic SMPL meshes at batch 32, 224^2, splatted at 112^2 and
    upsampled; no pixel may differ."""
    from inbed_pose_estimation_tpu_torch.ops.mask_raster import render_body_mask

    smpl = synthetic_smpl_model(0, device="cpu")
    rng = np.random.default_rng(5)
    rot = batch_rodrigues(torch.from_numpy(rng.normal(0, 0.3, (32 * 24, 3)).astype(np.float32))).reshape(32, 24, 3, 3)
    verts, _ = lbs(smpl, torch.from_numpy(rng.normal(0, 0.5, (32, 10)).astype(np.float32)), rot)
    cam = torch.from_numpy(np.stack([rng.uniform(0.6, 1.4, 32), rng.normal(0, 0.2, 32), rng.normal(0, 0.2, 32)],
                                    -1).astype(np.float32))
    cpu = render_body_mask(verts, cam)
    card = render_body_mask(verts.to(cuda), cam.to(cuda)).cpu()
    assert (cpu == 1).any() and (cpu == 0).any()
    assert int((card != cpu).sum()) == 0


def test_device_crop_on_card_matches_cpu(cuda):
    """K5 (plain torch) on the card against the CPU: a batch of raw uint8
    frames at the SLP frame size cropped to 224^2 (boxes inside the frame and
    across its edges), within 1e-5 before normalization."""
    from inbed_pose_estimation_tpu_torch.data.device_preprocess import crop_resize

    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.integers(0, 256, (4, 3, 1024, 576), dtype=np.uint8)).float() / 255.0
    center = torch.tensor([[288.0, 512.0], [40.0, 30.0], [500.0, 1000.0], [288.0, 512.0]])
    scale = torch.tensor([4.0, 3.0, 2.5, 6.2])
    cpu = crop_resize(img, center, scale, 224)
    card = crop_resize(img.to(cuda), center.to(cuda), scale.to(cuda), 224).cpu()
    assert (card - cpu).abs().max() <= 1e-5


def test_uint8_feed_decodes_on_card_as_on_cpu(cuda, monkeypatch):
    """decode_uint8_batch on the card against the CPU (equal: the same
    float32 operations), and the train step's copy to the card: the uint8
    images cross as uint8 and are decoded there."""
    from inbed_pose_estimation_tpu_torch.data.device_preprocess import decode_uint8_batch
    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model
    from inbed_pose_estimation_tpu_torch.train import build_parser, init_train_state, make_train_step, step_feed_keys
    from inbed_pose_estimation_tpu_torch.train import trainer as trainer_mod

    rng = np.random.default_rng(10)
    keys = ("img", "ir_img", "depth_img", "pm_img", "depth_img_uncover", "mask_uncover")
    u8 = {k: torch.from_numpy(rng.integers(0, 256, (2, 3 if k == "img" else 1, 64, 64), dtype=np.uint8))
          for k in keys}
    u8["pixel_noise"] = torch.from_numpy(rng.uniform(0.6, 1.4, (2, 3)).astype(np.float32))
    cpu = decode_uint8_batch(u8)
    card = decode_uint8_batch({k: v.to(cuda) for k, v in u8.items()})
    for k in keys:
        assert card[k].device.type == "cuda" and card[k].dtype == torch.float32
        assert torch.equal(card[k].cpu(), cpu[k]), k

    seen = {}

    def spy(batch):
        seen.update({k: (v.dtype, v.device.type) for k, v in batch.items()})
        return decode_uint8_batch(batch)

    monkeypatch.setattr(trainer_mod, "decode_uint8_batch", spy)
    options = build_parser().parse_args(["--name", "card", "--img_res", "64", "--batch_size", "2"])
    model, spec = build_model("cashmrV2", device=cuda)
    batch = {k: v.numpy() for k, v in u8.items() if k != "mask_uncover"}
    batch.update(keypoints=np.concatenate([rng.uniform(-0.8, 0.8, (2, 49, 2)), np.ones((2, 49, 1))], -1),
                 pose=rng.normal(0, 0.2, (2, 72)), betas=rng.normal(0, 0.5, (2, 10)),
                 pose_3d=np.concatenate([rng.normal(0, 0.3, (2, 24, 3)), np.ones((2, 24, 1))], -1),
                 has_smpl=np.array([1.0, 0.0]), has_pose_3d=np.ones(2), is_flipped=np.array([0.0, 1.0]),
                 rot_angle=np.array([10.0, 0.0]), sample_index=np.array([1, 3]))
    assert set(batch) == step_feed_keys(spec)
    state = init_train_state(model, options, np.zeros((4, 82)), device=cuda)
    step = make_train_step(model, spec, synthetic_smpl_model(0, device=cuda), synthetic_gmm_prior(device=cuda),
                           options, device=cuda)
    state, metrics = step(state, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    for k in ("img", "ir_img", "depth_img", "pm_img", "depth_img_uncover"):
        assert seen[k] == (torch.uint8, "cuda"), (k, seen[k])
    assert seen["pixel_noise"] == (torch.float32, "cuda")
