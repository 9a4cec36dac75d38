"""PyTorch port on the card: the CUDA skinning kernel against its plain
version, SMPLify through it, the training step on the card against the
CPU, the uint8 feed decoded on the card, K2-K5 on the card against the
CPU, the eval entry's pinned staging ring, and the decoders' shuffled
one-channel projection kernel against its plain version and in whole eval
calls, the multi-trunk cascade's reuse of unchanged trunks against
plain forwards, HMR 2.0 (hmr2_vith4mod) against the benchmark's plain
reference at its published widths, and the ResNet-50 trunk's eval tail
kernel against the modules at the trunk's shapes and in a whole pyramid.  Every test needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode); run them on the card with
`python -m pytest tests/test_torch_port_cuda.py -m cuda`."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inbed_pose_estimation_tpu_torch.geometry import batch_rodrigues
from inbed_pose_estimation_tpu_torch.ops import batch_norm_act as bna
from inbed_pose_estimation_tpu_torch.ops import shuffle_project as sp
from inbed_pose_estimation_tpu_torch.ops import skinning as sk
from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model
from torch_threads import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("B", [32, 64])
def test_taxel_map_on_card_matches_cpu(cuda, B):
    """K4 (plain torch) on the card against the CPU: SMPL's 6890 vertices a
    sample on the 112 x 112 grid, some off it and some at negative
    fractions; the contact maps equal, the depth maps within one float32
    rounding at their scale."""
    from inbed_pose_estimation_tpu_torch.ops import vert2map

    rng = np.random.default_rng(9)
    verts = np.concatenate([rng.uniform(-8, 120, (B, 6890, 2)), rng.uniform(0, 1.5, (B, 6890, 1))], -1)
    verts[:, :300, :2] = rng.uniform(-0.999, 0, (B, 300, 2))
    verts = torch.from_numpy(verts.astype(np.float32))
    depth, contact = vert2map(verts)
    card_depth, card_contact = (a.cpu() for a in vert2map(verts.to(cuda)))
    assert 0 < contact.mean() < 1
    assert torch.equal(card_contact, contact)
    atol = torch.finfo(torch.float32).eps * depth.abs().max().item()
    assert (card_depth - depth).abs().max().item() <= atol


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


EVAL_B, EVAL_RES = 32, 224


def _eval_step(name, cuda, prepare=None):
    """make_inference_fn over `name` with seeded weights and synthetic SMPL
    at the eval CLI's settings (224², two cascade passes, the last
    without its decoder); `prepare(model)` edits the model first."""
    from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
    from inbed_pose_estimation_tpu_torch.models import build_model

    torch.manual_seed(0)
    model, spec = build_model(name, device=cuda, img_res=EVAL_RES)
    if prepare is not None:
        prepare(model)
    smpl = synthetic_smpl_model(0, device=cuda)
    infer = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(num_vertices=smpl.v_template.shape[0]),
                              final_recon=False, device=cuda)
    return infer, spec


def _host_batch(spec, seed, B=EVAL_B):
    """Float32 NCHW host tensors, pageable, one per modality."""
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.normal(0, 1, (B, 3 if m == "img" else 1, EVAL_RES, EVAL_RES)).astype(np.float32))
                 for m in spec.modalities)


def _passed(infer, batch, cuda):
    """The answer of inputs already moved to the card with a blocking copy."""
    return infer(tuple(x.to(cuda) for x in batch))


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k].keys() == v.keys(), k
            for kk, vv in v.items():
                assert torch.equal(got[k][kk], vv), (k, kk)
        else:
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", ["cashmrV2", "ir_depth_pm_fusion"])
def test_staged_eval_equals_pass_through(cuda, name):
    """Host inputs staged through the pinned ring give the answers of the
    same inputs moved first with a blocking `.to`, bit for bit."""
    infer, spec = _eval_step(name, cuda)
    batch = _host_batch(spec, 1)
    staged = infer(batch)
    passed = _passed(infer, batch, cuda)
    torch.cuda.synchronize()
    _assert_same(staged, passed)
    assert infer.staging == {"staged": 1, "passed": 1, "remade": 0}


def test_staged_eval_survives_overwritten_host_batches(cuda):
    """The caller overwrites its host batch as soon as each call returns,
    with later calls in flight behind it; every kept answer stays that of
    its own batch once all calls have ended."""
    infer, spec = _eval_step("cashmrV2", cuda)
    batches = [_host_batch(spec, seed) for seed in range(2, 6)]
    want = [_passed(infer, b, cuda) for b in batches]
    torch.cuda.synchronize()
    buf = tuple(x.clone() for x in batches[0])
    kept = []
    for b in batches:
        for dst, src in zip(buf, b):
            dst.copy_(src)
        kept.append(infer(buf))
        for dst in buf:
            dst.fill_(float("nan"))
    torch.cuda.synchronize()
    for got, w in zip(kept, want):
        _assert_same(got, w)
    assert infer.staging["staged"] == len(batches)


def test_staged_eval_remakes_the_ring_on_a_new_shape(cuda):
    """Batches of 32, 7 and 32 frames (numpy, as the loader yields them):
    each answer equals its pass-through answer, and the ring is re-made
    twice."""
    infer, spec = _eval_step("cashmrV2", cuda)
    batches = [_host_batch(spec, 6), _host_batch(spec, 7, B=7), _host_batch(spec, 8)]
    kept = [infer(tuple(x.numpy() for x in b)) for b in batches]
    want = [_passed(infer, b, cuda) for b in batches]
    torch.cuda.synchronize()
    for got, w in zip(kept, want):
        _assert_same(got, w)
    assert infer.staging == {"staged": 3, "passed": 3, "remade": 2}


def test_staged_eval_call_does_not_sync(cuda):
    """A steady-state cashmrV2 call (the ring's slots both used once) runs
    no synchronizing CUDA operation: only the slot's event is waited on."""
    infer, spec = _eval_step("cashmrV2", cuda)
    batches = [_host_batch(spec, seed) for seed in (9, 10)]
    for b in batches:
        infer(b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = infer(batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(out["keypoints_3d_17"]).all()


@pytest.fixture
def float32_cuda(cuda):
    """The card with TF32 off, as the port's entry points pin it
    (`resolve_device`): the plain versions' cuDNN convolutions then run in
    float32 whichever tests ran before."""
    from inbed_pose_estimation_tpu_torch.device import resolve_device

    return resolve_device(cuda)


def _projection_operands(B, C, h, w, with_bn, bias, seed=0):
    """A pre-shuffle map and a projection of decoder scale (weights within
    1 / sqrt(9C), as Conv2d draws them); the BatchNorm's terms (mean,
    invstd, gamma, beta) with a shift of a few units, so that a BatchNorm
    reaching the padding shows."""
    g = torch.Generator().manual_seed(seed)
    bound = (9 * C) ** -0.5
    norm = torch.stack((torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5, torch.rand(C, generator=g) + 0.5,
                        torch.randn(C, generator=g) * 4))
    ops = (torch.randn(B, 4 * C, h, w, generator=g), (torch.rand(1, C, 3, 3, generator=g) * 2 - 1) * bound,
           norm if with_bn else None, torch.randn(1, generator=g) if bias else None)
    return [None if t is None else t.to("cuda") for t in ops]


def _rounding_bound(x, weight, norm):
    """Per output pixel, twice the float32 error bound of a sum of its 9C + 2
    terms in any order: (9C + 2) * 2**-24 * sum |w| |a|, with a the
    BatchNorm's output (the plain version rounds it once more)."""
    import torch.nn.functional as F

    a = F.pixel_shuffle(x, 2)
    if norm is not None:
        mean, invstd, gamma, beta = (t.view(1, -1, 1, 1) for t in norm)
        a = gamma * (a - mean) * invstd + beta
    return 2 * (weight.numel() + 2) * 2.0 ** -24 * F.conv2d(a.abs(), weight.abs(), padding=1)


@pytest.mark.parametrize("B,C,h,w,with_bn,bias", [
    (32, 128, 112, 112, True, False),  # Reconstruct's last stage in cashmrV2 and featatt_cashmr
    (32, 64, 112, 112, False, True),   # a fusion dec*3
    (3, 128, 15, 20, True, False),     # ragged: partial row tile, w below a column tile
    (3, 64, 15, 20, False, True),
    (2, 8, 9, 300, True, True),        # three column tiles
])
def test_shuffle_project_kernel_matches_plain(float32_cuda, B, C, h, w, with_bn, bias):
    """The kernel against its plain version (pixel_shuffle, the BatchNorm
    written out, cuDNN's conv2d, TF32 off) within the rounding bound of the
    two sums, pixel by pixel; the border rows and columns, where the padding
    enters after the BatchNorm, held on their own."""
    x, weight, norm, b = _projection_operands(B, C, h, w, with_bn, bias)
    before = sp.launches
    got = sp.shuffle_project(x, weight, norm, b)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    want = sp.shuffle_project_reference(x, weight, norm, b)
    assert got.shape == want.shape == (B, 1, 2 * h, 2 * w)
    over = (got - want).abs() / _rounding_bound(x, weight, norm)
    for name, part in {"top": over[..., 0, :], "bottom": over[..., -1, :], "left": over[..., :, 0],
                       "right": over[..., :, -1], "all": over}.items():
        assert float(part.max()) <= 1.0, name


@pytest.mark.parametrize("C", [128, 64])
def test_shuffle_project_kernel_equals_the_modules_bit_for_bit(float32_cuda, C):
    """At the decoders' shapes (B=32, a 112² pre-shuffle map) the kernel's
    output is the modules' own, PixelShuffle -> BatchNorm2d (eval) ->
    Conv2d(C, 1, 3) at 128 channels and PixelShuffle -> Conv2d(C, 1, 3)
    with bias at 64, bit for bit: it computes torch's eval BatchNorm in its
    own form and sums each output in the order of cuDNN's convolution."""
    import torch.nn.functional as F
    from torch import nn

    cuda = float32_cuda
    x, weight, _, b = _projection_operands(32, C, 112, 112, False, C == 64, seed=7)
    bn = nn.BatchNorm2d(C).to(cuda).eval()
    with torch.no_grad():
        g = torch.Generator(cuda).manual_seed(8)
        bn.running_mean.copy_(torch.randn(C, device=cuda, generator=g))
        bn.running_var.copy_(torch.rand(C, device=cuda, generator=g) + 0.5)
        bn.weight.copy_(torch.rand(C, device=cuda, generator=g) + 0.5)
        bn.bias.copy_(4 * torch.randn(C, device=cuda, generator=g))
        a = F.pixel_shuffle(x, 2)
        want = F.conv2d(bn(a) if C == 128 else a, weight, b, padding=1)
        got = sp.shuffle_project(x, weight, sp.batch_norm_terms(bn) if C == 128 else None, b)
    assert torch.equal(got, want)


def test_shuffle_project_kernel_rejects_what_it_does_not_take(cuda):
    x, weight, norm, _ = _projection_operands(2, 8, 4, 6, True, False)
    with pytest.raises(ValueError, match="contiguous"):
        sp.shuffle_project(x.transpose(2, 3).contiguous().transpose(2, 3), weight, norm)
    with pytest.raises(TypeError):
        sp.shuffle_project(x.double(), weight.double(), norm.double())
    with pytest.raises(ValueError, match="multiple of 4"):  # rows read in 16-byte pieces
        sp.shuffle_project(x[..., :5].contiguous(), weight, norm)
    with pytest.raises(ValueError, match="aligned"):
        sp.shuffle_project(torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x).copy_(x), weight, norm)
    with pytest.raises(RuntimeError, match="gradient"):
        sp.shuffle_project(x.requires_grad_(True), weight, norm)


def test_frozen_guide_recovers_as_the_modules_at_the_training_batch(cuda, monkeypatch):
    """The frozen fusion guide runs without autograd in a training step
    too, so ir_depth_pm_fusion's step at the train CLI's batch of 64 takes
    the kernel twice, at 64 channels with a bias.  Each of those launches
    equals the modules' PixelShuffle -> Conv2d(64, 1, 3) on the same
    pre-shuffle map bit for bit, and the guide's recovered maps equal those
    of the same call through the modules.  Its two trunk passes take the
    trunk's tail kernel as well, 49 launches each."""
    import torch.nn.functional as F

    from inbed_pose_estimation_tpu_torch.models import build_model, decoder

    torch.manual_seed(0)
    model, spec = build_model("ir_depth_pm_fusion", device=cuda, img_res=EVAL_RES)
    model.train()
    smpl = synthetic_smpl_model(0, device=cuda)
    g = torch.Generator(cuda).manual_seed(12)
    ir, depth = (torch.randn(64, 1, EVAL_RES, EVAL_RES, device=cuda, generator=g) for _ in range(2))
    calls, launch = [], sp.shuffle_project
    monkeypatch.setattr(decoder, "shuffle_project",
                        lambda *args: calls.append((args, launch(*args))) or calls[-1][1])
    before, tails = sp.launches, dict(bna.launches)
    with torch.no_grad():
        fused = model.guide((ir, depth), smpl).recovered
    assert sp.launches == before + 2 and len(calls) == 2
    assert {k: bna.launches[k] - tails[k] for k in tails} == {k: 2 * n for k, n in TRUNK_TAILS.items()}
    for (x, weight, norm, bias), got in calls:
        assert norm is None and x.shape == (64, 256, 112, 112)
        with torch.no_grad():
            assert torch.equal(got, F.conv2d(F.pixel_shuffle(x, 2), weight, bias, padding=1))
    calls.clear()
    monkeypatch.setattr(decoder, "fused_route", lambda *args, **kwargs: False)
    with torch.no_grad():
        plain = model.guide((ir, depth), smpl).recovered
    assert sp.launches == before + 2
    for head in ("ir", "depth"):
        assert torch.equal(fused[head], plain[head]), head


def _moved_decoder_tails(model, seed=5):
    """The last BatchNorm of each Reconstruct off its init values, with a
    shift of a few units (as a trained decoder's)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith("decDepth.3.2"):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g))
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 4)


# The benchmark's limits of `correct` (benchmark/limits/): the largest gap
# over the largest magnitude of the reference.
EVAL_LIMITS = {"rotmat": 2e-5, "betas": 1e-5, "cam": 1e-5, "vertices": 2e-5, "keypoints_3d_17": 2e-5}


# The trunk passes an eval call runs (cascade passes x trunks, less the
# featatt_cashmr trunks that pass 1 reuses): each launches the trunk's tail
# kernel 33 / 12 / 4 times (relu / add_relu / bn_add_relu).
EVAL_TRUNK_PASSES = {"cashmrV2": 2, "featatt_cashmr": 5, "ir_depth_pm_fusion": 4}
TRUNK_TAILS = {"relu": 33, "add_relu": 12, "bn_add_relu": 4}


@pytest.mark.parametrize("name,stages", [("cashmrV2", 1), ("featatt_cashmr", 1), ("ir_depth_pm_fusion", 4)])
def test_eval_call_through_the_fused_tails_matches_the_modules(cuda, monkeypatch, name, stages):
    """A whole eval call at B=32, 224² launches the kernel once per decoder
    stage it runs (the cascade's pass 0 in cashmrV2 and featatt_cashmr, the
    guide's and the main stage's two recovery decoders in the fusion), and
    answers as the same call through the modules does, within the
    benchmark's limits.  The fusion's body masks of the first call are
    replayed in the second: a mask is a rasterization, and a vertex moved
    by rounding can flip one of its pixels (the benchmark's check follows
    the program's masks the same way)."""
    from inbed_pose_estimation_tpu_torch.models import decoder, fusion

    infer, spec = _eval_step(name, cuda, prepare=_moved_decoder_tails)
    batch = _host_batch(spec, 11)
    masks, render = [], fusion.render_body_mask
    monkeypatch.setattr(fusion, "render_body_mask", lambda *args, **kwargs: masks.append(render(*args, **kwargs))
                        or masks[-1])
    before, tails = sp.launches, dict(bna.launches)
    fused = infer(batch)
    torch.cuda.synchronize()
    assert sp.launches == before + stages
    assert {k: bna.launches[k] - tails[k] for k in tails} == {
        k: n * EVAL_TRUNK_PASSES[name] for k, n in TRUNK_TAILS.items()}
    assert len(masks) == (2 if stages == 4 else 0)
    monkeypatch.setattr(fusion, "render_body_mask", lambda *args, **kwargs: masks.pop(0))
    monkeypatch.setattr(decoder, "fused_route", lambda *args, **kwargs: False)
    plain = infer(batch)
    torch.cuda.synchronize()
    assert sp.launches == before + stages
    for k, limit in EVAL_LIMITS.items():
        gap = float((fused[k] - plain[k]).abs().max() / plain[k].abs().max())
        assert gap <= limit, (k, gap)
    for k, v in plain["recon"].items():
        assert float((fused["recon"][k] - v).abs().max() / v.abs().max()) <= 2e-5, k


def _featatt_on_card(cuda):
    """featatt_cashmr's eval step at B=32, 224² (`_eval_step`), its model,
    with the attention gains off zero, where the module is the identity."""
    kept = []

    def prepare(model):
        with torch.no_grad():
            model.cross_att.gamma.copy_(torch.tensor([0.5, -0.3, 0.2, 0.4]))
        kept.append(model)

    infer, spec = _eval_step("featatt_cashmr", cuda, prepare=prepare)
    return infer, spec, kept[0]


def test_unchanged_trunk_recomputes_its_pyramid_bit_for_bit(float32_cuda):
    """The premise of the cascade's reuse: the RGB, IR and PM trunks, whose
    inputs pass 1 gets unchanged, run again after a whole pass-0 forward
    (trunks, attention, decoder, IEF) give every level of their pyramids
    equal bit for bit to the first run's."""
    _, spec, model = _featatt_on_card(float32_cuda)
    inputs = tuple(x.to(float32_cuda) for x in _host_batch(spec, 12))
    trunks = {name: getattr(model, f"feat_extraction_{name}") for name in ("rgb", "ir", "pm")}
    slots = {name: model.trunk_names.index(name) for name in trunks}
    with torch.no_grad():
        first = {name: t.pyramid(inputs[slots[name]]) for name, t in trunks.items()}
        model(inputs)
        again = {name: t.pyramid(inputs[slots[name]]) for name, t in trunks.items()}
    torch.cuda.synchronize()
    for name in trunks:
        for level, (a, b) in enumerate(zip(first[name], again[name])):
            assert torch.equal(a, b), (name, level)


def test_featatt_eval_call_with_reuse_equals_two_plain_forwards(float32_cuda):
    """A featatt_cashmr eval call, which reuses the three unchanged trunks
    in pass 1 (5 trunk passes run, 3 reused), answers as two plain
    forwards handed nothing from each other, bit for bit: rotmat, betas,
    cam and vertices, and pass 0's recovered depth through the cascade."""
    from inbed_pose_estimation_tpu_torch.models import cascade_apply, hmr

    infer, spec, model = _featatt_on_card(float32_cuda)
    batch = _host_batch(spec, 13)
    before = dict(hmr.trunk_passes)
    got = infer(batch)
    torch.cuda.synchronize()
    assert (hmr.trunk_passes["run"] - before["run"], hmr.trunk_passes["reused"] - before["reused"]) == (5, 3)
    inputs = tuple(x.to(float32_cuda) for x in batch)
    with torch.no_grad():
        first = model(inputs)
        second = model((inputs[0], inputs[1], first.recon["depth"], inputs[3]), compute_recon=False)
        verts, _ = lbs(synthetic_smpl_model(0, device=float32_cuda), second.betas, second.rotmat)
        outs = cascade_apply(lambda mods, **kw: model(mods, **kw), inputs, 2, feed_map=spec.cascade_feed_map,
                             final_recon=False)
    torch.cuda.synchronize()
    for k in ("rotmat", "betas", "cam"):
        assert torch.equal(got[k], getattr(second, k)), k
        assert torch.equal(getattr(outs[1], k), getattr(second, k)), k
    assert torch.equal(got["vertices"], verts)
    assert torch.equal(outs[0].recon["depth"], first.recon["depth"])


def _featatt_train_step_passes(device):
    """The trunk passes (run, reused) of one featatt_cashmr train step at
    RES 64, batch 2, on `device`, SMPLify off, and the step's metrics."""
    from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
    from inbed_pose_estimation_tpu_torch.models import build_model, hmr
    from inbed_pose_estimation_tpu_torch.train import build_parser, init_train_state, make_train_step, step_feed_keys

    options = build_parser().parse_args(["--name", "card", "--img_res", "64", "--batch_size", "2"])
    torch.manual_seed(0)
    model, spec = build_model("featatt_cashmr", device=device, img_res=64)
    r = np.random.default_rng(3)
    batch = {k: r.normal(0, 1, (2, 3 if k == "img" else 1, 64, 64)) for k in step_feed_keys(spec)
             if k.endswith(("img", "_uncover"))}
    batch.update(keypoints=np.concatenate([r.uniform(-0.8, 0.8, (2, 49, 2)), np.ones((2, 49, 1))], -1),
                 pose=r.normal(0, 0.2, (2, 72)), betas=r.normal(0, 0.5, (2, 10)),
                 pose_3d=np.concatenate([r.normal(0, 0.3, (2, 24, 3)), np.ones((2, 24, 1))], -1),
                 has_smpl=np.array([1.0, 0.0]), has_pose_3d=np.ones(2), is_flipped=np.array([0.0, 1.0]),
                 rot_angle=np.array([10.0, -5.0]), sample_index=np.array([3, 9]))
    state = init_train_state(model, options, np.zeros((16, 82)), device=device)
    step = make_train_step(model, spec, synthetic_smpl_model(0, device=device), synthetic_gmm_prior(device=device),
                           options, device=device)
    before = dict(hmr.trunk_passes)
    state, metrics = step(state, batch)
    return (hmr.trunk_passes["run"] - before["run"], hmr.trunk_passes["reused"] - before["reused"]), metrics


def test_featatt_train_step_on_card_reuses_no_trunk(cuda):
    """A featatt_cashmr train step on the card runs all 8 trunk passes of
    its two-pass cascade and reuses none: in training mode each pass
    updates BatchNorm's running statistics."""
    tails = dict(bna.launches)
    passes, metrics = _featatt_train_step_passes(cuda)
    assert passes == (8, 0)
    assert bna.launches == tails  # training BatchNorms and autograd: the modules
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_hmr2_eval_call_matches_the_reference_within_the_cells_limits(float32_cuda):
    """hmr2_vith4mod at its published widths, B=32, 224²: the eval step the
    benchmark times (`benchmark/program.py`, the registered model with the
    reference's seeded weights) against the plain reference
    (`benchmark/reference/vit_hmr.py`) on two of the cell's batches,
    within the cell's limits of `correct`; each call runs 38 self and 6
    cross attention cores (32 blocks, 6 head layers) on the plain route."""
    import pathlib
    from collections import Counter

    from benchmark import check, harness, program, traffic_gen
    from inbed_pose_estimation_tpu_torch.models import vit

    cell = harness.make_cell(pathlib.Path(__file__).resolve().parents[1], "hmr2_vith4mod.eval.b32", 2**31 + 2020,
                             float32_cuda)
    run = cell.run
    _, infer = program.build_inference(run)
    tails = dict(bna.launches)
    for inputs in traffic_gen.make_pool(run.config, run.traffic, run.seed, run.device)[:2]:
        before = Counter(vit.attention_calls)
        got = program.to_host(infer(inputs))
        calls = Counter(vit.attention_calls)
        calls.subtract(before)
        assert +calls == Counter({("plain", "self"): 38, ("plain", "cross"): 6})
        numbers, _ = check.answer_numbers(run, inputs, check.flatten(got))
        assert set(numbers) == set(cell.limits)
        for k, limit in cell.limits.items():
            assert numbers[k] <= limit, (k, numbers[k])
    assert bna.launches == tails  # no ResNet: the trunk's tail kernel never runs


def _moved_trunk_norms(module, seed):
    """Every BatchNorm of `module` off its init values, as a trained trunk's:
    shifts of a few units, scales around 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n, dev = m.num_features, m.running_mean.device
                m.running_mean.copy_(torch.randn(n, generator=g).to(dev))
                m.running_var.copy_((torch.rand(n, generator=g) * 2 + 0.1).to(dev))
                m.weight.copy_((torch.rand(n, generator=g) + 0.5).to(dev))
                m.bias.copy_(torch.randn(n, generator=g).to(dev))
    return module


def _bits(t):
    return t.view(torch.int32)


# (channels, side) of every tail of a trunk pass at 224²: the stem; each
# stage's conv1 (the first block's at the previous stage's side), conv2,
# conv3 and projection.  7² (H W = 49) takes the kernel's scalar path.
TRUNK_SHAPES = [(64, 112), (64, 56), (256, 56), (128, 56), (128, 28), (512, 28), (256, 28), (256, 14), (1024, 14),
                (512, 14), (512, 7), (2048, 7)]


@pytest.mark.parametrize("C,side", TRUNK_SHAPES)
def test_batch_norm_act_kernel_equals_the_modules_bit_for_bit(float32_cuda, C, side):
    """At B=32 on each of the trunk's shapes, each form of the kernel gives
    the modules' BatchNorm2d (eval), add and F.relu bit for bit, NaN, the
    infinities and signed zeros in the inputs included."""
    from inbed_pose_estimation_tpu_torch.models.backbone import BatchNorm2d

    cuda = float32_cuda
    bn, rbn = (_moved_trunk_norms(BatchNorm2d(C).to(cuda), s).eval() for s in (C, C + 1))
    g = torch.Generator(cuda).manual_seed(side)
    x, r = (torch.randn(32, C, side, side, device=cuda, generator=g) * 2 for _ in range(2))
    for t in (x, r):
        flat = t.view(-1)
        flat[:4] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0])
        flat[-3:] = torch.tensor([0.0, -0.0, float("nan")])
    before = dict(bna.launches)
    with torch.no_grad():
        forms = {"relu": (bna.batch_norm_act(x, bn), F.relu(bn(x))),
                 "add_relu": (bna.batch_norm_act(x, bn, r), F.relu(bn(x) + r)),
                 "bn_add_relu": (bna.batch_norm_act(x, bn, r, rbn), F.relu(bn(x) + rbn(r)))}
    torch.cuda.synchronize()
    assert {k: bna.launches[k] - before[k] for k in before} == dict.fromkeys(bna.FORMS, 1)
    for form, (got, want) in forms.items():
        assert torch.equal(_bits(got), _bits(want)), form


def test_batch_norm_act_kernel_computes_invstd_as_torch(float32_cuda):
    """The kernel computes invstd = rsqrt(running_var + eps) itself: with
    x = 1, mean 0, weight 1 and bias 0 the output is that invstd, and it
    equals torch.rsqrt(running_var + eps) bit for bit over variances from
    1e-8 to 1e8."""
    from inbed_pose_estimation_tpu_torch.models.backbone import BatchNorm2d

    cuda = float32_cuda
    C = 4096
    bn = BatchNorm2d(C).to(cuda).eval()
    with torch.no_grad():
        bn.running_var.copy_(10.0 ** torch.linspace(-8, 8, C, device=cuda))
        got = bna.batch_norm_act(torch.ones(2, C, 2, 2, device=cuda), bn)
        want = torch.rsqrt(bn.running_var + bn.eps)
    assert torch.equal(_bits(got), _bits(want.view(1, C, 1, 1).expand(2, C, 2, 2)))


def test_trunk_pyramid_on_card_equals_the_modules_bit_for_bit(float32_cuda, monkeypatch):
    """One eval ResNet50Trunk.pyramid at B=32, 224² through the kernel
    equals the modules' route on x0..x4 bit for bit, with 33 relu, 12
    add_relu and 4 bn_add_relu launches."""
    from inbed_pose_estimation_tpu_torch.models import backbone

    cuda = float32_cuda
    torch.manual_seed(0)
    trunk = _moved_trunk_norms(backbone.ResNet50Trunk(3).to(cuda), 21).eval()
    x = torch.randn(32, 3, 224, 224, device=cuda)
    before = dict(bna.launches)
    with torch.no_grad():
        fused = trunk.pyramid(x)
        torch.cuda.synchronize()
        assert {k: bna.launches[k] - before[k] for k in before} == TRUNK_TAILS
        monkeypatch.setattr(backbone, "fused_route", lambda *args: False)
        plain = trunk.pyramid(x)
    torch.cuda.synchronize()
    assert {k: bna.launches[k] - before[k] for k in before} == TRUNK_TAILS
    for level, (a, b) in enumerate(zip(fused, plain)):
        assert torch.equal(_bits(a), _bits(b)), level


def test_trunk_tail_kernel_reads_statistics_written_since_the_last_call(float32_cuda, monkeypatch):
    """A projection block on the kernel after an in-place write to a
    running_var and after a load_state_dict equals the modules' with the
    new statistics: nothing of a BatchNorm is kept between launches."""
    from inbed_pose_estimation_tpu_torch.models import backbone

    cuda = float32_cuda
    torch.manual_seed(0)
    block = _moved_trunk_norms(backbone.Bottleneck(256, 128, 2, project=True).to(cuda), 1).eval()
    other = _moved_trunk_norms(backbone.Bottleneck(256, 128, 2, project=True).to(cuda), 2).eval()
    x = torch.randn(8, 256, 56, 56, device=cuda)

    def both():
        """(the kernel's answer, the modules')"""
        with monkeypatch.context() as m, torch.no_grad():
            got = block(x)
            m.setattr(backbone, "fused_route", lambda *args: False)
            return got, block(x)

    before = sum(bna.launches.values())
    first, _ = both()
    with torch.no_grad():
        block.downsample[1].running_var.mul_(3)
    edited, want_edited = both()
    with torch.no_grad():
        block.load_state_dict(other.state_dict())
    loaded, want_loaded = both()
    torch.cuda.synchronize()
    assert sum(bna.launches.values()) == before + 9
    assert not torch.equal(edited, first) and not torch.equal(loaded, edited)
    assert torch.equal(edited, want_edited)
    assert torch.equal(loaded, want_loaded)


def test_trunk_takes_the_modules_under_autograd_and_in_bfloat16(float32_cuda):
    from inbed_pose_estimation_tpu_torch.models.backbone import ResNet50Trunk
    from inbed_pose_estimation_tpu_torch.models.layers import set_compute_dtype

    cuda = float32_cuda
    trunk = ResNet50Trunk(3).to(cuda).eval()
    x = torch.randn(2, 3, 64, 64, device=cuda)
    before = dict(bna.launches)
    trunk.pyramid(x)  # autograd on
    set_compute_dtype(trunk, torch.bfloat16)
    with torch.no_grad():
        trunk.pyramid(x)
    torch.cuda.synchronize()
    assert bna.launches == before
