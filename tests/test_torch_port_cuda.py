"""PyTorch port on the card: the CUDA skinning kernel against its plain
version.  Every test needs a CUDA device and skips without one (a CUDA
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
