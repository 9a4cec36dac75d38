"""PyTorch port, the decoders' one-channel output stage on the CPU: the
plain version of `ops/shuffle_project.py` against the modules' own tail
(upsampler -> projection in `Reconstruct`, ResBlock -> PixelShuffle ->
projection in the fusion family's `dec*3`), with BatchNorm statistics whose
shift would show if the BatchNorm reached the padding; the route's predicate;
the decoders' fused branch wired to the right modules; the parameter names
that checkpoints read; the wrapper's checks.  The kernel itself runs only
on the card (`tests/test_torch_port_cuda.py`)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from inbed_pose_estimation_tpu_torch.models import build_model, decoder
from inbed_pose_estimation_tpu_torch.models.decoder import Reconstruct, ResBlock, fused_route, upsampler
from inbed_pose_estimation_tpu_torch.models.fusion import TwoStageFusion
from inbed_pose_estimation_tpu_torch.models.hmr import HMRCore
from inbed_pose_estimation_tpu_torch.models.layers import Conv2d
from inbed_pose_estimation_tpu_torch.ops import shuffle_project as sp
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.utils.profiling import span
from torch_threads import one_torch_thread  # noqa: F401


def _moved_batch_norms(module, seed):
    """Every BatchNorm of `module` off its init values, with a large shift:
    a shift of up to ~8 against outputs of the convolutions of order 1, so
    that a BatchNorm applied to the zero padding shows."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.randn(n, generator=g) * 2)
            m.running_var.copy_(torch.rand(n, generator=g) * 2 + 0.5)
            m.weight.data.copy_(torch.rand(n, generator=g) + 0.5)
            m.bias.data.copy_(torch.randn(n, generator=g) * 4)
    return module


def _tail(kind, C, seed=0):
    """(pre-shuffle map maker, modules' tail, (weight, norm, bias)) of
    `Reconstruct` ("reconstruct": upsampler(C) then Conv2d(C, 1, 3)) or of a
    fusion `dec*3` ("fusion": ResBlock(4C), PixelShuffle, Conv2d(C, 1, 3) with bias)."""
    torch.manual_seed(seed)
    if kind == "reconstruct":
        up, proj = upsampler(C), Conv2d(C, 1, 3, padding=1, bias=False)
        _moved_batch_norms(up, seed).eval()
        return up[0], lambda h: proj(up[2](up[1](h))), (proj.weight, sp.batch_norm_terms(up[2]), None)
    res, shuffle, proj = ResBlock(4 * C), nn.PixelShuffle(2), Conv2d(C, 1, 3, padding=1)
    _moved_batch_norms(res, seed).eval()
    return res, lambda h: proj(shuffle(h)), (proj.weight, None, proj.bias)


CASES = [("reconstruct", 128, 2, 16, 16), ("reconstruct", 128, 1, 7, 11), ("fusion", 64, 2, 16, 16),
         ("fusion", 64, 1, 15, 9)]


@pytest.mark.parametrize("kind,C,B,h,w", CASES)
def test_plain_version_equals_the_modules_tail(kind, C, B, h, w):
    """shuffle_project on the CPU (the plain version) equals the modules'
    tail from the same pre-shuffle map, within float32 rounding: the
    BatchNorm is written out from its terms, the convolution the same."""
    before, tail, (weight, norm, bias) = _tail(kind, C)
    x = torch.randn(B, C if kind == "reconstruct" else 4 * C, h, w)
    with torch.no_grad():
        pre = before(x)
        want = tail(pre)
        got = sp.shuffle_project(pre, weight, norm, bias)
    assert got.shape == (B, 1, 2 * h, 2 * w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert sp.launches == 0


@pytest.mark.parametrize("kind,C,B,h,w", CASES[:2])
def test_batch_norm_on_the_padding_would_show(kind, C, B, h, w):
    """The BatchNorm statistics of these tests are strong enough that the
    tempting error, applying the BatchNorm after padding, moves the border
    pixels far outside the tolerance above, and no interior pixel."""
    before, tail, (weight, norm, bias) = _tail(kind, C)
    with torch.no_grad():
        pre = before(torch.randn(B, C, h, w))
        want = sp.shuffle_project(pre, weight, norm, bias)
        mean, invstd, gamma, beta = (t.view(1, -1, 1, 1) for t in norm)
        padded = F.pad(F.pixel_shuffle(pre, 2), (1, 1, 1, 1))
        wrong = F.conv2d(gamma * (padded - mean) * invstd + beta, weight)
    gap = (wrong - want).abs()
    assert float(gap[..., 1:-1, 1:-1].max()) <= 1e-5 * float(want.abs().max())
    assert float(gap.max()) > 1e-2 * float(want.abs().max())


def _stand_in(device="cuda", dtype=torch.float32):
    """What `fused_route` reads of a tensor, for a device this machine lacks."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


def test_route_takes_the_kernel_only_for_float32_eval_without_autograd_on_the_card():
    up, proj = upsampler(8), Conv2d(8, 1, 3, padding=1, bias=False)
    bn = up[2].eval()
    with torch.no_grad():
        assert fused_route(_stand_in(), proj, bn)
        assert fused_route(_stand_in(), proj)  # no BatchNorm: the fusion tail
        assert not fused_route(_stand_in("cpu"), proj, bn)
        assert not fused_route(torch.zeros(1, 32, 2, 2), proj, bn)
        assert not fused_route(_stand_in(dtype=torch.bfloat16), proj, bn)
        bn.train()
        assert not fused_route(_stand_in(), proj, bn)  # batch statistics
        bn.eval()
        proj.compute_dtype = torch.bfloat16
        assert not fused_route(_stand_in(), proj, bn)
        proj.compute_dtype = None
    assert torch.is_grad_enabled()
    assert not fused_route(_stand_in(), proj, bn)  # under autograd
    with torch.inference_mode():
        assert fused_route(_stand_in(), proj, bn)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The decoders' fused branch taken on the CPU, where shuffle_project
    runs its plain version: the branch's wiring is then checked here."""
    monkeypatch.setattr(decoder, "fused_route", lambda h, proj, bn=None: not torch.is_grad_enabled())


def _reconstruct_inputs(B=1, top=16):
    g = torch.Generator().manual_seed(1)
    widths = (64, 256, 512, 1024, 2048)
    return [torch.randn(B, c, top >> i, top >> i, generator=g) for i, c in enumerate(widths)]


def test_reconstruct_fused_branch_equals_the_modules(fused_on_cpu):
    """Reconstruct in eval through the fused branch (pre-shuffle map,
    `decDepth.3.2`'s terms, `decDepth.4`'s weight) gives the modules'
    answer, and opens one `ops.shuffle_project` span inside `hmr.decoder`."""
    torch.manual_seed(0)
    rec = _moved_batch_norms(Reconstruct(), 2).eval()
    xs = _reconstruct_inputs()
    with torch.enable_grad():
        want = rec(*xs).detach()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("hmr.decoder"):
            got = rec(*xs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    names = [e.name for e in prof.events()]
    assert names.count("ops.shuffle_project") == 1
    inner = next(e for e in prof.events() if e.name == "ops.shuffle_project")
    outer = next(e for e in prof.events() if e.name == "hmr.decoder")
    assert outer.time_range.start <= inner.time_range.start and inner.time_range.end <= outer.time_range.end


def test_fusion_fused_branch_equals_the_modules(fused_on_cpu):
    """A TwoStageFusion (ir_depth_fusion, RES 64) in eval through the fused
    branch of each `dec*3` (its pre-shuffle ResBlock output, its
    projection's weight and bias) recovers the images the modules recover."""
    model, spec = build_model("ir_depth_fusion", device="cpu", img_res=64)
    _moved_batch_norms(model, 3).eval()
    smpl = synthetic_smpl_model(0, device="cpu")
    rng = np.random.default_rng(4)
    inputs = tuple(torch.from_numpy(rng.normal(0, 1, (1, 1, 64, 64)).astype(np.float32)) for _ in spec.modalities)
    with torch.enable_grad():
        want = {k: v.detach() for k, v in model(inputs, smpl).recovered.items()}
    with torch.no_grad():
        got = model(inputs, smpl).recovered
    assert got.keys() == want.keys() == {"ir", "depth"}
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5 * float(want[k].abs().max()))


def _meta_models():
    zeros = np.zeros(144, np.float32), np.zeros(10, np.float32), np.zeros(3, np.float32)
    with torch.device("meta"):
        return Reconstruct(), HMRCore(6, *zeros, recon_heads=("depth",)), TwoStageFusion((1, 1), *zeros)


def test_parameter_names_of_the_tails_are_unchanged():
    """Checkpoints and the flax maps read these names: the fused route
    calls the existing submodules' tensors and adds none."""
    rec, core, fusion = _meta_models()
    rec_sd, core_sd, fusion_sd = rec.state_dict(), core.state_dict(), fusion.state_dict()
    assert (len(rec_sd), len(core_sd), len(fusion_sd)) == (108, 439, 399)
    tail = {"decDepth.3.0.weight": (512, 128, 3, 3), "decDepth.3.2.weight": (128,), "decDepth.3.2.bias": (128,),
            "decDepth.3.2.running_mean": (128,), "decDepth.3.2.running_var": (128,),
            "decDepth.3.2.num_batches_tracked": (), "decDepth.4.weight": (1, 128, 3, 3)}
    for prefix, sd in (("", rec_sd), ("Reconstruct_depth.", core_sd)):
        assert {k: tuple(sd[prefix + k].shape) for k in tail} == tail
        assert not any(k.startswith(prefix + "decDepth.4.") and k != prefix + "decDepth.4.weight" for k in sd)
    for name in ("IR", "Depth"):
        head = {k: tuple(v.shape) for k, v in fusion_sd.items()
                if k.startswith(f"dec{name}3.") and ".body." not in k}
        assert head == {f"dec{name}3.0.weight": (256, 256, 3, 3), f"dec{name}3.0.bias": (256,),
                        f"dec{name}3.3.weight": (1, 64, 3, 3), f"dec{name}3.3.bias": (1,)}


def _operands(C=8, h=3, w=5):
    return torch.randn(2, 4 * C, h, w), torch.randn(1, C, 3, 3), torch.rand(4, C), torch.randn(1)


@pytest.mark.parametrize("bad,error", [
    (lambda o: (o[0][:, :-1],) + o[1:], ValueError),               # 4C not a multiple of 4
    (lambda o: (o[0][0],) + o[1:], ValueError),                    # not [B, 4C, h, w]
    (lambda o: (o[0], o[1][:, :-1]) + o[2:], ValueError),          # weight of another C
    (lambda o: o[:2] + (o[2][:2],) + o[3:], ValueError),           # norm without all four terms
    (lambda o: o[:3] + (torch.randn(2),), ValueError),             # bias of two channels
    (lambda o: (o[0], o[1].double()) + o[2:], TypeError),          # mixed dtypes
    (lambda o: (o[0][:0],) + o[1:], ValueError),                   # empty batch
    (lambda o: (o[0].to("meta"), o[1].to("meta"), None, None), ValueError),  # no such device path
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        sp.shuffle_project(*bad(_operands()))
