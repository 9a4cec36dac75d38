"""PyTorch port, the ResNet-50 trunk's eval tail on the CPU: the plain
version of `ops/batch_norm_act.py` against the modules' BatchNorm, add and
ReLU; the route's predicate; the fused branch of `Bottleneck` and of a whole
`ResNet50Trunk.pyramid`, wired to the right modules and forms; x0 left as
the stem convolution's output; the parameter names that checkpoints read;
the wrapper's checks; and statistics written after a first call being read
by the next.  The kernel itself runs only on the card
(`tests/test_torch_port_cuda.py`)."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from inbed_pose_estimation_tpu_torch.models import backbone
from inbed_pose_estimation_tpu_torch.models.backbone import BatchNorm2d, Bottleneck, ResNet50Trunk, fused_route
from inbed_pose_estimation_tpu_torch.models.layers import Conv2d, set_compute_dtype
from inbed_pose_estimation_tpu_torch.ops import batch_norm_act as bna
from torch_threads import one_torch_thread  # noqa: F401


def _moved_batch_norms(module, seed):
    """Every BatchNorm of `module` off its init values, with shifts of a few
    units, so that a missing or doubled BatchNorm, add or ReLU shows."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.randn(n, generator=g))
            m.running_var.copy_(torch.rand(n, generator=g) * 2 + 0.25)
            m.weight.data.copy_(torch.rand(n, generator=g) + 0.5)
            m.bias.data.copy_(torch.randn(n, generator=g))
    return module


def _modules_tail(x, bn, residual=None, residual_bn=None):
    """The modules' own tail: the BatchNorm layer, the add, F.relu."""
    h = bn(x)
    if residual is not None:
        h = h + (residual if residual_bn is None else residual_bn(residual))
    return F.relu(h)


@pytest.mark.parametrize("form", bna.FORMS)
@pytest.mark.parametrize("hw", [7, 8])  # H W = 49, the 7^2 stage; 64, a multiple of 4
def test_plain_version_equals_the_modules_bit_for_bit(form, hw):
    g = torch.Generator().manual_seed(hw)
    C = 12
    bn, rbn = (_moved_batch_norms(BatchNorm2d(C), s).eval() for s in (1, 2))
    x, r = (torch.randn(3, C, hw, hw, generator=g) * 2 for _ in range(2))
    residual = None if form == "relu" else r
    residual_bn = rbn if form == "bn_add_relu" else None
    with torch.no_grad():
        got = bna.batch_norm_act(x, bn, residual, residual_bn)
        want = _modules_tail(x, bn, residual, residual_bn)
    assert torch.equal(got, want)
    assert 0 < float((got == 0).float().mean()) < 1  # the ReLU cuts some, not all
    assert bna.launches == dict.fromkeys(bna.FORMS, 0)


def _stand_in(device="cuda", dtype=torch.float32):
    """What `fused_route` reads of a tensor, for a device this machine lacks."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


def test_route_takes_the_kernel_only_for_float32_eval_without_autograd_on_the_card():
    block = Bottleneck(16, 4, project=True).eval()
    convs = [block.conv1, block.conv2, block.conv3, block.downsample[0]]
    norms = [block.bn1, block.bn2, block.bn3, block.downsample[1]]
    with torch.no_grad():
        assert fused_route(_stand_in(), convs, norms)
        assert not fused_route(_stand_in("cpu"), convs, norms)
        assert not fused_route(torch.zeros(1, 16, 2, 2), convs, norms)
        assert not fused_route(_stand_in(dtype=torch.bfloat16), convs, norms)
        block.downsample[1].train()  # one BatchNorm on batch statistics is enough to refuse
        assert not fused_route(_stand_in(), convs, norms)
        block.downsample[1].eval()
        set_compute_dtype(block, torch.bfloat16)
        assert not fused_route(_stand_in(), convs, norms)
        set_compute_dtype(block, None)
        assert fused_route(_stand_in(), convs, norms)
    assert torch.is_grad_enabled()
    assert not fused_route(_stand_in(), convs, norms)  # under autograd
    with torch.inference_mode():
        assert fused_route(_stand_in(), convs, norms)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The trunk's fused branch taken on the CPU, where batch_norm_act runs
    its plain version, and the forms it is called with, in order."""
    calls = []

    def recorded(x, bn, residual=None, residual_bn=None):
        calls.append(bna.FORMS[0 if residual is None else 1 if residual_bn is None else 2])
        return bna.batch_norm_act(x, bn, residual, residual_bn)

    monkeypatch.setattr(backbone, "fused_route", lambda x, convs, norms: not torch.is_grad_enabled()
                        and not any(bn.training for bn in norms))
    monkeypatch.setattr(backbone, "batch_norm_act", recorded)
    return calls


@pytest.mark.parametrize("project,stride", [(False, 1), (True, 1), (True, 2)])
def test_bottleneck_fused_branch_equals_the_modules(fused_on_cpu, project, stride):
    torch.manual_seed(0)
    inplanes = 16 if project else 32
    block = _moved_batch_norms(Bottleneck(inplanes, 8, stride, project=project), 3).eval()
    x = torch.randn(2, inplanes, 9, 9)
    want = block(x)  # under autograd: the modules
    assert fused_on_cpu == []
    with torch.no_grad():
        got = block(x)
    assert torch.equal(got, want.detach())
    assert fused_on_cpu == ["relu", "relu", "bn_add_relu" if project else "add_relu"]


def _small_trunk(seed=0):
    torch.manual_seed(seed)
    return _moved_batch_norms(ResNet50Trunk(3), seed + 1).eval()


def test_trunk_pyramid_fused_branch_equals_the_modules(fused_on_cpu):
    """A whole eval pyramid through the fused branch: every level equal to
    the modules' bit for bit, 33 relu, 12 add_relu and 4 bn_add_relu tails
    a pass, and x0 the stem convolution's output before its BatchNorm."""
    trunk = _small_trunk()
    x = torch.randn(2, 3, 32, 32)
    want = [t.detach() for t in trunk.pyramid(x)]
    with torch.no_grad():
        got = trunk.pyramid(x)
        stem = trunk.conv1(x)
    for level, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), level
    assert torch.equal(got[0], stem)
    assert {form: fused_on_cpu.count(form) for form in bna.FORMS} == {"relu": 33, "add_relu": 12, "bn_add_relu": 4}
    assert fused_on_cpu[:3] == ["relu"] * 3  # the stem, then the first block's conv1 and conv2


def test_training_trunk_runs_the_modules(fused_on_cpu):
    trunk = _small_trunk().train()
    with torch.no_grad():
        trunk.pyramid(torch.randn(2, 3, 32, 32))
    assert fused_on_cpu == []


def _reference_names():
    """The reference's (torchvision's) ResNet-50 parameter and buffer names."""
    def bn(prefix):
        return [f"{prefix}.{k}" for k in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")]

    names = ["conv1.weight", *bn("bn1")]
    for stage, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            p = f"layer{stage}.{b}"
            for i in (1, 2, 3):
                names += [f"{p}.conv{i}.weight", *bn(f"{p}.bn{i}")]
            if b == 0:
                names += [f"{p}.downsample.0.weight", *bn(f"{p}.downsample.1")]
    return names


def test_state_dict_names_are_the_references():
    assert sorted(ResNet50Trunk(3).state_dict()) == sorted(_reference_names())


def test_statistics_written_after_a_call_are_read_by_the_next(fused_on_cpu):
    """Nothing of a BatchNorm is kept between calls: a load_state_dict and
    an in-place write to running_var after a first call both show in the
    next, which equals the modules' with the new statistics."""
    torch.manual_seed(0)
    block = _moved_batch_norms(Bottleneck(16, 8, 1, project=True), 3).eval()
    other = _moved_batch_norms(Bottleneck(16, 8, 1, project=True), 4).eval()
    x = torch.randn(2, 16, 8, 8)
    with torch.no_grad():
        first = block(x)
        block.load_state_dict(other.state_dict())
        loaded = block(x)
        assert not torch.equal(loaded, first)
        assert torch.equal(loaded, other(x))
        block.downsample[1].running_var.mul_(4)
        edited = block(x)
    assert not torch.equal(edited, loaded)
    assert torch.equal(edited, block(x).detach())  # the modules under autograd


def _operands(C=4):
    bn = _moved_batch_norms(BatchNorm2d(C), 0).eval()
    return torch.randn(2, C, 5, 5), bn


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, bn = _operands()
    with pytest.raises(TypeError):
        bna.batch_norm_act(x.double(), bn)
    with pytest.raises(TypeError):
        bna.batch_norm_act(x, bn, x.double())
    with pytest.raises(TypeError):
        bna.batch_norm_act(x, BatchNorm2d(4).double().eval())
    with pytest.raises(ValueError, match="contiguous"):
        bna.batch_norm_act(x.transpose(2, 3), bn)
    with pytest.raises(ValueError, match="contiguous"):
        bna.batch_norm_act(x, bn, x.transpose(2, 3))
    with pytest.raises(ValueError, match="shape"):
        bna.batch_norm_act(x[0], bn)
    with pytest.raises(ValueError, match="shape"):
        bna.batch_norm_act(x, bn, x[:, :, 1:])
    with pytest.raises(ValueError, match="shape"):
        bna.batch_norm_act(x[:, :0], bn)
    with pytest.raises(ValueError, match="channels"):
        bna.batch_norm_act(x[:, :3].contiguous(), bn)
    with pytest.raises(ValueError, match="unsupported device"):
        bna.batch_norm_act(x.to("meta"), _operands()[1].to("meta"))
    with pytest.raises(ValueError, match="meta"):
        bna.batch_norm_act(x, bn, x.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        bna.batch_norm_act(x.to("meta"), bn)
    with pytest.raises(ValueError, match="training"):
        bna.batch_norm_act(x, bn.train())
    with pytest.raises(ValueError, match="needs a residual"):
        bna.batch_norm_act(x, bn.eval(), None, bn)
    with pytest.raises(ValueError, match="running statistics"):
        bna.batch_norm_act(x, nn.BatchNorm2d(4, affine=False).eval())
    assert bna.launches == dict.fromkeys(bna.FORMS, 0)


def test_conv2d_of_the_route_is_the_ports():
    """The predicate reads `compute_dtype`, which only the port's Conv2d has:
    the trunk builds every convolution from it."""
    assert all(isinstance(m, Conv2d) for m in ResNet50Trunk(3).modules() if isinstance(m, nn.Conv2d))
