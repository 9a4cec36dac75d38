"""PyTorch port, the multi-trunk cascade's reuse of unchanged trunks on the
CPU (RES 64, batch 2, seeded weights with BatchNorm off its init values
and non-zero attention gains): a trunk whose input is the very tensor of
the previous pass, not written since, in eval mode and without autograd,
takes that pass's x4 instead of running again.  The answers equal those of
plain forwards handed nothing from a previous pass, bit for bit;
`hmr.trunk_passes` counts the trunks run and reused; an input written in
place, an inference tensor, autograd, a decoder reading the trunk's skips
or training mode runs the trunk again, and training leaves BatchNorm's
running statistics as two independent forwards do."""

import copy

import numpy as np
import pytest
import torch

from inbed_pose_estimation_tpu_torch.evaluation import load_j_regressor_h36m, make_inference_fn
from inbed_pose_estimation_tpu_torch.models import build_model, cascade_apply, hmr
from inbed_pose_estimation_tpu_torch.models.backbone import BatchNorm2d
from inbed_pose_estimation_tpu_torch.smpl import lbs, synthetic_smpl_model
from torch_threads import one_torch_thread  # noqa: F401

RES, B = 64, 2

# Trunk passes (run, reused) of one two-pass eval call.  featcat has no
# cascade; ir_depth_featatt_cashmrV2 feeds both of its slots back.
PASSES = {"featcat": (2, 0), "featcat_cashmr": (5, 3), "featatt_cashmr": (5, 3),
          "ir_depth_featatt_cashmrV2": (4, 0)}


def _model(name, seed=0):
    torch.manual_seed(seed)
    model, spec = build_model(name, device="cpu", img_res=RES)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
        if model.cross_att is not None:  # at zero the attention is the identity
            model.cross_att.gamma.uniform_(0.25, 0.75, generator=g)
    return model, spec


def _inputs(spec, seed):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.normal(0, 1, (B, 3 if m == "img" else 1, RES, RES)).astype(np.float32))
                 for m in spec.modalities)


def _counted(fn):
    """fn()'s result and the trunk passes (run, reused) it made."""
    before = dict(hmr.trunk_passes)
    result = fn()
    return result, tuple(hmr.trunk_passes[k] - before[k] for k in ("run", "reused"))


def _plain_cascade(model, spec, inputs, final_recon):
    """The two passes as plain forwards, each handed nothing from the other."""
    first = model(inputs)
    current = list(inputs)
    for name, slot in spec.cascade_feed_map:
        current[slot] = first.recon[name]
    return first, model(tuple(current), compute_recon=final_recon)


def _assert_equal(got, want):
    for k in ("rotmat", "betas", "cam", "pose6d"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.recon.keys() == want.recon.keys()
    for k, v in want.recon.items():
        assert torch.equal(got.recon[k], v), k


@pytest.mark.parametrize("final_recon", [False, True])
@pytest.mark.parametrize("name", ["featatt_cashmr", "featcat_cashmr"])
def test_eval_call_equals_two_plain_forwards(name, final_recon):
    """make_inference_fn's answers equal, with torch.equal, those of two
    plain forwards: the pass-1 decoder (final_recon) reads the depth
    trunk's skips, and that trunk's input is the recovered depth, so it
    runs either way."""
    model, spec = _model(name)
    smpl = synthetic_smpl_model(0, device="cpu")
    infer = make_inference_fn(model, spec, smpl, load_j_regressor_h36m(), num_cas_iters=2,
                              final_recon=final_recon, device="cpu")
    inputs = _inputs(spec, 1)
    got, passes = _counted(lambda: infer(inputs))
    assert passes == PASSES[name]
    with torch.no_grad():
        (_, want), plain_passes = _counted(lambda: _plain_cascade(model, spec, inputs, final_recon))
        verts, _ = lbs(smpl, want.betas, want.rotmat)
    assert plain_passes == (8, 0)
    for k in ("rotmat", "betas", "cam"):
        assert torch.equal(got[k], getattr(want, k)), k
    assert torch.equal(got["vertices"], verts)
    assert got["recon"].keys() == want.recon.keys() == ({"depth"} if final_recon else set())
    for k, v in want.recon.items():
        assert torch.equal(got["recon"][k], v), k


@pytest.mark.parametrize("name", sorted(PASSES))
def test_trunk_passes_per_eval_call(name):
    """The counter a call: 5 run and 3 reused where only the depth is fed
    back, 4 and 0 where both of two slots are, 2 and 0 without a cascade;
    and the same again on a second call, which takes nothing from the
    first."""
    model, spec = _model(name)
    infer = make_inference_fn(model, spec, synthetic_smpl_model(0, device="cpu"), num_cas_iters=2,
                              final_recon=False, device="cpu")
    inputs = _inputs(spec, 2)
    first, passes = _counted(lambda: infer(inputs))
    assert passes == PASSES[name]
    second, passes = _counted(lambda: infer(inputs))
    assert passes == PASSES[name]
    assert torch.equal(first["rotmat"], second["rotmat"])


@pytest.mark.parametrize("case", ["written_in_place", "inference_tensors", "autograd", "skips_read"])
def test_trunks_run_again_where_reuse_cannot_be_shown_sound(case):
    """featatt_cashmr's cascade where the rule cannot show a trunk's
    output unchanged, or the pass needs more of it than x4: an RGB input
    written in place after pass 0 runs its trunk again (6 run, 2 reused);
    inputs made under inference mode (no version counter) and a cascade
    under autograd run all 8; with nothing fed back and pass 1 decoding,
    the depth trunk, whose skips the decoder reads, runs again (5, 3).  The
    answers equal plain forwards on what each pass saw."""
    model, spec = _model("featatt_cashmr")
    inputs = _inputs(spec, 3)
    if case == "inference_tensors":
        with torch.inference_mode():
            inputs = tuple(x.clone() for x in inputs)
    original = inputs[0].clone()
    shifted = original + 0.5
    feed_map = () if case == "skips_read" else spec.cascade_feed_map

    def apply_fn(mods, **kw):
        out = model(mods, **kw)
        if case == "written_in_place" and "carry" not in kw:
            mods[0].add_(0.5)
        return out

    with torch.set_grad_enabled(case == "autograd"):
        outs, passes = _counted(lambda: cascade_apply(apply_fn, inputs, 2, feed_map=feed_map,
                                                      final_recon=case == "skips_read"))
        assert passes == {"written_in_place": (6, 2), "inference_tensors": (8, 0), "autograd": (8, 0),
                          "skips_read": (5, 3)}[case]
        if case == "written_in_place":
            assert torch.equal(inputs[0], shifted)
            first = model((original,) + inputs[1:])
            current = [shifted, inputs[1], first.recon["depth"], inputs[3]]
            want = [first, model(tuple(current), compute_recon=False)]
        elif case == "skips_read":
            want = [model(inputs), model(inputs)]
        else:
            want = _plain_cascade(model, spec, inputs, False)
    for got, w in zip(outs, want):
        _assert_equal(got, w)
        assert got.carry is None


@pytest.mark.parametrize("grad", [True, False])
def test_training_cascade_reuses_nothing(grad):
    """A featatt_cashmr cascade in training mode runs all 8 trunk passes,
    with or without autograd, and leaves every BatchNorm buffer, and the
    answers, as two independent forwards of a copy of the model do (the
    IEF's dropout drawn from generators seeded alike)."""
    model, spec = _model("featatt_cashmr")
    twin = copy.deepcopy(model)
    model.train()
    twin.train()
    inputs = _inputs(spec, 4)
    g, g_twin = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    with torch.set_grad_enabled(grad):
        outs, passes = _counted(lambda: cascade_apply(lambda mods, **kw: model(mods, generator=g, **kw), inputs, 2,
                                                      feed_map=spec.cascade_feed_map))
        first = twin(inputs, generator=g_twin)
        second = twin((inputs[0], inputs[1], first.recon["depth"], inputs[3]), generator=g_twin)
    assert passes == (8, 0)
    for got, want in zip(outs, (first, second)):
        _assert_equal(got, want)
    buffers = dict(twin.named_buffers())
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
