"""PyTorch port, HMR 2.0 (`hmr2_vith4mod`, `models/vit.py`) on the CPU:
the registered model at small widths against the benchmark's plain
reference (`benchmark/reference/vit_hmr.py`) through the eval entry, with
controls that must miss; the published widths built on the meta device; a
train step at small widths, whose drop path draws from the caller's
generator; the model's spans and its attention counter."""

import dataclasses
import json
import pathlib
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark import harness, program, smpl_assets, traffic_gen, weights
from benchmark.reference import nets
from inbed_pose_estimation_tpu_torch.fitting import synthetic_gmm_prior
from inbed_pose_estimation_tpu_torch.models import build_model, factory, get_spec, vit
from inbed_pose_estimation_tpu_torch.smpl import synthetic_smpl_model
from inbed_pose_estimation_tpu_torch.train import init_train_state, make_train_step, step_feed_keys
from test_torch_port_tracing import Opt, _train_batch, traced_spans
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
NAME, RES, B, SEED = "hmr2_vith4mod", 64, 2, 2**31 + 20
KEYS = ("rotmat", "betas", "cam", "vertices", "keypoints_3d_17")
SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 256,
         "head_hidden_size": 32, "head_num_layers": 2, "head_num_attention_heads": 2, "head_dim_head": 16,
         "head_mlp_dim": 32}
# The port runs the reference's float32 operations in the reference's
# order, so on the CPU it reads 0; 1e-6 of the largest magnitude leaves
# room for a sum taken in another order, and each control misses it.
TOL = 1e-6


def _config():
    return json.loads((REPO / "benchmark" / "configs" / f"{NAME}.json").read_text())


@pytest.fixture
def small(monkeypatch):
    """The registered model built at the small widths."""
    monkeypatch.setitem(vit.WIDTHS, "vit_h16", dataclasses.replace(vit.WIDTHS["vit_h16"], **SMALL))


def _run():
    config = {**_config(), **SMALL, "img_res": RES}
    reference = harness.reference_module(REPO, config)
    dev = torch.device("cpu")
    return harness.Run(config, {"driver": "eval", "batch": B, "pool": 1}, SEED, dev, reference,
                       weights.make_weights(reference.params(config), SEED, dev),
                       smpl_assets.make_assets(config["smpl"], SEED, dev))


def _gaps(got, want):
    return {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in KEYS}


def _scale_dropped(model):
    model.backbone.blocks[0].attn.scale = 1.0


def _norm1_gain_changed(model):
    with torch.no_grad():
        model.backbone.blocks[1].norm1.weight.mul_(1.001)


@pytest.mark.parametrize("control", [None, _scale_dropped, _norm1_gain_changed],
                         ids=["port", "attention_scale_dropped", "norm1_gain_changed"])
def test_port_matches_the_benchmark_reference(small, control):
    """The reference's parameters load strictly into the registered model,
    and the eval step that `benchmark/program.py` builds (`build_model` ->
    `make_inference_fn`, one pass) gives the reference's rotmat, betas,
    cam, vertices and J17 within TOL; a control (the first block's
    attention scale dropped, the second block's norm1 gain moved by 0.1%)
    misses by more."""
    run = _run()
    model, infer = program.build_inference(run)
    inputs = traffic_gen.make_pool(run.config, run.traffic, run.seed, run.device)[0]
    want = nets.infer(run.reference.network, run.weights, run.config, inputs, run.assets)
    if control is not None:
        control(model)
    gaps = _gaps(infer(inputs), want)
    if control is None:
        assert max(gaps.values()) <= TOL, gaps
    else:
        assert max(gaps.values()) > TOL, gaps


def test_published_widths_on_the_meta_device(monkeypatch):
    """`build_model` at the published widths, on the meta device: 671.4 M
    parameters (631.9 M in the trunk), named as the reference's `params`
    names them, and the configuration's widths are the port's."""
    monkeypatch.setattr(factory, "resolve_device", torch.device)
    with torch.device("meta"):
        model, spec = build_model(NAME, device="meta")
    assert spec.trunk == "vit_h16" and spec.input_mode == "concat" and spec.in_channels == 6 and not spec.cascade
    assert isinstance(model, vit.HMR2) and not model.training
    assert sum(p.numel() for p in model.parameters()) == 671_447_197
    assert sum(p.numel() for p in model.backbone.parameters()) == 631_900_160
    config = _config()
    reference = harness.reference_module(REPO, config)
    specs = {name: shape for name, shape, _, _ in reference.params(config)}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == specs
    w = vit.WIDTHS["vit_h16"]
    assert {f.name: config[f.name] for f in dataclasses.fields(w)} == dataclasses.asdict(w)
    assert config["head_context_dim"] == w.hidden_size and config["qkv_bias"] is True
    assert model.backbone.pos_embed.shape == (1, 197, 1280)
    rates = [b.drop_path_rate for b in model.backbone.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.55) and len(rates) == 32


def _step(model, spec, seed):
    smpl = synthetic_smpl_model(0, device="cpu")
    opt = Opt()
    opt.run_smplify = False
    state = init_train_state(model, opt, np.zeros((16, 82), np.float32), seed=seed, device="cpu")
    step = make_train_step(model, spec, smpl, synthetic_gmm_prior(device="cpu"), opt, device="cpu")
    return step(state, _train_batch(step_feed_keys(spec)))


def test_train_step_reaches_every_parameter(small):
    """One step at small widths with drop path off: a finite loss, and a
    non-zero gradient on every parameter but the token embedding's weight,
    which multiplies HMR 2.0's zero token (its gradient is zero there)."""
    torch.manual_seed(0)
    model, spec = build_model(NAME, device="cpu", img_res=RES, dropout_rate=0.0)
    state, metrics = _step(model, spec, seed=1)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    zero_token = "smpl_head.transformer.to_token_embedding.weight"
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert bool(p.grad.abs().sum() > 0) == (name != zero_token), name


def test_drop_path_draws_from_the_callers_generator(small):
    """Two steps of one model's copies with generators seeded alike give
    the same loss and parameters, bit for bit, and leave torch's default
    generator alone; another seed draws other drop-path masks."""
    torch.manual_seed(0)
    model, spec = build_model(NAME, device="cpu", img_res=RES)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for seed in (1, 1, 2):
        model.load_state_dict(start)
        default = torch.random.get_rng_state()
        state, metrics = _step(model, spec, seed)
        assert torch.equal(torch.random.get_rng_state(), default)
        results.append((metrics["loss"], {k: v.clone() for k, v in model.state_dict().items()}))
    (loss_a, params_a), (loss_b, params_b), (loss_c, _) = results
    assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
    assert all(torch.equal(params_a[k], params_b[k]) for k in params_a)
    assert not torch.equal(loss_a, loss_c)


def test_eval_call_spans_and_attention_calls(small, tmp_path):
    """An eval call opens `hmr.vit` once, `hmr.vit_attn` once per block
    under it and `hmr.token_head` once, and none of HMRCore's spans; the
    counter reads one self attention per block and per head layer and one
    cross attention per head layer, all on the plain route."""
    run = _run()
    _, infer = program.build_inference(run)
    inputs = traffic_gen.make_pool(run.config, run.traffic, run.seed, run.device)[0]
    before = Counter(vit.attention_calls)
    _, tree = traced_spans(lambda: infer(inputs), tmp_path)
    calls = Counter(vit.attention_calls)
    calls.subtract(before)
    blocks, layers = SMALL["num_hidden_layers"], SMALL["head_num_layers"]
    assert +calls == Counter({("plain", "self"): blocks + layers, ("plain", "cross"): layers})
    counts = Counter(n for n, _ in tree)
    assert counts == Counter({"eval.call": 1, "eval.h2d": 1, "hmr.vit": 1, "hmr.vit_attn": blocks,
                              "hmr.token_head": 1, "smpl.lbs": 1, "eval.j17": 1})
    assert {tree[p][0] for n, p in tree if n == "hmr.vit_attn"} == {"hmr.vit"}
    assert {tree[p][0] for n, p in tree if n in ("hmr.vit", "hmr.token_head")} == {"eval.call"}


def test_the_spec_selects_the_trunk():
    """The trunk is a field of the spec: every other name keeps ResNet-50."""
    assert {n: get_spec(n).trunk for n in factory.model_names() if get_spec(n).trunk != "resnet50"} == \
        {NAME: "vit_h16"}
