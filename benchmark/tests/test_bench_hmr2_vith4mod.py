"""The hmr2_vith4mod cell on the CPU: the program against the plain
reference of HMR 2.0 (`reference/vit_hmr.py`) at small widths and 64x64,
the faults that `correct` must catch (the blocks' attention removed among
them), its limits, its FLOP count against FlopCounterMode, the readers of
its spans (`hmr.vit`, `hmr.vit_attn`, `hmr.token_head`) and their
BENCHMARK.json entries, those spans reaching a tiny cell's trace, and the
reference importing nothing of the program.

The configuration's widths are cut to SMALL in the tiny copy, and the
program is built at the same widths (`models/vit.py::WIDTHS`)."""

from __future__ import annotations

import ast
import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_tiny import BENCH, REPO, edit, run_tiny, tiny_root
from test_bench_flops import _count
from test_bench_reference import _answer_altered, _half_batch

CELL = "hmr2_vith4mod.eval.b32"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 256,
         "head_hidden_size": 32, "head_num_layers": 2, "head_num_attention_heads": 2, "head_dim_head": 16,
         "head_mlp_dim": 32}
READERS = {"vit_ms.eval": "hmr.vit", "vit_attn_ms.eval": "hmr.vit_attn", "token_head_ms.eval": "hmr.token_head"}
LAYERS = {"vit_ms.eval": "ViT trunk (models/vit.py::ViT)",
          "vit_attn_ms.eval": "ViT attention cores (models/vit.py::attend)",
          "token_head_ms.eval": "transformer-decoder SMPL head (models/vit.py::SMPLTransformerDecoderHead)",
          "vit_roofline.eval": "ViT trunk (models/vit.py::ViT)"}


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    """A tiny copy of the benchmark with the configuration at SMALL, and the
    program built at SMALL."""
    from inbed_pose_estimation_tpu_torch.models import vit

    monkeypatch.setitem(vit.WIDTHS, "vit_h16", dataclasses.replace(vit.WIDTHS["vit_h16"], **SMALL))
    root = tiny_root(tmp_path)
    edit(root / "benchmark" / "configs" / "hmr2_vith4mod.json", **SMALL)
    return root


def attention_removed(infer):
    """The timed path with every ViT block's attention branch giving zero
    (a forward hook on each `vit.Attention` while the step runs)."""
    from inbed_pose_estimation_tpu_torch.models import vit

    def hook(module, args, output):
        if isinstance(module, vit.Attention):
            return torch.zeros_like(output)

    def broken(inputs):
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            return infer(inputs)
        finally:
            handle.remove()
    return broken


def test_program_matches_the_reference(small_root):
    result = run_tiny(small_root, CELL)
    assert result["correct"] is True, result["check"]
    for name, c in result["check"].items():
        assert c["value"] <= 1e-6, name  # the same float32 arithmetic on the CPU


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered, attention_removed])
def test_a_broken_timed_path_is_not_correct(small_root, fault):
    result = run_tiny(small_root, CELL, wrap=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_limits_cover_exactly_the_compared_numbers(small_root):
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    assert set(run_tiny(small_root, CELL)["check"]) == set(limits)


def _vit_flops(config, batch, res):
    """FlopCounterMode over the reference's trunk: (all of it, its batched
    products, which are the attention cores' alone)."""
    from benchmark import harness, weights

    config = {**config, "img_res": res}
    reference = harness.reference_module(REPO, config)
    w = weights.make_weights(reference.params(config), 5, "cpu")
    x = torch.randn(batch, sum(config["channels"]), res, res, generator=torch.Generator().manual_seed(5))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        reference.vit(w, config, x)
    by_op = counter.get_flop_counts()["Global"]
    return counter.get_total_flops(), sum(v for op, v in by_op.items() if "bmm" in str(op))


@pytest.mark.parametrize("batch,res", [(2, 64), (1, 96)])
def test_flop_count_matches_flop_counter_mode(batch, res):
    flops, network, step = _count("hmr2_vith4mod", batch, res, **SMALL)
    assert flops["network"] == network
    assert flops["step"] == step
    config = {**json.loads((BENCH / "configs" / "hmr2_vith4mod.json").read_text()), **SMALL}
    vit, attn = _vit_flops(config, batch, res)
    assert (flops["vit"], flops["vit_attn"]) == (vit, attn) and 0 < attn < vit < network


def test_full_size_count():
    """The full-size figures PERF.md records: 8,218.8 GFLOP of network a
    call at B=32, 8,118.1 of them in the trunk and 201.4 in its attention
    cores."""
    from benchmark import harness

    config = json.loads((BENCH / "configs" / "hmr2_vith4mod.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "eval.b32.json").read_text())
    got = harness.load_module(BENCH / "flops" / "hmr2_vith4mod.py", "flops_full_hmr2").count(config, traffic)
    assert got == {"network": 8218826506240, "step": 8219298882432, "vit": 8118075392000,
                   "vit_attn": 201410478080}


def _reader(name):
    from benchmark import harness

    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def _reading(span_device_s, trace_calls=4, peak=67e12, vit=8e12):
    return {"trace": {"span_device_s": span_device_s}, "traffic": {"trace_calls": trace_calls},
            "flops": {"network": 8e12, "step": 8e12, "vit": vit},
            "config": {"dtype": "float32", "tf32": False}, "device_kind": "card",
            "peaks": {"card": {"float32": peak}} if peak else {}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_gives_device_ms_per_call(name):
    other = {"benchmark.network": 9.0, "eval.call": 9.5, "hmr.trunk": 0.5}
    read = _reader(name).read
    assert read(_reading({**other, READERS[name]: 0.04})) == pytest.approx(10.0)
    assert read(_reading(other)) is None
    assert read(_reading({**other, READERS[name]: 0.0})) is None


def test_vit_roofline_reads_flops_over_span_time_and_peak():
    read = _reader("vit_roofline.eval").read
    # 4 calls of 8.04e12 FLOPs in 0.96 s of device time is 33.5 TFLOP/s: half of 67.
    assert read(_reading({"hmr.vit": 0.96}, vit=8.04e12)) == pytest.approx(50.0)
    assert read(_reading({"benchmark.network": 1.0})) is None
    assert read(_reading({"hmr.vit": 0.96}, peak=None)) is None
    assert read(_reading({"hmr.vit": 0.96}, vit=None)) is None


def test_benchmark_json_entries():
    config = next(c for c in SPEC["configs"] if c["name"] == "hmr2_vith4mod")
    assert config["file"] == "benchmark/configs/hmr2_vith4mod.json" and config["reduced"] == []
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hmr2_vith4mod", "eval.b32", 1)
    lists = {m["name"]: m.get("workloads") for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in ("eval_images_per_s", "mfu.eval", "network_roofline.eval", "idle_share.eval", "h2d_ms.eval",
                 "smpl_ms.eval"):
        assert CELL in lists[name], name
    for name in ("trunk_ms.eval", "decoder_ms.eval", "multi_trunk_ms.eval", "cross_att_ms.eval"):
        assert CELL not in lists[name], name
    for name, layer in LAYERS.items():
        entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
        assert entry == {"name": name, "unit": "%" if "roofline" in name else "ms",
                         "better": "higher" if "roofline" in name else "lower", "source": "device_trace",
                         "layer": layer, "moves": "eval_images_per_s", "workloads": [CELL]}


def test_new_spans_reach_the_trace(small_root):
    """A tiny cell's traced stretch on the CPU holds the spans its readers
    read, beside the network's, SMPL's and the entry's, and none of the
    ResNet families' spans."""
    from benchmark import harness, trace

    cell = harness.make_cell(small_root, CELL, 2**31 + 5, "cpu")
    state = cell.driver.setup(cell.run)
    seen = set(trace.profile(cell.run.device, lambda: cell.driver.trace_stretch(state))["span_device_s"])
    assert {"benchmark.network", "hmr.vit", "hmr.vit_attn", "hmr.token_head", "smpl.lbs", "eval.j17"} <= seen
    assert not seen & {"hmr.trunk", "hmr.ief", "hmr.decoder", "hmr.multi_trunk", "hmr.cross_att"}


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((BENCH / "reference" / "vit_hmr.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add("." if node.level else node.module.split(".")[0])
    assert tops == {"__future__", "torch", "."}, tops
    source = (BENCH / "reference" / "vit_hmr.py").read_text()
    assert "scaled_dot_product_attention" not in source
