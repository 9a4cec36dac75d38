"""The featatt_cashmr cell on the CPU: the program against the plain
reference of the multi-trunk cascade at a tiny size, the faults that
`correct` must catch (the cross attention bypassed among them), its limits,
its FLOP count against FlopCounterMode, the readers of its spans
(`hmr.multi_trunk`, `hmr.cross_att`) and their BENCHMARK.json entries, and
those spans reaching a tiny cell's trace."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_tiny import BENCH, REPO, run_tiny, tiny_root
from test_bench_flops import _count
from test_bench_reference import _answer_altered, _half_batch

CELL = "featatt_cashmr.eval.b32"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
READERS = {"multi_trunk_ms.eval": "hmr.multi_trunk", "cross_att_ms.eval": "hmr.cross_att"}
LAYERS = {"multi_trunk_ms.eval": "per-modality trunks (models/hmr.py::MultiTrunkCore)",
          "cross_att_ms.eval": "cross attention (models/attention.py::CrossAttention)",
          "cross_att_roofline.eval": "cross attention (models/attention.py::CrossAttention)"}


def bypass_cross_attention(infer):
    """The timed path with the program's cross attention replaced by its
    input maps joined on channels (a forward hook on every
    `CrossAttention` while the step runs)."""
    from inbed_pose_estimation_tpu_torch.models.attention import CrossAttention

    def hook(module, args, output):
        if isinstance(module, CrossAttention):
            return torch.cat(list(args[0]), 1)

    def broken(inputs):
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            return infer(inputs)
        finally:
            handle.remove()
    return broken


def test_program_matches_the_reference(tmp_path):
    result = run_tiny(tiny_root(tmp_path), CELL)
    assert result["correct"] is True, result["check"]
    for name, c in result["check"].items():
        assert c["value"] <= 1e-6, name  # the same float32 arithmetic on the CPU


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered, bypass_cross_attention])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    result = run_tiny(tiny_root(tmp_path), CELL, wrap=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_limits_cover_exactly_the_compared_numbers(tmp_path):
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    assert set(run_tiny(tiny_root(tmp_path), CELL)["check"]) == set(limits)


def _cross_att_flops(config, batch, res):
    """FlopCounterMode over the reference's cross attention alone, once per
    pass, on maps of x4's size."""
    from benchmark import harness, weights

    reference = harness.reference_module(REPO, config)
    w = weights.make_weights(reference.params(config), 5, "cpu")
    h = res
    for _ in range(5):
        h = (h - 1) // 2 + 1
    g = torch.Generator().manual_seed(5)
    x4s = [torch.randn(batch, reference.WIDTH, h, h, generator=g) for _ in config["channels"]]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        reference.cross_attention(w, x4s)
    return counter.get_total_flops() * config["num_cas_iters"]


@pytest.mark.parametrize("batch,res", [(2, 64), (1, 96)])
def test_flop_count_matches_flop_counter_mode(batch, res):
    flops, network, step = _count("featatt_cashmr", batch, res)
    assert flops["network"] == network
    assert flops["step"] == step
    config = json.loads((BENCH / "configs" / "featatt_cashmr.json").read_text())
    config["img_res"] = res
    assert flops["cross_att"] == _cross_att_flops(config, batch, res) > 0


def test_full_size_count():
    """The full-size figures PERF.md records: 4,140.9 GFLOP of network a
    call at B=32, 328.3 of them in the cross attention."""
    from benchmark import harness

    config = json.loads((BENCH / "configs" / "featatt_cashmr.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "eval.b32.json").read_text())
    got = harness.load_module(BENCH / "flops" / "featatt_cashmr.py", "flops_full_featatt").count(config, traffic)
    assert got == {"network": 4140934365184, "step": 4141406741376, "cross_att": 328268251136}


def _reader(name):
    from benchmark import harness

    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def _reading(span_device_s, trace_calls=4, peak=67e12, cross_att=328e9):
    return {"trace": {"span_device_s": span_device_s}, "traffic": {"trace_calls": trace_calls},
            "flops": {"network": 4e12, "step": 4e12, "cross_att": cross_att},
            "config": {"dtype": "float32", "tf32": False}, "device_kind": "card",
            "peaks": {"card": {"float32": peak}} if peak else {}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_gives_device_ms_per_call(name):
    other = {"benchmark.network": 9.0, "hmr.trunk": 0.5, "eval.call": 9.5}
    read = _reader(name).read
    assert read(_reading({**other, READERS[name]: 0.04})) == pytest.approx(10.0)
    assert read(_reading(other)) is None
    assert read(_reading({**other, READERS[name]: 0.0})) is None


def test_cross_att_roofline_reads_flops_over_span_time_and_peak():
    read = _reader("cross_att_roofline.eval").read
    # 4 calls of 335e9 FLOPs in 0.04 s of device time is 33.5 TFLOP/s: half of 67.
    assert read(_reading({"hmr.cross_att": 0.04}, cross_att=335e9)) == pytest.approx(50.0)
    assert read(_reading({"benchmark.network": 1.0})) is None
    assert read(_reading({"hmr.cross_att": 0.04}, peak=None)) is None
    assert read(_reading({"hmr.cross_att": 0.04}, cross_att=None)) is None


def test_benchmark_json_entries():
    config = next(c for c in SPEC["configs"] if c["name"] == "featatt_cashmr")
    assert config["file"] == "benchmark/configs/featatt_cashmr.json" and config["reduced"] == []
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("featatt_cashmr", "eval.b32", 1)
    lists = {m["name"]: m.get("workloads") for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in ("eval_images_per_s", "mfu.eval", "network_roofline.eval", "idle_share.eval", "h2d_ms.eval"):
        assert lists[name][-1] == CELL, name
    for name, layer in LAYERS.items():
        entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
        assert entry == {"name": name, "unit": "%" if "roofline" in name else "ms",
                         "better": "higher" if "roofline" in name else "lower", "source": "device_trace",
                         "layer": layer, "moves": "eval_images_per_s", "workloads": [CELL]}


def test_new_spans_reach_the_trace(tmp_path):
    """A tiny cell's traced stretch on the CPU holds the spans its readers
    read, beside the network's and the other layers' spans."""
    from benchmark import harness, trace

    cell = harness.make_cell(tiny_root(tmp_path), CELL, 2**31 + 5, "cpu")
    state = cell.driver.setup(cell.run)
    reading = trace.profile(cell.run.device, lambda: cell.driver.trace_stretch(state))
    assert {"benchmark.network", "hmr.multi_trunk", "hmr.trunk", "hmr.cross_att", "hmr.decoder", "hmr.ief",
            "smpl.lbs", "eval.j17"} <= set(reading["span_device_s"])
