"""The readers of the program's own spans: device ms per call from hand-made
reductions, None where the span is missing or reads 0, the cells each is
reported in, and the port's spans reaching the benchmark's trace of a
tiny cell on the CPU."""

from __future__ import annotations

import json

import pytest

from bench_tiny import BENCH, REPO, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
BOTH = ["cashmrV2.eval.b32", "ir_depth_pm_fusion.eval.b32"]
READERS = {"trunk_ms.eval": (("hmr.trunk",), BOTH),
           "decoder_ms.eval": (("hmr.decoder", "fusion.recover"), BOTH),
           "smpl_ms.eval": (("smpl.lbs",), BOTH),
           "body_mask_ms.eval": (("ops.body_mask",), ["ir_depth_pm_fusion.eval.b32"])}


def _reader(name):
    from benchmark import harness

    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def _reading(span_device_s, trace_calls=4):
    return {"trace": {"span_device_s": span_device_s}, "traffic": {"trace_calls": trace_calls}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_device_ms_per_call(name):
    spans, _ = READERS[name]
    other = {"benchmark.network": 9.0, "eval.call": 9.5}
    got = _reader(name).read(_reading({**other, **{s: 0.01 * (i + 1) for i, s in enumerate(spans)}}))
    want = sum(0.01 * (i + 1) for i in range(len(spans))) / 4 * 1e3
    assert got == pytest.approx(want)
    assert _reader(name).read(_reading(other)) is None
    assert _reader(name).read(_reading({**other, **{s: 0.0 for s in spans}})) is None


def test_decoder_ms_reads_either_family():
    read = _reader("decoder_ms.eval").read
    assert read(_reading({"hmr.decoder": 0.2}, 2)) == pytest.approx(100.0)
    assert read(_reading({"fusion.recover": 0.6}, 2)) == pytest.approx(300.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_entry_and_its_cells(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert entry["workloads"] == READERS[name][1]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "ms", "lower", "device_trace", "eval_images_per_s")


@pytest.mark.parametrize("workload", BOTH)
def test_program_spans_reach_the_trace(tmp_path, workload):
    """A tiny cell's traced stretch on the CPU holds every span its readers
    read (with no device time there, so each reader finds nothing)."""
    from benchmark import harness, trace

    cell = harness.make_cell(tiny_root(tmp_path), workload, 2**31 + 5, "cpu")
    state = cell.driver.setup(cell.run)
    reading = trace.profile(cell.run.device, lambda: cell.driver.trace_stretch(state))
    seen = set(reading["span_device_s"])
    for name, (spans, cells) in READERS.items():
        if workload in cells:
            assert set(spans) & seen, (name, seen)
    assert {"eval.call", "eval.h2d", "hmr.trunk", "hmr.ief", "smpl.lbs", "eval.j17"} <= seen
    assert ("ops.body_mask" in seen) == (workload == "ir_depth_pm_fusion.eval.b32")
