"""The harness on the CPU: BENCHMARK.json against the contract's shape,
every part found by name, the result line's keys, a new cell added as new
files only, no card meaning no result, and the imports the benchmark may
not make."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench_tiny import BENCH, REPO, run_tiny, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and 1 <= len(c["why"]) <= 200
    for entry in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        reported = [m["name"] for m in SPEC["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layer and all(m["moves"] in reported for m in layer)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(workload):
    w = next(x for x in SPEC["workloads"] if x["name"] == workload)
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (REPO / config["file"]).is_file() and config["file"].startswith("benchmark/")
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (BENCH / "limits" / f"{workload}.json").is_file()
    assert (BENCH / "flops" / f"{w['config']}.py").is_file()
    for m in SPEC["per_layer"]:
        if workload in m.get("workloads", []):
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(tmp_path, traced):
    result = run_tiny(tiny_root(tmp_path), "cashmrV2.eval.b32", traced=traced)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for name, c in result["check"].items():
        assert c["value"] <= c["limit"], name
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
        assert result["metrics"] == {}  # no card: no peak, no device time, so every reader finds nothing
    else:
        assert set(result["metrics"]) == {"setup_s", "eval_images_per_s"}


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    plus BENCHMARK.json entries, with no existing file edited."""
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "cashmrV2.json").read_text())
    cfg.update(num_cas_iters=3)
    (b / "configs" / "cashmrV2_3pass.json").write_text(json.dumps(cfg))
    (b / "traffic" / "eval.b3.json").write_text(json.dumps(
        {"driver": "eval", "batch": 3, "pool": 2, "warm_calls": 1, "trace_calls": 1, "check": 1}))
    (b / "limits" / "cashmrV2_3pass.eval.b3.json").write_text((b / "limits" / "cashmrV2.eval.b32.json").read_text())
    (b / "flops" / "cashmrV2_3pass.py").write_text((b / "flops" / "cashmrV2.py").read_text())
    (b / "metrics" / "calls_traced.eval.py").write_text(
        "def read(reading):\n    return float(reading['traffic']['trace_calls'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cashmrV2_3pass", "source": "test", "file": "benchmark/configs/cashmrV2_3pass.json",
                            "reduced": ["num_cas_iters"], "why": "test"})
    spec["workloads"].append({"name": "cashmrV2_3pass.eval.b3", "config": "cashmrV2_3pass", "traffic": "eval.b3",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "eval_images_per_s":
            m["workloads"].append("cashmrV2_3pass.eval.b3")
    spec["per_layer"].append({"name": "calls_traced.eval", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "device", "moves": "eval_images_per_s",
                              "workloads": ["cashmrV2_3pass.eval.b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = run_tiny(root, "cashmrV2_3pass.eval.b3", traced=True)
    assert result["correct"] is True
    assert result["metrics"]["calls_traced.eval"]["value"] == 1.0
    assert {p: p.read_bytes() for p in before} == before


STUB_ARCHITECTURE = """
import torch.nn.functional as F


def params(config):
    return [("fc.weight", (4, config["width"]), "linear", config["width"]),
            ("fc.bias", (4,), "bias", config["width"])]


def network(w, config, inputs, assets, masks=None, bands=False):
    return {"y": F.linear(inputs[0], w["fc.weight"], w["fc.bias"])}
"""

STUB_DRIVER = """
import time
from types import SimpleNamespace

import torch


def setup(run):
    x = torch.randn(run.traffic["batch"], run.config["width"], generator=torch.Generator().manual_seed(run.seed))
    return SimpleNamespace(run=run, x=x, out=None, calls=0)


def _call(state):
    run = state.run
    state.out = run.reference.network(run.weights, run.config, (state.x,), run.assets)
    state.calls += 1


def measure(state, seconds):
    start, t0 = state.calls, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _call(state)
    n, elapsed = state.calls - start, time.perf_counter() - t0
    return {"e2e": {"stub_calls_per_s": n / elapsed}, "attempted": n, "calls": n, "seconds": elapsed}


def trace_stretch(state):
    for _ in range(state.run.traffic["trace_calls"]):
        _call(state)


def collect(state):
    return [(state.x, state.out)]


def release(state):
    state.out = None


def compare(run, collected):
    return [{"y": float((got["y"] - run.reference.network(run.weights, run.config, (x,), run.assets)["y"]).abs().max())}
            for x, got in collected], {}
"""


def test_a_new_driver_kind_and_architecture_are_new_files_only(tmp_path):
    """A driver kind with its own comparison, an architecture with its own
    reference, an end-to-end metric and a per-layer metric added as files
    plus BENCHMARK.json entries, with no existing file edited."""
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    (b / "reference" / "stub_linear.py").write_text(STUB_ARCHITECTURE)
    (b / "drivers" / "stub.py").write_text(STUB_DRIVER)
    smpl = json.loads((b / "configs" / "cashmrV2.json").read_text())["smpl"]
    (b / "configs" / "stub_linear.json").write_text(json.dumps({"architecture": "stub_linear", "width": 6,
                                                                "smpl": smpl}))
    (b / "traffic" / "stub.b2.json").write_text(json.dumps({"driver": "stub", "batch": 2, "trace_calls": 3}))
    (b / "limits" / "stub_linear.stub.b2.json").write_text(json.dumps({"y": 0.0}))
    (b / "flops" / "stub_linear.py").write_text(
        "def count(config, traffic):\n    n = 2 * traffic['batch'] * config['width'] * 4\n"
        "    return {'network': n, 'step': n}\n")
    (b / "metrics" / "calls_traced.stub.py").write_text(
        "def read(reading):\n    return float(reading['traffic']['trace_calls'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stub_linear", "source": "test", "file": "benchmark/configs/stub_linear.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "stub_linear.stub.b2", "config": "stub_linear", "traffic": "stub.b2",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "stub_calls_per_s", "unit": "calls/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["stub_linear.stub.b2"]})
    spec["per_layer"].append({"name": "calls_traced.stub", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "device", "moves": "stub_calls_per_s",
                              "workloads": ["stub_linear.stub.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    plain = run_tiny(root, "stub_linear.stub.b2")
    assert plain["correct"] is True and plain["check"] == {"y": {"value": 0.0, "limit": 0.0}}
    assert set(plain["metrics"]) == {"setup_s", "stub_calls_per_s"}
    traced = run_tiny(root, "stub_linear.stub.b2", traced=True)
    assert traced["correct"] is True and traced["metrics"]["calls_traced.stub"]["value"] == 3.0
    assert {p: p.read_bytes() for p in before} == before


def test_no_card_means_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints nothing on stdout."""
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "cashmrV2.eval.b32", "--seed",
                           str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def _imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = _imported_tops(BENCH / path)
    assert not tops & {"jax", "jaxlib", "flax", "inbed_pose_estimation_tpu"}, tops
    if path.startswith("reference/"):
        assert "inbed_pose_estimation_tpu_torch" not in tops and "benchmark" not in tops


def test_a_run_loads_no_jax(tmp_path):
    """In a fresh process, a whole tiny run leaves no JAX module loaded."""
    root = tiny_root(tmp_path)
    code = ("import sys; sys.path.insert(0, %r); from bench_tiny import run_tiny; from pathlib import Path; "
            "r = run_tiny(Path(%r), 'cashmrV2.eval.b32'); from benchmark import harness; "
            "print(r['correct'], harness.forbidden_modules())") % (str(Path(__file__).parent), str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-2:] == ["True", "[]"]


def test_trace_reduction_on_a_synthetic_trace():
    """Busy time is the union of device intervals, span time counts the
    kernels launched inside the span, HtoD copies are summed, and each idle
    gap is named by the innermost host event over its middle."""
    from benchmark import trace

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        x("user_annotation", "benchmark.network", 0, 50),
        x("cpu_op", "aten::conv2d", 0, 10), x("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
        x("cuda_runtime", "cudaLaunchKernel", 60, 1, 2), x("cpu_op", "aten::copy_", 100, 60),
        x("cuda_runtime", "cudaMemcpyAsync", 110, 40, 3),
        x("kernel", "conv", 20, 30, 1), x("kernel", "conv", 40, 20, 2), x("kernel", "add", 70, 10, 2),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 150, 20, 3),
    ]
    r = trace.reduce_trace(events, 200e-6)
    assert r["busy_s"] == pytest.approx((40 + 10 + 20) * 1e-6)
    assert r["span_device_s"]["benchmark.network"] == pytest.approx(30e-6)
    assert r["h2d_s"] == pytest.approx(20e-6)
    assert r["device_ops"][0] == ["conv", pytest.approx(50e-6)]
    assert r["idle_gaps"][0] == ["cudaMemcpyAsync", pytest.approx(70e-6)]
