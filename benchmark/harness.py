"""Run one cell of `BENCHMARK.json` and build its result line.

Everything is found by name under the benchmark's folder:

  configs       the file that BENCHMARK.json's configuration entry names
  reference/<architecture>.py   the configuration's plain reference:
                           params(config) and network(...)
  traffic/<traffic>.json   parameters for the generator; `driver` names
                           drivers/<driver>.py
  limits/<workload>.json   the limit of each number that decides `correct`
  flops/<config>.py        count(config, traffic) -> FLOPs of a call
  metrics/<metric>.py      read(reading) -> value or None, one per-layer metric

A driver module has setup(run), measure(state, seconds),
trace_stretch(state), collect(state), release(state) and
compare(run, collected) -> (numbers of each answer, notes): it holds what
the timed path produced against the plain reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

from . import program, smpl_assets, trace, weights

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "inbed_pose_estimation_tpu")


def load_spec(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Run:
    """What a driver and the check need: the cell's configuration and
    traffic, the seed, the device, the architecture's reference module, the
    weights and SMPL assets made from the seed, and (for tests) a wrapper
    put around the program's entry."""
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    reference: object
    weights: dict
    assets: dict
    wrap: Optional[Callable] = None


@dataclass
class Cell:
    spec: dict
    workload: dict
    limits: dict
    driver: object
    run: Run


def reference_module(root, config):
    """The plain reference of the configuration's architecture."""
    arch = config["architecture"]
    return load_module(Path(root) / "benchmark" / "reference" / f"{arch}.py", f"benchmark.reference.{arch}")


def make_cell(root, workload_name: str, seed: int, device, wrap=None) -> Cell:
    """Find the cell's files by name and make its weights and assets."""
    root = Path(root)
    bench = root / "benchmark"
    spec = load_spec(root)
    workload = by_name(spec["workloads"], workload_name, "workload")
    config = load_json(root / by_name(spec["configs"], workload["config"], "configuration")["file"])
    traffic = load_json(bench / "traffic" / f"{workload['traffic']}.json")
    limits = load_json(bench / "limits" / f"{workload_name}.json")
    driver = load_module(bench / "drivers" / f"{traffic['driver']}.py", f"benchmark_driver_{traffic['driver']}")
    reference = reference_module(root, config)
    dev, seed = torch.device(device), int(seed)
    run = Run(config, traffic, seed, dev, reference, weights.make_weights(reference.params(config), seed, dev),
              smpl_assets.make_assets(config["smpl"], seed, dev), wrap)
    return Cell(spec, workload, limits, driver, run)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def run_cell(root, workload_name: str, seed: int, seconds: float, traced: bool, device="cuda",
             t0: Optional[float] = None, wrap: Optional[Callable] = None) -> dict:
    """One run of a cell; returns the result line's dict (its last key,
    `check`, holds each compared number beside its limit; `notes`, when
    the comparison has any, counts how it went)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = Path(root) / "benchmark"
    cell = make_cell(root, workload_name, seed, device, wrap)
    spec, workload, limits, driver, run = cell.spec, cell.workload, cell.limits, cell.driver, cell.run
    config, traffic, dev = run.config, run.traffic, run.device
    state = driver.setup(run)
    program.sync(dev)
    setup_s = time.perf_counter() - t0

    measured = driver.measure(state, seconds)
    reading = None
    if traced:
        reading = {"trace": trace.profile(dev, lambda: driver.trace_stretch(state))}
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    collected = driver.collect(state)
    driver.release(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    per_answer, notes = driver.compare(run, collected)
    numbers = {}
    for answer in per_answer:
        for k, v in answer.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    missing = [k for k in limits if k not in numbers]
    unlimited = [k for k in numbers if k not in limits]
    if unlimited:
        raise KeyError(f"limits/{workload_name}.json has no limit for {unlimited}")
    bad_answers = sum(any(not v <= limits[k] for k, v in a.items()) for a in per_answer)
    correct = bad_answers == 0 and not missing and bool(per_answer)

    if traced:
        flops = load_module(bench / "flops" / f"{workload['config']}.py", f"benchmark_flops_{workload['config']}")
        reading.update(measured=measured, flops=flops.count(config, traffic), config=config, traffic=traffic,
                       device_kind=device_kind(dev), peaks=load_json(bench / "peaks.json"))
        metrics = per_layer_metrics(spec, bench, workload, reading)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        for name, value in measured["e2e"].items():
            metrics[name] = {"value": value, "unit": units[name]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": device_kind(dev), "count": 1,
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": measured["attempted"], "failed": bad_answers, "metrics": metrics,
              "device": device_info}
    if traced:
        tr = reading["trace"]
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"][:10]}
    if notes:
        result["notes"] = notes
    result["check"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    return result


def per_layer_metrics(spec, bench: Path, workload: dict, reading: dict) -> dict:
    """Each per-layer metric that this cell reports: those that list it
    under `workloads`, and those without the key whose end-to-end metric
    the cell reports.  A reader that finds nothing returns None and the
    metric is left out."""
    reports = {m["name"] for m in spec["end_to_end"]
               if "workloads" not in m or workload["name"] in m["workloads"]}
    out = {}
    for m in spec["per_layer"]:
        if "workloads" in m:
            if workload["name"] not in m["workloads"]:
                continue
        elif m["moves"] not in reports:
            continue
        reader = load_module(bench / "metrics" / f"{m['name']}.py", f"benchmark_metric_{m['name']}")
        value = reader.read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_kind(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
