"""The controls of `correct` on the card, at each cell's own size: the
reference computed in TF32 and put in the program's place, and the
program with TF32 switched on, must each break at least one limit, while
a short run of the program itself meets every limit.  Needs a CUDA device
and skips without one; run on the card with

    python -m pytest -o addopts="" --noconftest -m cuda benchmark/tests/test_bench_controls.py
"""

from __future__ import annotations

import json

import pytest
import torch

from bench_tiny import BENCH, REPO

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's skinning kernel has no CPU mode")
    return "cuda:0"


@pytest.mark.parametrize("workload", CELLS)
def test_controls_break_a_limit_and_the_program_does_not(cuda, workload):
    from benchmark import calibrate, harness

    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        run = harness.run_cell(REPO, workload, seed, 1.0, False, device=cuda)
        assert run["correct"] is True, run["check"]
        readings = calibrate.control_readings(REPO, workload, seed, cuda)
        for name in ("control", "program_tf32"):
            broken = [k for k, v in readings[name].items() if not v <= limits[k]]
            assert broken, (name, readings[name])
        torch.cuda.empty_cache()
