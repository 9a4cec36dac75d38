"""A tiny copy of the benchmark for CPU tests: BENCHMARK.json and the data
files copied into a temporary root, configurations at 64x64 and traffic
at batch 2 with 3 pool entries.  Code found by name (drivers, reference
architectures, metric readers, FLOP counts) is the benchmark's own, read
from the copy."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
BENCH = REPO / "benchmark"
DATA_DIRS = ("configs", "reference", "traffic", "limits", "drivers", "flops", "metrics")


def tiny_root(tmp: Path, res: int = 64) -> Path:
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "benchmark").mkdir()
    for d in DATA_DIRS:
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    shutil.copy(BENCH / "peaks.json", root / "benchmark" / "peaks.json")
    for p in (root / "benchmark" / "configs").glob("*.json"):
        edit(p, img_res=res)
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        edit(p, batch=min(d["batch"], 2), pool=3, check=2, trace_calls=2, warm_calls=1)
    return root


def edit(path: Path, **changes) -> None:
    d = json.loads(Path(path).read_text())
    d.update(changes)
    Path(path).write_text(json.dumps(d, indent=1))


def run_tiny(root: Path, workload: str, traced: bool = False, seed: int = 2**31 + 11, wrap=None) -> dict:
    from benchmark import harness

    return harness.run_cell(root, workload, seed, 0.2, traced, device="cpu", wrap=wrap)
