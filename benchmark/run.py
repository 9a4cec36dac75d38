"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for: without CUDA, or with fewer cards, it exits with code 2 and prints no
result.  `--trace 0` prints the cell's end-to-end metrics; `--trace 1`
its per-layer metrics, from a torch.profiler trace of a stretch after the
window, with `busy_s`, `window_s` and a breakdown.  The numbers that
decide `correct` are printed beside their limits as the last lines on
standard error and under `check`, the last key of the result line.  The
run exits with code 3 and prints no result if JAX, flax or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # Kernel caches of the libraries the program may use live inside the
    # checkout, at fixed paths (the port's own nvcc build is ops/_build/).
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
    import torch

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    chips = harness.by_name(spec["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device="cuda:0", t0=T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, n in result.get("notes", {}).items():
        print(f"note {name}: {n!r}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
