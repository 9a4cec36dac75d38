"""Readings that the limits of `correct` are set from, on the card.

For each seed, one short run of the cell (the program's numbers, exactly
as a benchmark run computes them), then on the same seed's weights, assets
and first `check` pool entries two controls at the cell's own size:

  control      the reference computed in TF32, put in the program's place
               and compared with the reference in float32
  program_tf32 the program with TF32 switched on after it is built

Each seed's readings are printed as one JSON line on standard output.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 [--seconds 1]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from benchmark import check, harness, program, traffic_gen


def control_readings(root: Path, workload_name: str, seed: int, device) -> dict:
    run = harness.make_cell(root, workload_name, seed, device).run
    pool = traffic_gen.make_pool(run.config, run.traffic, seed, run.device)[: run.traffic["check"]]
    _, infer = program.build_inference(run)
    with check.tf32(True):
        program_tf32 = [program.to_host(infer(inputs)) for inputs in pool]
    del infer
    out = {"control": {}, "program_tf32": {}}
    for inputs, got in zip(pool, program_tf32):
        control = check.reference_outputs(run, inputs, use_tf32=True)
        for name, answer in (("control", control), ("program_tf32", check.flatten(got))):
            for k, v in check.answer_numbers(run, inputs, answer)[0].items():
                out[name][k] = max(out[name].get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(root, args.workload, seed, args.seconds, False, device="cuda:0")
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "program": {k: v["value"] for k, v in result["check"].items()},
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                **control_readings(root, args.workload, seed, "cuda:0"),
                "card": torch.cuda.get_device_name(0)}
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
