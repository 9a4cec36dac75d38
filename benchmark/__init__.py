"""The benchmark of `inbed_pose_estimation_tpu_torch` on NVIDIA H100s.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix, per-layer metric or FLOP count
is a file of its own here, found by that name (README.md).
"""
