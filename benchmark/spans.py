"""Arithmetic of the readers of the program's own spans (`metrics/*_ms.eval.py`).

The port opens a `record_function` span at each layer boundary while a
profiler records (`inbed_pose_estimation_tpu_torch/utils/profiling.py::span`);
`trace.reduce_trace` gives the device time of the kernels launched inside
each span name.
"""

from __future__ import annotations


def ms_per_call(reading, names):
    """Device time of the kernels launched inside the spans `names`, in ms
    per traced call, or None where none of them was seen or they read 0."""
    s = sum(reading["trace"]["span_device_s"].get(name, 0.0) for name in names)
    return s / reading["traffic"]["trace_calls"] * 1e3 if s > 0 else None
