"""A torch.profiler trace of a stretch of the cell's own path, reduced to
what the per-layer metrics read.

`profile` records CPU and CUDA activity around a stretch, writes the
Chrome trace to a temporary file under TMPDIR, reads it back and deletes
it.  `Spans` opens a `record_function` span around every forward call of
a module, from a forward pre-hook and a forward hook that the benchmark
registers on the object it built (the program is not edited).

The reduction (`reduce_trace`) gives:
  busy_s        the union of the device's kernel, copy and memset intervals
  window_s      the stretch's length on the host's clock
  h2d_s         device time of host-to-device copies
  span_device_s device time of the kernels launched inside each named span
  device_ops    the 10 kernel names that took most device time
  idle_gaps     the 10 longest idle stretches of the device, summed by the
                innermost host operation running at their middle
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 160


class Spans:
    """record_function spans named `name` around `module`'s forward calls."""

    def __init__(self, module, name):
        self.name = name
        self.open = []
        self.handles = [module.register_forward_pre_hook(self._enter), module.register_forward_hook(self._exit)]

    def _enter(self, module, args):
        rf = torch.autograd.profiler.record_function(self.name)
        rf.__enter__()
        self.open.append(rf)

    def _exit(self, module, args, output):
        self.open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def profile(device, fn):
    """Profile fn() (which ends with the device synchronised) and return
    the reduced trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_trace(events, window_s)


def _intervals_union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def reduce_trace(events, window_s):
    events = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in device if e["cat"] == "kernel"]
    busy_us, merged = _intervals_union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
    spans = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            spans[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    span_device_s = {}
    for name, ivs in spans.items():
        ivs.sort()
        total = 0.0
        for k in kernels:
            t = launch_ts.get(k.get("args", {}).get("correlation"))
            if t is not None and any(s <= t <= e for s, e in ivs):
                total += float(k["dur"])
        span_device_s[name] = total * 1e-6
    by_name = defaultdict(float)
    for k in kernels:
        by_name[k["name"][:NAME_CHARS]] += float(k["dur"]) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    h2d_us = sum(float(e["dur"]) for e in device if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "h2d_s": h2d_us * 1e-6,
        "span_device_s": span_device_s,
        "device_ops": [[n, s] for n, s in device_ops],
        "idle_gaps": _idle_gaps(merged, [e for e in events if e.get("cat") in HOST_CATS]),
    }


def _idle_gaps(merged, host):
    """The 10 longest gaps between the device's busy intervals, summed by
    the innermost host event that covers each gap's middle."""
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1) if merged[i + 1][0] > merged[i][1]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in host))
    by_name = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inner = None
        for hs, he, name in host:
            if hs > mid:
                break
            if he >= mid and (inner is None or he - hs < inner[1] - inner[0]):
                inner = (hs, he, name)
        by_name[(inner[2] if inner else "no host event")[:NAME_CHARS]] += (e - s) * 1e-6
    return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])]
