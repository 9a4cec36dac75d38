"""Shared arithmetic of the per-layer metric readers (`metrics/<name>.py`).

`reading` holds the reduced trace (`trace`), the measured stretch with the
profiler off (`measured`: calls, seconds), the FLOP count of a call
(`flops`: step, network), the configuration, the traffic, the device's
name and the table of peaks.  Each function returns None where it finds
nothing to read: an unknown card, no span, no copy.
"""

from __future__ import annotations

NETWORK_SPAN = "benchmark.network"


def peak_flops(reading):
    card = reading["peaks"].get(reading["device_kind"])
    if card is None:
        return None
    dtype = reading["config"]["dtype"]
    if dtype == "float32" and reading["config"].get("tf32"):
        dtype = "tf32"
    return card.get(dtype)


def mfu(reading):
    """The whole step's FLOPs over the stretch run with the profiler off, as
    a share of the card's peak, in %."""
    peak, m = peak_flops(reading), reading["measured"]
    if not peak or not m["calls"] or m["seconds"] <= 0:
        return None
    return 100.0 * reading["flops"]["step"] * m["calls"] / m["seconds"] / peak


def network_roofline(reading):
    """The network's FLOPs over the device time of the kernels launched
    inside the spans around the model's forward, as a share of the peak."""
    peak = peak_flops(reading)
    device_s = reading["trace"]["span_device_s"].get(NETWORK_SPAN)
    if not peak or not device_s:
        return None
    return 100.0 * reading["flops"]["network"] * reading["traffic"]["trace_calls"] / device_s / peak


def idle_share(reading):
    t = reading["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
