"""The cross attention's share of its roofline: its FLOPs per call
(`flops/<config>.py`'s `cross_att`) over the device time of the kernels
launched inside the program's `hmr.cross_att` spans, as a share of the
float32 peak, in %.  At B=32 its 1x1 convolutions are 1568 x 2048 x 2048
products, ~310 FLOP a byte, so the layer is compute bound and the FLOP
bound is its roofline."""

from benchmark.readings import peak_flops

SPAN = "hmr.cross_att"


def read(reading):
    peak, flops = peak_flops(reading), reading["flops"].get("cross_att")
    device_s = reading["trace"]["span_device_s"].get(SPAN)
    if not peak or not flops or not device_s:
        return None
    return 100.0 * flops * reading["traffic"]["trace_calls"] / device_s / peak
