"""The ViT trunk's share of its roofline: its FLOPs per call
(`flops/<config>.py`'s `vit`) over the device time of the kernels launched
inside the program's `hmr.vit` spans, as a share of the float32 peak, in
%.  At B=32 its Linears are 6272-row products of 1280 to 5120 columns,
hundreds of FLOPs a byte, so the trunk is compute bound and the FLOP bound
is its roofline."""

from benchmark.readings import peak_flops

SPAN = "hmr.vit"


def read(reading):
    peak, flops = peak_flops(reading), reading["flops"].get("vit")
    device_s = reading["trace"]["span_device_s"].get(SPAN)
    if not peak or not flops or not device_s:
        return None
    return 100.0 * flops * reading["traffic"]["trace_calls"] / device_s / peak
