"""Device time of the cross attention in one eval call, in ms: the kernels
launched inside the program's `hmr.cross_att` spans
(`models/attention.py::CrossAttention.forward`)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("hmr.cross_att",))
