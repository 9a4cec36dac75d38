"""Device time of the per-modality trunks in one eval call, in ms: the
kernels launched inside the program's `hmr.multi_trunk` spans (the loop
over the trunks in `models/hmr.py::MultiTrunkCore.forward`)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("hmr.multi_trunk",))
