"""Device time of the ResNet-50 trunk in one eval call, in ms: the kernels
launched inside the program's `hmr.trunk` spans (`models/backbone.py`)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("hmr.trunk",))
