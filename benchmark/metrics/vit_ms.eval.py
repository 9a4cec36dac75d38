"""Device time of the ViT trunk in one eval call, in ms: the kernels
launched inside the program's `hmr.vit` spans (`models/vit.py::ViT`)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("hmr.vit",))
