"""Device time of the body masks (K2) in one eval call, in ms: the kernels
launched inside the program's `ops.body_mask` spans
(`ops/mask_raster.py::render_body_mask`)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("ops.body_mask",))
