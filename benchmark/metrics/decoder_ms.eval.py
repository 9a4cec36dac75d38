"""Device time of the image decoders in one eval call, in ms: the kernels
launched inside the program's `hmr.decoder` spans (each `Reconstruct`
head, `models/decoder.py`) and `fusion.recover` spans (the fusion
family's recovery decoders, `models/fusion.py`)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("hmr.decoder", "fusion.recover"))
