"""The whole step's share of the card's peak (float32 outside the tensor
cores), over a stretch of the traced run with the profiler off."""

from benchmark.readings import mfu


def read(reading):
    return mfu(reading)
