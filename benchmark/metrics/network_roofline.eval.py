"""The network's share of its roofline: the network's FLOPs (counted from
the architecture's shapes) over the device time of the kernels launched
inside the benchmark's spans around the model's forward calls, as a share
of the float32 peak.  The network is compute bound at these shapes, so the
FLOP bound is its roofline."""

from benchmark.readings import network_roofline


def read(reading):
    return network_roofline(reading)
