"""Device time of SMPL in one eval call, in ms: the kernels launched inside
the program's `smpl.lbs` spans (`smpl/model.py::lbs`: blend shapes, the
kinematic chain and the skinning kernel K1)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("smpl.lbs",))
