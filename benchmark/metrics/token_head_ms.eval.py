"""Device time of the transformer-decoder SMPL head in one eval call, in
ms: the kernels launched inside the program's `hmr.token_head` spans (the
decoder over one query token, the readout and the rotations,
`models/vit.py::SMPLTransformerDecoderHead`)."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("hmr.token_head",))
