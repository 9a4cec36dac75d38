"""Device time of the ViT blocks' attention cores in one eval call, in ms:
the kernels launched inside the program's `hmr.vit_attn` spans (scores,
softmax and values of each block, `models/vit.py::Attention`), which lie
inside `hmr.vit`."""

from benchmark.spans import ms_per_call


def read(reading):
    return ms_per_call(reading, ("hmr.vit_attn",))
