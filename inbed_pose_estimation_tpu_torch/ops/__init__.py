"""Hand-written kernels of the port and their wrappers: the CUDA kernels of
`csrc/` and the native host crop of `native/`; and K4, the taxel map, in
plain torch."""
from .vert2map import vert2map

__all__ = ["vert2map"]
