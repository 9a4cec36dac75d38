"""Hand-written kernels of the port and their wrappers: the CUDA kernels of
`csrc/` and the native host crop of `native/`."""
