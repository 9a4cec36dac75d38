"""Device choice for the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return the torch device an entry point runs on, and pin true float32.

    "cuda" (the default) raises when no CUDA device is present: the port
    never falls back to the CPU unless the caller asks for "cpu".

    Every call sets `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` to False, so matrix products and
    cuDNN convolutions on the card run in true float32 like the JAX eval
    path, which pins `Precision.HIGHEST` on SMPL and geometry.  cuDNN's
    flag is True by default, so without this the H100 convolutions would
    run in TF32 (about three decimal digits).
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


@functools.cache
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant tensor of `values` on `device`, made once per process.

    Indexing a CUDA tensor with a Python list, or `torch.tensor(list,
    device="cuda")`, copies the list to the card and waits for the copy on
    every call; the fitting loop runs such code hundreds of times a step.
    Callers must not write to the result.
    """
    return torch.tensor(values, dtype=dtype, device=device)
