"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled for sm_90a into `_build/` beside this file (listed in
`.gitignore`).  A library's file name carries a hash of its source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when the module is imported: `build_all()` compiles every
source in parallel (one nvcc process each), and `library(name)` builds on
first use and loads once per process.  `launcher` types a kernel's C entry
point once and launches it on its tensors' device and current stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def sources() -> list[str]:
    """Names of the kernel sources, `csrc/<name>.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (all by default) that are not built yet.

    Starts one nvcc per source, all at once, and waits for every one.
    Returns {name: nvcc's output (ptxas register and spill report)}; raises
    if any compile fails.
    """
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: a concurrent process never loads a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(f"{n}:\n{logs[n]}" for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _loaded:
        target = _target(name)
        if not target.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(target))
    return _loaded[name]


def launcher(name: str, entry: str, argtypes: list):
    """A launch of `entry` in `csrc/<name>.cu`.

    The C function takes `argtypes`, then a cudaStream_t, and returns 0 or a
    CUDA error code that `<name>_error_string` names.  The returned
    `launch(device, *args)` builds and types the library on its first call,
    calls `entry` under `device` on that device's current stream, and raises
    a RuntimeError on a nonzero code.
    """

    @functools.cache
    def typed():
        lib = library(name)
        forward, error_string = getattr(lib, entry), getattr(lib, f"{name}_error_string")
        forward.argtypes, forward.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
        error_string.argtypes, error_string.restype = [ctypes.c_int], ctypes.c_char_p
        return forward, error_string

    def launch(device, *args):
        import torch

        forward, error_string = typed()
        with torch.cuda.device(device):
            err = forward(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: {error_string(err).decode()}")

    return launch
