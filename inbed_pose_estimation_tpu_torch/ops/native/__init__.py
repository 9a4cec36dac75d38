"""The native host crop (`preprocess.cc`) through ctypes: `--fast_preprocess`.

`preprocess_batch` has the JAX package's signature (`ops/native/__init__.py`
there).  The source is built with g++ on first use into `ops/_build/`
beside the CUDA libraries (listed in `.gitignore`), under a name that
carries a hash of the source and the flags, so an edited source is rebuilt.
The flags are the JAX package's, so both builds compute the same bits on
one machine.  Nothing is built when the module is imported.

Where the JAX package falls back to the Pillow crop when the library cannot
be built, the port raises: `--fast_preprocess` either runs this kernel or
stops.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "preprocess.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_loaded: dict = {}


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libpreprocess-{digest.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The loaded library, built on first use; raises RuntimeError when it
    cannot be built (no g++, or a failed compile)."""
    if "lib" in _loaded:
        return _loaded["lib"]
    target = _target()
    if not target.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("--fast_preprocess needs g++ to build ops/native/preprocess.cc, and none was found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build ops/native/preprocess.cc:\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent process never loads a partial file
    lib = ctypes.CDLL(str(target))
    lib.preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.preprocess_batch.restype = None
    _loaded["lib"] = lib
    return lib


def preprocess_batch(images: np.ndarray, centers: np.ndarray, scales: np.ndarray, flips: np.ndarray,
                     noise: np.ndarray, res: int, mean: np.ndarray, std: np.ndarray, num_threads: int = 0,
                     rots: Optional[np.ndarray] = None) -> np.ndarray:
    """Crop, resize, rotate, noise and normalize a uint8 NHWC batch.

    images [B, H, W, C] uint8; centers [B, 2]; scales [B] (the box is 200 *
    scale pixels high); flips [B]; noise [B, 3] (channel gains, the first
    for a single channel); mean, std [C]; rots [B] in degrees (None: no
    rotation); `num_threads` host threads (0: min(8, cores)).  Returns
    [B, res, res, C] float32: (clip(sample * noise, 0, 255) / 255 - mean) / std.
    """
    lib = library()
    images = np.ascontiguousarray(images, np.uint8)
    B, H, W, C = images.shape
    if rots is None:
        rots = np.zeros(B, np.float32)
    specs = np.ascontiguousarray(np.concatenate([
        np.asarray(centers, np.float32).reshape(B, 2),
        np.asarray(scales, np.float32).reshape(B, 1),
        np.asarray(flips, np.float32).reshape(B, 1),
        np.asarray(noise, np.float32).reshape(B, 3),
        np.asarray(rots, np.float32).reshape(B, 1),
    ], axis=1), np.float32)
    mean = np.ascontiguousarray(mean, np.float32).reshape(-1)
    std = np.ascontiguousarray(std, np.float32).reshape(-1)
    if mean.size != C or std.size != C:
        raise ValueError(f"mean and std need {C} values, got {mean.size} and {std.size}")
    out = np.empty((B, res, res, C), np.float32)
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.preprocess_batch(images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B, H, W, C,
                         specs.ctypes.data_as(f32), res, mean.ctypes.data_as(f32), std.ctypes.data_as(f32),
                         out.ctypes.data_as(f32), num_threads)
    return out
