"""Host image reads and writes through OpenCV, as the JAX package does them
(`cv2.imread` in its dataset and eval driver, `cv2.imwrite` in its synthetic
tree).  The one module of the port's data side that touches OpenCV."""

from __future__ import annotations

from typing import Optional

import cv2
import numpy as np


def read_rgb(path: str) -> np.ndarray:
    """A colour image as float32 [H, W, 3] in RGB order (OpenCV reads BGR)."""
    img = read_rgb_u8(path)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def read_rgb_u8(path: str) -> Optional[np.ndarray]:
    """A colour image as uint8 [H, W, 3] in RGB order, or None when it
    cannot be read."""
    img = cv2.imread(path)
    return None if img is None else np.ascontiguousarray(img[:, :, ::-1])


def read_gray(path: str) -> np.ndarray:
    """A single-channel image as float32 [H, W]."""
    img = read_gray_u8(path)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def read_gray_u8(path: str) -> Optional[np.ndarray]:
    """A single-channel image as uint8 [H, W], or None when it cannot be read."""
    return cv2.imread(path, 0)


def write(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W] or [H, W, 3] (BGR order, as OpenCV takes it)."""
    if not cv2.imwrite(path, img):
        raise OSError(f"cannot write {path}")
