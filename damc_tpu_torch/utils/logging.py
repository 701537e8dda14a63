"""Metric logs and image grids (counterpart of `damc_tpu/utils/logging.py`).

`MetricsLogger` writes the JAX package's JSONL rows (`step`, `wall_s`,
`phase`, then the metrics) to `<log_dir>/metrics.jsonl`; its echo on
stdout is the same row as JSON after a `[phase] ` tag. `save_image_grid`
lays images out as the JAX package's does and writes the PNG with `zlib`
and `struct` alone (8-bit gray or RGB, filter 0 on every row), so no image
library is needed. The toy workload's KDE plot is not ported yet
(ROADMAP.md, queue 1, item 5).
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class MetricsLogger:
    """JSONL metrics writer + optional stdout echo."""

    def __init__(self, log_dir: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self.path = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, "metrics.jsonl")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train") -> None:
        record = {
            "step": int(step),
            "wall_s": round(time.time() - self._t0, 3),
            "phase": prefix,
            **{k: float(v) for k, v in metrics.items()},
        }
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.echo:
            echo = {"iter": record["step"], "wall_s": record["wall_s"]}
            echo.update((k, record[k]) for k in metrics)
            print(f"[{prefix}] " + json.dumps(echo), flush=True)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> the bytes of a PNG file."""
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError(f"encode_png wants uint8 (H, W) or (H, W, 3), got {pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    color = 0 if pixels.ndim == 2 else 2
    rows = pixels.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter type 0 per row
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (
        PNG_SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b"")
    )


def grid_pixels(images: np.ndarray, nrow: int = 8) -> np.ndarray:
    """NHWC images in [-1, 1] or [0, 1] -> the uint8 grid: min-max
    normalised, 2-pixel borders of white, `nrow` images a row; (H, W) for
    one channel, else (H, W, C)."""
    images = np.asarray(images)
    lo, hi = images.min(), images.max()
    images = (images - lo) / max(hi - lo, 1e-8)
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.ones((nrows * (h + 2) + 2, ncol * (w + 2) + 2, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[
            r * (h + 2) + 2 : r * (h + 2) + 2 + h,
            col * (w + 2) + 2 : col * (w + 2) + 2 + w,
        ] = images[i]
    arr = (grid * 255).astype(np.uint8)
    return arr[..., 0] if c == 1 else arr


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """Save a grid PNG of NHWC images in [-1, 1] or [0, 1]
    (torchvision `save_image(normalize=True)` equivalent)."""
    pixels = grid_pixels(images, nrow)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
