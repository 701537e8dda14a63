"""Metric logs and image grids (counterpart of `damc_tpu/utils/logging.py`).

`MetricsLogger` writes the JAX package's JSONL rows (`step`, `wall_s`,
`phase`, then the metrics) to `<log_dir>/metrics.jsonl`; its echo on
stdout is the same row as JSON after a `[phase] ` tag. `save_image_grid`
lays images out as the JAX package's does and writes the PNG with `zlib`
and `struct` alone (8-bit gray or RGB; filter 0 on every row unless the
caller names the rows' filters), so no image library is needed.
`save_kde_plot` writes the toy workload's density
heatmap the same way: the JAX package's scipy KDE grid through a copy of
matplotlib's viridis table, without matplotlib.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np

from ..data.images import PNG_SIGNATURE, filter_rows
# matplotlib's viridis colormap as it maps to bytes (256 entries, RGB):
# `matplotlib.colormaps["viridis"](np.arange(256), bytes=True)[:, :3]`.
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
), np.uint8).reshape(256, 3)


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


def encode_png(pixels: np.ndarray, filters=None) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> the bytes of a PNG file. Row r
    takes PNG filter type `filters[r]` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth; one int for every row); None writes type 0 throughout."""
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError(f"encode_png wants uint8 (H, W) or (H, W, 3), got {pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    color = 0 if pixels.ndim == 2 else 2
    rows = pixels.reshape(h, -1)
    if filters is None:
        raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    else:
        ftypes = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
        raw = np.concatenate([ftypes[:, None], filter_rows(rows, 1 if color == 0 else 3, ftypes)], axis=1)
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


KDE_GRID = 100  # density cells a side (`np.mgrid[low:high:100j]`)
KDE_CELL = 6  # pixels a side of one cell in the PNG


def kde_grid(samples: np.ndarray, low: float = -4.0, high: float = 4.0, kde_bw: float = 0.15) -> np.ndarray:
    """The (100, 100) density of a Gaussian KDE of 2-D `samples` (N, 2) on
    the grid of `damc_tpu/utils/logging.py::save_kde_plot`: entry [i, j] at
    x = the i-th and y = the j-th of 100 points from low to high."""
    from scipy.stats import gaussian_kde

    kernel = gaussian_kde(np.asarray(samples).T, bw_method=kde_bw)
    xs, ys = np.mgrid[low:high:100j, low:high:100j]
    return np.reshape(kernel(np.vstack([xs.ravel(), ys.ravel()])).T, xs.shape)


def kde_pixels(zs: np.ndarray) -> np.ndarray:
    """uint8 RGB of the grid as matplotlib's `imshow(zs, cmap="viridis")`
    colours it: min-max normalised, index floor(v * 256) clipped to 255,
    row i of the grid at the i-th row from the top; each cell a
    KDE_CELL x KDE_CELL block."""
    lo, hi = float(zs.min()), float(zs.max())
    v = (zs - lo) / (hi - lo) if hi > lo else np.zeros_like(zs)
    idx = np.clip((v * 256).astype(np.int64), 0, 255)
    return np.repeat(np.repeat(VIRIDIS[idx], KDE_CELL, axis=0), KDE_CELL, axis=1)


def save_kde_plot(samples: np.ndarray, path: str, low: float = -4.0, high: float = 4.0,
                  kde_bw: float = 0.15) -> None:
    """KDE density heatmap of 2-D samples (`toy_example.py:158-177`), a
    600 x 600 RGB PNG of `kde_pixels(kde_grid(...))`."""
    pixels = kde_pixels(kde_grid(samples, low, high, kde_bw))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
