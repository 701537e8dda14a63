"""QOI decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`QoiImagePlugin.py`; the op stream in `csrc/host/rle_decode.cpp`).

PIL reads the 14-byte header (big-endian width and height, the channel
count: 3 is RGB, anything else RGBA; the colour space is skipped), then
every op of QOI: RGB, RGBA, INDEX (into a 64-entry table hashed
(r*3 + g*5 + b*7 + a*11) % 64, an entry never written reading as
(0, 0, 0, 0)), DIFF, LUMA and RUN (which does not update the table). The
previous pixel starts as (0, 0, 0, 255). A run may overshoot the last
pixel; the end marker is not read. A stream that ends before the last
pixel raises ValueError naming the file, as PIL fails there.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from . import rle
from .images import PIL_MAX_PIXELS, NotThisFormat

QOI_MAGIC = b"qoif"


def qoi_header(data, name: str) -> Tuple[int, int, int]:
    """(width, height, channels) as `QoiImageFile._open` reads them;
    NotThisFormat where PIL's open falls through (a header cut short, an
    empty size)."""
    s = data[:14]
    if s[:4] != QOI_MAGIC or len(s) < 13:
        raise NotThisFormat(f"{name}: not a QOI file")
    width, height = struct.unpack_from(">II", s, 4)
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: QOI of size {width}x{height}")
    return width, height, s[12]


def decode_qoi(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the QOI file `data`."""
    try:
        w, h, _ = qoi_header(data, name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: QOI of size {w}x{h} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    status, pixels = rle.qoi(data[14:], w * h)
    if status != rle.OK:
        raise ValueError(f"{name}: the QOI stream ends before its last pixel")
    return pixels.reshape(h, w, 3)
