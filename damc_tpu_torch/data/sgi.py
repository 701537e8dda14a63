"""SGI decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`SgiImagePlugin.py`; the run lengths in `csrc/host/rle_decode.cpp`, which
follows Pillow's `SgiRleDecode.c`).

PIL reads a 512-byte header (big-endian: magic 474, storage, bytes a
channel, dimension, width, height, channels) and takes the modes of its
table: grey (1 channel, dimension 1 or 2), RGB and RGBA (3 and 4 channels,
dimension 3), at 1 or 2 bytes a channel, where 2-byte samples keep their
high byte. Rows run bottom-up. Verbatim data holds each channel's plane
in turn; run-length data has a table of each row's offset and length
per channel, and each row's chunks (a count and a flag, the flag set:
copy, clear: repeat) expand into one interleaved row that is kept from
row to row (a row that stops short leaves the rest of the previous one).
What PIL refuses raises as PIL raises it: ValueError naming the file,
both for a mode outside PIL's table and for a corrupt file.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from . import rle
from .images import PIL_MAX_PIXELS, NotThisFormat

HEADER = 512
# (bytes a channel, dimension, channels) -> PIL's raw mode (SgiImagePlugin.MODES)
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B", (1, 3, 3): "RGB",
         (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def is_sgi(head: bytes) -> bool:
    """PIL's accept test for SGI."""
    return len(head) >= 2 and head[:2] == b"\x01\xda"


@dataclass
class SgiHeader:
    width: int
    height: int
    compression: int
    bpc: int
    bands: int


def sgi_header(data, name: str) -> SgiHeader:
    """The header as `SgiImageFile._open` reads it; NotThisFormat where
    PIL's open falls through (a header cut short, an empty size),
    ValueError for a mode PIL has no reader for."""
    s = data[:HEADER]
    if not is_sgi(s) or len(s) < 12:
        raise NotThisFormat(f"{name}: not an SGI file")
    compression, bpc = s[2], s[3]
    dimension, width, height, zsize = struct.unpack_from(">4H", s, 4)
    rawmode = MODES.get((bpc, dimension, zsize))
    if rawmode is None:
        raise ValueError(f"{name}: unsupported SGI image mode ({bpc} bytes a channel, dimension {dimension}, "
                         f"{zsize} channels)")
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: SGI of size {width}x{height}")
    return SgiHeader(width, height, compression, bpc, len(rawmode.split(";")[0]))


def decode_sgi(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the SGI file `data`."""
    try:
        hd = sgi_header(data, name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    w, h, bpc, bands = hd.width, hd.height, hd.bpc, hd.bands
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: SGI of size {w}x{h} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    if hd.compression == 0:
        page = w * h * bpc
        if len(data) < HEADER + bands * page:
            raise ValueError(f"{name}: SGI pixel data cut short")
        planes = np.frombuffer(data, np.uint8, bands * page, HEADER).reshape(bands, h, w, bpc)[..., 0]
        img = planes.transpose(1, 2, 0)
    elif hd.compression == 1:
        status, done, rows = rle.sgi_rle(data[HEADER:], bpc, w, h, bands)
        if status != rle.OK:
            raise ValueError(f"{name}: {rle.FAULTS[status]}")
        rows[done:] = 0  # an early end leaves the rest of the image as PIL made it
        img = rows.reshape(h, w, bands, bpc)[..., 0]
    else:
        raise ValueError(f"{name}: SGI storage {hd.compression} (PIL reads 0, verbatim, and 1, run-length)")
    img = img[::-1]
    if bands == 1:
        return np.ascontiguousarray(np.repeat(img, 3, axis=2))
    return np.ascontiguousarray(img[..., :3])
