"""TGA decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`TgaImagePlugin.py` of Pillow 12.2.0; the run lengths in
`csrc/host/rle_decode.cpp`, which follows Pillow's `TgaRleDecode.c`).

A TGA file has no magic bytes: PIL tries it 38th of its formats and takes
any file whose 18-byte header holds a colour-map type of 0 or 1, a size of
at least 1x1, a depth of 1, 8, 16, 24 or 32, an image type of 1, 2, 3, 9,
10 or 11 and, with a colour map, a map depth of 16, 24 or 32. What PIL
then gives:

  * types 3 and 11 (grey) at depth 1 (bits, 1 white), 8 and 16 (grey and
    alpha); types 2 and 10 (truecolour) at 16 (5-5-5 BGR, each field
    v * 255 // 31), 24 (BGR) and 32 (BGRA); types 1 and 9 at depth 8
    through a colour map. Other pairs open with no pixels to read, and
    PIL refuses them when it loads them; so is a type 1 or 9 file without
    a colour map, and a map on a truecolour or 1-bit image.
  * A colour map is preceded by `first` black entries (PIL pads it), so
    an index i reads entry i - first; an index past the map is black; a
    map of more than 256 entries in all, and a 32-bit map (PIL has no
    BGRA palette reader), are refused. A grey image with a map is read
    through it, as PIL's palette turns the image into one of indices.
  * Rows run bottom-up unless the descriptor's bit 0x20 is set; bit 0x10
    flips each row left to right.
  * Run-length packets: a literal may run on into the next row, a run may
    not (PIL's "buffer overrun"); a 1-bit run-length file never ends (PIL
    counts its packets in whole bytes of zero width).
  * 12.2.0 seeks 26 bytes before the end of an RGBA (16- or 32-bit
    truecolour) file for the TGA 2.0 footer: a file shorter than that
    fails where PIL opens it by its path, as the JAX reader does.

A file PIL refuses, or a corrupt one, raises ValueError naming the file.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import rle
from .images import PIL_MAX_PIXELS, NotThisFormat

# (image type & 7, depth) -> PIL's raw mode (TgaImagePlugin.MODES)
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
RAW_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}
FOOTER = 26  # the TGA 2.0 footer 12.2.0 looks for in an RGBA file


@dataclass
class TgaHeader:
    width: int
    height: int
    image_type: int
    depth: int
    mode: str  # PIL's mode: 1, L, LA, P, RGB or RGBA
    rawmode: Optional[str]  # None: PIL opens the file with no pixels to read
    top_down: bool
    flip: bool
    palette: Optional[np.ndarray]  # (entries, 3) uint8, `first` black entries first
    palette_bytes: int  # the colour map's bytes as read (PIL's palette data)
    map_depth: int
    start: int  # the pixels' file offset


def tga_header(data, name: str) -> TgaHeader:
    """The header as `TgaImageFile._open` reads it from `data` (the file's
    bytes or a `formats.Source`). Raises NotThisFormat where PIL's open
    falls through."""
    s = data[:18]
    if len(s) < 18:
        raise NotThisFormat(f"{name}: no TGA header")
    id_len, cmap_type, image_type = s[0], s[1], s[2]
    depth, flags = s[16], s[17]
    width, height = struct.unpack_from("<HH", s, 12)
    if cmap_type not in (0, 1) or width <= 0 or height <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat(f"{name}: not a TGA file")
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat(f"{name}: unknown TGA mode")
    orientation = flags & 0x30
    pos = 18 + id_len
    palette, palette_bytes, map_depth = None, 0, 0
    if cmap_type:
        first, size, map_depth = struct.unpack_from("<HHB", s, 3)
        if map_depth not in (16, 24, 32):
            raise NotThisFormat(f"{name}: unknown TGA map depth")
        entry = map_depth // 8
        table = data[pos:pos + entry * size]
        pos += len(table)
        palette_bytes = entry * first + len(table)
        n = len(table) // entry
        raw = np.frombuffer(table, np.uint8, n * entry).reshape(n, entry)
        if map_depth == 16:
            p = raw[:, 0].astype(np.uint16) | raw[:, 1].astype(np.uint16) << 8
            rgb = np.stack([(p >> 10) & 31, (p >> 5) & 31, p & 31], axis=1) * 255 // 31
        else:
            rgb = raw[:, 2::-1]
        palette = np.zeros((first + n, 3), np.uint8)
        palette[first:] = rgb
    return TgaHeader(width, height, image_type, depth, mode, MODES.get((image_type & 7, depth)),
                     orientation in (0x20, 0x30), orientation in (0x10, 0x30), palette, palette_bytes, map_depth, pos)


def decode_tga(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the TGA file `data`, as PIL's
    `Image.open(...).convert("RGB")` gives them."""
    try:
        hd = tga_header(data, name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    w, h = hd.width, hd.height
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: TGA of size {w}x{h} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    if hd.rawmode is None:
        raise ValueError(f"{name}: PIL has no reader for TGA image type {hd.image_type} at depth {hd.depth}")
    if hd.mode == "L" and hd.rawmode == "P":
        raise ValueError(f"{name}: TGA colour-mapped image without a colour map")
    if hd.palette is not None:
        if hd.mode not in ("P", "L", "LA"):
            raise ValueError(f"{name}: TGA colour map on a {hd.mode} image")
        if hd.map_depth == 32:
            raise ValueError(f"{name}: TGA 32-bit colour map (PIL has no BGRA palette reader)")
        if hd.palette_bytes // (hd.map_depth // 8) > 256:
            raise ValueError(f"{name}: TGA colour map of more than 256 entries")
    bits = RAW_BITS[hd.rawmode]
    row_bytes = (w * bits + 7) // 8
    if hd.image_type & 8:
        status, rows = rle.tga_rle(data[hd.start:], hd.depth // 8, row_bytes, h)
        if status != rle.OK:
            raise ValueError(f"{name}: {rle.FAULTS[status]}")
    else:
        if len(data) < hd.start + row_bytes * h:
            raise ValueError(f"{name}: TGA pixel data cut short")
        rows = np.frombuffer(data, np.uint8, row_bytes * h, hd.start).reshape(h, row_bytes)
    if hd.mode == "RGBA" and len(data) < FOOTER:
        raise ValueError(f"{name}: an RGBA TGA of {len(data)} bytes (PIL 12.2.0 seeks {FOOTER} bytes before its end)")
    if hd.rawmode == "1":
        img = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        img = np.repeat(img[..., None], 3, axis=2)
    elif hd.rawmode in ("P", "L", "LA"):
        idx = rows.reshape(h, w, bits // 8)[..., 0]
        if hd.palette is not None:
            palette = np.zeros((max(256, len(hd.palette)), 3), np.uint8)
            palette[:len(hd.palette)] = hd.palette
            img = np.take(palette, idx, axis=0)
        else:
            img = np.repeat(idx[..., None], 3, axis=2)
    elif hd.rawmode == "BGRA;15Z":
        p = rows.reshape(h, w, 2).astype(np.uint16)
        p = p[..., 0] | p[..., 1] << 8
        img = (np.stack([(p >> 10) & 31, (p >> 5) & 31, p & 31], axis=-1) * 255 // 31).astype(np.uint8)
    else:
        img = rows.reshape(h, w, bits // 8)[..., 2::-1]
    if not hd.top_down:
        img = img[::-1]
    if hd.flip:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)
