"""ICO and CUR decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`IcoImagePlugin.py`, `CurImagePlugin.py`).

An icon file is a 6-byte header and a directory of 16-byte entries (width,
height, colours, reserved, planes, bits a pixel, bytes, offset).

  * ICO: PIL sorts the entries by colour depth (the bits a pixel, else
    ceil(log2(colours)), else 256), then, stably, by area, largest first,
    and loads the first (its `_open` loads it: PIL decodes the frame while
    it opens the file). A frame that starts with PNG's signature is a PNG
    file (the port's PNG decoder); any other is a bitmap info header (a DIB,
    the port's BMP code) of twice the image's height, whose first half in
    file order is the image and whose AND mask (or, at 32 bits, alpha
    bytes) PIL reads from the entry's end: a mask cut short fails, though
    the mask's alpha is dropped by the conversion to RGB.
  * CUR: PIL takes the first entry, or a later one wider and taller in its
    two size bytes, and reads a bitmap at its offset (at the file position
    after the directory when the offset is 0), halving the height; there
    is no mask.

`ico_directory` and `cur_bitmap` are PIL's opens: they raise NotThisFormat
where PIL falls through to the next format (a directory or info header
cut short, no entry, an empty size) and ValueError where PIL refuses the
file. A CUR's magic is also the first bytes of an uncompressed truecolour
TGA, which PIL reads as TGA when its CUR open falls through. An ICO frame
refused inside PIL's open falls through to formats that all refuse ICO's
first bytes, so it raises ValueError here.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import List

import numpy as np

from .images import PIL_MAX_PIXELS, PNG_SIGNATURE, Dib, NotThisFormat, decode_png, dib_pixels, parse_dib

ICO_MAGIC = b"\x00\x00\x01\x00"
CUR_MAGIC = b"\x00\x00\x02\x00"


@dataclass
class IconEntry:
    width: int
    height: int
    bpp: int
    size: int
    offset: int
    color_depth: int


def ico_directory(data, name: str) -> List[IconEntry]:
    """The directory's entries in PIL's order (the one PIL loads first)."""
    s = data[:6]
    if s[:4] != ICO_MAGIC or len(s) < 6:
        raise NotThisFormat(f"{name}: not an ICO file")
    entries = []
    for i in range(struct.unpack_from("<H", s, 4)[0]):
        e = data[6 + 16 * i:6 + 16 * i + 16]
        if len(e) < 16:
            raise NotThisFormat(f"{name}: ICO directory cut short")
        nb_color, bpp = e[2], struct.unpack_from("<H", e, 6)[0]
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append(IconEntry(e[0] or 256, e[1] or 256, bpp, *struct.unpack_from("<II", e, 8), depth))
    if not entries:
        raise NotThisFormat(f"{name}: ICO file of no entries")
    entries.sort(key=lambda x: x.color_depth)
    entries.sort(key=lambda x: x.width * x.height, reverse=True)
    return entries


def decode_ico(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the ICO file `data`'s frame that
    PIL loads."""
    try:
        entry = ico_directory(data, name)[0]
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    frame = data[entry.offset:entry.offset + 8]
    if frame == PNG_SIGNATURE:
        return decode_png(data[entry.offset:], name)
    try:
        dib = parse_dib(data, entry.offset, 0, name, "ICO bitmap")
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    if dib.width * dib.height > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: ICO bitmap of size {dib.width}x{dib.height}")
    rows = int(dib.height / 2)
    if rows <= 0:
        raise ValueError(f"{name}: ICO bitmap of {dib.height} rows")
    if entry.bpp == 32:  # alpha bytes: every 4th byte of the image's rows
        if len(data) - dib.start < dib.width * rows * 4:
            raise ValueError(f"{name}: ICO alpha cut short")
    else:  # the AND mask, rows padded to 32 bits, at the entry's end; PIL does not read the last row's padding
        stride = (dib.width + 31) // 32 * 4
        at = entry.offset + entry.size - stride * rows
        if at < 0 or len(data[at:at + stride * rows]) < stride * (rows - 1) + (dib.width + 7) // 8:
            raise ValueError(f"{name}: ICO mask cut short")
    return dib_pixels(data, dib, name, rows, "ICO bitmap")


def cur_bitmap(data, name: str) -> Dib:
    """The bitmap PIL's CUR open reads, `data` the file's bytes or a
    `formats.Source`; its height is the full bitmap's."""
    s = data[0:6]
    if s[:4] != CUR_MAGIC or len(s) < 6:
        raise NotThisFormat(f"{name}: not a CUR file")
    count = struct.unpack_from("<H", s, 4)[0]
    m = b""
    for i in range(count):
        e = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = e
            continue
        if not e:
            raise NotThisFormat(f"{name}: CUR directory cut short")
        if e[0] > m[0]:
            if len(e) < 2 or len(m) < 2:
                raise NotThisFormat(f"{name}: CUR directory cut short")
            if e[1] > m[1]:
                m = e
    if len(m) < 16:
        raise NotThisFormat(f"{name}: no cursor in the CUR file")
    at = struct.unpack_from("<I", m, 12)[0] or 6 + 16 * count  # offset 0: where the directory ends
    dib = parse_dib(data, at, 0, name, "CUR bitmap")
    if dib.height // 2 == 0:
        raise NotThisFormat(f"{name}: CUR bitmap of {dib.height} rows")
    return dib


def decode_cur(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the CUR file `data`'s cursor that
    PIL loads."""
    try:
        dib = cur_bitmap(data, name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    rows = dib.height // 2
    if dib.width * rows > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: CUR of size {dib.width}x{rows} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    return dib_pixels(data, dib, name, rows, "CUR bitmap")
