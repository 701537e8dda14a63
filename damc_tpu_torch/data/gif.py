"""GIF decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`GifImagePlugin.py`; the LZW in `csrc/host/lzw_decode.cpp`, which follows
Pillow's `GifDecode.c`).

PIL reads the first frame only, on the logical screen, which grows to hold
the frame. The screen starts as palette index 0, or as the frame's
transparency index where its Graphic Control Extension gives one (not the
background index). The frame's pixels are looked up in its local colour
table, else the global one; a table whose entries are the grey ramp
(entry i = (i, i, i)) is no table to PIL, which then reads the indices as
grey levels where no other table applies; an index past a table's entries
is black. Interlaced rows come in GIF's four passes. What PIL refuses (a
header, extension or descriptor cut short, no frame, LZW data that breaks
or ends before the frame is whole) raises ValueError naming the file.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from . import lzw
from .images import PIL_MAX_PIXELS

GIF_MAGIC = (b"GIF87a", b"GIF89a")


def _table(data: bytes, pos: int, bits: int, name: str):
    """(table bytes or None for the grey ramp, next position) of a colour
    table of 2^bits entries, as PIL reads it (short at the end of the file,
    refused where that cuts an entry)."""
    p = data[pos:pos + (3 << bits)]
    if len(p) % 3:
        raise ValueError(f"{name}: GIF colour table cut short")
    ramp = np.repeat(np.arange(len(p) // 3, dtype=np.int64)[:, None], 3, axis=1)
    needed = not np.array_equal(np.frombuffer(p, np.uint8).reshape(-1, 3), ramp)
    return (p if needed else None), pos + len(p)


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the GIF file `data`'s first frame,
    as PIL's `Image.open(...).convert("RGB")` gives them."""
    if not data.startswith(GIF_MAGIC) or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file (bad or short header)")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_table: Optional[bytes] = None
    if flags & 128:
        global_table, pos = _table(data, pos, (flags & 7) + 1, name)

    def sub_block(at):  # GifImageFile.data(): (block or None, next position)
        if at >= len(data) or data[at] == 0:
            return None, min(at + 1, len(data))
        block = data[at + 1:at + 1 + data[at]]
        return block, at + 1 + len(block)

    def skip_blocks(at):
        block, at = sub_block(at)
        while block:
            block, at = sub_block(at)
        return at

    if pos >= len(data) or data[pos:pos + 1] == b";":
        raise ValueError(f"{name}: no image in the GIF file")
    transparency, frame = None, None
    while pos < len(data):
        s = data[pos:pos + 1]
        pos += 1
        if s == b";":
            break
        if s == b"!":
            if pos >= len(data):
                raise ValueError(f"{name}: GIF extension cut short")
            label = data[pos]
            block, pos = sub_block(pos + 1)
            if label == 249 and block is not None:
                if len(block) < (4 if block[:1] and block[0] & 1 else 3):
                    raise ValueError(f"{name}: GIF graphic control extension cut short")
                if block[0] & 1:
                    transparency = block[3]
            elif label == 254:
                while block:
                    block, pos = sub_block(pos)
                continue
            elif label == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                block, pos = sub_block(pos)
            pos = skip_blocks(pos)
        elif s == b",":
            if pos + 9 > len(data):
                raise ValueError(f"{name}: GIF image descriptor cut short")
            x0, y0, w, h, fflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            local: object = None  # None: no local table; False: a grey-ramp one
            if fflags & 128:
                local, pos = _table(data, pos, (fflags & 7) + 1, name)
                local = False if local is None else local
            if pos >= len(data):
                raise ValueError(f"{name}: GIF image data missing")
            frame = (x0, y0, x0 + w, y0 + h, bool(fflags & 64), local, data[pos])
            pos += 1
            break
    if frame is None:
        raise ValueError(f"{name}: no image in the GIF file")
    x0, y0, x1, y1, interlace, local, bits = frame
    width, height = max(x1, width), max(y1, height)
    if width <= 0 or height <= 0 or width * height > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: a GIF of size {width}x{height} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    table = local if local else global_table
    image = np.full((height, width), transparency or 0, np.uint8)
    if x1 <= x0 or y1 <= y0:  # Pillow 12.2.0's setimage refuses a tile of no pixels
        raise ValueError(f"{name}: a GIF frame of no pixels")
    status = lzw.gif_frame(data[pos:], bits, interlace, image, (x0, y0, x1, y1))
    if status != lzw.OK:
        raise ValueError(f"{name}: {lzw.GIF_FAULTS[status]}")
    if table is None:
        return np.repeat(image[..., None], 3, axis=2)
    palette = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(table, np.uint8).reshape(-1, 3)
    palette[:len(entries)] = entries
    return np.take(palette, image, axis=0)
