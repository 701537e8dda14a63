"""ICNS decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`IcnsImagePlugin.py`; the packed channels in `csrc/host/rle_decode.cpp`).

An ICNS file is a header (`icns`, the file's length) and blocks (a type,
the block's length with its 8-byte header). PIL lists the sizes its table
(`SIZES`) knows whose types the file holds and loads the largest (size,
size, scale): every type of that size in the table's order, a later one
overriding an earlier one's channels. A PNG entry (ic07 to ic14, icp4 to
icp6) is a PNG file, read by the port's PNG decoder, and is the image when
there is one; a JPEG 2000 entry raises NotImplementedError (ROADMAP queue
3); the 24-bit entries (is32, il32, ih32, it32 after 4 zero bytes) are
three channels of width x height bytes, each packed in runs (a byte b of
128 or more: the next byte b - 125 times; else b + 1 literal bytes) unless
the entry holds exactly 3 x width x height bytes (interleaved RGB), and
the masks (s8mk, l8mk, h8mk, t8mk) alpha, which the conversion to RGB
drops but which must be whole. A PNG whose size is not the chosen size
over a whole scale is refused, as PIL's size check refuses it. Runs read
on past their block to the end of the file, as PIL's reads do.

`icns_directory` is PIL's open: NotThisFormat where PIL falls through (a
block header cut short or of no length, no known size). A file PIL
refuses, or a corrupt one, raises ValueError naming the file.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

from . import rle
from .images import PIL_MAX_PIXELS, PNG_SIGNATURE, NotThisFormat, decode_png

ICNS_MAGIC = b"icns"
PNG, RGB24, RGB24T, MASK = "png", "rgb", "rgb_t", "mask"
# IcnsFile.SIZES: (size, size, scale) -> the entry types PIL reads for it, in order
SIZES = {
    (512, 512, 2): [(b"ic10", PNG)],
    (512, 512, 1): [(b"ic09", PNG)],
    (256, 256, 2): [(b"ic14", PNG)],
    (256, 256, 1): [(b"ic08", PNG)],
    (128, 128, 2): [(b"ic13", PNG)],
    (128, 128, 1): [(b"ic07", PNG), (b"it32", RGB24T), (b"t8mk", MASK)],
    (64, 64, 1): [(b"icp6", PNG)],
    (32, 32, 2): [(b"ic12", PNG)],
    (48, 48, 1): [(b"ih32", RGB24), (b"h8mk", MASK)],
    (32, 32, 1): [(b"icp5", PNG), (b"il32", RGB24), (b"l8mk", MASK)],
    (16, 16, 2): [(b"ic11", PNG)],
    (16, 16, 1): [(b"icp4", PNG), (b"is32", RGB24), (b"s8mk", MASK)],
}
JPEG2000 = ((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a"), b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")


def icns_directory(data, name: str) -> Tuple[Dict[bytes, Tuple[int, int]], list]:
    """({type: (data offset, length)}, the sizes PIL lists) as `IcnsFile`
    reads them from `data` (the file's bytes or a `formats.Source`)."""
    head = data[:8]
    if len(head) < 8 or head[:4] != ICNS_MAGIC:
        raise NotThisFormat(f"{name}: not an ICNS file")
    filesize = struct.unpack(">I", head[4:])[0]
    blocks, i = {}, 8
    while i < filesize:
        b = data[i:i + 8]
        if len(b) < 8:
            raise NotThisFormat(f"{name}: ICNS block header cut short")
        sig, size = struct.unpack(">4sI", b)
        if size <= 0:
            raise NotThisFormat(f"{name}: ICNS block of no length")
        blocks[sig] = (i + 8, size - 8)
        i += size
    sizes = [size for size, kinds in SIZES.items() if any(t in blocks for t, _ in kinds)]
    if not sizes:
        raise NotThisFormat(f"{name}: no 32-bit icon resources in the ICNS file")
    return blocks, sizes


def decode_icns(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the ICNS file `data`'s largest
    image."""
    try:
        blocks, sizes = icns_directory(data, name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    best = max(sizes)
    w, h = best[0] * best[2], best[1] * best[2]
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: ICNS image of size {w}x{h}")
    channels = {}
    for sig, kind in SIZES[best]:
        if sig not in blocks:
            continue
        start, length = blocks[sig]
        if kind == PNG:
            head = data[start:start + 12]
            if head[:8] == PNG_SIGNATURE:
                channels["RGBA"] = decode_png(data[start:], name)
            elif head.startswith(JPEG2000[0]) or head == JPEG2000[1]:
                raise NotImplementedError(f"{name}: PIL reads this ICNS file's JPEG 2000 entry; the port does not yet")
            else:
                raise ValueError(f"{name}: unsupported ICNS entry {sig!r}")
            continue
        if kind == RGB24T:
            if data[start:start + 4] != b"\x00\x00\x00\x00":
                raise ValueError(f"{name}: ICNS {sig!r} entry without its zero signature")
            start, length = start + 4, length - 4
        sizesq = w * h
        if kind == MASK:
            if len(data) - start < sizesq:
                raise ValueError(f"{name}: ICNS mask {sig!r} cut short")
            channels["A"] = True
        elif length == sizesq * 3:
            if len(data) - start < length:
                raise ValueError(f"{name}: ICNS entry {sig!r} cut short")
            channels["RGB"] = np.frombuffer(data, np.uint8, length, start).reshape(h, w, 3)
        else:
            status, planes = rle.icns_rle(data[start:], sizesq)
            if status != rle.OK:
                raise ValueError(f"{name}: ICNS entry {sig!r}: {rle.FAULTS[status]}")
            channels["RGB"] = planes.reshape(3, h, w).transpose(1, 2, 0)
    img = channels.get("RGBA")
    if img is None:
        if "RGB" not in channels:
            raise ValueError(f"{name}: ICNS size {best} has a mask and no image")
        return np.ascontiguousarray(channels["RGB"])
    ih, iw = img.shape[:2]
    if not any(s[1] * s[2] / ih == s[0] * s[2] // iw for s in sizes):
        raise ValueError(f"{name}: ICNS PNG of size {iw}x{ih} fits none of the file's sizes")
    return img
