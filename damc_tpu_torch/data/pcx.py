"""PCX and DCX decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`PcxImagePlugin.py`, `DcxImagePlugin.py`; the run lengths in
`csrc/host/rle_decode.cpp`, which follows Pillow's `PcxDecode.c`).

PIL reads a 128-byte header: the box (xmin, ymin, xmax, ymax, the size
xmax - xmin + 1 by ymax - ymin + 1), the version, the bits a plane, the
planes and the stride the file gives, and takes:

  * 1 bit, 1 plane: bits, 1 white;
  * 1 bit, 2 or 4 planes: palette indices from the planes of each row
    (plane k the index's bit k), looked up in the header's 16-colour
    palette;
  * version 5, 8 bits, 1 plane: grey levels, unless the file ends in a
    769-byte palette (a 12, then 256 RGB entries) that is not the grey
    ramp, which the pixels then index; the file must hold 769 bytes,
    since PIL seeks that far back from its end (a file opened by path);
  * version 5, 8 bits, 3 planes: the R, G and B planes of each row.

PIL does not trust the stride the file gives: it computes the bytes a
plane, (width * bits + 7) // 8, and rounds that up to even when the
file's stride differs. A row is that times the planes. `PcxDecode.c`
then moves the planes of each row together before it unpacks them: 1-bit
planes to (width + 7) // 8 bytes apart (so they read right), 8-bit planes
to the width apart when row // (row // width) is wider than the width
(so an RGB image whose padded stride divides evenly, such as width 3 with
stride 4, reads its planes from the wrong bytes, as in PIL). The port
does the same. Runs may not cross a row's end.

DCX is PCX's page container: a magic number, then up to 1,024 page
offsets ending at a zero; PIL reads the first page, a PCX file at its
offset (the 769-byte palette still taken from the end of the whole file).

A file PIL refuses, or a corrupt one, raises ValueError naming the file.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import rle
from .images import PIL_MAX_PIXELS, NotThisFormat

DCX_MAGIC = 0x3ADE68B1
PALETTE_TAIL = 769  # a 12 byte, then 256 RGB entries, at the end of an 8-bit file


def is_pcx(head: bytes) -> bool:
    """PIL's accept test for PCX."""
    return len(head) >= 2 and head[0] == 10 and head[1] in (0, 2, 3, 5)


def is_dcx(head: bytes) -> bool:
    """PIL's accept test for DCX."""
    return len(head) >= 4 and struct.unpack_from("<I", head)[0] == DCX_MAGIC


@dataclass
class PcxHeader:
    width: int
    height: int
    bits: int
    planes: int
    stride: int  # PIL's bytes a plane
    mode: str  # 1, P, L or RGB
    palette: Optional[np.ndarray]  # (256, 3) uint8 for mode P
    start: int


def pcx_header(data, at: int, name: str) -> PcxHeader:
    """The PCX header at `at` as `PcxImageFile._open` reads it, from
    the file's bytes or a `formats.Source`. NotThisFormat where PIL's open falls through; ValueError
    for what it refuses."""
    s = data[at:at + 68]
    if not is_pcx(s):
        raise NotThisFormat(f"{name}: not a PCX file")
    if len(s) < 12:
        raise NotThisFormat(f"{name}: PCX header cut short")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat(f"{name}: bad PCX image size")
    if len(s) < 68:
        raise NotThisFormat(f"{name}: PCX header cut short")
    version, bits, planes = s[1], s[3], s[65]
    given = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        size = len(data)
        if size < PALETTE_TAIL:
            raise ValueError(f"{name}: an 8-bit PCX of {size} bytes (PIL seeks {PALETTE_TAIL} bytes before its end)")
        tail = data[size - PALETTE_TAIL:size]
        if len(tail) == PALETTE_TAIL and tail[0] == 12:
            table = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not np.array_equal(table, np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)):
                mode, palette = "P", table
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"{name}: unknown PCX mode (version {version}, {bits} bits, {planes} planes)")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    stride = (width * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    return PcxHeader(width, height, bits, planes, stride, mode, palette, at + 128)


def dcx_first_page(data, name: str) -> int:
    """The offset of a DCX file's first page, as `DcxImageFile._open`
    reads its directory; NotThisFormat where PIL's open falls through (a
    directory cut short, no page)."""
    if not is_dcx(data[:4]):
        raise NotThisFormat(f"{name}: not a DCX file")
    offsets = []
    for i in range(1024):
        b = data[4 + 4 * i:4 + 4 * i + 4]
        if len(b) < 4:
            raise NotThisFormat(f"{name}: DCX directory cut short")
        offset = struct.unpack("<I", b)[0]
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise NotThisFormat(f"{name}: DCX file of no pages")
    return offsets[0]


def _pixels(data: bytes, hd: PcxHeader, name: str) -> np.ndarray:
    w, h = hd.width, hd.height
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: PCX of size {w}x{h} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    row = hd.planes * hd.stride
    bits = {"RGB": 24, "L": 8, "P": 8 if hd.bits == 8 else hd.planes, "1": 1}[hd.mode]
    status, rows = rle.pcx_rle(data[hd.start:], row, w, bits, h)
    if status != rle.OK:
        raise ValueError(f"{name}: {rle.FAULTS[status]}")
    if hd.mode == "RGB":
        img = np.stack([rows[:, :w], rows[:, w:2 * w], rows[:, 2 * w:3 * w]], axis=-1)
    elif hd.mode in ("L", "P") and hd.bits == 8:
        idx = rows[:, :w]
        img = np.take(hd.palette, idx, axis=0) if hd.mode == "P" else np.repeat(idx[..., None], 3, axis=2)
    else:
        plane = (w + 7) // 8  # the unpackers' plane stride (P;2L, P;4L) and row (1)
        bits = np.unpackbits(np.pad(rows, ((0, 0), (0, max(0, hd.planes * plane - row))))[:, :hd.planes * plane]
                             .reshape(h, hd.planes, plane), axis=2)[..., :w]
        if hd.mode == "1":
            img = np.repeat((bits[:, 0] * np.uint8(255))[..., None], 3, axis=2)
        else:
            idx = sum(bits[:, k].astype(np.uint8) << k for k in range(hd.planes))
            img = np.take(hd.palette, idx, axis=0)
    return np.ascontiguousarray(img)


def decode_pcx(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the PCX file `data`."""
    try:
        hd = pcx_header(data, 0, name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    return _pixels(data, hd, name)


def decode_dcx(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the first page of the DCX file
    `data`."""
    try:
        hd = pcx_header(data, dcx_first_page(data, name), name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    return _pixels(data, hd, name)
