"""TIFF decoding as PIL's `Image.open(...).convert("RGB")` gives it
(`TiffImagePlugin.py`; LZW, PackBits and ThunderScan in
`csrc/host/lzw_decode.cpp`, CCITT fax in `csrc/host/fax_decode.cpp`,
Zstandard in `csrc/host/zstd_decode.cpp`, JPEG in `csrc/host/jpeg_decode.cpp`,
Deflate through zlib, LZMA through liblzma in `data/xz.py`).

PIL reads the first image file directory (IFD) of a classic TIFF in either
byte order or of a little-endian BigTIFF, and picks its mode and raw mode
from `OPEN_INFO` by byte order, photometric interpretation, sample format,
fill order, bits a sample and extra samples. Then it takes one of three
paths, and so does this module:

  * uncompressed: PIL's own raw decoder, one tile per strip or tile
    offset (planar configuration 2 reads each plane with one letter of the
    raw mode), the predictor ignored;
  * compressed: libtiff's strip and tile reads (`TiffDecode.c`): CCITT
    modified Huffman (2, 32771), T.4 (3, 1-D or 2-D) and T.6 (4), LZW (5,
    the pre-5.0 codes too), JPEG (7: the JPEGTables stream, then each strip
    or tile on its own; YCbCr converted to RGB by libjpeg, other colour
    spaces as their samples stand), Deflate (8, 32946), PackBits (32773),
    ThunderScan (32809), LZMA (34925) and Zstandard (50000); bit order
    reversed for fill order 2 before decoding (but for JPEG), predictor 2
    (horizontal differencing at 8, 16 and 32 bits) or 3 (floating point)
    undone after LZW, Deflate, LZMA and Zstandard, 16- and 32-bit samples
    in the machine's byte order, planes copied one by one;
  * YCbCr under any other compression, and old-style JPEG (6): libtiff's
    RGBA interface (`TIFFRGBAImage`), its tables converting each sample
    block (the Y samples, then Cb and Cr) with the chroma replicated over
    the block, ReferenceBlackWhite and YCbCrCoefficients applied; a strip
    that fails to decode leaves what it wrote (PIL asks libtiff not to stop
    at errors), but one that cannot be read at all fails the image.

The samples are converted as `convert("RGB")` does from the mode: bilevel
and grey below 8 bits scaled (MinIsWhite inverted), 12- and 16-bit grey
clamped to 255, other 16-bit samples cut to their high byte, float
truncated and clamped, the colour map's 16-bit entries divided by 256,
associated alpha un-premultiplied, CMYK by PIL's multiplicative formula.
CIELab (mode LAB, a* and b* signed) goes to RGB through LittleCMS as
PIL's ImageCms transform computes it (`data/cielab.py`). The Orientation
tag is applied, as PIL's TIFF reader transposes the image once it is
loaded. What PIL refuses (SGILog, WebP, which PIL's libtiff lacks, and
anything else its reader or libtiff turns down), or a corrupt file, raises
ValueError naming the file.
"""

from __future__ import annotations

import functools
import re
import struct
import zlib
from fractions import Fraction

import numpy as np

from . import cielab, fax, lzw, xz, zstd
from .images import PIL_MAX_PIXELS
from .jpeg import decode_tiff_jpeg

II, MM = b"II", b"MM"
PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")
# PIL's COMPRESSION_INFO: the codings it names.
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16", 32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
# Codings PIL names that its libtiff does not decode: SGILog takes only the
# LogL and LogLuv photometric interpretations, which PIL has no mode for, and
# the bundled libtiff is built without WebP.
REFUSED = {34676: "SGILog", 34677: "SGILog24", 50001: "WebP"}
CCITT_MODES = {2: fax.RLE, 32771: fax.RLE_WORD, 4: fax.G4}
PREDICTED = (5, 8, 32946, 34925, 50000)  # the codecs libtiff runs its predictor after

# PIL's OPEN_INFO, (photometric, sample format, fill order, bits, extra
# samples, mode, raw mode, byte orders); "" is both byte orders.
_OPEN = [
    (0, (1,), 1, (1,), (), "1", "1;I", ""), (0, (1,), 2, (1,), (), "1", "1;IR", ""),
    (1, (1,), 1, (1,), (), "1", "1", ""), (1, (1,), 2, (1,), (), "1", "1;R", ""),
    (0, (1,), 1, (2,), (), "L", "L;2I", ""), (0, (1,), 2, (2,), (), "L", "L;2IR", ""),
    (1, (1,), 1, (2,), (), "L", "L;2", ""), (1, (1,), 2, (2,), (), "L", "L;2R", ""),
    (0, (1,), 1, (4,), (), "L", "L;4I", ""), (0, (1,), 2, (4,), (), "L", "L;4IR", ""),
    (1, (1,), 1, (4,), (), "L", "L;4", ""), (1, (1,), 2, (4,), (), "L", "L;4R", ""),
    (0, (1,), 1, (8,), (), "L", "L;I", ""), (0, (1,), 2, (8,), (), "L", "L;IR", ""),
    (1, (1,), 1, (8,), (), "L", "L", ""), (1, (2,), 1, (8,), (), "L", "L", ""), (1, (1,), 2, (8,), (), "L", "L;R", ""),
    (1, (1,), 1, (12,), (), "I;16", "I;12", "II"),
    (0, (1,), 1, (16,), (), "I;16", "I;16", "II"), (1, (1,), 1, (16,), (), "I;16", "I;16", "II"),
    (1, (1,), 1, (16,), (), "I;16B", "I;16B", "MM"), (1, (1,), 2, (16,), (), "I;16", "I;16R", "II"),
    (1, (2,), 1, (16,), (), "I", "I;16S", "II"), (1, (2,), 1, (16,), (), "I", "I;16BS", "MM"),
    (0, (3,), 1, (32,), (), "F", "F;32F", "II"), (0, (3,), 1, (32,), (), "F", "F;32BF", "MM"),
    (1, (1,), 1, (32,), (), "I", "I;32N", "II"),
    (1, (2,), 1, (32,), (), "I", "I;32S", "II"), (1, (2,), 1, (32,), (), "I", "I;32BS", "MM"),
    (1, (3,), 1, (32,), (), "F", "F;32F", "II"), (1, (3,), 1, (32,), (), "F", "F;32BF", "MM"),
    (1, (1,), 1, (8, 8), (2,), "LA", "LA", ""),
    (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB", ""), (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R", ""),
    (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA", ""),
    (2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX", ""), (2, (1,), 1, (8,) * 5, (0, 0), "RGB", "RGBXX", ""),
    (2, (1,), 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX", ""),
    (2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa", ""), (2, (1,), 1, (8,) * 5, (1, 0), "RGBA", "RGBaX", ""),
    (2, (1,), 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX", ""),
    (2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA", ""), (2, (1,), 1, (8,) * 5, (2, 0), "RGBA", "RGBAX", ""),
    (2, (1,), 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX", ""),
    (2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA", ""),
    (2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16L", "II"), (2, (1,), 1, (16, 16, 16), (), "RGB", "RGB;16B", "MM"),
    (2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16L", "II"), (2, (1,), 1, (16,) * 4, (), "RGBA", "RGBA;16B", "MM"),
    (2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16L", "II"), (2, (1,), 1, (16,) * 4, (0,), "RGB", "RGBX;16B", "MM"),
    (2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16L", "II"), (2, (1,), 1, (16,) * 4, (1,), "RGBA", "RGBa;16B", "MM"),
    (2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16L", "II"), (2, (1,), 1, (16,) * 4, (2,), "RGBA", "RGBA;16B", "MM"),
    (3, (1,), 1, (1,), (), "P", "P;1", ""), (3, (1,), 2, (1,), (), "P", "P;1R", ""),
    (3, (1,), 1, (2,), (), "P", "P;2", ""), (3, (1,), 2, (2,), (), "P", "P;2R", ""),
    (3, (1,), 1, (4,), (), "P", "P;4", ""), (3, (1,), 2, (4,), (), "P", "P;4R", ""),
    (3, (1,), 1, (8,), (), "P", "P", ""), (3, (1,), 1, (8, 8), (0,), "P", "PX", ""),
    (3, (1,), 1, (8, 8), (2,), "PA", "PA", ""), (3, (1,), 2, (8,), (), "P", "P;R", ""),
    (5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK", ""), (5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX", ""),
    (5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX", ""),
    (5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16L", "II"), (5, (1,), 1, (16,) * 4, (), "CMYK", "CMYK;16B", "MM"),
    (6, (1,), 1, (8,), (), "L", "L", ""), (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX", ""),
    (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB", ""),
]
OPEN_INFO = {(order, photo, fmt, fill, bits, extra): (mode, raw)
             for photo, fmt, fill, bits, extra, mode, raw, orders in _OPEN for order in (orders and (orders.encode(),)
                                                                                           or (II, MM))}
MAX_SAMPLES = max(len(k[4]) for k in OPEN_INFO)
# PIL's unpackers for a planar tile's one letter of the raw mode: (mode, letter) -> bits a sample
PLANE_UNPACKERS = {("RGB", "R"): 8, ("RGB", "G"): 8, ("RGB", "B"): 8, ("RGBA", "R"): 8, ("RGBA", "G"): 8,
                   ("RGBA", "B"): 8, ("RGBA", "A"): 8, ("CMYK", "C"): 8, ("CMYK", "M"): 8, ("CMYK", "Y"): 8,
                   ("CMYK", "K"): 8, ("L", "L"): 8, ("1", "1"): 1, ("P", "P"): 8, ("I", "I"): 32, ("F", "F"): 32,
                   ("LAB", "L"): 8, ("LAB", "A"): 8, ("LAB", "B"): 8}
# raw modes of OPEN_INFO that PIL has no unpacker for: its raw decoder refuses them
NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}
# Tags: (name, PIL's spec'd count is one)
ONE_VALUE = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8}
TYPE_FORMATS = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d", 13: "L", 16: "Q"}
ORIENTATIONS = {2: "flip_lr", 3: "rot180", 4: "flip_tb", 5: "transpose", 6: "rot270", 7: "transverse", 8: "rot90"}
REVERSED = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)], np.uint8)


def is_tiff(head: bytes) -> bool:
    """Whether PIL's TIFF reader takes a file with these first bytes."""
    return head[:4] in PREFIXES


class _Bad(Exception):
    """A fault PIL meets too: raised as ValueError naming the file."""


def _rational(num: int, den: int):
    return Fraction(num, den) if den else float("nan")


def _ifd(data: bytes):
    """(byte order, tags {tag: value}, directory) of the first IFD, read as
    PIL's ImageFileDirectory_v2 reads it: entries of unknown type skipped,
    values past the entry read at their offset (a short read ends the IFD
    there), a spec'd single value or a BYTE entry kept as one value, any
    other entry as a tuple. `directory` is what libtiff's reading of it
    needs: (whether the entry table lies whole in the file, the bytes of
    the header and directory or None where an entry's type is unknown)."""
    ifh = data[:8]
    if ifh[:4] not in PREFIXES:
        raise _Bad("not a TIFF file")
    big = len(ifh) > 2 and ifh[2] == 43
    if big:
        ifh += data[8:16]
    order = ifh[:2]
    endian = ">" if order == MM else "<"
    try:
        (first,) = struct.unpack(endian + ("Q" if big else "L"), ifh[8:16] if big else ifh[4:8])
    except struct.error:
        raise _Bad("TIFF header cut short") from None
    if not first:
        raise _Bad("no image in the TIFF file")
    if first >= 2 ** 63:
        raise _Bad("TIFF IFD offset past 2^63")
    raw, types = {}, {}
    pos, table_whole = first, False
    space = 16 + 8 + 8 if big else 8 + 2 + 4  # libtiff's EstimateStripByteCounts: header, directory, its data
    try:
        head = data[pos:pos + (8 if big else 2)]
        if len(head) < (8 if big else 2):
            raise EOFError
        (count,) = struct.unpack(endian + ("Q" if big else "H"), head)
        pos += len(head)
        width = 20 if big else 12
        table_whole = pos + count * width <= len(data)  # libtiff reads the entry table whole or not at all
        for _ in range(count):
            entry = data[pos:pos + width]
            if len(entry) < width:
                raise EOFError
            pos += width
            tag, typ, n, inline = struct.unpack(endian + ("HHQ8s" if big else "HHL4s"), entry)
            space = None if space is None or typ not in LIBTIFF_TYPE_SIZES else space + width + (
                LIBTIFF_TYPE_SIZES[typ] * n if LIBTIFF_TYPE_SIZES[typ] * n > (8 if big else 4) else 0)
            if typ not in TYPE_SIZES:
                continue
            size = n * TYPE_SIZES[typ]
            if size > (8 if big else 4):
                (at,) = struct.unpack(endian + ("Q" if big else "L"), inline)
                value = data[at:at + size]
                if len(value) < size:
                    raise EOFError
            else:
                value = inline[:size]
            if not value:
                continue
            raw[tag], types[tag] = value, typ
    except EOFError:  # PIL stops reading the IFD at a short read and keeps what it has
        pass
    tags = {}
    for tag, value in raw.items():
        typ = types[tag]
        if typ in (1, 7):
            v = value
        elif typ == 2:
            v = (value[:-1] if value.endswith(b"\0") else value).decode("latin-1", "replace")
        elif typ in (5, 10):
            nums = struct.unpack(f"{endian}{len(value) // 4}{'L' if typ == 5 else 'l'}", value)
            v = tuple(_rational(a, b) for a, b in zip(nums[::2], nums[1::2]))
        else:
            fmt = TYPE_FORMATS[typ]
            v = struct.unpack(f"{endian}{len(value) // struct.calcsize('<' + fmt)}{fmt}", value)
        if isinstance(v, (bytes, str)):
            v = v if (tag in ONE_VALUE or typ == 1) else (v,)
        elif tag in ONE_VALUE or (tag not in _SPEC_TAGS and len(v) == 1):
            v = v[0]
        tags[tag] = v
    return order, tags, (table_whole, space)


LIBTIFF_TYPE_SIZES = {**TYPE_SIZES, 17: 8, 18: 8}
_SPEC_TAGS = ONE_VALUE | {258, 273, 279, 320, 324, 325, 338, 339, 700}


# PIL's unpackers of samples below 8 bits: raw mode -> (bits, inverted, bits reversed)
BIT_RAWMODES = {"1": (1, False, False), "1;I": (1, True, False), "1;R": (1, False, True), "1;IR": (1, True, True),
                "L;2": (2, False, False), "L;2I": (2, True, False), "L;2R": (2, False, True),
                "L;2IR": (2, True, True), "L;4": (4, False, False), "L;4I": (4, True, False),
                "L;4R": (4, False, True), "L;4IR": (4, True, True), "P;1": (1, False, False),
                "P;1R": (1, False, True), "P;2": (2, False, False), "P;2R": (2, False, True),
                "P;4": (4, False, False), "P;4R": (4, False, True)}
# byte-a-sample grey and palette unpackers: raw mode -> (inverted, bits reversed)
BYTE_RAWMODES = {"L": (False, False), "L;I": (True, False), "L;R": (False, True), "L;IR": (True, True),
                 "P": (False, False), "P;R": (False, True)}
WORD_RAWMODES = {"I;16": "<u2", "I;16N": "<u2", "I;16B": ">u2", "I;16R": "<u2", "I;16S": "<i2", "I;16BS": ">i2",
                 "I;32N": "<i4", "I;32S": "<i4", "I;32BS": ">i4", "F;32F": "<f4", "F;32BF": ">f4",
                 "I": "<i4", "F": "<f4"}


def _unpack(raw: str, mode: str, rows: np.ndarray, width: int) -> np.ndarray:
    """PIL's unpacker `raw` for `mode` over rows of bytes (R, N): the
    mode's samples (R, width, bands), int64 (float64 for mode F)."""
    r = rows.shape[0]
    if raw in BIT_RAWMODES:
        depth, inverted, reversed_ = BIT_RAWMODES[raw]
        b = REVERSED[rows] if reversed_ else rows
        per = 8 // depth  # samples a byte, the first in the high bits
        b = b[:, :-(-width // per)]
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        v = ((b[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(r, -1)[:, :width].astype(np.int64)
        if inverted:
            v = (1 << depth) - 1 - v
        if mode != "P":
            v = v * (255 // ((1 << depth) - 1))
        return v[..., None]
    if raw in BYTE_RAWMODES or len(raw) == 1 and raw in "RGBACMYKLP":
        inverted, reversed_ = BYTE_RAWMODES.get(raw, (False, False))
        v = (REVERSED[rows] if reversed_ else rows)[:, :width].astype(np.int64)
        return (255 - v if inverted else v)[..., None]
    if raw in WORD_RAWMODES:
        dt = np.dtype(WORD_RAWMODES[raw])
        b = REVERSED[rows] if raw == "I;16R" else rows
        v = np.ascontiguousarray(b[:, :width * dt.itemsize]).view(dt)
        with np.errstate(invalid="ignore"):  # a float's NaN pattern read as it stands
            return v.astype(np.float64 if dt.kind == "f" else np.int64)[..., None]
    if raw == "I;12":  # 12-bit samples packed MSB first, two in three bytes
        n = (width + 1) // 2 * 3
        b = np.zeros((r, n), np.int64)
        b[:, :min(n, rows.shape[1])] = rows[:, :n]
        b0, b1, b2 = b[:, 0::3], b[:, 1::3], b[:, 2::3]
        return np.stack([b0 << 4 | b1 >> 4, (b1 & 15) << 8 | b2], axis=2).reshape(r, -1)[:, :width, None]
    # several samples a pixel: letters, then ";16L", ";16B", ";16N" (the high byte kept) or ";R"
    letters, _, flags = raw.partition(";")
    n = len(letters)
    b = REVERSED[rows] if flags == "R" else rows
    if flags.startswith("16"):
        v = b[:, :width * n * 2].reshape(r, width, n, 2)[..., 0 if flags == "16B" else 1].astype(np.int64)
    else:
        v = b[:, :width * n].reshape(r, width, n).astype(np.int64)
    if letters in ("LA", "PA"):
        return v[..., :2]
    if letters == "PX":
        return v[..., :1]
    if letters.startswith("RGBa"):  # associated alpha: PIL's unpackRGBa un-premultiplies
        return np.concatenate([_unpremultiply(v[..., :3], v[..., 3:4]), v[..., 3:4]], axis=2)
    return v[..., :4] if letters.startswith(("RGBA", "CMYK")) else v[..., :3]


def _unpremultiply_table() -> np.ndarray:
    """PIL's un-premultiplication of a colour c under alpha a, as a table
    [a, c]: 0 where alpha is 0, c at 255, else min(c * 255 // a, 255)."""
    a, c = np.arange(256)[:, None], np.arange(256)[None, :]
    t = np.minimum(c * 255 // np.maximum(a, 1), 255)
    t[0], t[255] = 0, np.arange(256)
    return t.astype(np.uint8)


UNPREMULTIPLY = _unpremultiply_table()


def _unpremultiply(c: np.ndarray, a: np.ndarray) -> np.ndarray:
    """The colours `c` (..., 3) un-premultiplied by the alphas `a` (..., 1)."""
    return UNPREMULTIPLY[a, c]


def _to_rgb(mode: str, s: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 from the mode's samples, as PIL's convert("RGB")."""
    if mode in ("1", "L", "LA", "I;16", "I;16B", "I"):
        v = np.clip(s[..., 0], 0, 255).astype(np.uint8)
        return np.repeat(v[..., None], 3, axis=2)
    if mode == "F":
        v = s[..., 0]
        v = np.where(v <= 0, 0, np.where(v >= 255, 255, np.nan_to_num(np.trunc(v), nan=0.0))).astype(np.uint8)
        return np.repeat(v[..., None], 3, axis=2)
    if mode in ("P", "PA"):
        return np.take(palette, s[..., 0].astype(np.uint8), axis=0)
    if mode == "LAB":
        return cielab.lab_to_rgb(s.astype(np.uint8))
    if mode == "CMYK":
        k = 255 - s[..., 3:4]
        t = (255 - s[..., :3]) * k + 128
        return (((t >> 8) + t) >> 8).astype(np.uint8)
    return s[..., :3].astype(np.uint8)


def _bits_of(raw: str) -> int:
    """The bits a pixel of PIL's raw mode (its unpacker's `bits`)."""
    if raw in BIT_RAWMODES:
        return BIT_RAWMODES[raw][0]
    if raw in WORD_RAWMODES:
        return np.dtype(WORD_RAWMODES[raw]).itemsize * 8
    letters, _, flags = raw.partition(";")
    if flags == "12":
        return 12
    return (16 if flags.startswith("16") else 8) * len(letters)


def _strips_or_tiles(tags: dict, key_tag: int):
    v = tags.get(key_tag, ())
    return tuple(v) if isinstance(v, (tuple, bytes)) else (v,)


def _inflate(data: bytes, size: int, out=None) -> bool:
    """A Deflate strip as libtiff's ZIPDecode reads it through zlib: inflate
    until `size` bytes are out (what follows them unread, the checksum too
    unless the stream ends there) into `out`; a corrupt stream, or one that
    ends first, fails with what it decoded written."""
    decoder = zlib.decompressobj()
    try:
        got = decoder.decompress(data, size)
    except zlib.error:
        _partial(zlib.decompressobj, zlib.error, data, size, out)
        return False
    out[:len(got)] = np.frombuffer(got, np.uint8)
    return len(got) == size


def _partial(make, error, data: bytes, size: int, out) -> int:
    """The bytes a decoder writes before it meets a fault, fed one input
    byte at a time (written to `out`); returns how many."""
    decoder, got = make(), b""
    try:
        for k in range(len(data)):
            got += decoder.decompress(data[k:k + 1], size - len(got))
            if len(got) >= size:
                break
    except error:
        pass
    out[:len(got)] = np.frombuffer(got, np.uint8)
    return len(got)


def _decompress(data: bytes, comp: int, size: int, fill_order: int, out: np.ndarray, width: int, row_bytes: int,
                t4: int, fax_state) -> int:
    """Decode one stored strip or tile into out[:size] as libtiff does:
    1, or what libtiff's codec returns where it fails (0; the CCITT codecs
    -1, which TIFFReadTile takes for success), `out` then holding what it
    wrote (the rest as it was, or zeros where libtiff clears it). `width`
    and `row_bytes` are the row of pixels and of bytes the CCITT codes and
    ThunderScan fill; `t4` is the T4Options tag; `fax_state` the CCITT
    codec's state from strip to strip."""
    if fill_order == 2:
        data = REVERSED[np.frombuffer(data, np.uint8)].tobytes()
    if comp in (2, 3, 4, 32771):
        mode = fax.G3_2D if comp == 3 and t4 & 1 else fax.G3 if comp == 3 else CCITT_MODES[comp]
        return 1 if fax.fax_decode(data, out[:size], mode, width, row_bytes, fax_state) == fax.OK else -1
    if comp == 5:
        ok = lzw.tiff_lzw(data, size, out) == lzw.OK
    elif comp == 32773:
        ok = lzw.packbits(data, size, out) == lzw.OK
    elif comp == 32809:
        ok = lzw.thunderscan(data, size, width, out) == lzw.OK
    elif comp == 50000:
        ok = zstd.zstd_decode(data, size, out) == zstd.OK
    elif comp == 34925:
        ok = xz.unxz(data, size, out)
    else:
        ok = _inflate(data, size, out)
    return int(ok)


def _predict(block: np.ndarray, rows: int, row_bytes: int, predictor: int, bits: int, stride: int,
             fmt: int, endian: str) -> np.ndarray:
    """Undo predictor 2 or 3 over a decoded block of `rows` rows, as
    libtiff's tif_predict.c: the result in the machine's (little-endian)
    byte order."""
    m = block[:rows * row_bytes].reshape(rows, row_bytes)
    if predictor == 2:
        if bits not in (8, 16, 32, 64):
            raise _Bad(f"predictor 2 at {bits} bits a sample")
        dt = {8: "u1", 16: "u2", 32: "u4", 64: "u8"}[bits]
        v = m.copy().view(endian + dt).reshape(rows, -1, stride).astype("<" + dt)
        return np.cumsum(v, axis=1, dtype=v.dtype).reshape(rows, -1).view(np.uint8).reshape(-1)
    if predictor == 3:
        if fmt != 3 or bits not in (16, 24, 32, 64):
            raise _Bad(f"predictor 3 at {bits} bits, sample format {fmt}")
        if row_bytes % (bits // 8 * stride):
            raise _Bad("predictor 3 row not whole")
        acc = m.reshape(rows, -1, stride).copy()
        acc = np.cumsum(acc, axis=1, dtype=np.uint8).reshape(rows, row_bytes)
        nb = bits // 8
        return acc.reshape(rows, nb, row_bytes // nb).transpose(0, 2, 1)[:, :, ::-1].reshape(-1)
    raise _Bad(f"predictor {predictor} is not supported")


def decode_tiff(data: bytes, name: str = "<bytes>", blank: int = 0) -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the TIFF file `data`'s first image,
    as PIL's `Image.open(...).convert("RGB")` gives them. `blank` is what
    PIL's strip or tile buffer holds before libtiff's first read (malloc's,
    so undefined): the bytes a short Group 4 strip or a JPEG frame smaller
    than its strip leaves there."""
    try:
        return _decode(data, name, blank)
    except _Bad as e:
        raise ValueError(f"{name}: {e}") from None
    except (KeyError, IndexError, TypeError, ValueError, struct.error, OverflowError, ZeroDivisionError) as e:
        raise ValueError(f"{name}: a TIFF PIL refuses too ({type(e).__name__}: {e})") from None


def _decode(data: bytes, name: str, blank: int = 0) -> np.ndarray:
    order, tags, directory = _ifd(data)
    if 0xBC01 in tags:
        raise _Bad("Windows Media Photo files not supported")
    compression = COMPRESSIONS[tags.get(259, 1)]
    planar = tags.get(284, 1)
    photo = tags.get(262, 0)
    if compression == "tiff_jpeg":
        photo = 6
    fill = tags.get(266, 1)
    if 256 not in tags or 257 not in tags:
        raise _Bad("missing dimensions")
    xsize, ysize = tags[256], tags[257]
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise _Bad("invalid dimensions")
    sample_format = tags.get(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format):
        sample_format = (sample_format[0],)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    spp = tags.get(277, 3 if compression == "tiff_jpeg" and photo in (2, 6) else 1)
    bps_count = 3 if photo in (2, 6, 8) else 4 if photo == 5 else 1
    if planar == 2 and extra and max(extra) == 0:  # Pillow 12.2.0: unspecified planes past the colour are dropped
        bps, spp, extra = bps[:-len(extra)], spp - len(extra), ()
    bps_count += len(extra)
    comp_code = next(k for k, v in COMPRESSIONS.items() if v == compression)
    if spp > MAX_SAMPLES:
        raise _Bad("invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise _Bad("unknown data organization")
    key = (order, photo, tuple(sample_format), fill, tuple(bps), tuple(extra))
    if key not in OPEN_INFO:
        raise _Bad("unknown pixel mode")
    mode, raw = OPEN_INFO[key]
    if xsize <= 0 or ysize <= 0 or xsize * ysize > PIL_MAX_PIXELS:
        raise _Bad(f"a TIFF of size {xsize}x{ysize} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    if comp_code in REFUSED:
        raise _Bad(f"TIFF compression {comp_code} ({REFUSED[comp_code]}), which PIL's libtiff does not decode")
    palette = np.zeros((256, 3), np.uint8)
    if mode in ("P", "PA"):
        cmap = tags[320]
        cmap = list(cmap) if isinstance(cmap, tuple) else list(cmap) if isinstance(cmap, bytes) else [cmap]
        entries = np.asarray([int(b // 256) & 255 for b in cmap], np.uint8)
        n = len(entries) // 3
        palette[:min(n, 256)] = np.stack([entries[:n], entries[n:2 * n], entries[2 * n:3 * n]], 1)[:256]
    if compression == "raw":
        samples = _raw_path(data, tags, mode, raw, xsize, ysize, bps, bps_count, planar)
    elif photo == 6 and not (comp_code == 7 and planar == 1):  # TiffDecode.c reads YCbCr as RGBA
        samples = _rgba_path(data, tags, directory, xsize, ysize, bps, spp, planar, comp_code, fill, order)
    else:
        samples = _libtiff_path(data, tags, directory, key, mode, raw, xsize, ysize, bps, spp, planar, comp_code,
                                fill, sample_format, blank)
    rgb = _to_rgb(mode, samples, palette)
    return _orient(rgb, tags)


def _orient(rgb: np.ndarray, tags: dict) -> np.ndarray:
    """PIL's exif_transpose of the loaded image by the Orientation tag (or
    an XMP packet's tiff:Orientation where there is no tag)."""
    orientation = tags.get(274)
    if orientation is None and 700 in tags:
        xmp = tags[700]
        if isinstance(xmp, tuple) and len(xmp) == 1:
            xmp = xmp[0]
        if isinstance(xmp, (bytes, str)) and xmp:
            pattern = rb'tiff:Orientation(="|>)([0-9])' if isinstance(xmp, bytes) else r'tiff:Orientation(="|>)([0-9])'
            match = re.search(pattern, xmp)
            if match:
                orientation = int(match[2])
    try:
        method = ORIENTATIONS.get(orientation)
    except TypeError:
        method = None
    if method == "flip_lr":
        rgb = rgb[:, ::-1]
    elif method == "rot180":
        rgb = rgb[::-1, ::-1]
    elif method == "flip_tb":
        rgb = rgb[::-1]
    elif method == "transpose":
        rgb = rgb.transpose(1, 0, 2)
    elif method == "rot270":
        rgb = rgb.transpose(1, 0, 2)[:, ::-1]
    elif method == "transverse":
        rgb = rgb[::-1, ::-1].transpose(1, 0, 2)
    elif method == "rot90":
        rgb = rgb.transpose(1, 0, 2)[::-1]
    return np.ascontiguousarray(rgb)


def _mode_bands(mode: str) -> int:
    return {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "I;16": 1, "I;16B": 1, "LA": 2, "PA": 2, "RGB": 3,
            "RGBA": 4, "CMYK": 4, "LAB": 3}[mode]


def _raw_path(data, tags, mode, raw, xsize, ysize, bps, bps_count, planar):
    """PIL's raw decoder over its tile list: one tile a strip or tile
    offset, sorted by offset, consecutive duplicates but the last dropped;
    a planar tile unpacks one letter of the raw mode into its band."""
    if 273 in tags:
        offsets = _strips_or_tiles(tags, 273)
        h, w = tags.get(278, ysize), xsize
    elif 324 in tags:
        offsets = _strips_or_tiles(tags, 324)
        w, h = tags.get(322), tags.get(323)
        if not isinstance(w, int) or not isinstance(h, int):
            raise _Bad("invalid tile dimensions")
    else:
        raise _Bad("unknown data organization")
    if w == xsize and h == ysize and planar != 2:
        offsets = offsets[-1:]
    tiles, x, y, layer = [], 0, 0, 0
    for offset in offsets:
        stride = w * sum(bps) / 8 if x + w > xsize else 0
        tile_raw = raw
        if planar == 2:
            tile_raw = raw[layer]
            stride /= bps_count
        tiles.append((offset, (x, y, min(x + w, xsize), min(y + h, ysize)), tile_raw, int(stride), layer))
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y = 0
                layer += 1
    tiles.sort(key=lambda t: t[0])
    kept = [t for i, t in enumerate(tiles) if i + 1 == len(tiles) or tiles[i + 1][1:4] != t[1:4]]
    jobs, last_error = [], False
    for offset, box, tile_raw, stride, layer in kept:
        if len(tile_raw) == 1:
            band_bits = PLANE_UNPACKERS.get((mode, tile_raw))
            if band_bits is None:
                raise _Bad("unknown raw mode for given image mode")
            bits = band_bits
        elif tile_raw in NO_UNPACKER:
            raise _Bad("unknown raw mode for given image mode")
        else:
            bits = _bits_of(tile_raw)
        x0, y0, x1, y1 = box
        if not all(isinstance(v, int) for v in box):
            raise _Bad("tile extents are not integers")
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or x1 > xsize or th <= 0 or y1 > ysize or x0 < 0 or y0 < 0:  # Pillow 12.2.0's setimage
            raise _Bad("tile cannot extend outside image")
        if offset < 0:
            raise _Bad("negative strip offset")
        row_bytes = (tw * bits + 7) // 8
        skip = stride - row_bytes if stride else 0
        if skip < 0:
            last_error = True
            continue
        last_error = False
        need = th * row_bytes + (th - 1) * skip
        if len(data) - offset < need:
            raise _Bad("image file is truncated")
        jobs.append((offset, (x0, y0, x1, y1), tile_raw, row_bytes, skip, need))
    if last_error:
        raise _Bad("decoder configuration error")
    image = np.zeros((ysize, xsize, _mode_bands(mode)), np.float32 if mode == "F" else np.int32)
    for offset, (x0, y0, x1, y1), tile_raw, row_bytes, skip, need in jobs:
        tw, th = x1 - x0, y1 - y0
        pitch = row_bytes + skip
        block = np.zeros(th * pitch, np.uint8)
        block[:need] = np.frombuffer(data, np.uint8, need, offset)
        rows = block.reshape(th, pitch)[:, :row_bytes]
        if len(tile_raw) == 1:
            v = _unpack(tile_raw, mode, rows, tw)
            band = ("LAB".index(tile_raw) if mode == "LAB" else
                    {"R": 0, "G": 1, "B": 2, "A": 3, "C": 0, "M": 1, "Y": 2, "K": 3}.get(tile_raw, 0))
            image[y0:y1, x0:x1, band] = v[..., 0] ^ 128 if mode == "LAB" and band else v[..., 0]  # band1I, band2I
        else:
            image[y0:y1, x0:x1] = _unpack(tile_raw, mode, rows, tw)
    return image


def _libtiff_path(data, tags, directory, key, mode, raw, xsize, ysize, bps, spp, planar, comp, fill, sample_format,
                  blank=0):
    """libtiff's strip or tile reads as Pillow's TiffDecode.c makes them."""
    table_whole, space = directory
    if not table_whole:
        raise _Bad("cannot read the TIFF directory")
    if mode in ("P", "PA") and len(tags[320]) != 3 << bps[0]:  # libtiff ignores a colour map of another size
        raise _Bad("TIFF directory is missing the required ColorMap")
    if fill == 2:
        mode, raw = OPEN_INFO[key[:3] + (1,) + key[4:]]
    ycc = key[1] == 6  # YCbCr reaching this path: JPEG in one plane, which libjpeg turns into RGB
    if ycc:
        raw = "RGB"
    elif raw == "I;16":
        raw = "I;16N"
    elif raw.endswith((";16B", ";16L")):
        raw = raw[:-1] + "N"
    bits = bps[0]
    if comp in (2, 3, 4, 32771) and bits != 1:
        raise _Bad("Bits/sample must be 1 for Group 3/4 encoding/decoding")
    if comp == 32809 and bits != 4:
        raise _Bad("the ThunderScan decoder only supports 4 bits a sample")
    if comp == 7 and bits != 8:
        raise _Bad("Improper JPEG data precision")
    tiled = 324 in tags and 322 in tags
    offsets = _strips_or_tiles(tags, 324 if tiled else 273)
    counts = _strips_or_tiles(tags, 325 if tiled else 279)
    if planar not in (1, 2):
        raise _Bad(f"planar configuration {planar}")
    planes = 1
    if planar == 2 and spp > 1:  # each sample plane copied into its band (8 bits, or a 16-bit sample's high byte)
        planes = _mode_bands(mode)
        if spp != planes and not tiled:  # libtiff's strips of more planes than the mode's bands: refused
            raise _Bad("separate planes that are not the mode's bands")
    predictor = tags.get(317, 1) if comp in PREDICTED else 1
    fmt = sample_format[0]
    separate = planar == 2 and spp > 1
    plane_spp = 1 if separate else spp
    state_bits = _bits_of(raw)
    if tiled:
        tw, th = tags.get(322), tags.get(323)
        across = -(-xsize // tw)
        down = -(-ysize // th)
        unit_rows, unit_width = th, tw
        grid = [(tx * tw, ty * th, ty * across + tx) for ty in range(down) for tx in range(across)]
        per_plane = across * down
    else:
        rps = tags.get(278, 2 ** 32 - 1)
        rps = min(rps, ysize) if rps < 2 ** 32 - 1 else ysize
        unit_rows, unit_width = rps, xsize
        grid = [(0, y, y // rps) for y in range(0, ysize, rps)]
        per_plane = -(-ysize // rps)
    row_bytes = (unit_width * plane_spp * bits + 7) // 8
    unit_size = row_bytes * unit_rows
    if tiled:
        if unit_size > ((th * state_bits // planes + 7) // 8) * tw:
            raise _Bad("tile size is not what the mode expects")
    elif unit_size > ((xsize * state_bits // planes + 7) // 8) * unit_rows:
        raise _Bad("strip size is not what the mode expects")
    if unit_size > 2 ** 31 - 2:
        raise _Bad("strip or tile too large")
    if not tiled and len(offsets) == 1 and counts[:1] == (0,) and offsets[0] and space is not None:
        # libtiff's estimate for a one-strip image whose byte count is zero
        space = len(data) - space if len(data) >= space else len(data)
        counts = (max(0, min(space, len(data) - offsets[0])),)
    jobs = []
    for x, y, index in grid:
        for plane in range(planes):
            k = index + plane * per_plane
            if k >= len(offsets) or k >= len(counts):
                raise _Bad("strip or tile offset missing")
            offset, count = offsets[k], counts[k]
            if count <= 0 or offset < 0 or offset + count > len(data):
                raise _Bad("strip or tile out of the file")
            jobs.append((x, y, plane, offset, count))
    image = np.zeros((ysize, xsize, _mode_bands(mode)), np.float32 if mode == "F" else np.int32)
    native = np.dtype({16: "<u2", 32: "<u4", 64: "<u8"}.get(bits, "u1"))
    swap = key[0] == MM and bits in (16, 32, 64)  # libtiff swaps samples to the machine's order
    t4 = tags.get(292, 0) if isinstance(tags.get(292, 0), int) else 0
    buffer = np.full(unit_size, blank, np.uint8)  # PIL's strip or tile buffer, which a short Group 4 strip leaves
    fax_state = fax.State()
    decoded_jpeg = _jpeg_units(data, tags, jobs, ycc, unit_width, unit_rows, row_bytes, ysize, tiled,
                               1 if separate else spp, blank) if comp == 7 else None

    def decoded(i, offset, count, rows):  # one strip or tile, as TIFFReadEncodedStrip or TIFFReadTile gives it
        size = rows * row_bytes
        if decoded_jpeg is not None:
            return decoded_jpeg[i][:rows]
        status = _decompress(data[offset:offset + count], comp, size, fill, buffer, unit_width, row_bytes, t4,
                             fax_state)
        if status == 0 or (status < 0 and not tiled):  # TIFFReadEncodedStrip fails at <= 0, TIFFReadTile at 0
            raise _Bad(f"corrupt or short {COMPRESSIONS[comp]} data")
        block = buffer[:size]
        if predictor != 1:
            block = _predict(block, rows, row_bytes, predictor, bits, plane_spp, fmt, ">" if key[0] == MM else "<")
        elif swap:
            block = block.copy().view(native.newbyteorder(">")).astype(native).view(np.uint8)
        return np.array(block[:size]).reshape(rows, row_bytes)

    def place(m, x, y, plane, cw, ch):
        if separate:
            v = m[:ch, :cw * 2].reshape(ch, cw, 2)[..., 1] if bits == 16 else m[:ch, :cw]
            image[y:y + ch, x:x + cw, plane] = v ^ 128 if mode == "LAB" and plane else v
        else:
            image[y:y + ch, x:x + cw] = _unpack(raw, mode, m[:ch], cw)

    if tiled:
        for i, (x, y, plane, offset, count) in enumerate(jobs):
            place(decoded(i, offset, count, unit_rows), x, y, plane, min(unit_width, xsize - x),
                  min(unit_rows, ysize - y))
    else:  # a plane's strips are whole rows: decoded one by one, unpacked together
        for plane in range(planes):
            rows = [decoded(i, offset, count, min(unit_rows, ysize - y)) for i, (_, y, p, offset, count)
                    in enumerate(jobs) if p == plane]
            place(np.concatenate(rows), 0, 0, plane, xsize, ysize)
    if planes == 4 and mode == "RGBA":  # TiffDecode.c: associated or unspecified alpha, un-premultiplied
        es = tags.get(338) or (0,)  # libtiff calls a fourth sample with no ExtraSamples unspecified
        if es[0] in (0, 1):
            image[..., :3] = _unpremultiply(image[..., :3], image[..., 3:4])
    return image


def _ycbcr_subsampling(tags: dict, first: bytes = b"") -> tuple:
    """libtiff's YCbCrSubsampling: the tag, else (for JPEG, JPEGFixupTags)
    component 0's sampling in the first strip's frame header, else (2, 2)."""
    v = tags.get(530)
    if isinstance(v, tuple) and len(v) >= 2:
        return int(v[0]), int(v[1])
    k = 2
    while first and k + 4 <= len(first):  # the marker segments up to the first SOF
        if first[k] != 0xFF:
            break
        m = first[k + 1]
        if m == 0xFF:
            k += 1
            continue
        length = first[k + 2] << 8 | first[k + 3]
        if m in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA) and k + 12 <= len(first):
            h, v = first[k + 11] >> 4, first[k + 11] & 15
            if h in (1, 2, 4) and v in (1, 2, 4):
                return h, v
            break
        k += 2 + length
    return 2, 2


def _jpeg_units(data, tags, jobs, ycc, unit_width, unit_rows, row_bytes, ysize, tiled, ncomp, blank=0):
    """Every strip or tile of a JPEG-in-TIFF image, decoded in file order
    as libtiff's tif_jpeg.c reads them (see `jpeg.decode_tiff_jpeg`)."""
    tables = tags.get(347, b"")
    tables = tables[0] if isinstance(tables, tuple) and len(tables) == 1 else tables
    tables = bytes(tables) if isinstance(tables, bytes) else b""
    streams = [data[offset:offset + count] for _, _, _, offset, count in jobs]
    sampling = _ycbcr_subsampling(tags, streams[0] if streams else b"") if ycc else (1, 1)
    segments = []
    for _, y, _, _, _ in jobs:
        rows = unit_rows if tiled else min(unit_rows, ysize - y)
        segments.append((unit_width, rows, int(not tiled and y + rows == ysize)))
    status, message, outs = decode_tiff_jpeg(tables, streams, segments, row_bytes, ncomp, ycc, sampling, blank)
    if status != 0:
        raise _Bad(f"JPEG data libtiff refuses: {message}")
    return outs




# TIFFRGBAImage's put functions for contiguous YCbCr (PickContigCase) by (h, v)
# subsampling: the bytes each skips past a clipped tile's row of blocks for
# every h pixels clipped (putcontig8bitYCbCr44tile's is 10, not 18)
YCBCR_PUTS = {(4, 4): 10, (4, 2): 10, (4, 1): 6, (2, 2): 6, (2, 1): 4, (1, 2): 4, (1, 1): 3}


def _float_tag(tags: dict, tag: int, count: int, default: tuple) -> np.ndarray:
    """A RATIONAL array tag as libtiff stores it (float32; a zero
    denominator reads as 0), else `default`."""
    v = tags.get(tag)
    if not isinstance(v, tuple) or len(v) != count:
        return np.asarray(default, np.float32)
    return np.asarray([0.0 if isinstance(x, float) and x != x else float(x) for x in v], np.float32)


def _ycbcr_tables(tags: dict):
    """libtiff's YCbCr to RGB conversion for these tags (`_ycbcr_luts`),
    or None where its initYCbCrConversion refuses them."""
    luma = _float_tag(tags, 529, 3, (0.299, 0.587, 0.114))
    ref = _float_tag(tags, 532, 6, (0, 255, 128, 255, 128, 255))
    if np.isnan(luma).any() or luma[1] == 0:
        return None
    if not ((ref > np.float32(-0x7FFFFFFF + 128)) & (ref < np.float32(0x7FFFFFFF))).all():
        return None
    return _ycbcr_luts(luma.tobytes(), ref.tobytes())


@functools.lru_cache(maxsize=16)
def _ycbcr_luts(luma_bytes: bytes, ref_bytes: bytes) -> tuple:
    """tif_color.c TIFFYCbCrToRGBInit in float32 and 16.16 fixed point, its
    tables folded into lookups: red by (Y, Cr), blue by (Y, Cb), green's
    chroma term by (Cb, Cr), and the Y table."""
    f32 = np.float32
    luma, ref = np.frombuffer(luma_bytes, f32), np.frombuffer(ref_bytes, f32)

    def clamp(f, lo, hi):
        return np.where(~(f >= lo), f32(lo), np.where(f > hi, f32(hi), f))

    def fix(x):  # FIX(x): (int32)(x * 65536 + 0.5), the product in float, the sum in double
        return np.int64(np.trunc(np.float64(f32(x) * f32(65536)) + 0.5))

    with np.errstate(all="ignore"):
        f1 = f32(2) - f32(2) * luma[0]
        d1 = fix(clamp(f1, 0.0, 2.0))
        f2 = luma[0] * f1 / luma[1]
        d2 = -fix(clamp(f2, 0.0, 2.0))
        f3 = f32(2) - f32(2) * luma[2]
        d3 = fix(clamp(f3, 0.0, 2.0))
        f4 = luma[2] * f3 / luma[1]
        d4 = -fix(clamp(f4, 0.0, 2.0))
        x = np.arange(-128, 128)

        def code2v(c, rb, rw, cr):  # ((c - (int32)RB) * (float)CR) / (float)(RW - RB or 1)
            span = rw - rb
            span = span if span != 0 else f32(1)
            return (np.asarray(c - np.int64(np.trunc(rb)), np.float32) * f32(cr)) / f32(span)

        cr = np.trunc(clamp(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127), -128.0 * 32, 128.0 * 32))
        cb = np.trunc(clamp(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127), -128.0 * 32, 128.0 * 32))
        ty = np.trunc(clamp(code2v(x + 128, ref[0], ref[1], 255), -128.0 * 32, 128.0 * 32)).astype(np.int64)
    cr, cb = cr.astype(np.int64), cb.astype(np.int64)
    cr_r = (d1 * cr + (1 << 15)) >> 16
    cb_b = (d3 * cb + (1 << 15)) >> 16
    cr_g = d2 * cr
    cb_g = d4 * cb + (1 << 15)
    red = np.clip(ty[:, None] + cr_r[None, :], 0, 255).astype(np.uint8).ravel()
    blue = np.clip(ty[:, None] + cb_b[None, :], 0, 255).astype(np.uint8).ravel()
    chroma = ((cb_g[:, None] + cr_g[None, :]) >> 16).ravel()
    return red, blue, chroma, ty


def _ycbcr_to_rgb(luts, y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """TIFFYCbCrtoRGB over uint8 arrays of samples: (..., 3) uint8."""
    red, blue, chroma, ty = luts
    y16, cb16, cr16 = (v.astype(np.intp) for v in (y, cb, cr))
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = red[(y16 << 8) | cr16]
    out[..., 1] = np.clip(ty[y16] + chroma[(cb16 << 8) | cr16], 0, 255)
    out[..., 2] = blue[(y16 << 8) | cb16]
    return out


def _ojpeg_header(data: bytes, tags: dict, xsize: int, ysize: int) -> bytes:
    """The JPEG header tif_ojpeg.c writes for a file whose tables stand in
    tags: JPEGQTables (519, 64 bytes each), JPEGDCTables and JPEGACTables
    (520, 521: 16 counts and their symbols), component i using table i (or
    the last), sampled as YCbCrSubsampling says; JPEGRestartInterval
    (515) where given. Only baseline (JPEGProc 1) is read."""
    if tags.get(512, 1) != 1:
        raise _Bad("old-style JPEG that is not baseline")
    hs, vs = _ycbcr_subsampling(tags)
    q, dc, ac = (_strips_or_tiles(tags, t) for t in (519, 520, 521))
    if not q or not dc or not ac:
        raise _Bad("old-style JPEG without its tables")
    out = bytearray(b"\xff\xd8")
    for i in range(3):
        table = data[q[min(i, len(q) - 1)]:][:64]
        if len(table) < 64:
            raise _Bad("old-style JPEG quantization table past the file")
        out += b"\xff\xdb" + struct.pack(">H", 67) + bytes([i]) + table
    for cls, offs in ((0, dc), (1, ac)):
        for i in range(3):
            at = offs[min(i, len(offs) - 1)]
            counts = data[at:at + 16]
            body = data[at:at + 16 + sum(counts)]
            if len(counts) < 16 or len(body) < 16 + sum(counts):
                raise _Bad("old-style JPEG Huffman table past the file")
            out += b"\xff\xc4" + struct.pack(">H", 3 + len(body)) + bytes([cls << 4 | i]) + body
    if isinstance(tags.get(515), int) and tags[515]:
        out += b"\xff\xdd" + struct.pack(">HH", 4, tags[515])
    out += b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, ysize, xsize, 3)
    out += bytes([0, hs << 4 | vs, 0, 1, 0x11, 1, 2, 0x11, 2])
    out += b"\xff\xda" + struct.pack(">HB", 12, 3) + bytes([0, 0x00, 1, 0x11, 2, 0x22, 0, 63, 0])
    return bytes(out)


def _ojpeg_stream(stream: bytes, data: bytes, tags: dict, xsize: int, ysize: int) -> bytes:
    """The JPEG stream tif_ojpeg.c hands libjpeg: its own reading of the
    markers up to SOS (SOI skipped wherever it stands, APPn and COM
    skipped, an unknown marker or a length below 2 refused, the reading
    ended by a byte that is not 0xFF), then SOI, the tables, DRI, SOF and
    SOS it read (or made from the tags where the stream has no SOF), and
    the data from where its reading stopped."""
    pos, kept, sof, sos = 0, bytearray(), None, None
    while pos < len(stream) and stream[pos] == 0xFF:
        while pos < len(stream) and stream[pos] == 0xFF:
            pos += 1
        if pos >= len(stream):
            raise _Bad("old-style JPEG data ends in a marker")
        m = stream[pos]
        pos += 1
        if m == 0xD8:
            continue
        if pos + 2 > len(stream):
            raise _Bad("old-style JPEG data ends in a marker")
        n = stream[pos] << 8 | stream[pos + 1]
        if n < 2:
            raise _Bad("Corrupt JPEG data")
        segment = b"\xff" + bytes([m]) + stream[pos:pos + n]
        if len(segment) < n + 2:
            raise _Bad("old-style JPEG data ends in a marker")
        pos += n
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            continue
        if m in (0xC0, 0xC1, 0xC3):
            if sof is not None:
                raise _Bad("Corrupt JPEG data (a second SOF)")
            sof = segment
        elif m == 0xDA:
            sos = segment
            break
        elif m in (0xDB, 0xC4, 0xDD):
            kept += segment
        else:
            raise _Bad(f"Unknown marker type {m} in JPEG data")
    if sof is None:
        if 519 not in tags:
            raise _Bad("old-style JPEG without its tables")
        return _ojpeg_header(data, tags, xsize, ysize) + stream[pos:]
    if sos is None:
        raise _Bad("old-style JPEG without a scan header")
    return b"\xff\xd8" + bytes(kept) + sof + sos + stream[pos:]


def _ojpeg(data: bytes, tags: dict, xsize: int, ysize: int, tables) -> np.ndarray:
    """Old-style JPEG (compression 6) as libtiff's tif_ojpeg.c hands it to
    TIFFRGBAImage: one JPEG stream read from JPEGInterchangeFormat (for its
    length, or to the end of the file) and then from each strip in turn;
    its YCbCr samples, at the frame's own subsampling, converted by
    libtiff's tables with the chroma replicated over each block. Rows past
    the strips the file lists read as zero samples (PIL asks libtiff not to
    stop at a strip it cannot read)."""
    if tags.get(262) != 6:
        raise _Bad("old-style JPEG that is not YCbCr")
    if 324 in tags:
        raise _Bad("old-style JPEG in tiles")
    offsets, counts = _strips_or_tiles(tags, 273), _strips_or_tiles(tags, 279)
    stream = b""
    jif, jif_len = tags.get(513), tags.get(514)
    if isinstance(jif, int) and 0 < jif < len(data):
        jif_len = jif_len if isinstance(jif_len, int) and 0 < jif_len <= len(data) - jif else len(data) - jif
        stream = data[jif:jif + jif_len]
    for offset, count in zip(offsets, counts):
        if 0 < offset < len(data):
            stream += data[offset:offset + count] if count else data[offset:]
    stream = _ojpeg_stream(stream, data, tags, xsize, ysize)
    hs, vs = _ycbcr_subsampling({}, stream)
    if (hs, vs) not in YCBCR_PUTS:
        raise _Bad(f"TIFFRGBAImage cannot handle YCbCr subsampling {hs}x{vs}")
    across, down = -(-xsize // hs), -(-ysize // vs)
    stride = across * (hs * vs + 2)
    status, message, (blocks,) = decode_tiff_jpeg(b"", [stream], [(xsize, down, ysize)], stride, 3, 2, (hs, vs))
    if status != 0:
        raise _Bad(f"old-style JPEG data libtiff refuses: {message}")
    rps = tags.get(278, ysize)
    rps = rps if isinstance(rps, int) and 0 < rps < ysize else ysize
    if rps < ysize and rps % (8 * vs):  # tif_ojpeg.c: a strip is whole rows of MCUs
        raise _Bad("Incompatible vertical subsampling and image strip/tile length")
    if -(-ysize // rps) - min(len(offsets), len(counts)) > 1:  # observed of PIL: a second unlisted strip fails
        raise _Bad("old-style JPEG missing more than one strip")
    listed = min(len(offsets), len(counts)) * rps  # the rows of the strips the file lists
    src = blocks.reshape(-1)
    r, c = np.arange(ysize)[:, None], np.arange(xsize)[None, :]
    at = (r // vs) * stride + (c // hs) * (hs * vs + 2)
    rgb = _ycbcr_to_rgb(tables, src[at + (r % vs) * hs + c % hs], src[at + hs * vs], src[at + hs * vs + 1])
    rgb[listed:] = _ycbcr_to_rgb(tables, np.zeros(1, np.int64), np.zeros(1, np.int64), np.zeros(1, np.int64))
    return rgb


def _rgba_path(data, tags, directory, xsize, ysize, bps, spp, planar, comp, fill, order):
    """Pillow's _decodeAsRGBA: libtiff's TIFFRGBAImage over a YCbCr image,
    one block of rows a strip or tile at a time, errors not stopping it."""
    table_whole, space = directory
    if not table_whole:
        raise _Bad("cannot read the TIFF directory")
    if tuple(bps) != (8, 8, 8) or spp != 3:
        raise _Bad("TIFFRGBAImage cannot handle this YCbCr format")
    if planar not in (1, 2):
        raise _Bad(f"planar configuration {planar}")
    hs, vs = _ycbcr_subsampling(tags)
    separate = planar == 2
    if (hs, vs) not in ({(1, 1)} if separate else YCBCR_PUTS):
        raise _Bad(f"TIFFRGBAImage cannot handle YCbCr subsampling {hs}x{vs}")
    tables = _ycbcr_tables(tags)
    if tables is None:
        raise _Bad("invalid YCbCrCoefficients or ReferenceBlackWhite")
    if comp == 6:
        return _ojpeg(data, tags, xsize, ysize, tables)
    if comp in (2, 3, 4, 32771):
        raise _Bad("Bits/sample must be 1 for Group 3/4 encoding/decoding")
    if comp == 32809:
        raise _Bad("the ThunderScan decoder only supports 4 bits a sample")
    tiled = 324 in tags and 322 in tags
    offsets = _strips_or_tiles(tags, 324 if tiled else 273)
    counts = _strips_or_tiles(tags, 325 if tiled else 279)
    if tiled:
        uw, uh = tags.get(322), tags.get(323)
        grid = [(tx * uw, ty * uh, ty * -(-xsize // uw) + tx) for ty in range(-(-ysize // uh))
                for tx in range(-(-xsize // uw))]
        per_plane = len(grid)
    else:
        rps = tags.get(278, 2 ** 32 - 1)
        uh = min(rps, ysize) if rps < 2 ** 32 - 1 else ysize
        uw = xsize
        grid = [(0, y, y // uh) for y in range(0, ysize, uh)]
        per_plane = -(-ysize // uh)
    if not tiled and len(offsets) == 1 and counts[:1] == (0,) and offsets[0] and space is not None:
        space = len(data) - space if len(data) >= space else len(data)
        counts = (max(0, min(space, len(data) - offsets[0])),)
    planes = 3 if separate else 1
    if separate:
        unit_bytes = uw * uh
        row_bytes = uw
    else:
        blocks_hor = -(-uw // hs)
        block_row = blocks_hor * (hs * vs + 2)
        row_bytes = block_row // vs  # TIFFScanlineSize of subsampled YCbCr
        unit_bytes = block_row * -(-uh // vs)
    predictor = tags.get(317, 1) if comp in PREDICTED else 1
    jpeg = None
    if comp == 7:  # separate planes of one component each
        jobs = [(x, y, p, offsets[k + p * per_plane] if k + p * per_plane < len(offsets) else 0,
                 counts[k + p * per_plane] if k + p * per_plane < len(counts) else 0)
                for x, y, k in grid for p in range(planes)]
        jpeg = _jpeg_units(data, tags, jobs, False, uw, uh, row_bytes, ysize, tiled, 1)
    samples = np.zeros((3, ysize, xsize), np.uint8)  # Y, Cb and Cr of each pixel, converted at the end
    n = 0
    bsize = hs * vs + 2
    index = {}  # (rows, cw) -> where each pixel's Y, Cb and Cr stand in its block data
    for x, y, k in grid:
        rows = uh if tiled else min(uh, ysize - y)
        if x == 0:  # gtStripContig and gtTileContig zero a new buffer each call: a strip, or a row of tiles
            buffers = [np.zeros(unit_bytes, np.uint8) for _ in range(planes)]
        plane_data = []
        for p in range(planes):
            buffer = buffers[p]
            if jpeg is not None:
                plane_data.append(jpeg[n].reshape(-1)[:uw * rows].copy())
                n += 1
                continue
            if separate:
                size = uw * rows
            elif tiled:
                size = unit_bytes
            else:
                size = min(-(-rows // vs) * vs * row_bytes, block_row * -(-rows // vs))
            j = k + p * per_plane
            offset = offsets[j] if j < len(offsets) else -1
            count = counts[j] if j < len(counts) else 0
            if count <= 0 or offset < 0 or offset + count > len(data):  # TIFFFillStrip or TIFFFillTile fails
                if p == 0 and x == 0:  # before gtStripContig or gtTileContig has its buffer: the call fails
                    raise _Bad("strip or tile out of the file")
                buffer[:size] = 0  # else libtiff clears what it was asked for
            elif _decompress(data[offset:offset + count], comp, size, fill, buffer, uw, row_bytes, 0, None) > 0:
                pred_row = uw * (1 if separate else 3) if tiled else row_bytes  # libtiff's predictor row
                if predictor != 1 and size % pred_row == 0:
                    buffer[:size] = _predict(buffer[:size].copy(), size // pred_row, pred_row, predictor, 8,
                                             1 if separate else 3, 1, ">" if order == MM else "<")
            plane_data.append(buffer[:size].copy() if separate else buffer)
        cw = min(uw, xsize - x)
        keep = min(rows, ysize - y)
        if separate:
            for p, d in enumerate(plane_data):
                samples[p, y:y + keep, x:x + cw] = d.reshape(rows, uw)[:keep, :cw]
            continue
        if (keep, cw) not in index:
            r = np.arange(keep)[:, None]
            c = np.arange(cw)[None, :]
            clipped = uw - cw  # fromskew: the put steps over it with its own factor
            at = (r // vs) * (-(-cw // hs) * bsize + clipped // hs * YCBCR_PUTS[(hs, vs)]) + (c // hs) * bsize
            index[keep, cw] = np.stack([at + (r % vs) * hs + c % hs, at + hs * vs + 0 * c, at + hs * vs + 1 + 0 * c])
        src = plane_data[0]
        samples[:, y:y + keep, x:x + cw] = src[np.minimum(index[keep, cw], len(src) - 1)]
    return _ycbcr_to_rgb(tables, samples[0], samples[1], samples[2])
