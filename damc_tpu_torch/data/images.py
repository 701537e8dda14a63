"""PNG and BMP decoding and PIL's bilinear and Lanczos resize, with zlib and
numpy alone.

The JAX package reads image folders through PIL (`damc_tpu/data/datasets.py::
load_image_folder`: `Image.open(p).convert("RGB")`, then `Image.resize(...,
Image.BILINEAR)`). The port's reader must give the same bytes without PIL,
so that its training data equals the JAX package's:

  * `decode_png` (one file; `parse_png` then `decode_parsed` for many)
    reads PNGs of every colour type at every bit depth PNG allows (grey at
    1, 2, 4, 8 and 16 bits; palette at 1, 2, 4 and 8; RGB, grey + alpha
    and RGBA at 8 and 16), plain or Adam7-interlaced, and converts them to
    RGB as PIL's `convert("RGB")` of the mode PIL opens them in does: grey
    below 8 bits scaled to 8 (x255, x85, x17), 16-bit grey clamped to 255
    (PIL's I;16), every other 16-bit sample cut to its high byte, alpha
    and tRNS dropped, palette indices looked up and one past the PLTE's
    entries black. A PNG that PIL refuses too, or a corrupt one, raises
    `ValueError` naming the file and the fault.
  * `decode_bmp` reads every BMP coding PIL's `BmpImagePlugin.py` reads:
    BI_RGB at 1, 4 and 8 bits (palette indices), 16 (5-5-5), 24 and 32
    bits; BI_BITFIELDS at 16, 24 and 32 bits in PIL's layouts; RLE8 and
    RLE4 as Pillow 12.2.0's decoder reads them; bottom-up or top-down; as
    PIL's `convert("RGB")` gives them, quirks included (a grey-ramp
    palette read as grey levels, an index past the palette black). What
    PIL refuses (2 bits a pixel, BI_JPEG, BI_PNG, another bit-field
    layout) and a truncated file raise `ValueError` naming the file.
  * `resize` is PIL's `Image.resize(size, Image.BILINEAR)` or
    `Image.LANCZOS` on 8-bit images, bit for bit (Pillow's
    `libImaging/Resample.c`): a triangle or Lanczos-3 filter whose support
    grows with the downscale factor (antialiasing), weights normalised in
    float64 and rounded to 22 fraction bits, the horizontal pass, then the
    vertical, each rounded and clamped to 8 bits.

A PNG row carries one of five filters (None, Sub, Up, Average, Paeth),
which predict each byte from its left, upper and upper-left neighbours.
Average and Paeth make every pixel of a row depend on the decoded pixel to
its left, so a row cannot be undone as one vector operation. `unfilter`
walks the anti-diagonals instead: pixel (r, x) needs only (r, x - 1),
(r - 1, x) and (r - 1, x - 1), which lie on the two diagonals before its
own, so each diagonal is decoded in one vector step, every row under its
own filter type: H + W - 1 steps for an H x W image. The image is kept
sheared (diagonal t is row t of the work array) so that a step reads and
writes contiguous memory, and images of one size are decoded together,
which spreads each step's fixed cost over the batch. Below 8 bits a pixel
the filter's unit is a byte; an Adam7 pass is unfiltered as an image of
its own, batched with every pass of the same shape.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # colour type -> its bit depths
# Adam7's seven passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
GREY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}  # grey below 8 bits to 8, as PIL's unpackers 1, L;2 and L;4
PIL_READ = 65536  # PIL's decodermaxblock: the most of an IDAT chunk PIL hands its decoder at once
PIL_MAX_PIXELS = 2 * 89478485  # PIL refuses larger images (DecompressionBombError)
PRECISION_BITS = 22  # fraction bits of the resize weights (Resample.c, 8 bits a sample)


def paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of each byte from its left (a), upper (b) and
    upper-left (c) neighbours, as signed integer arrays."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, ftypes: Sequence[int]) -> np.ndarray:
    """The filtered bytes of the uint8 scanlines `rows` (H, W * bpp), row r
    under filter type `ftypes[r]` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    x = rows.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    ft = np.asarray(ftypes, np.int64).reshape(-1, 1)
    pred = np.choose(ft, (0, a, b, (a + b) >> 1, paeth(a, b, c)))
    return ((x - pred) & 255).astype(np.uint8)


def unfilter(filtered: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """The scanlines (N, H, W * bpp) uint8 of N images whose row r of image i
    was filtered with type `ftypes[i, r]`: the inverse of `filter_rows`.

    The work array d holds pixel (r, x) of every image at d[r + x + 2,
    r + 1]: its left neighbour is then d[r + x + 1, r + 1], its upper one
    d[r + x + 1, r] and its upper-left one d[r + x, r]. Planes 0 and 1,
    column 0 and every place off the image stay zero, which is the value
    PNG gives a neighbour outside the image."""
    n_img, h, n = filtered.shape
    w = n // bpp
    ft = np.asarray(ftypes, np.int64).reshape(n_img, h)
    if not ft.any():
        return filtered.copy()
    rr, xx = np.arange(h)[:, None], np.arange(w)[None, :]
    d = np.zeros((h + w + 1, h + 1, n_img, bpp), np.int16)
    d[rr + xx + 2, rr + 1] = filtered.reshape(n_img, h, w, bpp).transpose(1, 2, 0, 3)
    masks = [(ft == k).T.astype(np.int16)[:, :, None] for k in range(5)]  # (H, N, 1) each
    present = [bool(m.any()) for m in masks]
    for t in range(h + w - 1):
        r0, r1 = max(0, t - w + 1), min(h - 1, t)
        rows = slice(r0, r1 + 1)
        a, b, c = d[t + 1, r0 + 1:r1 + 2], d[t + 1, rows], d[t, rows]
        cur = d[t + 2, r0 + 1:r1 + 2]  # the residuals, decoded in place
        if present[1]:
            cur += masks[1][rows] * a
        if present[2]:
            cur += masks[2][rows] * b
        if present[3]:
            cur += masks[3][rows] * ((a + b) >> 1)
        if present[4]:
            cur += masks[4][rows] * paeth(a, b, c)
        cur &= 255
    return d[rr + xx + 2, rr + 1].transpose(2, 0, 1, 3).astype(np.uint8).reshape(n_img, h, n)


@dataclass
class ParsedPng:
    """A PNG's header, palette and filtered scanlines, before unfiltering:
    one pass over the whole image, or each of Adam7's passes that holds a
    pixel, as ((first column, first row, column step, row step), filtered
    rows (R, row bytes) uint8, the filter type of each row (R,))."""

    name: str
    width: int
    height: int
    color: int
    depth: int
    palette: Optional[np.ndarray]  # (entries, 3) uint8 for colour type 3
    passes: List[Tuple[Tuple[int, int, int, int], np.ndarray, np.ndarray]]

    @property
    def channels(self) -> int:
        return CHANNELS[self.color]

    @property
    def bpp(self) -> int:
        """The filter's unit: the bytes of a pixel, 1 below 8 bits a pixel."""
        return max(1, self.channels * self.depth // 8)

    @property
    def ftypes(self) -> np.ndarray:
        return np.concatenate([ftypes for _, _, ftypes in self.passes])

    @property
    def nbytes(self) -> int:
        return sum(rows.size for _, rows, _ in self.passes)


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk, its CRC checked, up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated {ctype!r} chunk")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: CRC mismatch in the {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _inflate(idat: Sequence[bytes], shapes: Sequence[Tuple[int, int]], name: str) -> bytes:
    """The inflated image data as far as PIL's decoder takes it: zlib is fed
    PIL's reads (up to PIL_READ bytes of one IDAT chunk at a time) and asked
    for no byte past the last row, so a checksum or a corruption after the
    rows is met only where PIL meets it, in the read that ends the rows. A
    stream that ends (zlib's end of stream) in the read that completes a
    row ends the image there, PIL's early end: the rows not reached stay
    zero. `shapes` holds each pass's (rows, bytes a row). Raises ValueError
    for a corrupt stream and for one that stops before its rows do."""
    need, out = sum(rows * row for rows, row in shapes), bytearray()

    def row_end(n):
        for rows, row in shapes:
            if n <= rows * row:
                return n % row == 0
            n -= rows * row
        return False

    inflater = zlib.decompressobj()
    for chunk in idat:
        for at in range(0, len(chunk), PIL_READ):
            before = len(out)
            try:
                out += inflater.decompress(chunk[at:at + PIL_READ], need - len(out))
            except zlib.error as e:
                raise ValueError(f"{name}: corrupt image data ({e})") from None
            if len(out) == need:
                return bytes(out)
            if inflater.eof:
                if len(out) > before and row_end(len(out)):
                    return bytes(out)
                raise ValueError(f"{name}: the image data ends after {len(out)} of its {need} bytes")
    raise ValueError(f"{name}: the image data holds {len(out)} bytes, {need} expected")


def parse_png(data: bytes, name: str = "<bytes>") -> ParsedPng:
    """Check the chunks of a PNG file, inflate its image data and cut it
    into the filtered rows of each pass. The image data is inflated only as
    far as the rows need, as PIL's decoder stops there. Raises ValueError
    naming the file for a PNG that is corrupt (a CRC, a truncated chunk or
    image data, a filter type past 4, a header of the wrong size), that
    breaks the format (a colour type, or a bit depth for the colour type,
    that PNG does not have; an unknown compression or filter method; a
    PLTE of more than 256 entries) or that holds an unknown critical
    chunk. A palette image without PLTE reads as black, as in PIL."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            if len(body) < 13:
                raise ValueError(f"{name}: an IHDR chunk of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":  # PIL takes len // 3 entries
            palette = np.frombuffer(body, np.uint8, len(body) // 3 * 3).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif not ctype[0] & 0x20 and ctype != b"IEND":  # upper-case first letter: critical
            raise ValueError(f"{name}: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"{name}: colour type {color} is not a PNG colour type")
    if depth not in DEPTHS[color]:
        raise ValueError(f"{name}: bit depth {depth} is not one of colour type {color}'s {DEPTHS[color]}")
    if compression or filter_method:
        raise ValueError(f"{name}: unknown compression or filter method ({compression}, {filter_method})")
    if color == 3 and palette is None:  # PIL reads every index as black
        palette = np.zeros((0, 3), np.uint8)
    if color == 3 and len(palette) > 256:
        raise ValueError(f"{name}: a PLTE chunk of {len(palette)} entries (PIL takes 256 at most)")
    if not 0 < w * h <= PIL_MAX_PIXELS:
        raise ValueError(f"{name}: a PNG of size {w}x{h} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    bits = CHANNELS[color] * depth
    windows = [(x0, y0, dx, dy) for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)) if x0 < w and y0 < h]
    shapes = [(-(-(h - y0) // dy), 1 + (-(-(w - x0) // dx) * bits + 7) // 8) for x0, y0, dx, dy in windows]
    raw = _inflate(idat, shapes, name)
    flat = np.frombuffer(raw, np.uint8)
    passes, pos = [], 0
    for window, (rows, row) in zip(windows, shapes):
        rows = min(rows, (len(raw) - pos) // row)  # a stream that ended early leaves rows out
        if rows == 0:
            break
        block = flat[pos:pos + rows * row].reshape(rows, row)
        pos += rows * row
        if int(block[:, 0].max()) > 4:
            raise ValueError(f"{name}: filter type {int(block[:, 0].max())} is not a PNG filter type")
        passes.append((window, block[:, 1:], block[:, 0]))
    return ParsedPng(name, w, h, color, depth, palette, passes)


def _unpack(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """The first `count` samples of each row of bytes (R, N): below 8 bits
    MSB first (the padding bits dropped), 16 bits big-endian as uint16."""
    if depth == 16:
        return (rows[:, 0::2].astype(np.uint16) << 8 | rows[:, 1::2])[:, :count]
    if depth == 8:
        return rows[:, :count]
    shifts = (8 - depth - depth * np.arange(8 // depth)).astype(np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(len(rows), -1)[:, :count]


def _samples(png: ParsedPng, rows: Sequence[np.ndarray]) -> np.ndarray:
    """(H, W, channels) samples from each pass's unfiltered rows, each pass
    scattered to its place (uint16 at 16 bits, else uint8); rows that the
    image data did not reach are zero, as PIL leaves them."""
    h, w, c = png.height, png.width, png.channels
    out = np.zeros((h, w, c), np.uint16 if png.depth == 16 else np.uint8)
    for ((x0, y0, dx, dy), _, _), r in zip(png.passes, rows):
        pw = -(-(w - x0) // dx)
        out[y0:y0 + dy * len(r):dy, x0::dx] = _unpack(r, png.depth, pw * c).reshape(len(r), pw, c)
    return out


def _to_rgb(png: ParsedPng, s: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 from the samples (H, W, channels), as PIL's
    convert("RGB") of the mode PIL opens the file in: grey below 8 bits
    scaled to 8 (modes 1, L;2, L;4), 16-bit grey clamped to 255 (mode
    I;16), the other 16-bit samples cut to their high byte (RGB;16B,
    LA;16B, RGBA;16B), alpha dropped, palette indices looked up unscaled
    and one past the PLTE entries black."""
    if png.color == 3:
        palette = np.zeros((256, 3), np.uint8)
        n = min(len(png.palette), 256)
        palette[:n] = png.palette[:n]
        return np.take(palette, s[..., 0], axis=0)
    if png.color in (0, 4):
        v = s[..., 0]
        if png.depth == 16:
            v = np.minimum(v, 255) if png.color == 0 else v >> 8
        else:
            v = v * np.uint8(GREY_SCALE[png.depth])
        return np.repeat(v.astype(np.uint8)[..., None], 3, axis=2)
    rgb = s[..., :3]
    return (rgb >> 8).astype(np.uint8) if png.depth == 16 else np.ascontiguousarray(rgb)


def decode_parsed(pngs: Sequence[ParsedPng]) -> List[np.ndarray]:
    """The RGB pixels (H, W, 3) uint8 of each parsed PNG. Passes of one
    shape and filter unit are unfiltered together, over images and over
    Adam7's passes alike, so a tree of same-size files takes one wavefront
    a pass shape, not one a file."""
    groups = {}
    for i, p in enumerate(pngs):
        for k, (_, rows, _) in enumerate(p.passes):
            groups.setdefault((rows.shape, p.bpp), []).append((i, k))
    done = {}
    for (_, bpp), members in groups.items():
        rows = unfilter(np.stack([pngs[i].passes[k][1] for i, k in members]),
                        np.stack([pngs[i].passes[k][2] for i, k in members]), bpp)
        done.update(zip(members, rows))
    return [_to_rgb(p, _samples(p, [done[i, k] for k in range(len(p.passes))])) for i, p in enumerate(pngs)]


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the PNG file `data`, as PIL's
    `Image.open(...).convert("RGB")` gives them; `name` labels errors."""
    return decode_parsed([parse_png(data, name)])[0]


BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)  # the info-header sizes PIL reads
BMP_COMPRESSIONS = {0: "BI_RGB", 1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG"}
# BmpImagePlugin.py's bit-field layouts, (bits, (r, g, b[, a]) masks) -> the
# byte that holds each of R, G and B in a little-endian pixel (PIL's raw
# modes BGRX, XBGR, BGXR, ABGR, RGBA, BGRA, BGAR; all-zero masks read as
# BGRA), or the 16-bit pixel's red, green and blue bit widths (BGR;16,
# BGR;15). PIL refuses every other layout.
BMP_BITFIELDS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0)): (2, 1, 0),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0)): (3, 2, 1),
    (32, (0xFF000000, 0xFF00, 0xFF, 0)): (3, 1, 0),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): (3, 2, 1),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): (0, 1, 2),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): (2, 1, 0),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): (3, 1, 0),
    (32, (0, 0, 0, 0)): (2, 1, 0),
    (24, (0xFF0000, 0xFF00, 0xFF)): (2, 1, 0),
    (16, (0xF800, 0x7E0, 0x1F)): (5, 6, 5),
    (16, (0x7C00, 0x3E0, 0x1F)): (5, 5, 5),
}


def _bmp_rle(data: bytes, pos: int, width: int, height: int, rle4: bool, name: str) -> np.ndarray:
    """The (height * width,) pixel bytes of an RLE8 or RLE4 stream starting
    at `pos`, as Pillow's BmpRleDecoder makes them (`BmpImagePlugin.py`),
    run by run: an encoded run clipped at the row's end (RLE4: the two
    nibbles by turns); end of line padding the row with zeros; end of
    bitmap stopping; a delta moving right and up by its two bytes (as
    Pillow 12.2.0 reads it: 12.1.0 skipped those two bytes and moved by the
    next two); an absolute run (RLE4: count // 2 bytes, two
    pixels each) advancing the column by its count, then the file position
    aligned to an even offset of the file. A stream that stops before the
    last pixel raises, as PIL's "not enough image data"."""
    out = bytearray()
    x, end, n = 0, len(data), width * height
    while len(out) < n and pos + 2 <= end:
        count, value = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, width - x))
            if rle4:
                out += bytes((value >> 4, value & 15)) * (count // 2) + bytes((value >> 4,)) * (count % 2)
            else:
                out += bytes((value,)) * count
            x += count
        elif value == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif value == 1:  # end of bitmap
            break
        elif value == 2:  # delta
            if pos + 2 > end:
                break
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(min(right + up * width, n - len(out)))  # bytes past the last pixel are never read
            x = len(out) % width
        else:  # absolute run
            k = value // 2 if rle4 else value
            run = data[pos:pos + k]
            pos += len(run)
            if rle4:
                out += np.stack([np.frombuffer(run, np.uint8) >> 4, np.frombuffer(run, np.uint8) & 15], 1).tobytes()
            else:
                out += run
            if len(run) < k:
                break
            x += value
            pos += pos % 2
    if len(out) < n:
        raise ValueError(f"{name}: the RLE stream holds {len(out)} of {n} pixels")
    return np.frombuffer(bytes(out[:n]), np.uint8)


class NotThisFormat(Exception):
    """PIL's `_open` of a format raised SyntaxError, IndexError, TypeError,
    KeyError, EOFError or struct.error, or opened no mode or an empty
    size: `Image.open` goes on to the next format of its order
    (`formats.ORDER`)."""


@dataclass
class Dib:
    """A bitmap info header as `BmpImagePlugin._bitmap` reads it: the
    size, PIL's mode (RGB, P, L or 1), the bit-field layout, the palette
    (mode P), the coding and where the pixels start."""

    width: int
    height: int
    bits: int
    compression: int
    top_down: bool
    mode: str
    palette: Optional[np.ndarray]
    layout: Optional[Tuple[int, ...]]
    start: int


def parse_dib(data: bytes, hpos: int, offset: int, name: str, what: str = "BMP") -> Dib:
    """The info header at `hpos` read as `BmpImagePlugin._bitmap(header,
    offset)` reads it; `offset` is the pixels' file offset, 0 for "right
    after the palette" (a DIB, an icon's frame). Raises NotThisFormat where
    PIL's open falls through (the header's size or a 40-byte header's masks
    cut short, an empty size) and ValueError naming the file where PIL
    refuses the file (an unknown header, depth, coding or bit-field layout,
    a header cut short, a palette of no or too many colours)."""
    size = data[hpos:hpos + 4]
    if len(size) < 4:
        raise NotThisFormat(f"{name}: {what} info header cut short")
    header = struct.unpack("<I", size)[0]
    hd = data[hpos:hpos + header] if header in BMP_HEADERS else b""
    if header > 4 and len(data) < hpos + header:
        raise ValueError(f"{name}: truncated {what} header")
    if header not in BMP_HEADERS:
        raise ValueError(f"{name}: {what} info header of {header} bytes is not supported")
    u16 = lambda o: struct.unpack_from("<H", hd, o)[0]
    u32 = lambda o: struct.unpack_from("<I", hd, o)[0]
    pos = hpos + header  # PIL's file position as it reads on
    masks = None
    if header == 12:  # OS/2 1.x core header: 16-bit sizes, 3-byte palette entries
        width, height, bits, compression, colors, entry = u16(4), u16(6), u16(10), 0, 0, 3
        top_down = False
    else:
        top_down = hd[11] == 0xFF  # PIL reads the height's top byte
        width, height = u32(4), u32(8)
        height = 2**32 - height if top_down else height
        bits, compression, colors, entry = u16(14), u32(16), u32(32), 4
        if compression == 3:
            if header == 40:
                extra = data[pos:pos + 12]
                if len(extra) < 12:
                    raise NotThisFormat(f"{name}: {what} bit-field masks cut short")
                masks = struct.unpack("<3I", extra) + (0,)
                pos += 12
            else:
                masks = struct.unpack_from("<3I" if header == 52 else "<4I", hd, 40) + ((0,) if header == 52 else ())
    colors = colors or 1 << bits
    if offset == hpos + header and bits <= 8:  # PIL's quirk: the pixels start after the palette
        offset += entry * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: {what} of {bits} bits a pixel is not supported (PIL reads 1, 4, 8, 16, 24 and 32)")
    kind = BMP_COMPRESSIONS.get(compression, str(compression))
    layout = None
    if compression == 3:
        layout = BMP_BITFIELDS.get((bits, masks if bits == 32 else masks[:3]))
        if layout is None:
            shown = ", ".join(f"{m:#x}" for m in masks)
            raise ValueError(f"{name}: {what} bit-field layout ({shown}) at {bits} bits is not one PIL reads")
    elif compression not in (0, 1, 2):
        raise ValueError(f"{name}: {what} compression {kind} is not supported (PIL reads BI_RGB, RLE8, RLE4, "
                         "BI_BITFIELDS)")
    mode, palette = "RGB", None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: {what} palette of {colors} colours")
        table = data[pos:pos + entry * colors]
        pos += len(table)
        levels = (0, 255) if colors == 2 else range(colors)
        if all(table[i * entry:i * entry + 3] == bytes((v & 255,)) * 3 for i, v in enumerate(levels)):
            mode = "1" if colors == 2 else "L"
        else:
            mode, n = "P", len(table) // entry  # PIL refuses more than 256 when it loads the pixels
            palette = np.zeros((max(n, 256), 3), np.uint8)
            palette[:n] = np.frombuffer(table, np.uint8, n * entry).reshape(n, entry)[:, 2::-1]
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: {what} of size {width}x{height}")
    return Dib(width, height, bits, compression, top_down, mode, palette, layout, offset or pos)


def dib_pixels(data: bytes, dib: Dib, name: str, height: Optional[int] = None, what: str = "BMP") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of a parsed bitmap, as PIL's
    `convert("RGB")` gives them; `height` cuts the image to its first rows
    in file order (an icon's colour bitmap, over its mask)."""
    width, rows = dib.width, dib.height if height is None else height
    mode, bits, kind = dib.mode, dib.bits, BMP_COMPRESSIONS.get(dib.compression)
    if mode == "P" and len(dib.palette) > 256:
        raise ValueError(f"{name}: {what} palette of {len(dib.palette)} colours (PIL takes 256 at most)")
    if dib.compression in (1, 2):
        if mode not in ("P", "L"):
            raise ValueError(f"{name}: {what} {kind} at {bits} bits a pixel is not supported")
        idx = _bmp_rle(data, dib.start, width, rows, dib.compression == 2, name).reshape(rows, width)
    else:
        unit = {"1": 1, "L": 8}.get(mode, bits)  # the bits a pixel PIL's raw mode unpacks
        stride = ((width * bits + 31) >> 3) & ~3
        row = (width * unit + 7) // 8
        if row > stride:
            raise ValueError(f"{name}: {what} rows of {stride} bytes hold no {width} pixels of {unit} bits")
        need = stride * (rows - 1) + row  # PIL does not read the last row's padding
        if len(data) < dib.start + need:
            raise ValueError(f"{name}: truncated {what} pixel data")
        body = np.zeros(stride * rows, np.uint8)
        body[:need] = np.frombuffer(data, np.uint8, need, dib.start)
        rows_ = body.reshape(rows, stride)[:, :row]
        if unit < 8:
            idx = _unpack(rows_, unit, width)
        elif unit == 8:
            idx = rows_
        elif unit == 16:
            p = rows_.reshape(rows, width, 2).astype(np.uint16)
            p = p[..., 0] | p[..., 1] << 8
            rbits, gbits, bbits = dib.layout or (5, 5, 5)
            fields = (p >> (gbits + bbits), p >> bbits, p)
            rgb = np.stack([(f & ((1 << k) - 1)) * 255 // ((1 << k) - 1)
                            for f, k in zip(fields, (rbits, gbits, bbits))], axis=-1)
            idx = rgb.astype(np.uint8)
        else:
            order = dib.layout or (2, 1, 0)
            idx = rows_.reshape(rows, width, unit // 8)[..., list(order)]
    if not dib.top_down:
        idx = idx[::-1]
    if mode == "RGB":
        return np.ascontiguousarray(idx)
    if mode == "P":
        return np.take(dib.palette, idx, axis=0)
    grey = idx * np.uint8(255) if mode == "1" else idx
    return np.repeat(np.ascontiguousarray(grey)[..., None], 3, axis=2)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the BMP file `data`, as PIL's
    `Image.open(...).convert("RGB")` gives them (`BmpImagePlugin.py`),
    bottom-up unless the height is negative:
      * BI_RGB at 1, 4 and 8 bits (palette indices, MSB first), 16 bits
        (5-5-5), 24 (BGR) and 32 (BGRX), rows padded to 4 bytes;
      * BI_BITFIELDS at 16, 24 and 32 bits in PIL's layouts
        (`BMP_BITFIELDS`), the masks after a 40-byte header or inside a
        larger one;
      * RLE8 and RLE4 as Pillow's BmpRleDecoder reads them (`_bmp_rle`).
    A palette whose entries are the grey levels 0, 1, 2, ... (or black and
    white, of two entries) makes PIL read the pixel bytes as grey levels
    (mode L) or as bits (mode 1), whatever the bit depth; other palettes
    are looked up, and an index past the palette's entries is black.
    Raises ValueError naming the file for what PIL refuses (2 bits a
    pixel or another depth, BI_JPEG, BI_PNG, a bit-field layout outside
    PIL's, a palette of more than 256 colours) and for a truncated file.
    (Where PIL's BMP reader falls through, no later format of PIL's order
    takes a file that starts "BM": PIL refuses it too.)"""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError(f"{name}: not a BMP file (bad signature)")
    try:
        dib = parse_dib(data, 14, struct.unpack_from("<I", data, 10)[0], name)
    except NotThisFormat as e:
        raise ValueError(str(e)) from None
    if dib.width * dib.height > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: BMP of size {dib.width}x{dib.height} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    return dib_pixels(data, dib, name)


def _triangle(x: np.ndarray) -> np.ndarray:
    """Resample.c's bilinear_filter: 1 - |x| on (-1, 1)."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Resample.c's lanczos_filter: sinc(x) * sinc(x / 3) on [-3, 3). It
    goes through `math.sin`, the C library's sin that Pillow calls, value
    by value: numpy's vectorised sin may round differently."""
    return np.array([_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0 for v in x.ravel()]).reshape(x.shape)


# filter name -> (support, filter), as Resample.c's filter table holds them
FILTERS = {"bilinear": (1.0, _triangle), "lanczos": (3.0, _lanczos)}


@functools.lru_cache(maxsize=256)
def _coefficients(in_size: int, out_size: int, filter: str = "bilinear") -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), integer weights (out, ksize)) of each
    output sample: Resample.c's `precompute_coeffs` with PIL's `filter`,
    then `normalize_coeffs_8bpc` (a negative weight rounds with -0.5, C's
    conversion toward zero). Weights past a sample's window are 0. Cached
    per sizes and filter (a folder's or a database's images mostly share
    their sizes, and the Lanczos weights go value by value through
    `math.sin`); the arrays are read-only, since every caller shares them."""
    support, fn = FILTERS[filter]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int): toward zero
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    arg = ((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)
    k = np.where(x[None, :] < xmax[:, None], fn(arg), 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # in order, as the C loop adds them
        total = total + k[:, j]
    k = k / np.where(total != 0.0, total, 1.0)[:, None]
    scaled = k * (1 << PRECISION_BITS)
    weights = np.where(k < 0, -0.5 + scaled, 0.5 + scaled).astype(np.int64)
    xmin.setflags(write=False)
    weights.setflags(write=False)
    return xmin, weights


def _resample(img: np.ndarray, axis: int, out_size: int, filter: str) -> np.ndarray:
    """One pass of the resize along `axis` (1 horizontal, 0 vertical) of a
    uint8 (H, W, C) image: each output sample is 2^21 plus the weighted sum
    of its window, shifted right by 22 bits (arithmetically: a negative sum
    gives 0) and clamped to [0, 255]. The sums fit int32 as they do in C:
    255 times the positive weights, which add up to less than 2^23."""
    in_size = img.shape[axis]
    xmin, k = _coefficients(in_size, out_size, filter)
    k = k.astype(np.int32)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(tuple(out_size if i == axis else s for i, s in enumerate(img.shape)),
                  1 << (PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)  # past a window the weight is 0
        acc += np.take(img, idx, axis=axis) * k[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int], filter: str = "bilinear") -> np.ndarray:
    """`img` (H, W, C) uint8 resized to `size` = (width, height), equal to
    PIL's `Image.resize(size, Image.BILINEAR)` or `Image.LANCZOS` on 8-bit
    RGB: the horizontal pass first, then the vertical; a pass whose size
    does not change is skipped, so a resize to the image's own size is a
    copy."""
    w, h = int(size[0]), int(size[1])
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize wants uint8 (H, W, C), got {img.dtype} {img.shape}")
    if w < 1 or h < 1:
        raise ValueError(f"resize: bad size {size}")
    if filter not in FILTERS:
        raise ValueError(f"resize: filter must be one of {sorted(FILTERS)}, got {filter!r}")
    out = img
    if w != img.shape[1]:
        out = _resample(out, 1, w, filter)
    if h != img.shape[0]:
        out = _resample(out, 0, h, filter)
    return out.copy() if out is img else out


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`resize(img, size, "bilinear")`: PIL's `Image.resize(size,
    Image.BILINEAR)`, bit for bit."""
    return resize(img, size, "bilinear")


def resize_lanczos(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`resize(img, size, "lanczos")`: PIL's `Image.resize(size,
    Image.LANCZOS)`, bit for bit."""
    return resize(img, size, "lanczos")
