"""PNG and BMP decoding and PIL's bilinear and Lanczos resize, with zlib and
numpy alone.

The JAX package reads image folders through PIL (`damc_tpu/data/datasets.py::
load_image_folder`: `Image.open(p).convert("RGB")`, then `Image.resize(...,
Image.BILINEAR)`). The port's reader must give the same bytes without PIL,
so that its training data equals the JAX package's:

  * `decode_png` (one file; `parse_png` then `decode_parsed` for many)
    reads 8-bit PNGs of colour types 0 (grey), 2 (RGB), 3 (palette), 4
    (grey + alpha) and 6 (RGBA), without interlacing, and converts them to
    RGB as PIL's `convert("RGB")` does: grey replicated, alpha dropped,
    palette looked up. Any other PNG raises `ValueError` naming the file
    and the feature.
  * `decode_bmp` reads uncompressed (BI_RGB) BMPs of 24 and 32 bits a
    pixel and with an 8-bit palette, bottom-up or top-down, as PIL's
    `convert("RGB")` gives them (the fourth byte of a 32-bit pixel is
    dropped, as PIL's BGRX raw mode drops it). Any other BMP raises
    `ValueError` naming the file and the feature.
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
which spreads each step's fixed cost over the batch.
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
    """A PNG's header, palette and filtered scanlines, before unfiltering."""

    name: str
    width: int
    height: int
    color: int
    palette: Optional[np.ndarray]  # (entries, 3) uint8 for colour type 3
    filtered: np.ndarray  # (H, W * bpp) uint8
    ftypes: np.ndarray  # (H,) the filter type of each row

    @property
    def bpp(self) -> int:
        return CHANNELS[self.color]


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


def parse_png(data: bytes, name: str = "<bytes>") -> ParsedPng:
    """Check the chunks of a PNG file and inflate its image data. Raises
    ValueError for a PNG this reader does not take (bit depth other than
    8, Adam7 interlacing, an unknown critical chunk) or a corrupt one."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif not ctype[0] & 0x20 and ctype != b"IEND":  # upper-case first letter: critical
            raise ValueError(f"{name}: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"{name}: colour type {color} is not a PNG colour type")
    if depth != 8:
        raise ValueError(f"{name}: bit depth {depth} is not supported (8 bits a sample only)")
    if interlace:
        raise ValueError(f"{name}: Adam7 interlacing is not supported")
    if compression or filter_method:
        raise ValueError(f"{name}: unknown compression or filter method ({compression}, {filter_method})")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: a palette image without a PLTE chunk")
    row = 1 + w * CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * row:
        raise ValueError(f"{name}: the image data holds {len(raw)} bytes, {h * row} expected")
    rows = np.frombuffer(raw, np.uint8, count=h * row).reshape(h, row)
    if int(rows[:, 0].max(initial=0)) > 4:
        raise ValueError(f"{name}: filter type {int(rows[:, 0].max())} is not a PNG filter type")
    return ParsedPng(name, w, h, color, palette, rows[:, 1:], rows[:, 0])


def _to_rgb(png: ParsedPng, pix: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 from the unfiltered samples (H, W, bpp), as PIL's
    convert("RGB")."""
    if png.color == 2:
        return pix
    if png.color == 6:
        return pix[..., :3].copy()
    if png.color == 3:
        if int(pix.max(initial=0)) >= len(png.palette):
            raise ValueError(f"{png.name}: a palette index beyond the {len(png.palette)} PLTE entries")
        return png.palette[pix[..., 0]]
    return np.repeat(pix[..., :1], 3, axis=2)  # grey, grey + alpha


def decode_parsed(pngs: Sequence[ParsedPng]) -> List[np.ndarray]:
    """The RGB pixels (H, W, 3) uint8 of each parsed PNG; images of one size
    and colour type are unfiltered together."""
    groups = {}
    for i, p in enumerate(pngs):
        groups.setdefault((p.height, p.width, p.bpp), []).append(i)
    out: List[Optional[np.ndarray]] = [None] * len(pngs)
    for (h, w, bpp), idx in groups.items():
        rows = unfilter(np.stack([pngs[i].filtered for i in idx]), np.stack([pngs[i].ftypes for i in idx]), bpp)
        for i, r in zip(idx, rows):
            out[i] = _to_rgb(pngs[i], r.reshape(h, w, bpp))
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the PNG file `data`, as PIL's
    `Image.open(...).convert("RGB")` gives them; `name` labels errors."""
    return decode_parsed([parse_png(data, name)])[0]


BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)  # the info-header sizes PIL reads


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the BMP file `data`, as PIL's
    `Image.open(...).convert("RGB")` gives them (`BmpImagePlugin.py`):
    uncompressed 24- and 32-bit pixels (BGR, BGRX) and 8-bit palette
    indices, rows padded to 4 bytes, bottom-up unless the height is
    negative. Raises ValueError naming the file and the feature for any
    other BMP (RLE or bit-field compression, 1, 4 or 16 bits a pixel) and
    for a truncated one."""
    u16 = lambda o: struct.unpack_from("<H", data, o)[0]
    u32 = lambda o: struct.unpack_from("<I", data, o)[0]
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError(f"{name}: not a BMP file (bad signature)")
    offset, header = u32(10), u32(14)
    if header not in BMP_HEADERS:
        raise ValueError(f"{name}: BMP info header of {header} bytes is not supported")
    if len(data) < 14 + header:
        raise ValueError(f"{name}: truncated BMP header")
    if header == 12:  # OS/2 1.x core header: 16-bit sizes, 3-byte palette entries
        width, height, bits, compression, colors, entry = u16(18), u16(20), u16(24), 0, 0, 3
        top_down = False
    else:
        top_down = data[25] == 0xFF  # PIL reads the height's top byte
        width, height = u32(18), u32(22)
        height = 2**32 - height if top_down else height
        bits, compression, colors, entry = u16(28), u32(30), u32(46), 4
    if compression != 0:
        kind = {1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS", 4: "JPEG", 5: "PNG"}.get(compression, str(compression))
        raise ValueError(f"{name}: BMP compression {kind} is not supported (uncompressed BI_RGB only)")
    if bits not in (8, 24, 32):
        raise ValueError(f"{name}: BMP of {bits} bits a pixel is not supported (8, 24 and 32 only)")
    if width < 1 or height < 1:
        raise ValueError(f"{name}: BMP of size {width}x{height}")
    palette = None
    if bits == 8:
        colors = colors or 256
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: BMP palette of {colors} colours")
        start = 14 + header
        if len(data) < start + entry * colors:
            raise ValueError(f"{name}: truncated BMP palette")
        palette = np.frombuffer(data, np.uint8, entry * colors, start).reshape(colors, entry)[:, 2::-1]
        if offset == 14 + header:  # PIL's quirk: the pixels start after the palette
            offset += 4 * colors
    stride = ((width * bits + 31) >> 3) & ~3
    if len(data) < offset + stride * height:
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        idx = rows[:, :width]
        if int(idx.max()) >= len(palette):
            raise ValueError(f"{name}: a palette index beyond the {len(palette)} palette entries")
        return palette[idx]
    step = bits // 8
    return np.ascontiguousarray(rows[:, :width * step].reshape(height, width, step)[..., 2::-1])


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
