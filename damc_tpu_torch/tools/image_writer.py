"""A PNG and BMP writer, numpy and zlib only, for the files the port's
decoders (`data/images.py`) are held to PIL on and that PIL does not
write: PIL writes 8-bit PNGs, palette PNGs at 1, 2 and 4 bits and 1-, 8-
and 24-bit BMPs, but no Adam7 PNG (it ignores `interlace=1`), no 16-bit
RGB, RGBA or grey + alpha PNG, and no 4-bit, 16-bit, RLE or bit-field BMP.

* `write_png`: every colour type at every bit depth PNG allows, raw
  samples in, Adam7 or not, the row filters chosen, PLTE and tRNS, the
  image data split over several IDAT chunks.
* `write_bmp`: BI_RGB at 1, 4, 8, 16, 24 and 32 bits, RLE8, RLE4 and
  BI_BITFIELDS, bottom-up or top-down, with the OS/2 (12-byte) and the
  Windows info headers of 40 to 124 bytes; an RLE stream made by
  `rle_encode` or given byte for byte.

    from damc_tpu_torch.tools.image_writer import write_bmp, write_png
    data = write_png(samples, color=0, depth=4, interlace=True, filters=[0, 1, 2, 3, 4])
    data = write_bmp(indices, bits=4, palette=rgb16, compression=RLE4, top_down=True)
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

from ..data.images import ADAM7, CHANNELS, DEPTHS, PNG_SIGNATURE, filter_rows

BI_RGB, RLE8, RLE4, BI_BITFIELDS = 0, 1, 2, 3


def pack_samples(samples: np.ndarray, depth: int, padding: int = 0) -> np.ndarray:
    """(H, W * C) integer samples -> (H, ceil(W * C * depth / 8)) uint8
    rows: samples below 8 bits MSB first, 16 bits big-endian. `padding`
    fills the unused low bits of a row's last byte (decoders drop them)."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    nbytes = -(-n // per)
    spare = nbytes * per - n
    padded = np.zeros((h, nbytes * per), np.int64)
    padded[:, :n] = samples
    if spare:
        padded[:, n:] = (padding & ((1 << (spare * depth)) - 1)) >> (depth * np.arange(spare - 1, -1, -1))
    shifts = 8 - depth - depth * np.arange(per)
    return (padded.reshape(h, nbytes, per) << shifts).sum(axis=2).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def write_png(samples: np.ndarray, color: int, depth: int, palette: Optional[np.ndarray] = None,
              trns: Optional[bytes] = None, interlace: bool = False, filters: Union[int, Sequence[int]] = 0,
              idat_chunks: int = 1, padding: int = 0) -> bytes:
    """The bytes of a PNG of the raw samples (H, W) or (H, W, C): colour type
    `color` (0 grey, 2 RGB, 3 palette, 4 grey + alpha, 6 RGBA) at bit depth
    `depth`, each sample below 2^depth. `palette` (N, 3) uint8 is the PLTE
    chunk, `trns` the tRNS chunk's body. `interlace` writes Adam7's seven
    passes (an empty pass has no rows and no filter bytes). `filters` is
    one filter type for every row or a sequence cycled over the rows
    written, pass after pass. The compressed stream is cut into
    `idat_chunks` IDAT chunks."""
    if depth not in DEPTHS.get(color, ()):
        raise ValueError(f"no PNG has colour type {color} at {depth} bits")
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    c = CHANNELS[color]
    samples = samples.reshape(h, w, c)
    if int(samples.max(initial=0)) >= 1 << depth or int(samples.min(initial=0)) < 0:
        raise ValueError(f"samples outside [0, 2^{depth})")
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    ftypes = np.atleast_1d(np.asarray(filters, np.int64))
    raw, row = [], 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = pack_samples(sub.reshape(sub.shape[0], -1), depth, padding)
        ft = ftypes[(row + np.arange(len(rows))) % len(ftypes)]
        row += len(rows)
        raw.append(np.concatenate([ft[:, None].astype(np.uint8), filter_rows(rows, bpp, ft)], axis=1).ravel())
    stream = zlib.compress(np.concatenate(raw).tobytes() if raw else b"")
    cuts = np.linspace(0, len(stream), idat_chunks + 1).astype(int)
    out = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += _chunk(b"IDAT", stream[a:b])
    return out + _chunk(b"IEND", b"")


def _rle_row(row: np.ndarray, rle4: bool) -> bytes:
    """One row of palette indices as RLE8 or RLE4 runs: a run of 3 or more
    equal indices as an encoded run, other stretches of 3 or more as an
    absolute run padded to a 16-bit word (RLE4: of an even count, since
    Pillow reads count // 2 bytes of one), what is left as short encoded
    runs."""
    out = bytearray()
    row = [int(v) for v in row]
    n, x = len(row), 0

    def run_at(i):
        j = i
        while j < n and row[j] == row[i] and j - i < 255:
            j += 1
        return j - i

    while x < n:
        k = run_at(x)
        if k >= 3:
            out += bytes([k, row[x] * 17 if rle4 else row[x]])
            x += k
            continue
        j = x
        while j < n and j - x < 255 and run_at(j) < 3:
            j += 1
        if rle4 and (j - x) % 2 and j - x > 3:  # Pillow reads count // 2 bytes of an absolute run
            j -= 1
        seg = row[x:j]
        if len(seg) < 3 or rle4 and len(seg) % 2:
            for v in seg:
                out += bytes([1, v * 17 if rle4 else v])
        else:
            if rle4:
                packed = [(seg[i] << 4) | (seg[i + 1] if i + 1 < len(seg) else 0) for i in range(0, len(seg), 2)]
            else:
                packed = seg
            out += bytes([0, len(seg)]) + bytes(packed) + b"\x00" * (len(packed) % 2)
        x = j
    return bytes(out)


def rle_encode(indices: np.ndarray, rle4: bool) -> bytes:
    """The RLE8 or RLE4 stream of the (H, W) palette indices, rows in the
    order given (a bottom-up file gives its bottom row first): each row's
    runs, an end of line after each row but the last, an end of bitmap."""
    rows = [_rle_row(r, rle4) for r in np.asarray(indices)]
    return b"\x00\x00".join(rows) + b"\x00\x01"


def write_bmp(pixels: np.ndarray, bits: int, palette: Optional[np.ndarray] = None, compression: int = BI_RGB,
              masks: Optional[Sequence[int]] = None, top_down: bool = False, header: int = 40,
              rle: Optional[bytes] = None) -> bytes:
    """The bytes of a BMP. `pixels` is (H, W) palette indices at 1, 4 and 8
    bits, (H, W) raw 16- or 32-bit words (5-5-5 under BI_RGB; under
    BI_BITFIELDS as `masks` lay them out) or (H, W, 3) RGB at 24 and 32
    bits (BGR, BGRX with X = 0). `palette` (N, 3) RGB is written BGRX (BGR
    under the 12-byte header), N counted in the header. RLE8 and RLE4
    encode the indices with `rle_encode` unless `rle` gives the stream.
    BI_BITFIELDS puts (r, g, b[, a]) after a 40-byte header or inside a
    larger one. `top_down` stores a negative height."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
    entry = 3 if header == 12 else 4
    pal = b""
    if palette is not None:
        pal_arr = np.zeros((len(palette), entry), np.uint8)
        pal_arr[:, :3] = palette[:, ::-1]
        pal = pal_arr.tobytes()
    stride = ((w * bits + 31) >> 3) & ~3
    order = pixels if top_down else pixels[::-1]
    if compression in (RLE8, RLE4):
        body = rle if rle is not None else rle_encode(order, compression == RLE4)
    else:
        if bits <= 8:
            rows = pack_samples(order.reshape(h, w), bits)
        elif bits == 16:
            rows = order.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        elif bits == 24 or (bits == 32 and order.ndim == 3):
            step = bits // 8
            px = np.zeros((h, w, step), np.uint8)
            px[..., :3] = order[..., ::-1]
            rows = px.reshape(h, w * step)
        else:
            rows = order.astype("<u4").view(np.uint8).reshape(h, 4 * w)
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :rows.shape[1]] = rows
        body = padded.tobytes()
    fields = b""
    if compression == BI_BITFIELDS:
        fields = b"".join(struct.pack("<I", m) for m in masks)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        count = 0 if palette is None else len(palette)
        info = struct.pack("<IIiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression, len(body),
                           2835, 2835, count, 0)
        if header > 40:
            info += (fields + bytes(header - 40))[:header - 40]
            fields = b""
    offset = 14 + len(info) + len(fields) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + fields + pal + body


# The PNG and BMP kinds that the port reads beside 8-bit PNG and 8-, 24- and
# 32-bit BI_RGB BMP, as `write_kind` makes them from RGB pixels.
KINDS = ("png_grey1", "png_grey2", "png_grey4", "png_grey16", "png_palette1", "png_palette2", "png_palette4",
         "png_rgb16", "png_rgba16", "png_grey_alpha16", "png_adam7_rgb8", "png_adam7_palette4",
         "bmp_1", "bmp_4", "bmp_16", "bmp_bf565", "bmp_bf32", "bmp_rle8", "bmp_rle4")
BF32_LAYOUTS = (((0xFF0000, 0xFF00, 0xFF), 40), ((0xFF000000, 0xFF0000, 0xFF00), 40),
                ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), 124), ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), 108),
                ((0xFF000000, 0xFF00, 0xFF, 0), 56))  # some of PIL's layouts, each with a header that holds it


def _palette_of(rgb: np.ndarray, depth: int, entries: int) -> tuple:
    """(indices (H, W), palette (entries, 3)): the pixels' brightness cut
    into 2^depth levels, each level the mean colour of its pixels; indices
    past `entries` stay (they read as black)."""
    grey = rgb.astype(np.int64).sum(axis=2)
    idx = (grey * (1 << depth)) // (3 * 256)
    palette = np.zeros((entries, 3), np.uint8)
    for v in range(min(entries, 1 << depth)):
        hit = idx == v
        palette[v] = rgb[hit].mean(axis=0) if hit.any() else (v * 37 % 256, v * 91 % 256, v * 53 % 256)
    return idx, palette


def _spread16(v8: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """8-bit samples as 16-bit ones: the high byte kept, a random low byte."""
    return v8.astype(np.int64) << 8 | rng.integers(0, 256, v8.shape)


def write_kind(kind: str, rgb: np.ndarray, k: int = 0) -> bytes:
    """RGB pixels (H, W, 3) uint8 as a file of `kind` (one of KINDS). `k`
    varies the options file by file: the row filters, grey 16-bit samples
    at or past 255, a palette short of the indices (an index past it reads
    as black), bottom-up or top-down, the BI_BITFIELDS layout and header."""
    rgb = np.asarray(rgb, np.uint8)
    rng = np.random.default_rng(k)
    grey = (rgb.astype(np.int64).sum(axis=2) // 3)
    filters = (np.arange(5) + k) % 5 if k % 3 else [k % 5]
    top_down = k % 2 == 1
    if kind.startswith("png_grey") and kind[8:].isdigit():
        depth = int(kind[8:])
        samples = grey >> (8 - depth) if depth < 8 else (_spread16(grey, rng) if k % 2 else grey)
        return write_png(samples, 0, depth, filters=filters)
    if kind.startswith("png_palette"):
        depth = int(kind[11:])
        idx, palette = _palette_of(rgb, depth, (1 << depth) - (k % 3 == 0))
        return write_png(idx, 3, depth, palette=palette, filters=filters)
    if kind == "png_rgb16":
        return write_png(_spread16(rgb, rng), 2, 16, filters=filters)
    if kind == "png_rgba16":
        alpha = rng.integers(0, 1 << 16, rgb.shape[:2])
        return write_png(np.dstack([_spread16(rgb, rng), alpha]), 6, 16, filters=filters)
    if kind == "png_grey_alpha16":
        return write_png(np.dstack([_spread16(grey, rng), rng.integers(0, 1 << 16, grey.shape)]), 4, 16,
                         filters=filters)
    if kind == "png_adam7_rgb8":
        return write_png(rgb, 2, 8, interlace=True, filters=filters)
    if kind == "png_adam7_palette4":
        idx, palette = _palette_of(rgb, 4, 16 - (k % 3 == 0))
        return write_png(idx, 3, 4, palette=palette, interlace=True, filters=filters)
    if kind in ("bmp_1", "bmp_4", "bmp_rle8", "bmp_rle4"):
        bits = {"bmp_1": 1, "bmp_4": 4, "bmp_rle8": 8, "bmp_rle4": 4}[kind]
        idx, palette = _palette_of(rgb, bits, (1 << bits) - (k % 3 == 0 and bits > 1))
        compression = {"bmp_rle8": RLE8, "bmp_rle4": RLE4}.get(kind, BI_RGB)
        return write_bmp(idx, bits, palette, compression=compression, top_down=top_down)
    if kind == "bmp_16":
        words = (rgb[..., 0].astype(np.int64) >> 3) << 10 | (rgb[..., 1] >> 3) << 5 | rgb[..., 2] >> 3
        return write_bmp(words | (k % 2) << 15, 16, top_down=top_down)
    if kind == "bmp_bf565":
        words = (rgb[..., 0].astype(np.int64) >> 3) << 11 | (rgb[..., 1] >> 2) << 5 | rgb[..., 2] >> 3
        return write_bmp(words, 16, compression=BI_BITFIELDS, masks=(0xF800, 0x7E0, 0x1F), top_down=top_down,
                         header=(40, 52, 124)[k % 3])
    if kind == "bmp_bf32":
        masks, header = BF32_LAYOUTS[k % len(BF32_LAYOUTS)]
        words = rng.integers(0, 1 << 32, rgb.shape[:2], dtype=np.uint64)
        for v, m in zip(np.moveaxis(rgb, 2, 0), masks):
            shift = (m & -m).bit_length() - 1
            words = (words & ~np.uint64(m)) | (v.astype(np.uint64) << np.uint64(shift))
        return write_bmp(words, 32, compression=BI_BITFIELDS, masks=masks, top_down=top_down, header=header)
    raise ValueError(f"unknown kind {kind!r}")
