"""PNG, BMP, GIF, TIFF, PNM, TGA, QOI, ICO, CUR, ICNS, PCX, DCX and SGI
writers, numpy and zlib only, for the files the port's decoders
(`data/images.py`, `data/gif.py`, `data/tiff.py`, `data/pnm.py`,
`data/tga.py`, `data/qoi.py`, `data/ico.py`, `data/icns.py`,
`data/pcx.py`, `data/sgi.py`) are held to PIL on and that PIL does not
write: PIL writes
8-bit PNGs, palette PNGs at 1, 2 and 4 bits and 1-, 8- and 24-bit BMPs,
but no Adam7 PNG (it ignores `interlace=1`), no 16-bit RGB, RGBA or grey +
alpha PNG, and no 4-bit, 16-bit, RLE or bit-field BMP; its GIF writer
chooses the code size, the tables and the clear codes itself; its TIFF
writer writes no tiles, no planar configuration 2, no MinIsWhite, no
associated alpha, no 2-, 4- or 12-bit grey and no predictor at 16 bits;
it writes no plain PNM and no maxval but 255 and 65535.

* `write_png`: every colour type at every bit depth PNG allows, raw
  samples in, Adam7 or not, the row filters chosen, PLTE and tRNS, the
  image data split over several IDAT chunks.
* `write_bmp`: BI_RGB at 1, 4, 8, 16, 24 and 32 bits, RLE8, RLE4 and
  BI_BITFIELDS, bottom-up or top-down, with the OS/2 (12-byte) and the
  Windows info headers of 40 to 124 bytes; an RLE stream made by
  `rle_encode` or given byte for byte.
* `write_gif`: one frame at an offset in a logical screen that may be
  larger, a global, local or no colour table, a transparency index,
  interlace, any minimum code size from 0 to 12, clear codes every k codes
  or a code table left full (`gif_lzw`), or the frame's data given.
* `write_tiff`: strips or tiles, planar configuration 1 or 2, either byte
  order, classic or BigTIFF, samples of 1 to 32 bits, no compression,
  PackBits, LZW (`tiff_lzw`, or the pre-5.0 codes: `tiff_lzw_old`),
  Deflate, LZMA, CCITT modified Huffman, T.4 1-D and 2-D and T.6
  (`fax_encode`), ThunderScan (`thunderscan_encode`), JPEG strips and
  tiles with their tables apart (`jpeg_tables_split`), subsampled YCbCr
  (`ycbcr_blocks`), predictor 2, fill order 2, any photometric
  interpretation, colour map, extra samples and further tags.
* `write_pnm`: P1 to P6 at any maxval, with comments in the header.
* `write_tga`: image types 1, 2, 3, 9, 10 and 11 at depths 1 to 32, colour
  maps of 16, 24 and 32 bits from a first index, every orientation, an id
  section, run-length packets (`tga_rle`) whose literals run across rows
  (PIL writes TGA at 1, 8, 16 and 24-32 bits in two orientations).
* `write_qoi` (the reference encoder's ops) and `qoi_file` (any op
  stream).
* `icon_bitmap` and `write_icon`: ICO and CUR of PNG files and of 1- to
  32-bit bitmaps with AND masks (PIL writes ICO of PNG and of 32-bit
  bitmaps only, and no CUR).
* `write_icns` with `icns_rgb` / `icns_pack`: packed and interleaved
  24-bit entries, masks, PNG entries (PIL writes PNG entries only).
* `write_pcx` and `write_dcx`: 1 bit at 1, 2 and 4 planes with the
  header's palette, 8 bits with the 769-byte palette, 24 bits as 3 planes,
  any stride the header gives and a box off the origin.
* `write_sgi`: verbatim and run-length at 1 and 2 bytes a sample, 1, 3 and
  4 channels (PIL writes verbatim only).

    from damc_tpu_torch.tools.image_writer import write_bmp, write_png
    data = write_png(samples, color=0, depth=4, interlace=True, filters=[0, 1, 2, 3, 4])
    data = write_bmp(indices, bits=4, palette=rgb16, compression=RLE4, top_down=True)
"""

from __future__ import annotations

import lzma
import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

from ..data.images import ADAM7, CHANNELS, DEPTHS, PNG_SIGNATURE, filter_rows
from ..data.tiff import REVERSED
from . import jpeg_writer

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


def gif_lzw(indices: np.ndarray, bits: int, clear_every: int = 0, full_table: bool = False,
            end_code: bool = True) -> bytes:
    """GIF's LZW code stream (LSB-first, before the sub-blocks) of the
    palette indices, each below 2^bits, at minimum code size `bits` (0 to
    12): a clear code first, the table's codes, the end code. The code
    width follows the decoder's table (one entry behind the encoder's), as
    GIF decoders grow it. `clear_every` > 0 puts a clear code after that
    many codes; otherwise a clear code comes when the table reaches 4,096
    entries, unless `full_table`, which goes on with the full table."""
    clear, end = 1 << bits, (1 << bits) + 1
    acc, nacc, out = 0, 0, bytearray()
    state = {}

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += state["size"]
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
        if code == clear:  # the decoder's table, mirrored for the next code's width
            state.update(size=bits + 1, dnext=clear + 2, first=True, count=0)
        elif state["first"]:
            state["first"] = False
        elif state["dnext"] < 4096:
            if state["dnext"] == (1 << state["size"]) - 1 and state["size"] < 12:
                state["size"] += 1
            state["dnext"] += 1
        state["count"] += 1

    def reset():
        state["table"], state["next"] = {}, clear + 2

    state.update(size=bits + 1)
    put(clear)
    reset()
    w = None  # the code of the string matched so far; a string's key is (its prefix's code << 12) | its last index
    for v in np.asarray(indices).ravel().tolist():
        if w is None:
            w = v
            continue
        key = w << 12 | v
        if key in state["table"]:
            w = state["table"][key]
            continue
        put(w)
        if state["next"] < 4096:
            state["table"][key] = state["next"]
            state["next"] += 1
        w = v
        full = state["next"] >= 4096 and clear + 2 < 4096 and not full_table
        if (clear_every and state["count"] >= clear_every) or full:
            put(w)
            put(clear)
            reset()
            w = None
    if w is not None:
        put(w)
    if end_code:
        put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def gif_blocks(stream: bytes, size: int = 255) -> bytes:
    """`stream` cut into sub-blocks of `size` bytes, and the terminator."""
    return b"".join(bytes([len(stream[i:i + size])]) + stream[i:i + size]
                    for i in range(0, len(stream), size)) + b"\x00"


def _gif_table(palette: np.ndarray) -> tuple:
    """(size field, bytes) of a colour table: the palette padded to a power
    of two entries (2 to 256)."""
    palette = np.asarray(palette, np.uint8).reshape(-1, 3)
    k = max(1, (len(palette) - 1).bit_length())
    table = np.zeros((1 << k, 3), np.uint8)
    table[:len(palette)] = palette
    return k - 1, table.tobytes()


def write_gif(indices: np.ndarray, palette: Optional[np.ndarray] = None, local_palette: Optional[np.ndarray] = None,
              screen: Optional[tuple] = None, offset: tuple = (0, 0), transparency: Optional[int] = None,
              interlace: bool = False, bits: Optional[int] = None, clear_every: int = 0, full_table: bool = False,
              background: int = 0, data: Optional[bytes] = None, block_size: int = 255,
              extensions: bytes = b"", trailer: bytes = b";") -> bytes:
    """The bytes of a GIF of one frame of palette indices (H, W) at `offset`
    (x, y) in a logical screen `screen` (width, height; default the
    frame's). `palette` is the global colour table, `local_palette` the
    frame's own; with neither the file has no colour table. `transparency`
    writes a Graphic Control Extension with that index. `interlace` stores
    the rows in GIF's four passes. The frame's LZW stream is `gif_lzw` at
    minimum code size `bits` (default the table's size, at least 2) cut
    into sub-blocks of `block_size`, unless `data` gives the bytes after
    the code size byte. `extensions` go before the frame."""
    indices = np.asarray(indices)
    h, w = indices.shape
    sw, sh = screen or (w + offset[0], h + offset[1])
    flags, table = 0, b""
    if palette is not None:
        k, table = _gif_table(palette)
        flags = 0x80 | (k << 4) | k
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, background, 0) + table + extensions
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    flags, table = 0, b""
    if local_palette is not None:
        k, table = _gif_table(local_palette)
        flags = 0x80 | k
    if interlace:
        flags |= 0x40
        rows = np.concatenate([np.arange(h)[0::8], np.arange(h)[4::8], np.arange(h)[2::4], np.arange(h)[1::2]])
        indices = indices[rows]
    if bits is None:
        n = max(len(np.asarray(p).reshape(-1, 3)) for p in (palette, local_palette, np.zeros((256, 3)))
                if p is not None) if palette is not None or local_palette is not None else 256
        bits = max(2, (n - 1).bit_length())
    if data is None:
        data = gif_blocks(gif_lzw(indices, bits, clear_every, full_table), block_size)
    out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags) + table + bytes([bits]) + data
    return out + trailer


def tiff_lzw(data: bytes) -> bytes:
    """TIFF's LZW (MSB-first codes of 9 to 12 bits, widened one code early,
    as libtiff writes them) of `data`: a clear code first, a clear code
    when the table reaches 4,094 entries, the end code last."""
    acc, nacc, out = 0, 0, bytearray()
    size, table, nxt = 9, {}, 258

    def put(code):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    def grow(free):  # libtiff's LZWEncode after a code: a clear code at 4,094 entries, else a wider code
        nonlocal size
        if free == 4094:
            put(256)
            size = 9
            return 258
        if free > (1 << size) - 1:
            size += 1
        return free

    put(256)
    w = None  # the code of the string matched so far; a string's key is (its prefix's code << 8) | its last byte
    for v in data:
        if w is None:
            w = v
            continue
        key = w << 8 | v
        if key in table:
            w = table[key]
            continue
        put(w)
        table[key] = nxt
        w = v
        nxt = grow(nxt + 1)
        if nxt == 258:
            table = {}
    if w is not None:
        put(w)
        grow(nxt + 1)
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits runs of `data`: a repeat of 3 or more bytes as one run, the
    rest as literal runs, each at most 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes((257 - (j - i), data[i]))
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes((j - i - 1,)) + data[i:j]
        i = j
    return bytes(out)


def _tiff_pack(samples: np.ndarray, bits: int, endian: str, sample_format: int) -> bytes:
    """(R, N) samples as the bytes of R rows of `bits` each, rows padded
    to a byte: below 8 bits and at 12 MSB first, 16 and 32 bits in the
    file's byte order (32-bit float where `sample_format` is 3)."""
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    if bits in (16, 32):
        kind = "f" if sample_format == 3 else "i" if sample_format == 2 else "u"
        return samples.astype(f"{endian}{kind}{bits // 8}").tobytes()
    if bits in (1, 2, 4):
        return pack_samples(samples, bits).tobytes()
    if bits == 12:
        r, n = samples.shape
        s = np.zeros((r, n + n % 2), np.int64)
        s[:, :n] = samples
        a, b = s[:, 0::2], s[:, 1::2]
        packed = np.stack([a >> 4, (a & 15) << 4 | b >> 8, b & 255], axis=2).reshape(r, -1).astype(np.uint8)
        return packed[:, :(n * 12 + 7) // 8].tobytes()
    raise ValueError(f"no TIFF writer for {bits} bits a sample")


def _predict(samples: np.ndarray, stride: int, bits: int) -> np.ndarray:
    """Predictor 2: each sample less the one `stride` samples before it in
    its row, modulo 2^bits."""
    s = samples.astype(np.int64)
    d = s.copy()
    d[:, stride:] -= s[:, :-stride]
    return d & ((1 << bits) - 1)


TIFF_TYPES = {1: "B", 3: "H", 4: "L", 5: "L", 16: "Q", 11: "f", 12: "d", 2: "s", 7: "s"}  # 5: numerator, denominator


def write_tiff(samples: np.ndarray, photometric: int, bits: int = 8, compression: int = 1, predictor: int = 1,
               endian: str = "<", tile: Optional[tuple] = None, rows_per_strip: Optional[int] = None,
               planar: int = 1, extra_samples: Sequence[int] = (), colormap: Optional[np.ndarray] = None,
               fill_order: int = 1, sample_format: int = 1, bigtiff: bool = False, tags: Optional[dict] = None,
               strips: Optional[Sequence[bytes]] = None, t4_options: int = 0, fax_k: int = 2,
               old_lzw: bool = False, ycbcr: Optional[tuple] = None, jpeg: Optional[dict] = None) -> bytes:
    """The bytes of a one-page TIFF of `samples` (H, W) or (H, W, C) at
    `bits` a sample: strips of `rows_per_strip` rows (default: about 8 KiB
    a strip) or tiles of `tile` = (width, height), whose edges overhang the
    image; `planar` 2 stores each sample plane apart. `compression` 1
    (none), 2, 3, 4 or 32771 (CCITT by `fax_encode`, bits 1 black; 3 as
    `t4_options` says, a 1-D row every `fax_k` rows), 5 (LZW; `old_lzw`
    the pre-5.0 codes), 7 (JPEG by `jpeg_writer.write_jpeg` with `jpeg`'s
    "sampling", "quality" and "marker", the tables in JPEGTables unless
    "tables" is False), 8 or 32946 (Deflate), 32773 (PackBits), 32809
    (ThunderScan, 4 bits) or 34925 (LZMA). `ycbcr` (h, v) stores the
    samples (YCbCr) as subsampled blocks; `predictor` 2 differences the
    samples of each row before compressing; `fill_order` 2 reverses the
    bits of every stored byte. `colormap` (3, 2^bits) is written as
    ColorMap. `tags` {tag: (type, values)} adds or replaces entries;
    `strips` gives the stored strips or tiles byte for byte."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    planes = [samples[..., k:k + 1] for k in range(c)] if planar == 2 else [samples]
    if tile:
        tw, th = tile
        grid = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        row_bytes = (w * (c if planar == 1 else 1) * bits + 7) // 8
        th, tw = rows_per_strip or max(1, 8192 // max(row_bytes, 1)), w
        grid = [(0, y) for y in range(0, h, th)]
    stored = []
    for plane in planes:
        pc = plane.shape[2]
        for x, y in grid:
            block = plane[y:y + th, x:x + tw]
            if tile:  # a tile is whole: its overhang is zeros
                full = np.zeros((th, tw, pc), samples.dtype)
                full[:block.shape[0], :block.shape[1]] = block
                block = full
            rows = block.reshape(block.shape[0], -1)
            if predictor == 2:
                rows = _predict(rows, pc, bits)
            raw = _tiff_pack(rows, bits, endian, sample_format)
            if ycbcr:
                raw = ycbcr_blocks(block, *ycbcr)
            if compression == 5:
                raw = tiff_lzw_old(raw) if old_lzw else tiff_lzw(raw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw)
            elif compression == 32773:
                raw = packbits(raw)
            elif compression == 34925:
                raw = lzma.compress(raw, lzma.FORMAT_XZ)
            elif compression in FAX_CODINGS:
                coding = FAX_CODINGS[compression] if compression != 3 or not t4_options & 1 else "t4_2d"
                raw = fax_encode(block[..., 0], coding, fax_k, fill_bits=bool(t4_options & 4))
            elif compression == 32809:
                raw = thunderscan_encode(block[..., 0], len(stored))
            elif compression == 7:
                opts = dict(jpeg or {})
                sampling = opts.pop("sampling", [(1, 1)] * pc)
                whole = jpeg_writer.write_jpeg(block[..., 0] if pc == 1 else block, sampling, **{
                    k: v for k, v in opts.items() if k != "tables"})
                if opts.get("tables", True):
                    jpeg_tables, raw = jpeg_tables_split(whole)
                else:
                    raw = whole
            if fill_order == 2:
                raw = REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            stored.append(raw)
    if strips is not None:
        stored = list(strips)
    if compression == 7 and (jpeg or {}).get("tables", True) and strips is None:
        tags = {347: (7, list(jpeg_tables)), **(tags or {})}
    if ycbcr:
        tags = {530: (3, list(ycbcr)), **(tags or {})}
    if t4_options:
        tags = {292 if compression == 3 else 293: (4, [t4_options]), **(tags or {})}
    long_type = 16 if bigtiff else 4
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [c]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if sample_format != 1:
        entries[339] = (3, [sample_format] * c)
    if colormap is not None:
        entries[320] = (3, np.asarray(colormap, np.int64).ravel().tolist())
    if tile:
        entries.update({322: (4, [tw]), 323: (4, [th]), 324: (long_type, []),
                        325: (long_type, [len(s) for s in stored])})
    else:
        entries.update({278: (4, [th]), 273: (long_type, []), 279: (long_type, [len(s) for s in stored])})
    entries.update(tags or {})
    head = 16 if bigtiff else 8
    data_at, offsets = head, []
    for s in stored:
        offsets.append(data_at)
        data_at += len(s) + len(s) % 2
    offset_tag = 324 if tile else 273
    if offset_tag in entries and entries[offset_tag][1] == []:
        entries[offset_tag] = (entries[offset_tag][0], offsets)
    ifd_at = data_at
    n = len(entries)
    entry_size, count_fmt, inline = (20, "Q", 8) if bigtiff else (12, "L", 4)
    extra_at = ifd_at + (8 if bigtiff else 2) + n * entry_size + (8 if bigtiff else 4)
    ifd, extra = bytearray(struct.pack(endian + ("Q" if bigtiff else "H"), n)), bytearray()
    for tag in sorted(entries):
        typ, values = entries[tag]
        fmt = TIFF_TYPES[typ]
        body = bytes(values) if fmt == "s" else struct.pack(f"{endian}{len(values)}{fmt}", *values)
        count = len(body) if fmt == "s" else len(values) // 2 if typ == 5 else len(values)
        if len(body) <= inline:
            field = body + bytes(inline - len(body))
        else:
            field = struct.pack(endian + count_fmt, extra_at + len(extra))
            extra += body + bytes(len(body) % 2)
        ifd += struct.pack(f"{endian}HH{count_fmt}", tag, typ, count) + field
    ifd += bytes(8 if bigtiff else 4)
    magic = (b"II" if endian == "<" else b"MM") + struct.pack(endian + "H", 43 if bigtiff else 42)
    header = magic + (struct.pack(endian + "HHQ", 8, 0, ifd_at) if bigtiff else struct.pack(endian + "L", ifd_at))
    body = b"".join(s + bytes(len(s) % 2) for s in stored)
    return header + body + bytes(ifd) + bytes(extra)


# ---------------------------------------------------------------------------
# TIFF codings PIL does not write: CCITT 2-D, fill order 2 and word-aligned
# variants, ThunderScan, the pre-5.0 LZW codes, subsampled YCbCr, JPEG
# strips with subsampling, old-style JPEG
# ---------------------------------------------------------------------------

# T.4's run codes as they stand in the stream: terminating codes 0-63, then the
# make-up codes of 64, 128, ... 1728 of each colour and the shared 1792-2560.
FAX_WHITE = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 "
             "110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 "
             "0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 "
             "00010110 00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100 00000101 "
             "00001010 00001011 01010010 01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
             "01011010 01011011 01001010 01001011 00110010 00110011 00110100 11011 10010 010111 0110111 "
             "00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 011010010 011010011 "
             "011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 010011000 "
             "010011001 010011010 011000 010011011").split()
FAX_BLACK = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
             "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
             "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
             "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 000011010011 "
             "000011010100 000011010101 000011010110 000011010111 000001101100 000001101101 000011011010 "
             "000011011011 000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 "
             "000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
             "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 000001100111 "
             "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
             "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
             "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
             "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
             "0000001100100 0000001100101").split()
FAX_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
              "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111").split()
FAX_MODES = {"pass": "0001", "horiz": "001", -3: "0000010", -2: "000010", -1: "010", 0: "1", 1: "011", 2: "000011",
             3: "0000011"}
FAX_EOL = "000000000001"
FAX_CODINGS = {2: "mh", 32771: "mh16", 3: "t4", 4: "t6"}


def _fax_span(bits: list, run: int, black: bool) -> None:
    """The codes of one run, each as (bits, 13 if black else 12: the bits
    libtiff's decoder looks up it with)."""
    table, need = (FAX_BLACK, 13) if black else (FAX_WHITE, 12)
    while run >= 2624:
        bits.append((FAX_MAKEUP[-1], need))
        run -= 2560
    if run >= 64:
        k = run >> 6
        bits.append((table[63 + k] if k <= 27 else FAX_MAKEUP[k - 28], need))
        run -= k << 6
    bits.append((table[run], need))


def _fax_1d(bits: list, row: list) -> None:
    """One row in modified Huffman: white and black spans by turns, white
    first (of length 0 where the row starts black)."""
    x, black, w = 0, False, len(row)
    while x < w:
        y = x
        while y < w and row[y] == black:
            y += 1
        _fax_span(bits, y - x, black)
        x, black = y, not black
    if w == 0:
        _fax_span(bits, 0, False)


def _finddiff(row: list, bs: int, color: int) -> int:
    w = len(row)
    while bs < w and row[bs] == color:
        bs += 1
    return bs


def _fax_2d(bits: list, row: list, ref: list) -> None:
    """One row in T.4 2-D / T.6 modes against the reference row, as
    libtiff's Fax3Encode2DRow codes it."""
    w = len(row)
    a0 = 0
    a1 = 0 if row[0] else _finddiff(row, 0, 0)
    b1 = 0 if ref[0] else _finddiff(ref, 0, 0)
    while True:
        b2 = _finddiff(ref, b1, ref[b1]) if b1 < w else w
        if b2 >= a1:
            if abs(a1 - b1) <= 3:
                bits.append((FAX_MODES[a1 - b1], 7))
                a0 = a1
            else:
                a2 = _finddiff(row, a1, row[a1]) if a1 < w else w
                bits.append((FAX_MODES["horiz"], 7))
                black = not (a0 + a1 == 0 or row[a0] == 0)
                _fax_span(bits, a1 - a0, black)
                _fax_span(bits, a2 - a1, not black)
                a0 = a2
        else:
            bits.append((FAX_MODES["pass"], 7))
            a0 = b2
        if a0 >= w:
            break
        c = row[a0]
        a1 = _finddiff(row, a0, c)
        b1 = _finddiff(ref, _finddiff(ref, a0, 1 - c), c)


def fax_encode(rows: np.ndarray, coding: str, k: int = 2, fill_bits: bool = False, eofb: bool = True) -> bytes:
    """CCITT bytes (fill order 1) of `rows` (H, W) of bits, 1 black: coding
    "mh" (compression 2: each row modified Huffman, byte-aligned), "mh16"
    (32771: word-aligned), "t4" (3, 1-D: an EOL before each row), "t4_2d"
    (3 with T4Options bit 0: an EOL and a tag bit before each row, every
    k-th row 1-D, the rest 2-D against the row above), or "t6" (4: every row
    2-D, the EOFB at the end where `eofb`). `fill_bits` pads before each EOL
    so that it ends on a byte (T4Options bit 2)."""
    rows = (np.asarray(rows, np.int64) & 1).tolist()
    parts: list = []
    count = 0

    def put(items):
        nonlocal count
        for b in items:
            parts.append(b)
            count += len(b)

    def align(n):
        put(["0" * ((-count) % n)])

    ref = [0] * (len(rows[0]) if rows else 0)
    avail, loaded = 0, 0  # libtiff's BitsAvail and bytes read, for the word alignment of "mh16"
    for i, row in enumerate(rows):
        if coding in ("t4", "t4_2d"):
            if fill_bits:
                put(["0" * ((4 - count) % 8)])
            put([FAX_EOL + ("" if coding == "t4" else "1" if i % k == 0 else "0")])
        codes: list = []
        if coding == "t6" or (coding == "t4_2d" and i % k):
            _fax_2d(codes, row, ref)
        else:
            _fax_1d(codes, row)
        put([c for c, _ in codes])
        if coding == "mh":
            align(8)
        elif coding == "mh16":  # pad to where libtiff's Fax3DecodeRLE will look for the next row
            for code, need in codes:
                if avail < need:
                    avail, loaded = avail + 8, loaded + 1
                    if avail < need:
                        avail, loaded = avail + 8, loaded + 1
                avail -= len(code)
            avail -= avail % 16
            if avail == 0 and loaded % 2:
                loaded += 1
            put(["0" * (8 * loaded - avail - count)])
        ref = row
    if coding == "t6" and eofb:
        put([FAX_EOL * 2])
    align(8)
    s = "".join(parts)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def thunderscan_encode(samples: np.ndarray, k: int = 0) -> bytes:
    """ThunderScan codes of 4-bit samples (H, W): runs of the last pixel
    (up to 63), 2-bit deltas for three pixels, 3-bit deltas for two, raw
    values, chosen in turn by position and `k` (each row starts from pixel
    value 0, as libtiff's decoder does)."""
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for row in np.asarray(samples, np.int64):
        last, i, w = 0, 0, len(row)
        while i < w:
            run = 0
            while i + run < w and row[i + run] == last and run < 63:
                run += 1
            if run >= 2 and (i + k) % 3:
                out.append(run)
                i += run
                continue
            if i + 3 <= w and (i + k) % 2 == 0:
                d = [int(row[i]) - last, int(row[i + 1]) - int(row[i]), int(row[i + 2]) - int(row[i + 1])]
                if all(v in two for v in d):
                    out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                    last, i = int(row[i + 2]), i + 3
                    continue
            if i + 2 <= w:
                d = [int(row[i]) - last, int(row[i + 1]) - int(row[i])]
                if all(v in three for v in d):
                    out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                    last, i = int(row[i + 1]), i + 2
                    continue
            out.append(0xC0 | int(row[i]))
            last, i = int(row[i]), i + 1
    return bytes(out)


def tiff_lzw_old(data: bytes) -> bytes:
    """The pre-5.0 LZW codes of `data` (LSB first, the width growing once
    the decoder's table passes 2^width - 1 entries, as libtiff's
    LZWDecodeCompat reads them): a clear code first, another at 4,093
    entries, the end code last."""
    acc, nacc, out = 0, 0, bytearray()
    size, table, nxt = 9, {}, 258

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    put(256)
    w = None
    for v in data:
        if w is None:
            w = v
            continue
        key = w << 8 | v
        if key in table:
            w = table[key]
            continue
        put(w)
        table[key] = nxt
        nxt += 1
        w = v
        if nxt > 1 << size and size < 12:  # the decoder, an entry behind, widens past 2^size - 1
            size += 1
        if nxt >= 4093:
            put(256)
            size, table, nxt = 9, {}, 258
    if w is not None:
        put(w)
        nxt += 1
        if nxt > 1 << size and size < 12:  # the decoder, an entry behind, widens past 2^size - 1
            size += 1
    put(257)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JFIF's YCbCr of RGB pixels, rounded, (H, W, 3) int64."""
    r, g, b = (np.asarray(rgb, np.float64)[..., c] for c in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return np.clip(np.round(np.stack([y, 128 + (b - y) / 1.772, 128 + (r - y) / 1.402], -1)), 0, 255).astype(np.int64)


def ycbcr_blocks(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """Samples (H, W, 3) as TIFF's subsampled YCbCr data: blocks of hs x vs
    Y samples, then one Cb and one Cr (their block's mean), the image's
    edge replicated into partial blocks."""
    ycc = np.asarray(ycc, np.int64)
    h, w = ycc.shape[:2]
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    p = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    blocks = p.reshape(ph // vs, vs, pw // hs, hs, 3).transpose(0, 2, 1, 3, 4)
    y = blocks[..., 0].reshape(ph // vs, pw // hs, hs * vs)
    chroma = np.round(blocks[..., 1:].mean(axis=(2, 3))).astype(np.int64)
    return np.concatenate([y, chroma], axis=2).astype(np.uint8).tobytes()


def jpeg_tables_split(stream: bytes) -> tuple:
    """A JPEG file as JPEG-in-TIFF stores it: (the tables stream: SOI, every
    DQT and DHT, EOI; the abbreviated stream: the file without them)."""
    tables, rest, k = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while k < len(stream):
        m = stream[k + 1]
        if m == 0xDA:
            rest += stream[k:]
            break
        length = struct.unpack(">H", stream[k + 2:k + 4])[0]
        (tables if m in (0xDB, 0xC4) else rest).extend(stream[k:k + 2 + length])
        k += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(rest)


def write_pnm(samples: np.ndarray, magic: str, maxval: int = 255, comment: bytes = b"",
              separator: bytes = b"\n") -> bytes:
    """The bytes of a PNM: P1 and P4 (bits, 1 black), P2 and P5 (grey), P3
    and P6 (RGB) of the (H, W) or (H, W, 3) samples, each at most `maxval`
    (two bytes big-endian past 255 in P5 and P6; P1 to P3 as decimal text,
    rows on lines of their own). `comment` goes into the header, as a line
    after the magic number and after the width."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    note = b"#" + comment + b"\n" if comment else b""
    head = magic.encode() + separator + note + b"%d " % w + note + b"%d" % h + separator
    if magic not in ("P1", "P4"):
        head += b"%d" % maxval + separator
    rows = samples.reshape(h, -1)
    if magic == "P4":
        return head + pack_samples(rows, 1).tobytes()
    if magic in ("P5", "P6"):
        return head + rows.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + b"\n".join(b" ".join(b"%d" % v for v in r) for r in rows.tolist()) + b"\n"


# The PNG and BMP kinds that the port reads beside 8-bit PNG and 8-, 24- and
# 32-bit BI_RGB BMP, and its GIF, TIFF and PNM kinds, as `write_kind` makes
# them from RGB pixels.
KINDS = ("png_grey1", "png_grey2", "png_grey4", "png_grey16", "png_palette1", "png_palette2", "png_palette4",
         "png_rgb16", "png_rgba16", "png_grey_alpha16", "png_adam7_rgb8", "png_adam7_palette4",
         "bmp_1", "bmp_4", "bmp_16", "bmp_bf565", "bmp_bf32", "bmp_rle8", "bmp_rle4")
GIF_TIFF_PNM_KINDS = ("gif_global", "gif_interlaced", "gif_offset", "gif_grey", "tiff_raw", "tiff_packbits",
                      "tiff_lzw_pred2", "tiff_deflate", "tiff_tiled_lzw", "tiff_mm", "tiff_grey16", "tiff_miniswhite",
                      "tiff_palette", "tiff_cmyk", "tiff_rgba_assoc", "tiff_planar2", "pnm_p6", "pnm_p5_16", "pnm_p4")
# The TIFF codings PIL reads through libtiff beyond those (write_kind writes each but Zstandard, which PIL writes)
TIFF_CODING_KINDS = ("tiff_jpeg", "tiff_ycbcr", "tiff_ccitt_mh", "tiff_ccitt_t4", "tiff_ccitt_t6", "tiff_lzma",
                     "tiff_lab", "tiff_thunderscan", "tiff_lzw_old", "tiff_ojpeg")
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
    """RGB pixels (H, W, 3) uint8 as a file of `kind` (one of KINDS or
    GIF_TIFF_PNM_KINDS). `k` varies the options file by file: the row
    filters, grey 16-bit samples at or past 255, a palette short of the
    indices (an index past it reads as black), bottom-up or top-down, the
    BI_BITFIELDS layout and header; the GIF tables and clear codes, the
    TIFF strip height, tile size, compression and predictor."""
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
    if kind.startswith("gif"):
        return _gif_kind(kind, rgb, grey, k)
    if kind.startswith("tiff"):
        return _tiff_kind(kind, rgb, grey, k, rng)
    if kind == "pnm_p6":
        return write_pnm(rgb, "P6", comment=b"k=%d" % k if k % 2 else b"")
    if kind == "pnm_p5_16":
        return write_pnm(_spread16(grey, rng), "P5", 65535)
    if kind == "pnm_p4":
        return write_pnm((grey < 128 + (k % 5 - 2) * 20).astype(np.int64), "P4")
    if kind in ORDER_KINDS:
        return _order_kind(kind, rgb, grey, k, rng)
    raise ValueError(f"unknown kind {kind!r}")


def _gif_kind(kind: str, rgb: np.ndarray, grey: np.ndarray, k: int) -> bytes:
    """GIF kinds: a global table (a clear code every 200 + k codes, or
    only when the table is full), interlaced (a local table every other
    file), a frame inset in the screen with a transparency index that
    fills the border, and grey levels with no colour table."""
    h, w = grey.shape
    if kind == "gif_grey":
        return write_gif(grey, bits=8, clear_every=0 if k % 2 else 300 + k)
    idx, palette = _palette_of(rgb, 8, 256 - (k % 3 == 0))
    if kind == "gif_global":
        return write_gif(idx, palette, clear_every=200 + k if k % 2 else 0)
    if kind == "gif_interlaced":
        return write_gif(idx, None if k % 2 else palette, local_palette=palette if k % 2 else None, interlace=True)
    x0, y0 = min(1 + k % 7, (w - 1) // 2), min(1 + k % 5, (h - 1) // 2)
    frame = idx[y0:max(y0 + 1, h - 1 - k % 3), x0:max(x0 + 1, w - 1 - k % 4)]
    return write_gif(frame, palette, screen=(w, h), offset=(x0, y0), transparency=int(idx[0, 0]), background=1)


def _tiff_kind(kind: str, rgb: np.ndarray, grey: np.ndarray, k: int, rng: np.random.Generator) -> bytes:
    """TIFF kinds, strips of 1 to 32 rows by turns unless tiled."""
    rows = (1, 8, 13, 32)[k % 4]
    if kind == "tiff_raw":
        return write_tiff(rgb, 2, rows_per_strip=rows)
    if kind == "tiff_packbits":
        return write_tiff(rgb, 2, compression=32773, rows_per_strip=rows)
    if kind == "tiff_lzw_pred2":
        return write_tiff(rgb, 2, compression=5, predictor=2, rows_per_strip=rows)
    if kind == "tiff_deflate":
        return write_tiff(rgb, 2, compression=(8, 32946)[k % 2], predictor=1 + k % 2, rows_per_strip=rows)
    if kind == "tiff_tiled_lzw":
        return write_tiff(rgb, 2, compression=5, tile=((16, 32, 64)[k % 3], (16, 48)[k % 2]))
    if kind == "tiff_mm":
        return write_tiff(rgb, 2, compression=(1, 5)[k % 2], endian=">", rows_per_strip=rows)
    if kind == "tiff_grey16":
        samples = _spread16(grey, rng) if k % 2 else grey
        return write_tiff(samples, 1, bits=16, compression=(5, 8)[k % 2], predictor=1 + k % 2, rows_per_strip=rows)
    if kind == "tiff_miniswhite":
        bits = (8, 4)[k % 2]
        return write_tiff((255 - grey) >> (8 - bits), 0, bits=bits, compression=(1, 5)[k % 2], rows_per_strip=rows)
    if kind == "tiff_palette":
        bits = (8, 4)[k % 2]
        idx, palette = _palette_of(rgb, bits, 1 << bits)
        cmap = palette.T.astype(np.int64) * 257 ^ rng.integers(0, 256, palette.T.shape)
        return write_tiff(idx, 3, bits=bits, compression=(5, 1)[k % 2], colormap=cmap, rows_per_strip=rows)
    if kind == "tiff_cmyk":
        key = 255 - rgb.max(axis=2, keepdims=True).astype(np.int64)
        cmyk = np.concatenate([255 - rgb.astype(np.int64) - key, key], axis=2)
        return write_tiff(cmyk, 5, compression=(5, 32773)[k % 2], rows_per_strip=rows)
    if kind == "tiff_rgba_assoc":
        alpha = rng.integers(0, 256, grey.shape)
        alpha[: grey.shape[0] // 8] = (0, 255)[k % 2]
        premultiplied = rgb.astype(np.int64) * alpha[..., None] // 255
        return write_tiff(np.dstack([premultiplied, alpha]), 2, compression=(5, 8)[k % 2], extra_samples=[1],
                          rows_per_strip=rows)
    if kind == "tiff_planar2":
        return write_tiff(rgb, 2, compression=(5, 1)[k % 2], planar=2, rows_per_strip=rows)
    if kind in TIFF_CODING_KINDS:
        return _tiff_coding_kind(kind, rgb, grey, k, rng)
    raise ValueError(f"unknown kind {kind!r}")


def _tiff_coding_kind(kind: str, rgb: np.ndarray, grey: np.ndarray, k: int, rng: np.random.Generator) -> bytes:
    """The TIFF_CODING_KINDS: JPEG strips or tiles (YCbCr 4:2:0, 4:2:2 or
    4:4:4 by turns, every fifth RGB; the tables in JPEGTables or in each
    stream), subsampled YCbCr under LZW, Deflate or PackBits, bilevel CCITT
    (modified Huffman byte- or word-aligned, T.4 1-D or 2-D with fill bits,
    T.6; MinIsWhite or MinIsBlack, fill order 1 or 2), LZMA (predictor 2 by
    turns), CIELab, ThunderScan 4-bit grey, the pre-5.0 LZW codes and
    old-style JPEG (JPEGInterchangeFormat, or the tables in tags)."""
    h, w = grey.shape
    bilevel = (grey + rng.integers(-20, 21, grey.shape) < 128).astype(np.int64)
    photometric, fill = k % 2, 1 + (k // 2) % 2
    if kind == "tiff_jpeg":
        if k % 5 == 4:
            return write_tiff(rgb, 2, compression=7, rows_per_strip=16, jpeg=dict(marker="adobe-rgb",
                                                                                  sampling=[(1, 1)] * 3))
        samp = ((2, 2), (2, 1), (1, 1))[k % 3]
        tile = (64, 32) if k % 4 == 1 else None
        return write_tiff(rgb, 6, compression=7, tile=tile, rows_per_strip=16 * samp[1],
                          jpeg=dict(sampling=[samp, (1, 1), (1, 1)], quality=(75, 90)[k % 2], marker="none",
                                    tables=k % 3 != 2), tags={530: (3, list(samp))})
    if kind == "tiff_ycbcr":
        samp = ((2, 2), (2, 1), (1, 1), (4, 2), (4, 4))[k % 5]
        tags = {530: (3, list(samp))}
        if k % 3 == 1:
            tags[532] = (5, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1])
        return write_tiff(rgb_to_ycbcr(rgb), 6, compression=(5, 8, 32773)[k % 3], ycbcr=samp,
                          rows_per_strip=8 * samp[1], tags=tags)
    if kind == "tiff_ccitt_mh":
        return write_tiff(bilevel ^ photometric, photometric, bits=1, compression=(2, 32771)[k % 2 if k % 4 else 0],
                          rows_per_strip=(16, h)[k % 2], fill_order=fill)
    if kind == "tiff_ccitt_t4":
        return write_tiff(bilevel ^ photometric, photometric, bits=1, compression=3, t4_options=(0, 1, 4, 5)[k % 4],
                          fax_k=(2, 4)[k % 2], rows_per_strip=(16, h)[k % 2], fill_order=fill)
    if kind == "tiff_ccitt_t6":
        return write_tiff(bilevel ^ photometric, photometric, bits=1, compression=4, rows_per_strip=(32, h)[k % 2],
                          fill_order=fill)
    if kind == "tiff_lzma":
        return write_tiff(rgb, 2, compression=34925, predictor=1 + k % 2, rows_per_strip=(16, 64)[k % 2])
    if kind == "tiff_lab":  # L from grey; a* and b* signed, from the red-green and yellow-blue differences
        r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
        lab = np.stack([grey, np.clip(r - g, -128, 127) & 255, np.clip((r + g) // 2 - b, -128, 127) & 255], -1)
        return write_tiff(lab, 8, compression=(1, 5, 8)[k % 3], rows_per_strip=32, planar=1 + (k % 4 == 3))
    if kind == "tiff_thunderscan":
        return write_tiff(grey >> 4, photometric, bits=4, compression=32809, rows_per_strip=(16, h)[k % 2],
                          fill_order=fill)
    if kind == "tiff_lzw_old":
        return write_tiff(rgb, 2, compression=5, old_lzw=True, predictor=1 + k % 2, rows_per_strip=(8, 32)[k % 2])
    if kind == "tiff_ojpeg":
        return write_ojpeg(rgb, ((2, 2), (2, 1), (1, 1))[k % 3], ("whole", "split", "tags")[k % 3 if k % 2 else 0])
    raise ValueError(f"unknown kind {kind!r}")


def write_ojpeg(rgb: np.ndarray, sampling: tuple, layout: str = "whole", quality: int = 75) -> bytes:
    """An old-style JPEG TIFF (compression 6, YCbCr) of one strip: the JPEG
    stream of `rgb` at `sampling` (h, v) found through
    JPEGInterchangeFormat ("whole": the tag and the strip both at the
    stream; "split": the strip at its scan data), or ("tags") the strip
    holding the scan data alone and the tables in JPEGQTables,
    JPEGDCTables and JPEGACTables."""
    h, w = np.asarray(rgb).shape[:2]
    stream = jpeg_writer.write_jpeg(rgb, [sampling, (1, 1), (1, 1)], quality, marker="none")
    sos = stream.index(b"\xff\xda")
    header = sos + 2 + struct.unpack(">H", stream[sos + 2:sos + 4])[0]
    tags = {530: (3, list(sampling))}
    if layout == "whole":
        tags.update({513: (4, [8]), 514: (4, [len(stream)])})
        return write_tiff(rgb, 6, compression=6, rows_per_strip=h, strips=[stream], tags=tags)
    if layout == "split":
        tags.update({513: (4, [8]), 514: (4, [len(stream)]), 273: (4, [8 + header]), 279: (4, [len(stream) - header])})
        return write_tiff(rgb, 6, compression=6, rows_per_strip=h, strips=[stream], tags=tags)
    segments, k = {}, 2
    while k < sos:
        length = struct.unpack(">H", stream[k + 2:k + 4])[0]
        segments.setdefault(stream[k + 1], []).append(stream[k + 4:k + 2 + length])
        k += 2 + length
    q, dht = segments[0xDB][0][1:65], segments[0xC4][0]
    dc_end = 1 + 16 + sum(dht[1:17])
    dc, ac = dht[1:dc_end], dht[dc_end + 1:]
    scan = stream[header:]
    at = 8 + len(scan) + len(scan) % 2
    tables = q + dc + ac
    tags.update({512: (3, [1]), 519: (4, [at] * 3), 520: (4, [at + 64] * 3), 521: (4, [at + 64 + len(dc)] * 3)})
    return write_tiff(rgb, 6, compression=6, rows_per_strip=h, strips=[scan + bytes(len(scan) % 2) + tables],
                      tags=tags)


# ---------------------------------------------------------------------------
# TGA, QOI, ICO, CUR, ICNS, PCX, DCX and SGI (the formats PIL opens by its
# order's probes: `data/formats.py`)
# ---------------------------------------------------------------------------

def tga_rle(rows: np.ndarray, depth: int, cross_rows: bool = True) -> bytes:
    """TGA run-length packets of `rows` (H, W * depth bytes, in file
    order): runs of 2 or more equal pixels (never past a row's end, which
    PIL refuses), literals between them; with `cross_rows` a literal runs
    on into the next row, as PIL reads it."""
    px = np.ascontiguousarray(rows).reshape(rows.shape[0], -1, depth)
    h, w = px.shape[:2]
    out = bytearray()
    lit = []

    def flush():
        while lit:
            part = lit[:128]
            del lit[:128]
            out.append(len(part) - 1)
            out.extend(b"".join(part))

    for y in range(h):
        row = [bytes(p) for p in px[y]]
        x = 0
        while x < w:
            n = 1
            while x + n < w and n < 128 and row[x + n] == row[x]:
                n += 1
            if n >= 2:
                flush()
                out.append(0x80 | (n - 1))
                out.extend(row[x])
            else:
                lit.append(row[x])
            x += n
        if not cross_rows:
            flush()
    flush()
    return bytes(out)


def write_tga(pixels: np.ndarray, image_type: int, depth: int, colormap: Optional[np.ndarray] = None,
              map_depth: int = 24, first: int = 0, orientation: int = 0, ident: bytes = b"",
              cross_rows: bool = True) -> bytes:
    """The bytes of a TGA of image type 1, 2, 3, 9, 10 or 11. `pixels` is
    (H, W) indices or grey levels at depth 8, (H, W) bits at depth 1,
    (H, W) raw 16-bit words (truecolour 5-5-5, grey + alpha as grey |
    alpha << 8), or (H, W, 3) RGB / (H, W, 4) RGBA at 24 and 32 bits.
    `colormap` (N, 3) RGB is written at `map_depth` (16: 5-5-5, 24: BGR,
    32: BGRA with alpha 255) and indexed from `first`. `orientation` is the
    descriptor's bits 0x10 (right to left) and 0x20 (top-down)."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    cmap = b""
    if colormap is not None:
        c = np.asarray(colormap, np.int64).reshape(-1, 3)
        if map_depth == 16:
            words = (c[:, 0] >> 3) << 10 | (c[:, 1] >> 3) << 5 | c[:, 2] >> 3
            cmap = words.astype("<u2").tobytes()
        else:
            e = np.full((len(c), map_depth // 8), 255, np.uint8)
            e[:, :3] = c[:, ::-1]
            cmap = e.tobytes()
    order = pixels if orientation & 0x20 else pixels[::-1]
    if orientation & 0x10:
        order = order[:, ::-1]
    if depth == 1:
        rows = np.packbits(order.astype(np.uint8) & 1, axis=1)
    elif depth == 8:
        rows = order.astype(np.uint8)
    elif depth == 16:
        rows = order.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    else:
        px = np.zeros((h, w, depth // 8), np.uint8)
        px[..., :3] = order[..., 2::-1]
        if depth == 32:
            px[..., 3] = order[..., 3] if order.shape[-1] == 4 else 255
        rows = px.reshape(h, -1)
    n = len(cmap) // max(1, map_depth // 8) if colormap is not None else 0
    header = struct.pack("<BBBHHBHHHHBB", len(ident), int(colormap is not None), image_type,
                         first if colormap is not None else 0, n,
                         map_depth if colormap is not None else 0, 0, 0, w, h, depth, orientation)
    body = tga_rle(rows, max(1, depth // 8), cross_rows) if image_type & 8 else rows.tobytes()
    return header + ident + cmap + body


def qoi_file(width: int, height: int, channels: int, ops: bytes) -> bytes:
    """A QOI file of the given op stream (with QOI's end marker)."""
    return b"qoif" + struct.pack(">IIBB", width, height, channels, 0) + ops + b"\x00" * 7 + b"\x01"


def write_qoi(rgba: np.ndarray, channels: int = 4) -> bytes:
    """The bytes of a QOI of (H, W, 3 or 4) pixels, encoded as the
    reference encoder does: runs, then the index, then DIFF, LUMA, RGB or
    RGBA."""
    rgba = np.asarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    if rgba.shape[2] == 3:
        rgba = np.dstack([rgba, np.full((h, w), 255, np.uint8)])
    index = [(0, 0, 0, 0)] * 64
    prev, run, out = (0, 0, 0, 255), 0, bytearray()
    for p in map(tuple, rgba.reshape(-1, 4).tolist()):
        if p == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        hsh = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        if index[hsh] == p:
            out.append(hsh)
        else:
            index[hsh] = p
            if p[3] == prev[3]:
                d = [((p[i] - prev[i] + 128) % 256) - 128 for i in range(3)]
                dg, drg, dbg = d[1], d[0] - d[1], d[2] - d[1]
                if all(-2 <= v <= 1 for v in d):
                    out.append(0x40 | (d[0] + 2) << 4 | (d[1] + 2) << 2 | (d[2] + 2))
                elif -32 <= dg <= 31 and -8 <= drg <= 7 and -8 <= dbg <= 7:
                    out += bytes((0x80 | (dg + 32), (drg + 8) << 4 | (dbg + 8)))
                else:
                    out += bytes((0xFE,) + p[:3])
            else:
                out += bytes((0xFF,) + p)
        prev = p
    if run:
        out.append(0xC0 | (run - 1))
    return qoi_file(w, h, channels, bytes(out))


def icon_bitmap(pixels: np.ndarray, bits: int, palette: Optional[np.ndarray] = None,
                mask: Optional[np.ndarray] = None, header: int = 40) -> bytes:
    """An icon's bitmap: `write_bmp`'s info header (its height doubled),
    palette and pixels, then (unless `mask` is None) the AND mask (H, W) of
    bits, 1 transparent, rows bottom-up padded to 32 bits."""
    h, w = np.asarray(pixels).shape[:2]
    dib = bytearray(write_bmp(pixels, bits, palette, header=header)[14:])
    if header == 12:
        struct.pack_into("<H", dib, 6, 2 * h)
    else:
        struct.pack_into("<i", dib, 8, 2 * h)
    if mask is not None:
        stride = (w + 31) // 32 * 4
        rows = np.zeros((h, stride), np.uint8)
        packed = np.packbits(np.asarray(mask, np.uint8)[::-1] & 1, axis=1)
        rows[:, :packed.shape[1]] = packed
        dib += rows.tobytes()
    return bytes(dib)


def write_icon(frames: Sequence[tuple], cursor: bool = False) -> bytes:
    """The bytes of an ICO (or, with `cursor`, a CUR) of `frames`, each
    (data, width, height, bits, colours): a PNG file or an `icon_bitmap`.
    A CUR entry holds a hotspot where an ICO entry holds planes and bits."""
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(frames))
    offset = 6 + 16 * len(frames)
    body = b""
    for data, w, h, bits, colors in frames:
        hot = (w // 2, h // 2) if cursor else (1, bits)
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colors % 256, 0, *hot, len(data), offset + len(body))
        body += data
    return out + body


def icns_pack(channel: bytes) -> bytes:
    """An ICNS channel in runs: 3 to 130 equal bytes as 125 + n and the
    byte, other bytes in literals of up to 128 (n - 1, then the bytes)."""
    out, lit, i, n = bytearray(), bytearray(), 0, len(channel)

    def flush():
        while lit:
            part = lit[:128]
            del lit[:128]
            out.append(len(part) - 1)
            out.extend(part)

    while i < n:
        j = i
        while j < n and j - i < 130 and channel[j] == channel[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes((125 + j - i, channel[i]))
            i = j
        else:
            lit.append(channel[i])
            i += 1
    flush()
    return bytes(out)


def write_icns(entries: Sequence[tuple]) -> bytes:
    """The bytes of an ICNS of `entries` (type, data)."""
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d for t, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb(rgb: np.ndarray, packed: bool = True, it32: bool = False) -> bytes:
    """A 24-bit ICNS entry's data: the R, G and B channels packed (or
    interleaved, unpacked), it32's 4 zero bytes first."""
    rgb = np.asarray(rgb, np.uint8)
    data = b"".join(icns_pack(rgb[..., c].tobytes()) for c in range(3)) if packed else rgb.tobytes()
    return (b"\x00" * 4 if it32 else b"") + data


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX runs of each row (R, bytes): 2 to 63 equal bytes, or one byte of
    0xC0 or more, as 0xC0 | n and the byte; other bytes as they are."""
    out = bytearray()
    for row in np.asarray(rows, np.uint8):
        row = row.tobytes()
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 63 and row[j] == row[i]:
                j += 1
            if j - i >= 2 or row[i] >= 0xC0:
                out += bytes((0xC0 | (j - i), row[i]))
                i = j
            else:
                out.append(row[i])
                i += 1
    return bytes(out)


def write_pcx(pixels: np.ndarray, bits: int, planes: int, palette: Optional[np.ndarray] = None,
              vga_palette: Optional[np.ndarray] = None, stride: Optional[int] = None,
              origin: tuple = (0, 0)) -> bytes:
    """The bytes of a PCX. `pixels`: (H, W) bits (1 bit, 1 plane), (H, W)
    palette indices (1 bit at 2 or 4 planes: plane k the index's bit k; 8
    bits, 1 plane), or (H, W, 3) RGB (8 bits, 3 planes). `palette` (16, 3)
    goes in the header, `vga_palette` (256, 3) after the image (a 12 byte
    first). `stride` is the bytes a plane the header gives (default: the
    plane's bytes rounded up to even, which the rows are padded to)."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    plane = (w * bits + 7) // 8
    stride = plane + plane % 2 if stride is None else stride
    row_bytes = max(stride, plane)
    if bits == 8:
        layers = [pixels.astype(np.uint8)] if planes == 1 else [pixels[..., c].astype(np.uint8) for c in range(3)]
    else:
        layers = [np.packbits(((pixels.astype(np.int64) >> k) & 1).astype(np.uint8), axis=1) for k in range(planes)]
    rows = np.zeros((h, planes, row_bytes), np.uint8)
    for k, layer in enumerate(layers):
        rows[:, k, :layer.shape[1]] = layer
    rows = rows[:, :, :stride] if stride < row_bytes else rows
    x0, y0 = origin
    header = bytearray(128)
    header[:4] = bytes((10, 5, 1, bits))
    struct.pack_into("<6H", header, 4, x0, y0, x0 + w - 1, y0 + h - 1, 72, 72)
    if palette is not None:
        header[16:16 + 3 * len(palette)] = np.asarray(palette, np.uint8).tobytes()
    header[65] = planes
    struct.pack_into("<HH", header, 66, stride, 1)
    tail = b"" if vga_palette is None else b"\x0c" + np.asarray(vga_palette, np.uint8).reshape(256, 3).tobytes()
    return bytes(header) + pcx_rle(rows.reshape(h, -1)) + tail


def write_dcx(pages: Sequence[bytes]) -> bytes:
    """The bytes of a DCX of PCX `pages`."""
    offset = 4 + 4 * (len(pages) + 1)
    table = b""
    for p in pages:
        table += struct.pack("<I", offset)
        offset += len(p)
    return struct.pack("<I", 0x3ADE68B1) + table + b"\x00" * 4 + b"".join(pages)


def _sgi_row(values: np.ndarray, bpc: int) -> bytes:
    """One SGI row in chunks (bpc-byte units, big-endian): runs of 3 or
    more equal values (count, value), copies of the rest (0x80 | count, the
    values), at most 127 a chunk, ended by a zero count."""
    unit = lambda v: int(v).to_bytes(bpc, "big")
    out, i, n = bytearray(), 0, len(values)
    vals = [int(v) for v in values]
    while i < n:
        j = i
        while j < n and j - i < 127 and vals[j] == vals[i]:
            j += 1
        if j - i >= 3:
            out += unit(j - i) + unit(vals[i])
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and vals[j] == vals[j + 1] == vals[j + 2]):
            j += 1
        out += unit(0x80 | (j - i)) + b"".join(unit(v) for v in vals[i:j])
        i = j
    return bytes(out + unit(0))


def write_sgi(samples: np.ndarray, bpc: int = 1, rle: bool = False, dimension: Optional[int] = None) -> bytes:
    """The bytes of an SGI of (H, W) or (H, W, C) samples (C 1, 3 or 4) at
    `bpc` bytes a sample, verbatim or run-length, rows bottom-up."""
    s = np.asarray(samples, np.int64)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    dim = dimension or (2 if c == 1 else 3)
    header = bytearray(512)
    struct.pack_into(">HBBHHHH", header, 0, 474, int(rle), bpc, dim, w, h, c)
    struct.pack_into(">ii", header, 12, 0, (1 << 8 * bpc) - 1)
    planes = [s[::-1, :, k] for k in range(c)]
    if not rle:
        dtype = ">u2" if bpc == 2 else np.uint8
        return bytes(header) + b"".join(p.astype(dtype).tobytes() for p in planes)
    rows = [[_sgi_row(p[y], bpc) for y in range(h)] for p in planes]
    at = 512 + 8 * h * c
    starts, lengths, body = [], [], b""
    for k in range(c):
        for y in range(h):
            starts.append(at + len(body))
            lengths.append(len(rows[k][y]))
            body += rows[k][y]
    return bytes(header) + struct.pack(f">{h * c}I", *starts) + struct.pack(f">{h * c}I", *lengths) + body


# The kinds of the formats PIL takes by its open order that the port reads
# since its format table (write_kind writes each; QOI and PNG entries go
# through this module's own encoders).
ORDER_KINDS = ("tga_rgb24", "tga_rle_rgb16", "tga_rle_cmap", "tga_rle_grey", "tga_rgba32_flip", "qoi_rgb",
               "qoi_rgba", "ico_png", "ico_bmp8", "ico_bmp32", "cur_bmp24", "icns_rle", "icns_png", "pcx_rgb",
               "pcx_palette8", "pcx_planes4", "dcx_rgb", "sgi_rle_rgb", "sgi_rle16_rgba", "sgi_grey")


def _order_kind(kind: str, rgb: np.ndarray, grey: np.ndarray, k: int, rng: np.random.Generator) -> bytes:
    """ORDER_KINDS: `k` varies the orientation, the colour map's depth and
    first index, the id section, the PCX stride and origin, the icon's
    other entries."""
    h, w = grey.shape
    if kind == "tga_rgb24":
        return write_tga(rgb, 2, 24, orientation=(0, 0x20)[k % 2], ident=b"id" * (k % 3))
    if kind == "tga_rle_rgb16":
        words = (rgb[..., 0].astype(np.int64) >> 3) << 10 | (rgb[..., 1] >> 3) << 5 | rgb[..., 2] >> 3
        return write_tga(words | (k % 2) << 15, 10, 16, orientation=(0, 0x10, 0x20, 0x30)[k % 4])
    if kind == "tga_rle_cmap":
        idx, palette = _palette_of(rgb, 8, 256 - (k % 3 == 0))
        first = k % 4
        return write_tga(np.minimum(idx + first, 255), 9, 8, np.asarray(palette)[:256 - first], (16, 24)[k % 2],
                         first, orientation=(0x20, 0)[k % 2])
    if kind == "tga_rle_grey":
        return write_tga(grey & ~np.int64(k % 4), 11, 8, orientation=(0, 0x30)[k % 2])
    if kind == "tga_rgba32_flip":
        return write_tga(np.dstack([rgb, rng.integers(0, 256, (h, w))]), 10 if k % 2 else 2, 32, orientation=0x10)
    if kind in ("qoi_rgb", "qoi_rgba"):
        q = rgb & np.uint8(0xFC if k % 2 else 0xFF)
        if kind == "qoi_rgb":
            return write_qoi(q, 3)
        alpha = np.where(grey > 100, 255, grey).astype(np.uint8)
        return write_qoi(np.dstack([q, alpha]), 4)
    if kind.startswith(("ico", "cur")):
        small = _palette_of(np.resize(rgb, (16, 16, 3)), 4, 16)
        extra = (icon_bitmap(small[0], 4, small[1], np.zeros((16, 16))), 16, 16, 4, 16) if k % 2 else None
        mask = rng.integers(0, 2, (h, w))
        if kind == "ico_png":
            frame = (write_png(rgb, 2, 8), w, h, 32, 0)
        elif kind == "ico_bmp8":
            idx, palette = _palette_of(rgb, 8, 256)
            frame = (icon_bitmap(idx, 8, palette, mask), w, h, 8, 0)
        elif kind == "ico_bmp32":
            frame = (icon_bitmap(rgb, 32, mask=mask if k % 2 else None), w, h, 32, 0)
        else:
            frame = (icon_bitmap(rgb, 24, mask=mask), w, h, 24, 0)
        frames = [frame] + ([extra] if extra else [])
        return write_icon(frames[::-1] if k % 3 == 0 else frames, cursor=kind.startswith("cur"))
    if kind == "icns_rle":
        small = rgb[:128, :128] if h >= 128 and w >= 128 else np.resize(rgb, (128, 128, 3))
        entries = [(b"it32", icns_rgb(small, it32=True)), (b"t8mk", bytes(128 * 128))]
        if k % 2:
            entries += [(b"is32", icns_rgb(small[:16, :16])), (b"s8mk", bytes(256))]
        return write_icns(entries)
    if kind == "icns_png":
        side = 256 if k % 2 else 128
        small = np.resize(rgb, (side, side, 3))
        return write_icns([(b"ic08" if side == 256 else b"ic07", write_png(small, 2, 8)),
                           (b"il32", icns_rgb(small[:32, :32])), (b"l8mk", bytes(1024))])
    if kind == "pcx_rgb":
        return write_pcx(rgb, 8, 3, stride=(w + w % 2, w)[k % 2], origin=(k % 3, k % 5))
    if kind == "pcx_palette8":
        idx, palette = _palette_of(rgb, 8, 256)
        return write_pcx(idx, 8, 1, vga_palette=palette)
    if kind == "pcx_planes4":
        idx, palette = _palette_of(rgb, 4, 16)
        return write_pcx(idx, 1, 4, palette=palette)
    if kind == "dcx_rgb":
        pages = [write_pcx(rgb, 8, 3), write_pcx(rgb[::-1], 8, 3)]
        return write_dcx(pages[:1 + k % 2])
    if kind == "sgi_rle_rgb":
        return write_sgi(rgb, 1, rle=True)
    if kind == "sgi_rle16_rgba":
        return write_sgi(np.dstack([_spread16(rgb, rng), rng.integers(0, 1 << 16, (h, w))]), 2, rle=True)
    if kind == "sgi_grey":
        return write_sgi(grey, 1, rle=False, dimension=(1, 2)[k % 2])
    raise ValueError(f"unknown kind {kind!r}")
