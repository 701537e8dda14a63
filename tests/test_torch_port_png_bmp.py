"""The port's PNG and BMP decoders (`damc_tpu_torch/data/images.py`) on
every coding PIL reads, against PIL's `Image.open(...).convert("RGB")`,
exactly: every PNG colour type at every bit depth, plain and Adam7, at odd
sizes (1x1, 1xN, Nx1, sizes where Adam7 passes are empty); every BMP
coding (BI_RGB at 1 to 32 bits, BI_BITFIELDS in each of PIL's layouts,
RLE8 and RLE4 streams) bottom-up and top-down; PIL's refusals, which raise
ValueError naming the file; and a seeded fuzz of corrupt files, each of
which the port decodes to PIL's pixels where PIL decodes it and refuses
where PIL refuses it. The files come from `tools/image_writer.py` (PIL
writes few of these kinds) and from seeds.

The card's machine has Pillow 12.2.0, which reads an RLE delta by its own
two bytes; 12.1.0 skipped them and moved by the next two. The port reads
as 12.2.0 does, so where this machine's Pillow is older the module's
fixture makes its RLE decoder read a delta as 12.2.0 does."""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import PIL
import pytest
from PIL import BmpImagePlugin, Image

from damc_tpu_torch.data import images
from damc_tpu_torch.data.images import ADAM7, CHANNELS, DEPTHS, decode_bmp, decode_parsed, decode_png, parse_png
from damc_tpu_torch.tools.image_writer import (BF32_LAYOUTS, BI_BITFIELDS, BI_RGB, KINDS, RLE4, RLE8, write_bmp,
                                               write_kind, write_png)


class _DeltaAsIn12_2:
    """The file Pillow's BmpRleDecoder reads, for a Pillow before 12.2.0:
    after a delta's escape (0, 2) its first two-byte read is the delta and
    its second read gives those two bytes again, so it moves by them as
    12.2.0 does."""

    def __init__(self, fd):
        self.fd, self.last, self.delta = fd, [], None

    def read(self, n=-1):
        if n == 2 and self.delta is not None:
            out, self.delta = self.delta, None
            return out
        out = self.fd.read(n)
        if n == 2 and self.last == [b"\x00", b"\x02"]:
            self.delta = out
        self.last = (self.last + [out])[-2:] if n == 1 else []
        return out

    def __getattr__(self, name):
        return getattr(self.fd, name)


@pytest.fixture(autouse=True, scope="module")
def _pil_as_on_the_card():
    if tuple(int(v) for v in PIL.__version__.split(".")[:2]) >= (12, 2):
        yield
        return
    setfd = BmpImagePlugin.BmpRleDecoder.setfd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BmpImagePlugin.BmpRleDecoder, "setfd", lambda self, fd: setfd(self, _DeltaAsIn12_2(fd)))
        yield


def _pil(data: bytes):
    """PIL's RGB pixels of the file, or None where PIL raises."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # PIL raises OSError, ValueError, SyntaxError or struct.error
        return None


def _same_as_pil(data: bytes, decode, name: str = "f.x"):
    """The port's decode of `data` equals PIL's, or both raise (the port's
    ValueError naming the file)."""
    want = _pil(data)
    if want is None:
        with pytest.raises(ValueError, match=f"^{name}: "):
            decode(data, name)
        return
    got = decode(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# (height, width): 1x1, 1xN, Nx1 and sizes whose Adam7 passes 2 to 7 are empty in turn
SIZES = ((1, 1), (1, 13), (11, 1), (2, 3), (3, 2), (4, 5), (5, 4), (6, 7), (8, 8), (9, 16), (17, 9), (31, 33))


def _smooth(rng, h, w, c, top):
    """Seeded samples in [0, top) that vary smoothly along the rows."""
    walk = np.cumsum(rng.integers(-max(top // 32, 1), max(top // 32, 1) + 1, (h, w, c)), axis=1)
    return np.clip(walk + rng.integers(0, top, (h, 1, c)), 0, top - 1)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color, depth", [(c, d) for c, ds in DEPTHS.items() for d in ds],
                         ids=lambda v: str(v))
def test_png_matches_pil(color, depth, interlace):
    """Every colour type at every bit depth PNG allows, plain and Adam7, at
    the SIZES: the five row filters, non-zero padding bits, the data over
    two IDAT chunks; palettes of random colours with some indices past
    their end (black in PIL)."""
    rng = np.random.default_rng(100 * color + depth + interlace)
    for k, (h, w) in enumerate(SIZES):
        c = CHANNELS[color]
        samples = _smooth(rng, h, w, c, 1 << depth) if k % 2 else rng.integers(0, 1 << depth, (h, w, c))
        palette = None
        if color == 3:
            palette = rng.integers(0, 256, (int(rng.integers(1, (1 << depth) + 1)), 3), dtype=np.uint8)
        data = write_png(samples, color, depth, palette=palette, interlace=interlace, filters=(np.arange(7) + k) % 5,
                         idat_chunks=2, padding=int(rng.integers(256)))
        _same_as_pil(data, decode_png)


@pytest.mark.parametrize("color, depth, trns", [(0, 1, b"\x00\x01"), (0, 8, b"\x00\x05"), (0, 16, b"\x01\x00"),
                                                (2, 8, b"\x00\x01\x00\x02\x00\x03"), (2, 16, b"\x12\x34" * 3),
                                                (3, 4, b"\x00\x80\xff"), (3, 8, b"\xff\x00")], ids=str)
def test_png_trns_leaves_the_pixels(color, depth, trns):
    """A tRNS chunk (grey, RGB, palette) changes nothing of
    `convert("RGB")`'s pixels."""
    rng = np.random.default_rng(depth + len(trns))
    samples = rng.integers(0, 1 << depth, (7, 9, CHANNELS[color]))
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8) if color == 3 else None
    data = write_png(samples, color, depth, palette=palette, trns=trns, filters=[1, 4])
    assert _pil(data) is not None
    _same_as_pil(data, decode_png)


def _with_header(data: bytes, depth: int, color: int) -> bytes:
    body = data[16:24] + bytes([depth, color]) + data[26:29]
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF) + data[33:]


@pytest.mark.parametrize("depth, color", [(4, 2), (16, 3), (4, 4), (1, 6), (3, 0), (8, 1), (8, 5)], ids=str)
def test_png_header_refused_as_pil(depth, color):
    """A bit depth its colour type does not have, or no colour type of
    PNG's: PIL refuses the file, and so does the port, naming it."""
    data = _with_header(write_png(np.zeros((3, 4, 1), int), 0, 8), depth, color)
    assert _pil(data) is None
    with pytest.raises(ValueError, match=r"^f\.png: .*(bit depth|colour type)"):
        decode_png(data, "f.png")


def test_png_palette_past_256_entries_refused_as_pil():
    """A PLTE of 257 entries: PIL refuses the palette, the port the file."""
    data = write_png(np.zeros((2, 2), int), 3, 8, palette=np.zeros((257, 3), np.uint8))
    assert _pil(data) is None and _pil(write_png(np.zeros((2, 2), int), 3, 8, palette=np.zeros((256, 3)))) is not None
    with pytest.raises(ValueError, match=r"^f\.png: a PLTE chunk of 257 entries"):
        decode_png(data, "f.png")


def _png_of_rows(w, h, color, depth, idats, interlace, palette):
    """A PNG whose IDAT chunks hold the given compressed bytes."""
    chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette)
    return out + b"".join(chunk(b"IDAT", d) for d in idats) + chunk(b"IEND", b"")


@pytest.mark.parametrize("w, h, color, depth, interlace", [(3, 4, 2, 8, 0), (8, 8, 2, 8, 1), (10, 3, 0, 1, 0),
                                                           (9, 7, 3, 4, 1), (5, 5, 6, 16, 1)], ids=str)
def test_png_data_ending_early_as_pil(w, h, color, depth, interlace):
    """Image data whose zlib stream ends after k rows (PIL keeps them and
    leaves the rest zero, where the end comes in the read that completes a
    row) or inside a row (PIL raises), with the checksum whole, cut off,
    corrupt, or in an IDAT chunk of its own; rows past the image ignored."""
    rng = np.random.default_rng(w * h + color)
    c = CHANNELS[color]
    rows = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            rows += [bytes([int(rng.integers(5))]) + rng.integers(0, 256, (pw * c * depth + 7) // 8,
                                                                  dtype=np.uint8).tobytes() for _ in range(ph)]
    palette = rng.integers(0, 256, 48, dtype=np.uint8).tobytes() if color == 3 else None
    for k in range(len(rows) + 1):
        for extra in (0, 1):
            raw = b"".join(rows[:k]) + (rows[k][:extra] if k < len(rows) else b"")
            z = zlib.compress(raw)
            for idats in ([z], [z[:-4], z[-4:]], [z[:-6], z[-6:]]):
                _same_as_pil(_png_of_rows(w, h, color, depth, idats, interlace, palette), decode_png)
    z = zlib.compress(b"".join(rows) + bytes(50))
    bad = z[:-1] + bytes([z[-1] ^ 1])
    for idats in ([z[:-4]], [bad], [bad[:-4], bad[-4:]], [z + b"junk"]):
        _same_as_pil(_png_of_rows(w, h, color, depth, idats, interlace, palette), decode_png)


def test_png_checksum_past_pils_read_as_pil():
    """A corrupt checksum in the bytes after PIL's first 64 KiB read of the
    image data (which PIL never reads, the rows being done) decodes; one
    inside that read raises."""
    for raw_len, want_pil in ((65527, True), (65520, False)):
        w = (raw_len - 1) // 3
        stream = bytearray(zlib.compress(bytes([0]) + bytes(range(256)) * (3 * w // 256) + bytes(3 * w % 256), 0))
        stream[-1] ^= 0x40
        data = _png_of_rows(w, 1, 2, 8, [bytes(stream)], 0, None)
        assert (_pil(data) is not None) == want_pil, len(stream)
        _same_as_pil(data, decode_png)


def test_adam7_batch_unfilters_each_pass_shape_once(monkeypatch):
    """Six Adam7 files of one size (and one plain file of another) in one
    `decode_parsed` call: one wavefront for each of the seven pass shapes
    and one for the plain file, not one a pass a file; each file equals
    PIL's decode and its decode alone."""
    rng = np.random.default_rng(7)
    blobs = [write_png(rng.integers(0, 256, (21, 19, 3)), 2, 8, interlace=True, filters=(np.arange(5) + i) % 5)
             for i in range(6)] + [write_png(rng.integers(0, 16, (5, 6)), 0, 4, filters=[1, 2, 3])]
    calls = []
    unfilter = images.unfilter
    monkeypatch.setattr(images, "unfilter", lambda f, t, b: (calls.append(f.shape), unfilter(f, t, b))[1])
    got = decode_parsed([parse_png(b) for b in blobs])
    assert len(calls) == 8 and sorted(n for n, _, _ in calls) == [1] + [6] * 7
    for img, data in zip(got, blobs):
        np.testing.assert_array_equal(img, _pil(data))
        np.testing.assert_array_equal(img, decode_png(data))


BMP_KINDS = {  # name: (bits, compression, masks, header)
    "rgb1": (1, BI_RGB, None, 40), "rgb4": (4, BI_RGB, None, 40), "rgb8": (8, BI_RGB, None, 40),
    "rgb16": (16, BI_RGB, None, 40), "rgb24": (24, BI_RGB, None, 40), "rgb32": (32, BI_RGB, None, 40),
    "bf565": (16, BI_BITFIELDS, (0xF800, 0x7E0, 0x1F), 40), "bf555": (16, BI_BITFIELDS, (0x7C00, 0x3E0, 0x1F), 52),
    "bf24": (24, BI_BITFIELDS, (0xFF0000, 0xFF00, 0xFF), 108), "rle8": (8, RLE8, None, 40),
    "rle4": (4, RLE4, None, 40), "rle8_v5": (8, RLE8, None, 124), "os2_1": (1, BI_RGB, None, 12),
    "os2_4": (4, BI_RGB, None, 12), "os2_8": (8, BI_RGB, None, 12), "os2_24": (24, BI_RGB, None, 12),
    **{f"bf32_{i}": (32, BI_BITFIELDS, masks, header) for i, (masks, header) in enumerate(BF32_LAYOUTS)},
    "bf32_zero": (32, BI_BITFIELDS, (0, 0, 0, 0), 56), "bf32_abgr": (32, BI_BITFIELDS, (0xFF000000, 0xFF0000, 0xFF00, 0xFF), 124),
    "bf32_bgar": (32, BI_BITFIELDS, (0xFF000000, 0xFF00, 0xFF, 0xFF0000), 124),
}


@pytest.mark.parametrize("kind, top_down", [(k, t) for k in sorted(BMP_KINDS) for t in (False, True)
                                             if not (t and BMP_KINDS[k][3] == 12)],
                         ids=lambda v: {False: "bottom_up", True: "top_down"}.get(v, v) if isinstance(v, bool) else v)
def test_bmp_matches_pil(kind, top_down):
    """Every BMP coding PIL reads, bottom-up and top-down (the OS/2 header
    has no top-down), at the SIZES: palettes of random colours, some
    shorter than the indices (black past the end), RLE streams from the
    writer's encoder (encoded and absolute runs, end of line, end of
    bitmap); 16- and 32-bit words random in every bit, masks after the
    40-byte header or inside a larger one."""
    bits, compression, masks, header = BMP_KINDS[kind]
    rng = np.random.default_rng(len(kind) * 7 + top_down)
    for k, (h, w) in enumerate(SIZES):
        palette = None
        if bits <= 8:
            top = 16 if compression == RLE4 else 1 << bits
            pix = _smooth(rng, h, w, 1, top)[..., 0] if k % 2 else rng.integers(0, top, (h, w))
            palette = rng.integers(0, 256, (int(rng.integers(2, top + 1)) if k % 3 else top, 3), dtype=np.uint8)
        elif bits == 24:
            pix = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            pix = rng.integers(0, 1 << bits, (h, w), dtype=np.uint64)
        data = write_bmp(pix, bits, palette, compression=compression, masks=masks, top_down=top_down, header=header)
        _same_as_pil(data, decode_bmp)


@pytest.mark.parametrize("bits, compression", [(1, BI_RGB), (4, BI_RGB), (8, BI_RGB), (4, RLE4), (4, RLE8),
                                               (8, RLE8)], ids=str)
def test_bmp_grey_palettes_as_pil(bits, compression):
    """Palettes PIL takes for grey: entries equal to their index (mode L,
    the pixel bytes read as grey levels, whatever the bit depth: where the
    rows hold fewer bytes than pixels PIL refuses) and black and white of
    two entries (mode 1, the bytes read as bits); raw and RLE pixels."""
    rng = np.random.default_rng(bits * 10 + compression)
    for colors in (2, 4, 16, 256):
        for palette in (np.repeat(np.arange(colors)[:, None], 3, 1), np.array([[0, 0, 0], [255, 255, 255]])):
            if len(palette) != colors:
                continue
            for w in (1, 3, 4, 5, 8, 9, 33):
                pix = rng.integers(0, 16 if compression == RLE4 else 1 << bits, (5, w))
                data = write_bmp(pix, bits, palette.astype(np.uint8), compression=compression, top_down=w % 2 == 1)
                _same_as_pil(data, decode_bmp)


def _refused(case: str) -> bytes:
    rng = np.random.default_rng(3)
    idx, rgb = rng.integers(0, 4, (3, 5)), rng.integers(0, 256, (3, 5, 3), dtype=np.uint8)
    palette = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    words16, words32 = rng.integers(0, 1 << 16, (3, 5)), rng.integers(0, 1 << 32, (3, 5), dtype=np.uint64)
    bf = lambda bits, words, masks, header=40: write_bmp(words, bits, compression=BI_BITFIELDS, masks=masks,
                                                         header=header)
    with_bits = lambda data, bits: data[:28] + struct.pack("<H", bits) + data[30:]
    with_compression = lambda data, c: data[:30] + struct.pack("<I", c) + data[34:]
    return {
        "2_bits": lambda: with_bits(write_bmp(idx, 4, palette), 2),
        "0_bits": lambda: with_bits(write_bmp(idx, 4, palette), 0),
        "64_bits": lambda: with_bits(write_bmp(rgb, 32), 64),
        "bi_jpeg": lambda: with_compression(write_bmp(rgb, 24), 4),
        "bi_png": lambda: with_compression(write_bmp(rgb, 24), 5),
        "compression_6": lambda: with_compression(write_bmp(rgb, 24), 6),
        "bf16_f000": lambda: bf(16, words16, (0xF000, 0xF00, 0xF0)),
        "bf16_565_swapped": lambda: bf(16, words16, (0x1F, 0x7E0, 0xF800)),
        "bf24_rgb": lambda: bf(24, rgb, (0xFF, 0xFF00, 0xFF0000)),
        "bf32_rgbx": lambda: bf(32, words32, (0xFF, 0xFF00, 0xFF0000, 0), 56),
        "bf32_alpha_in_40": lambda: bf(32, words32, (0xFF, 0xFF00, 0xFF0000)),
        "bf8": lambda: with_compression(write_bmp(idx, 8, palette), 3),
        "rle8_at_24": lambda: with_compression(write_bmp(rgb, 24), 1),
        "palette_of_257": lambda: write_bmp(idx, 8, rng.integers(0, 256, (257, 3), dtype=np.uint8)),
        "grey_ramp_too_wide": lambda: write_bmp(rng.integers(0, 16, (3, 40)), 4,
                                                np.repeat(np.arange(16)[:, None], 3, 1).astype(np.uint8)),
    }[case]()


@pytest.mark.parametrize("case", ["2_bits", "0_bits", "64_bits", "bi_jpeg", "bi_png", "compression_6", "bf16_f000",
                                  "bf16_565_swapped", "bf24_rgb", "bf32_rgbx", "bf32_alpha_in_40", "bf8",
                                  "rle8_at_24", "palette_of_257", "grey_ramp_too_wide"])
def test_bmp_refused_as_pil(case):
    """What PIL refuses (a depth other than 1, 4, 8, 16, 24 and 32 bits,
    BI_JPEG, BI_PNG, a bit-field layout outside PIL's table, RLE of an RGB
    image, a palette past 256 colours, a grey-ramp palette over rows too
    short for a byte a pixel) raises ValueError naming the file."""
    data = _refused(case)
    assert _pil(data) is None
    with pytest.raises(ValueError, match=r"^the_file\.bmp: "):
        decode_bmp(data, "the_file.bmp")


RLE_STREAMS = [  # hand-made RLE runs: (count, value) pairs and escapes
    bytes([3, 5, 0, 0, 2, 7, 1, 1, 0, 0, 4, 2, 0, 1]),  # encoded runs, end of line, end of bitmap
    bytes([0, 2, 1, 1, 2, 3, 0, 1]),  # a delta first
    bytes([0, 2, 2, 1, 3, 9, 0, 0, 4, 4, 0, 1]),
    bytes([0, 3, 1, 2, 3, 0, 0, 0, 4, 1, 0, 1]),  # an absolute run of 3 and its word's padding
    bytes([0, 5, 1, 2, 3, 4, 5, 0, 0, 1]),
    bytes([9, 1, 9, 2, 0, 1]),  # runs past the row's end
    bytes([0, 9, 1, 2, 3, 4, 5, 6, 7, 8, 9, 0, 3, 1]),  # an absolute run past the row's end
    bytes([4, 1, 0, 2, 0]),  # a delta cut short
    bytes([4, 1, 0, 2]),
    bytes([4, 1, 0, 2, 0, 1]),
    bytes([4, 1, 0, 1]),  # end of bitmap before the last row
    bytes([4, 1, 4, 2, 4, 3]),  # no end of line
    bytes([4, 1, 4, 2, 4, 3, 0]),
    bytes([2, 0x12, 2, 0x34, 4, 0x56, 0, 5, 0x12, 0x34, 0x56, 0, 0, 1]),
    bytes([0, 4, 1, 2, 3]),  # an absolute run cut short
    bytes([0, 0, 0, 0, 0, 0, 6, 6, 6, 6, 6, 6]),  # empty lines
]


@pytest.mark.parametrize("stream", range(len(RLE_STREAMS)))
def test_rle_streams_as_pil(stream):
    """Hand-made RLE8 and RLE4 streams, bottom-up and top-down, at three
    sizes: every escape (end of line, end of bitmap, delta, absolute runs
    with their word padding) and every way to end early or run over."""
    rng = np.random.default_rng(stream)
    for compression, bits in ((RLE8, 8), (RLE4, 4), (RLE8, 4), (RLE4, 8)):
        for top_down in (False, True):
            for w, h in ((4, 3), (5, 2), (2, 6)):
                palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
                data = write_bmp(np.zeros((h, w), int), bits, palette, compression=compression, top_down=top_down,
                                 rle=RLE_STREAMS[stream])
                _same_as_pil(data, decode_bmp)


def _refix_crcs(data: bytes) -> bytes:
    """`data` with every whole chunk's CRC redone."""
    out, pos = bytearray(data[:8]), 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if pos + 12 + n > len(data):
            break
        out += data[pos:pos + 8 + n] + struct.pack(">I", zlib.crc32(data[pos + 4:pos + 8 + n]) & 0xFFFFFFFF)
        pos += 12 + n
    return bytes(out + data[pos:])


def _fuzz_seeds(rng):
    """One small seeded file of every PNG colour type x depth (Adam7 or not)
    and of every BMP coding."""
    pngs, bmps = [], []
    for color, depths in DEPTHS.items():
        for depth in depths:
            h, w = rng.integers(1, 12, 2)
            palette = rng.integers(0, 256, (1 << min(depth, 8), 3), dtype=np.uint8) if color == 3 else None
            pngs.append(write_png(_smooth(rng, h, w, CHANNELS[color], 1 << depth), color, depth, palette=palette,
                                  interlace=bool(rng.integers(2)), filters=list(rng.integers(0, 5, 5))))
    for bits, compression in [(1, 0), (4, 0), (8, 0), (4, 2), (8, 1), (4, 1), (16, 0), (16, 3), (24, 0), (32, 0),
                              (32, 3)]:
        h, w = rng.integers(1, 12, 2)
        palette = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8) if bits <= 8 else None
        pix = (_smooth(rng, h, w, 1, 1 << bits)[..., 0] if bits <= 8 else rng.integers(0, 256, (h, w, 3))
               if bits == 24 else rng.integers(0, 1 << bits, (h, w), dtype=np.uint64))
        masks = {16: (0xF800, 0x7E0, 0x1F), 32: (0xFF, 0xFF00, 0xFF0000, 0xFF000000)}.get(bits)
        bmps.append(write_bmp(pix, bits, palette, compression=compression, masks=masks, top_down=bool(rng.integers(2)),
                              header=124 if compression == 3 and bits == 32 else 40))
    return pngs, bmps


def _mutate_png(data: bytes, rng) -> bytes:
    """Bits flipped in the compressed image data, the inflated rows changed
    or cut and compressed again, or IHDR's depth, colour type or interlace
    changed; every CRC redone (PIL skips the image data's CRCs, the port
    checks them)."""
    d = bytearray(data)
    i = d.index(b"IDAT")
    (n,) = struct.unpack(">I", d[i - 4:i])
    kind = rng.integers(3)
    if kind == 0:
        for _ in range(rng.integers(1, 4)):
            d[i + 4 + rng.integers(n)] ^= 1 << rng.integers(8)
        return _refix_crcs(bytes(d))
    if kind == 1:
        raw = bytearray(zlib.decompress(bytes(d[i + 4:i + 4 + n])))
        for _ in range(rng.integers(1, 3)):
            raw[rng.integers(len(raw))] = rng.integers(256)
        if rng.integers(2):
            raw = raw[:rng.integers(len(raw) + 1)]
        z = zlib.compress(bytes(raw))
        return _refix_crcs(bytes(d[:i - 4]) + struct.pack(">I", len(z)) + b"IDAT" + z + bytes(4) + bytes(d[i + 8 + n:]))
    d[16 + rng.choice([8, 9, 12])] = rng.choice([0, 1, 2, 3, 4, 5, 6, 8, 16, 255])
    return _refix_crcs(bytes(d))


def _mutate_bmp(data: bytes, rng) -> bytes:
    """Bytes of the pixel data or RLE stream set to escapes or noise, the
    file cut short, or a header field (size, orientation, bits, compression,
    colour count, pixel offset, masks) set to a value PIL meets."""
    d = bytearray(data)
    offset = struct.unpack_from("<I", d, 10)[0]
    kind = rng.integers(3)
    if kind == 0 and len(d) > offset:
        for _ in range(rng.integers(1, 4)):
            d[offset + rng.integers(len(d) - offset)] = rng.choice([0, 1, 2, 3, int(rng.integers(256))])
    elif kind == 1:
        d = d[:rng.integers(2, len(d))]
    else:
        field = int(rng.choice([18, 22, 25, 28, 30, 46, 10, 54, 58]))
        if field + 4 > len(d):
            field = 28
        if field == 28:
            struct.pack_into("<H", d, field, int(rng.choice([0, 1, 2, 4, 8, 16, 24, 32, 48, 64])))
        elif field == 25:
            d[25] = 0xFF if d[25] != 0xFF else 0
        elif field == 30:
            struct.pack_into("<I", d, field, int(rng.integers(0, 7)))
        elif field == 46:
            struct.pack_into("<I", d, field, int(rng.choice([0, 1, 2, 3, 16, 255, 256, 257, 1000])))
        elif field == 10:
            struct.pack_into("<I", d, field, int(rng.choice([0, 54, 55, 1, 100, len(d)])))
        elif field in (54, 58):
            struct.pack_into("<I", d, field, int(rng.choice([0, 0xFF, 0xFF00, 0xFF0000, 0xFF000000, 0x1F])))
        else:
            struct.pack_into("<I", d, field, int(rng.integers(0, 20)))
    return bytes(d)


@pytest.mark.parametrize("seed", range(24))
def test_corrupt_files_as_pil(seed):
    """40 corrupt files a seed, drawn from one small file of every kind:
    where PIL decodes one, the port's pixels equal PIL's; where PIL raises,
    the port raises ValueError naming the file. (Truncating a PNG is left
    to the checks the port keeps on purpose: it reads every chunk to IEND
    with its CRC, where PIL stops after the image data.)"""
    rng = np.random.default_rng(1000 + seed)
    pngs, bmps = _fuzz_seeds(rng)
    for _ in range(40):
        if rng.integers(2):
            _same_as_pil(_mutate_png(pngs[rng.integers(len(pngs))], rng), decode_png, "f.png")
        else:
            _same_as_pil(_mutate_bmp(bmps[rng.integers(len(bmps))], rng), decode_bmp, "f.bmp")


def test_png_cut_after_its_image_data_raises():
    """The port keeps its structural checks where PIL does not look: a PNG
    cut after its image data, or with a corrupt CRC in the image data,
    decodes in PIL and raises in the port, naming the file and the fault."""
    data = write_png(np.arange(12).reshape(3, 4) % 4, 0, 2, filters=[4])
    assert _pil(data[:-6]) is not None
    with pytest.raises(ValueError, match=r"^f\.png: truncated"):
        decode_png(data[:-6], "f.png")
    i = data.index(b"IDAT") + 4
    bad_crc = data[:i] + data[i:].replace(data[data.index(b"IEND") - 8:data.index(b"IEND") - 4], bytes(4), 1)
    assert _pil(bad_crc) is not None
    with pytest.raises(ValueError, match=r"^f\.png: CRC mismatch in the b'IDAT' chunk"):
        decode_png(bad_crc, "f.png")


@pytest.mark.parametrize("kind", KINDS)
def test_write_kind_files_match_pil(kind):
    """The files chip_smoke's tree holds (`write_kind`) at CelebA's 178x218
    and at small sizes, each option of `k`: the port equals PIL."""
    rng = np.random.default_rng(len(kind))
    for k, (h, w) in enumerate([(218, 178), (1, 1), (3, 7), (12, 5), (9, 9), (20, 33)]):
        low = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
        pix = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR)).astype(np.int16)
        pix = np.clip(pix + rng.integers(-6, 7, pix.shape), 0, 255).astype(np.uint8)
        data = write_kind(kind, pix, k)
        want = _pil(data)
        assert want is not None
        decode = decode_png if kind.startswith("png") else decode_bmp
        np.testing.assert_array_equal(decode(data, kind), want)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_os2_palette_then_pixels_as_pil_12_2(bits):
    """An OS/2 (12-byte header) BMP whose pixel offset points at the palette
    (14 + 12): Pillow 12.2.0 starts the pixels 3 bytes a colour later (the
    entry size of that header; 12.1.0 skipped 4). The port equals PIL's
    decode of the same file with the offset written out, and, on Pillow
    12.2.0 or later, PIL's decode of the file itself."""
    rng = np.random.default_rng(bits)
    data = write_bmp(rng.integers(0, 1 << bits, (5, 7)), bits, rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8),
                     header=12)
    assert struct.unpack_from("<I", data, 10)[0] == 26 + 3 * (1 << bits)
    at_palette = data[:10] + struct.pack("<I", 26) + data[14:]
    np.testing.assert_array_equal(decode_bmp(at_palette, "f.bmp"), _pil(data))
    if tuple(int(v) for v in PIL.__version__.split(".")[:2]) >= (12, 2):
        np.testing.assert_array_equal(decode_bmp(at_palette, "f.bmp"), _pil(at_palette))
