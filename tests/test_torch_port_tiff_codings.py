"""The TIFF codings PIL decodes through libtiff beyond uncompressed,
PackBits, LZW and Deflate, in the port's TIFF reader
(`damc_tpu_torch/data/tiff.py`, with `csrc/host/fax_decode.cpp`,
`zstd_decode.cpp`, `lzw_decode.cpp`, `jpeg_decode.cpp` and
`data/cielab.py`), against PIL's `Image.open(...).convert("RGB")`,
exactly, on files named anything:

  * JPEG in TIFF (7): strips (the last short) and tiles (the edge ones
    cropped), the tables in JPEGTables or in each stream, grey, RGB, CMYK
    and YCbCr at 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and 4:2:0 by 4, with the
    YCbCrSubsampling tag or from the first frame; libjpeg's YCbCr to RGB
    for YCbCr in one plane, the samples as they stand otherwise, whatever
    markers the stream carries; PIL's own JPEG-in-TIFF files;
  * YCbCr (6) under LZW, Deflate, PackBits and LZMA through libtiff's RGBA
    interface: every subsampling TIFFRGBAImage reads, strips and tiles,
    ReferenceBlackWhite, YCbCrCoefficients, YCbCrPositioning, separate
    planes, predictor 2;
  * CCITT: modified Huffman (2) and its word-aligned form (32771), T.4 (3)
    1-D and 2-D with and without fill bits, T.6 (4), MinIsWhite and
    MinIsBlack, fill order 1 and 2, strips and tiles; PIL's own files;
  * LZMA (34925) and Zstandard (50000), with predictor 2, Zstandard frames
    of several blocks, raw and RLE blocks and skippable frames;
  * CIELab (8): PIL's LAB to RGB on 2^20 inputs, and TIFFs of signed a*
    and b*, contiguous and planar, under several codings;
  * ThunderScan (32809), on the writer's files and on random code streams;
  * the pre-5.0 LZW codes; old-style JPEG (6) through JPEGInterchangeFormat
    or with its tables in tags;
  * what PIL refuses (SGILog, WebP, uncompressed YCbCr, a CCITT or
    ThunderScan image of other depths, ...) raises ValueError naming the
    file; no TIFF PIL reads raises NotImplementedError;
  * the seeded fuzz of each coding: the port gives PIL's pixels where PIL
    decodes and raises ValueError where PIL raises;
  * the TIFF_CODING_KINDS of chip_smoke's tree, and a folder of them named
    .png and .jpg equal to the JAX package's reader.

The files come from `tools/image_writer.py` (PIL writes few of these
layouts) and from PIL. Only the folder test imports the JAX package, so
the rest runs on the card's machine too (`-k "not folder" --noconftest`).
PIL is not asked to save a mode "1" image as JPEG, which crashes it.
"""

from __future__ import annotations

import ctypes.util
import io
import lzma
import os
import struct
import subprocess
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from damc_tpu_torch.data import _native_build, datasets
from damc_tpu_torch.data import tiff as tiff_module
from damc_tpu_torch.data import xz
from damc_tpu_torch.data.cielab import lab_to_rgb
from damc_tpu_torch.data.datasets import decode_image
from damc_tpu_torch.tools.image_writer import (TIFF_CODING_KINDS, rgb_to_ycbcr, write_kind, write_ojpeg,
                                               write_tiff)

warnings.filterwarnings("ignore", module="PIL")


def _pil(data: bytes):
    """PIL's RGB pixels of the file, or None where PIL raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # PIL raises OSError, ValueError, SyntaxError, ...
        return None


UNDEFINED_CODINGS = (4, 7)  # a Group 4 strip stopped early, a JPEG frame smaller than its strip


def _same_as_pil(data: bytes, name: str = "f.png", must_decode: bool = False) -> bool:
    """The port's decode of `data` equals PIL's, or both raise (the port's
    ValueError naming the file); never NotImplementedError. A TIFF is
    decoded twice, its strip buffers first filled with 0 and with 255
    (`decode_tiff`'s `blank`): the bytes on which the two agree equal
    PIL's, and those on which they differ, which PIL takes from its
    malloc'ed strip buffer, are allowed only under UNDEFINED_CODINGS.
    Where a corrupt JPEG block would leave the range in which
    libjpeg-turbo's SIMD inverse DCT computes as its C version, the port
    refuses the file (as tests/test_torch_port_jpeg.py holds too). Returns
    whether some of the file's pixels were undefined."""
    want = _pil(data)
    assert not must_decode or want is not None, "PIL refuses a file the test means it to read"
    try:
        got = decode_image(data, name)
    except ValueError as e:
        assert want is None or "SIMD inverse DCT" in str(e), f"PIL reads the file, the port raises: {e}"
        assert str(e).startswith(f"{name}: "), e
        return False
    assert want is not None, "PIL raises, the port decodes"
    assert got.dtype == np.uint8 and got.shape == want.shape
    defined = np.ones(got.shape, bool)
    if tiff_module.is_tiff(data[:4]):
        defined = got == tiff_module.decode_tiff(data, name, blank=255)
        if not defined.all():
            coding = tiff_module._ifd(data)[1].get(259, 1)
            assert coding in UNDEFINED_CODINGS, f"compression {coding} leaves bytes no decode writes"
    np.testing.assert_array_equal(got[defined], want[defined])
    return not defined.all()


def _pil_tiff(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _smooth(rng, h, w):
    low = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3), dtype=np.uint8)
    pix = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR)).astype(np.int64)
    return np.clip(pix + rng.integers(-8, 9, (h, w, 3)), 0, 255).astype(np.uint8)


SIZES = ((29, 37), (16, 16), (1, 1), (17, 3), (40, 70))  # (height, width)


# ---------------------------------------------------------------------------
# JPEG in TIFF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("samp", [(1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2)])
def test_jpeg_ycbcr_strips_and_tiles_match_pil(samp):
    """YCbCr JPEG strips and tiles at each subsampling: the tables in
    JPEGTables or in each stream, the subsampling tagged or taken from the
    first frame, strips of one, two and four MCU rows (the last short),
    tiles whose edges overhang."""
    rng = np.random.default_rng(samp[0] * 8 + samp[1])
    for h, w in SIZES:
        rgb = _smooth(rng, h, w)
        for tile in (None, (16, 16), (32, 16)):
            for tables in (True, False):
                for mcu_rows in ((1, 2, 4) if tile is None else (1,)):
                    for tagged in (True, False):
                        jpeg = dict(sampling=[samp, (1, 1), (1, 1)], quality=int(rng.integers(50, 96)),
                                    marker=("none", "jfif")[mcu_rows % 2], tables=tables)
                        data = write_tiff(rgb, 6, compression=7, jpeg=jpeg, tile=tile,
                                          rows_per_strip=8 * mcu_rows * samp[1],
                                          tags={530: (3, list(samp))} if tagged else {})
                        _same_as_pil(data, must_decode=True)


def test_jpeg_other_colour_spaces_as_libtiff_reads_them():
    """Grey, RGB and CMYK JPEG strips and tiles come out as their samples
    stand, whatever the stream's markers say (JFIF, Adobe RGB, CMYK or
    YCCK); a subsampled stream that is not YCbCr, a YCbCrSubsampling tag
    the frame disagrees with and a frame wider than its strip are refused,
    as libtiff refuses them."""
    rng = np.random.default_rng(1)
    for h, w in SIZES:
        rgb = _smooth(rng, h, w)
        cmyk = np.dstack([rgb, rgb[..., :1] // 2])
        cases = [(2, rgb, "adobe-rgb", [(1, 1)] * 3), (2, rgb, "jfif", [(1, 1)] * 3), (1, rgb[..., 0], "none", [(1, 1)]),
                 (5, cmyk, "adobe-cmyk", [(1, 1)] * 4), (5, cmyk, "adobe-ycck", [(1, 1)] * 4)]
        for photo, samples, marker, samp in cases:
            for tile in (None, (16, 16)):
                data = write_tiff(samples, photo, compression=7, jpeg=dict(sampling=samp, marker=marker), tile=tile,
                                  rows_per_strip=8)
                _same_as_pil(data, must_decode=True)
    rgb = _smooth(rng, 16, 16)
    refused = [write_tiff(rgb, 2, compression=7, jpeg=dict(sampling=[(2, 2), (1, 1), (1, 1)], marker="jfif")),
               write_tiff(rgb, 6, compression=7, jpeg=dict(sampling=[(2, 2), (1, 1), (1, 1)]),
                          tags={530: (3, [2, 1])}),
               write_tiff(rgb, 6, compression=7, bits=8, jpeg=dict(sampling=[(1, 1)] * 3), tags={256: (4, [8])})]
    for data in refused:
        assert _pil(data) is None
        with pytest.raises(ValueError, match=r"^t\.jpg: "):
            decode_image(data, "t.jpg")


def test_jpeg_in_separate_planes_as_libtiff():
    """JPEG planes one component each: RGB as its samples stand; YCbCr
    through libtiff's RGBA interface, which reads separate planes only at
    1x1 subsampling (the tag's default, 2x2, refused as PIL refuses it)."""
    rng = np.random.default_rng(12)
    for h, w in ((16, 16), (29, 37), (8, 3)):
        rgb = _smooth(rng, h, w)
        for photo in (6, 2):
            for tags in ({}, {530: (3, [1, 1])}, {530: (3, [2, 2])}):
                _same_as_pil(write_tiff(rgb, photo, compression=7, planar=2, rows_per_strip=8, tags=tags,
                                        jpeg=dict(sampling=[(1, 1)], marker="none")),
                             must_decode=photo == 2 or tags.get(530) == (3, [1, 1]))


@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK", "YCbCr", "RGBA", "LAB"])
def test_pil_written_jpeg_in_tiff_matches_pil(mode):
    """PIL's own JPEG-in-TIFF files (libtiff's encoder) at several sizes
    and qualities."""
    rng = np.random.default_rng(len(mode))
    for h, w in ((29, 37), (178, 218), (5, 3), (64, 64)):
        img = Image.fromarray(_smooth(rng, h, w)).convert(mode)
        _same_as_pil(_pil_tiff(img, compression="jpeg", quality=int(rng.integers(40, 96))), must_decode=True)


# ---------------------------------------------------------------------------
# YCbCr
# ---------------------------------------------------------------------------

def _rational(vals):
    out = []
    for v in vals:
        den = 1000
        out += [int(round(v * den)), den]
    return 5, out


@pytest.mark.parametrize("samp", [(1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4), (2, 4)])
def test_ycbcr_through_libtiffs_rgba_interface_matches_pil(samp):
    """Subsampled YCbCr blocks under LZW, Deflate, PackBits and LZMA in
    strips and tiles, with the tags TIFFYCbCrToRGBInit reads (and a
    subsampling TIFFRGBAImage has no reader for, 2x4, refused as PIL
    refuses it)."""
    rng = np.random.default_rng(samp[0] * 8 + samp[1])
    extras = ({}, {529: _rational([0.2126, 0.7152, 0.0722])}, {532: _rational([16, 235, 128, 240, 128, 240])},
              {531: (3, [2])}, {274: (3, [3])}, {274: (3, [6])})
    for h, w in SIZES:
        ycc = rgb_to_ycbcr(rng.integers(0, 256, (h, w, 3)))
        for comp in (5, 8, 32773, 34925):
            for tile in (None, (16, 16)):
                for extra in extras:
                    data = write_tiff(ycc, 6, compression=comp, ycbcr=samp, tile=tile, rows_per_strip=4 * samp[1],
                                      tags={530: (3, list(samp)), **extra})
                    _same_as_pil(data)


def test_ycbcr_planes_predictor_and_refusals_as_pil():
    """YCbCr in separate planes (read at 1x1; refused subsampled), predictor
    2 over the blocks, and what PIL refuses: uncompressed YCbCr in PIL's
    own layout ("image file is truncated"), one-sample YCbCr under a
    codec."""
    rng = np.random.default_rng(2)
    for h, w in SIZES:
        ycc = rgb_to_ycbcr(rng.integers(0, 256, (h, w, 3)))
        for comp in (5, 8):
            _same_as_pil(write_tiff(ycc, 6, compression=comp, planar=2, rows_per_strip=5, tags={530: (3, [1, 1])}))
            _same_as_pil(write_tiff(ycc, 6, compression=comp, planar=2, rows_per_strip=5, tags={530: (3, [2, 2])}))
            _same_as_pil(write_tiff(ycc, 6, compression=comp, predictor=2, ycbcr=(1, 1), rows_per_strip=5,
                                    tags={530: (3, [1, 1])}))
            _same_as_pil(write_tiff(ycc, 6, compression=comp, predictor=2, ycbcr=(2, 2), rows_per_strip=6,
                                    tags={530: (3, [2, 2])}))
    img = Image.fromarray(_smooth(rng, 20, 30))
    for data in (_pil_tiff(img.convert("YCbCr")), write_tiff(rgb_to_ycbcr(np.asarray(img))[..., 0], 6,
                                                            compression=5)):
        assert _pil(data) is None
        with pytest.raises(ValueError, match=r"^y\.png: "):
            decode_image(data, "y.png")
    for comp in ("tiff_lzw", "tiff_adobe_deflate", "packbits", "lzma", "zstd"):
        _same_as_pil(_pil_tiff(img.convert("YCbCr"), compression=comp), must_decode=True)


# ---------------------------------------------------------------------------
# CCITT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp, t4", [(2, 0), (32771, 0), (3, 0), (3, 4), (3, 1), (3, 5), (4, 0)])
def test_ccitt_matches_pil(comp, t4):
    """Modified Huffman, word-aligned modified Huffman, T.4 1-D and 2-D
    (T4Options bits 0 and 2; a 1-D row every 1, 2 or 4 rows) and T.6, in
    MinIsWhite and MinIsBlack, fill order 1 and 2, strips and tiles."""
    rng = np.random.default_rng(comp + t4)
    for h, w in SIZES:
        bits = (rng.random((h, w)) < 0.3).astype(np.int64)
        if w > 5:
            bits[h // 2:] = (np.arange(w) // 5) % 2
        for photo in (0, 1):
            for fill in (1, 2):
                for tile in (None, (16, 16)):
                    for k in ((1, 2, 4) if t4 & 1 else (2,)):
                        data = write_tiff(bits, photo, bits=1, compression=comp, t4_options=t4, fill_order=fill,
                                          tile=tile, rows_per_strip=7, fax_k=k)
                        _same_as_pil(data)


def test_pil_written_ccitt_matches_pil():
    """PIL's own CCITT files (libtiff's encoders: modified Huffman, Group 3
    1-D, Group 4 and the word-aligned form) at several sizes."""
    rng = np.random.default_rng(3)
    for h, w in ((29, 37), (218, 178), (5, 3), (64, 64), (1, 300)):
        img = Image.fromarray(rng.random((h, w)) < 0.5) if w < 100 else Image.fromarray(
            _smooth(rng, h, w)).convert("1")
        for comp in ("tiff_ccitt", "group3", "group4", "tiff_raw_16"):
            _same_as_pil(_pil_tiff(img, compression=comp))


def test_ccitt_corrupt_codes_as_libtiff():
    """Bad code words end their row and the decode goes on; data that ends
    before the last row is refused in strips (and taken as decoded in
    tiles, where TIFFReadTile takes the codec's -1 for success); Group 4
    stops early without a fault once a row is out; a CCITT image of more
    than one bit a sample is refused."""
    rng = np.random.default_rng(4)
    bits = (rng.random((24, 40)) < 0.3).astype(np.int64)
    for comp, t4 in ((2, 0), (32771, 0), (3, 0), (3, 1), (4, 0)):
        for tile in (None, (16, 16)):
            good = write_tiff(bits, 0, bits=1, compression=comp, t4_options=t4, tile=tile, rows_per_strip=24)
            for _ in range(12):
                d = bytearray(good)
                for _ in range(int(rng.integers(1, 4))):
                    d[8 + int(rng.integers(40))] = int(rng.integers(256))
                _same_as_pil(bytes(d))
            _same_as_pil(good[:len(good) // 2])
    refused = write_tiff(bits * 200, 1, bits=8, compression=4, strips=[b"\x00" * 40], rows_per_strip=24)
    assert _pil(refused) is None
    with pytest.raises(ValueError, match=r"^c\.png: "):
        decode_image(refused, "c.png")


# ---------------------------------------------------------------------------
# LZMA and Zstandard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["lzma", "zstd"])
def test_pil_written_lzma_and_zstd_match_pil(comp):
    """PIL's LZMA and Zstandard files at every mode PIL writes, one and
    several blocks a strip, predictor 2."""
    rng = np.random.default_rng(len(comp))
    for mode in ("1", "L", "RGB", "CMYK", "RGBA", "LAB", "I;16"):
        for h, w in ((29, 37), (218, 178), (5, 3)):
            img = Image.fromarray(_smooth(rng, h, w))
            img = img.convert("L").point(lambda v: v * 200) .convert("I;16") if mode == "I;16" else img.convert(mode)
            for strip_size, pred in ((65536, 1), (400000, 2), (3000, 1)):
                info = {317: pred} if pred != 1 and mode not in ("1",) else {}
                _same_as_pil(_pil_tiff(img, compression=comp, strip_size=strip_size, tiffinfo=info),
                             must_decode=True)


def _zstd_frame(blocks, checksum=False, content_size=None):
    """A Zstandard frame of raw ("raw", bytes) and RLE ("rle", byte, n)
    blocks, single segment where the content size is given."""
    fhd, header = 0, b""
    if content_size is not None:
        fhd |= 0x20 | (2 << 6)
        header = struct.pack("<L", content_size)
    else:
        header = bytes([10 << 3])  # a window of 2^20
    if checksum:
        fhd |= 4
    out = struct.pack("<LB", 0xFD2FB528, fhd) + header
    for i, block in enumerate(blocks):
        last = i == len(blocks) - 1
        if block[0] == "raw":
            out += struct.pack("<L", last | 0 << 1 | len(block[1]) << 3)[:3] + block[1]
        else:
            out += struct.pack("<L", last | 1 << 1 | block[2] << 3)[:3] + bytes([block[1]])
    return out


def test_zstd_frames_and_blocks_as_libzstd():
    """Hand-made frames: raw and RLE blocks, a skippable frame first, a
    frame content size that disagrees, a reserved block type, a frame that
    ends before the strip is full, and data past the frame."""
    rng = np.random.default_rng(5)
    w, h = 9, 4
    rows = rng.integers(0, 256, (h, w * 3), dtype=np.uint8).tobytes()
    n = len(rows)
    good = _zstd_frame([("raw", rows[:10]), ("rle", 7, 5), ("raw", rows[15:])])
    cases = [good, b"\x50\x2a\x4d\x18" + struct.pack("<L", 3) + b"abc" + good, good + b"trailing",
             _zstd_frame([("raw", rows)], content_size=n), _zstd_frame([("raw", rows)], content_size=n + 1),
             _zstd_frame([("raw", rows[:20])]), good[:-4], good[:6] + bytes([good[6] | 6]) + good[7:]]
    for data in cases:
        _same_as_pil(write_tiff(np.zeros((h, w, 3), np.uint8), 2, compression=50000, rows_per_strip=h,
                                strips=[data]))


def test_lzma_writer_with_predictor_matches_pil():
    """The writer's LZMA strips (an .xz stream each), predictor 1 and 2,
    strips and tiles; a stream cut short is refused."""
    rng = np.random.default_rng(6)
    for h, w in SIZES:
        rgb = _smooth(rng, h, w)
        for pred in (1, 2):
            for tile in (None, (16, 16)):
                _same_as_pil(write_tiff(rgb, 2, compression=34925, predictor=pred, tile=tile, rows_per_strip=5),
                             must_decode=True)
    rgb = _smooth(rng, 8, 8)
    cut = write_tiff(rgb, 2, compression=34925, strips=[lzma.compress(rgb.tobytes(), lzma.FORMAT_XZ)[:-30]],
                     rows_per_strip=8)
    _same_as_pil(cut)


# ---------------------------------------------------------------------------
# CIELab
# ---------------------------------------------------------------------------

def test_unxz_faults_as_libtiff_and_names_a_missing_liblzma(monkeypatch):
    """`data/xz.py` over the system's liblzma: a whole stream fills the
    strip; a stream cut short leaves it not full; a fault met in the call
    that fills the strip (here the stream's footer) goes unnoticed, as in
    libtiff, where the standard library's `lzma` raises (so it cannot stand
    in); PIL reads that strip too. Where liblzma cannot be loaded, the
    decode raises OSError naming it."""
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 4, (8, 8, 3), dtype=np.uint8)
    raw = rgb.tobytes()
    packed = lzma.compress(raw, lzma.FORMAT_XZ)
    for stream, full in ((packed, True), (packed[:len(packed) // 2], False), (packed[:-2] + b"XX", True)):
        out = np.zeros(len(raw), np.uint8)
        assert xz.unxz(stream, len(raw), out) == full
        if full:
            assert out.tobytes() == raw
    with pytest.raises(lzma.LZMAError):
        lzma.decompress(packed[:-2] + b"XX", lzma.FORMAT_XZ)
    data = write_tiff(rgb, 2, compression=34925, strips=[packed[:-2] + b"XX"], rows_per_strip=8)
    _same_as_pil(data, must_decode=True)
    np.testing.assert_array_equal(decode_image(data, "f.png"), rgb)
    monkeypatch.setattr(xz, "_lib", [])
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: "libno_such_lzma.so.0")
    with pytest.raises(OSError, match="liblzma"):
        xz.unxz(packed, len(raw), np.zeros(len(raw), np.uint8))


def test_cielab_conversion_matches_pil_on_2_20_inputs():
    """`cielab.lab_to_rgb` equals PIL's LAB to RGB (LittleCMS) on 2^20
    random (L, a*, b*) triples, the grid's corners and extremes among them."""
    rng = np.random.default_rng(7)
    lab = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    lab[0, :8] = [[0, 0, 0], [255, 0, 0], [255, 127, 127], [255, 128, 128], [0, 128, 128], [128, 0, 0],
                  [100, 255, 255], [50, 10, 10]]
    want = np.asarray(Image.frombytes("LAB", (1024, 1024), lab.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(lab_to_rgb(lab), want)


def test_cielab_tiffs_match_pil():
    """CIELab TIFFs (a* and b* signed) uncompressed, LZW, Deflate, PackBits,
    JPEG and LZMA, contiguous and planar, strips and tiles; PIL's own."""
    rng = np.random.default_rng(8)
    for h, w in SIZES:
        lab = rng.integers(0, 256, (h, w, 3))
        for comp in (1, 5, 8, 32773, 34925):
            for planar in (1, 2):
                for tile in (None, (16, 16)):
                    _same_as_pil(write_tiff(lab, 8, compression=comp, planar=planar, tile=tile, rows_per_strip=3),
                                 must_decode=True)
        img = Image.fromarray(_smooth(rng, h, w)).convert("LAB")
        for comp in ("raw", "tiff_lzw", "jpeg", "zstd"):
            _same_as_pil(_pil_tiff(img, compression=comp), must_decode=True)


# ---------------------------------------------------------------------------
# ThunderScan, pre-5.0 LZW, old-style JPEG
# ---------------------------------------------------------------------------

def test_thunderscan_matches_pil():
    """The writer's ThunderScan files (runs, 2- and 3-bit deltas, raw
    values) in MinIsBlack and MinIsWhite, fill order 1 and 2; and 600
    random code streams, which libtiff decodes or refuses ("Not enough" or
    "Too much data")."""
    rng = np.random.default_rng(9)
    for h, w in SIZES + ((218, 178),):
        s4 = rng.integers(0, 16, (h, w))
        s4[:, :w // 2] = 5
        for photo in (0, 1):
            for fill in (1, 2):
                _same_as_pil(write_tiff(s4, photo, bits=4, compression=32809, rows_per_strip=5, fill_order=fill),
                             must_decode=True)
    for trial in range(600):
        w, h = int(rng.integers(1, 12)), int(rng.integers(1, 4))
        codes = bytes(rng.integers(0, 256, int(rng.integers(1, 20))).tolist())
        if trial % 3 == 0:
            codes = bytes(c & 0x47 if c < 0x80 else c for c in codes)
        _same_as_pil(write_tiff(np.zeros((h, w), np.int64), 1, bits=4, compression=32809, rows_per_strip=h,
                                strips=[codes]))
    refused = write_tiff(np.zeros((4, 4), np.int64), 1, bits=8, compression=32809, strips=[b"\xc1" * 16])
    assert _pil(refused) is None
    with pytest.raises(ValueError, match=r"^t\.png: "):
        decode_image(refused, "t.png")


def test_pre_5_0_lzw_matches_pil():
    """The pre-5.0 LZW codes (LSB first, widened one code later) at every
    width change and past a full table, predictor 1 and 2, strips and
    tiles; corrupt codes refused as libtiff refuses them."""
    rng = np.random.default_rng(10)
    for h, w in SIZES + ((218, 178),):
        rgb = rng.integers(0, 256, (h, w, 3)) // 40 * 40
        for pred in (1, 2):
            for tile in (None, (16, 16)):
                _same_as_pil(write_tiff(rgb, 2, compression=5, old_lzw=True, predictor=pred, tile=tile,
                                        rows_per_strip=9), must_decode=True)
    good = write_tiff(rgb, 2, compression=5, old_lzw=True, rows_per_strip=h)
    for _ in range(20):
        d = bytearray(good)
        d[8 + int(rng.integers(2, 200))] = int(rng.integers(256))
        _same_as_pil(bytes(d))


@pytest.mark.parametrize("samp", [(1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4)])
def test_old_style_jpeg_matches_pil(samp):
    """Old-style JPEG: the stream through JPEGInterchangeFormat (the strip
    at the stream or at its scan data), the tables in tags; rows per strip
    below the height, as libtiff reads them."""
    rng = np.random.default_rng(samp[0] * 8 + samp[1] + 100)
    for h, w in ((16, 24), (17, 3), (1, 1), (40, 70)):
        rgb = _smooth(rng, h, w)
        for layout in ("whole", "split", "tags"):  # libjpeg refuses 4x4 (18 blocks an MCU, past its 10)
            _same_as_pil(write_ojpeg(rgb, samp, layout), must_decode=samp != (4, 4))
        stream = write_ojpeg(rgb, samp, "whole")
        for rps in (8, 16):
            d = bytearray(stream)
            _same_as_pil(bytes(d).replace(struct.pack("<HHLL", 278, 4, 1, h), struct.pack("<HHLL", 278, 4, 1, rps)))


# ---------------------------------------------------------------------------
# Refusals, fuzz, kinds, folders
# ---------------------------------------------------------------------------

def test_codings_pil_refuses_raise_value_error():
    """SGILog (34676, 34677) under PIL's modes and photometric 32844 and
    32845, WebP (50001: this libtiff lacks it), an old-style JPEG that is
    not YCbCr: ValueError naming the file, as PIL refuses them."""
    rng = np.random.default_rng(11)
    grey = rng.integers(0, 256, (8, 8))
    cases = [write_tiff(grey, 1, compression=34676, strips=[bytes(64)]),
             write_tiff(grey, 32844, compression=34676, strips=[bytes(64)]),
             write_tiff(np.dstack([grey] * 3), 32845, compression=34677, strips=[bytes(192)]),
             write_tiff(np.dstack([grey] * 3), 2, compression=50001, strips=[b"RIFF" + bytes(60)]),
             write_tiff(np.dstack([grey] * 3), 2, compression=6, strips=[bytes(64)])]
    for data in cases:
        assert _pil(data) is None
        with pytest.raises(ValueError, match=r"^r\.jpg: "):
            decode_image(data, "r.jpg")


def _fuzz_bases(rng):
    out = []
    for k in range(36):
        h, w = (int(v) for v in rng.integers(2, 24, 2))
        rgb = _smooth(rng, h, w)
        grey = rgb.astype(np.int64).sum(axis=2) // 3
        c = k % 12
        if c == 0:
            out.append(write_tiff(rgb, 6, compression=7, rows_per_strip=8 * (1 + k % 2),
                                  jpeg=dict(sampling=[((2, 2), (2, 1), (1, 1))[k % 3], (1, 1), (1, 1)]),
                                  tags={530: (3, list(((2, 2), (2, 1), (1, 1))[k % 3]))}))
        elif c == 1:
            out.append(write_tiff(rgb_to_ycbcr(rgb), 6, compression=(5, 8, 32773)[k % 3], ycbcr=(2, 2),
                                  rows_per_strip=4, tags={530: (3, [2, 2])}))
        elif c in (2, 3, 4):
            comp, t4 = ((2, 0), (3, 1), (4, 0), (32771, 0), (3, 4), (3, 0))[(c - 2) * 2 + k % 2]
            out.append(write_tiff((grey < 128).astype(np.int64), k % 2, bits=1, compression=comp, t4_options=t4,
                                  rows_per_strip=5, tile=(16, 16) if k % 5 == 0 else None))
        elif c == 5:
            out.append(write_tiff(rgb, 2, compression=34925, predictor=1 + k % 2, rows_per_strip=6))
        elif c == 6:
            out.append(_pil_tiff(Image.fromarray(rgb), compression="zstd"))
        elif c == 7:
            out.append(write_tiff(rgb, 8, compression=(1, 5)[k % 2], rows_per_strip=4))
        elif c == 8:
            out.append(write_tiff(grey >> 4, 1, bits=4, compression=32809, rows_per_strip=4))
        elif c == 9:
            out.append(write_tiff(rgb, 2, compression=5, old_lzw=True, rows_per_strip=4))
        elif c == 10:
            out.append(write_ojpeg(rgb, ((2, 2), (1, 1))[k % 2], ("whole", "tags")[k % 2]))
        else:
            out.append(_pil_tiff(Image.fromarray(rgb).convert(("L", "CMYK")[k % 2]), compression="jpeg"))
    return out


def _mutate(data: bytes, rng) -> bytes:
    """Image data bytes set to noise, the file cut, or a one-value SHORT or
    LONG entry set to a value PIL meets (the entry table's types and
    counts left alone, as tests/test_torch_port_gif_tiff_pnm.py says why)."""
    d = bytearray(data)
    kind = int(rng.integers(3))
    if kind == 1:
        return bytes(d[:rng.integers(1, len(d))])
    e = "<" if d[:2] == b"II" else ">"
    ifd = struct.unpack_from(e + "L", d, 4)[0]
    if kind == 0 and ifd > 8:
        for _ in range(rng.integers(1, 4)):
            d[8 + rng.integers(ifd - 8)] = rng.integers(256)
        return bytes(d)
    n = struct.unpack_from(e + "H", d, ifd)[0]
    at = ifd + 2 + 12 * int(rng.integers(n))
    tag, typ, count = struct.unpack_from(e + "HHL", d, at)
    if count == 1 and typ in (3, 4):
        v = int(rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 16, 255, 256, 32773, 65535, int(rng.integers(40))]))
        struct.pack_into(e + ("H" if typ == 3 else "L"), d, at + 8, v)
    return bytes(d)


@pytest.mark.parametrize("seed", range(8))
def test_corrupt_codings_as_pil(seed):
    """100 corrupt files a seed, drawn from small files of every coding:
    where PIL decodes one, the port's pixels equal PIL's; where PIL raises,
    the port raises ValueError naming the file. Few of them (a Group 4 or
    JPEG strip cut short) leave PIL's pixels partly undefined."""
    rng = np.random.default_rng(2300 + seed)
    bases = _fuzz_bases(rng)
    undefined = sum(_same_as_pil(_mutate(bases[int(rng.integers(len(bases)))], rng), name="f.jpg")
                    for _ in range(100))
    assert undefined <= 5, f"{undefined} of 100 corrupt files take undefined bytes from PIL's strip buffer"


SANITIZED = ("fax_decode", "zstd_decode", "lzw_decode", "jpeg_decode")
SANITIZED_FUZZ = """
import ctypes, sys
from damc_tpu_torch.data import _native_build, fax, jpeg, lzw, zstd
import test_torch_port_tiff_codings as t
for name, module in zip(t.SANITIZED, (fax, zstd, lzw, jpeg)):
    lib = ctypes.CDLL(f"{sys.argv[1]}/{name}.so")
    module._configure(lib)
    _native_build._loaded[name] = lib
for seed in range(8):
    t.test_corrupt_codings_as_pil(seed)
t.test_ccitt_corrupt_codes_as_libtiff()
t.test_zstd_frames_and_blocks_as_libzstd()
t.test_thunderscan_matches_pil()
t.test_pre_5_0_lzw_matches_pil()
print("fuzzed")
"""


def test_corrupt_codings_under_sanitizers(tmp_path):
    """The host libraries this module's codings run (Group 3 and 4 fax,
    Zstandard, LZW and ThunderScan, JPEG in TIFF) built with
    AddressSanitizer and UBSan, where any read or write out of bounds and
    any undefined operation stops the process, run the seeded fuzz (800
    files), the corrupt CCITT codes, the Zstandard frames, the random
    ThunderScan streams and the pre-5.0 LZW files in a child process, which
    must exit 0 (as tests/test_torch_port_webp.py does for JPEG and WebP)."""
    cxx = _native_build.compiler()[0]
    runtime = [subprocess.run([cxx, f"-print-file-name={name}"], capture_output=True, text=True, timeout=60).stdout.strip()
               for name in ("libasan.so", "libubsan.so")]
    if not all(os.path.isabs(path) for path in runtime):
        pytest.skip(f"{cxx} has no sanitizer runtime")
    flags = ["-O1", "-g", "-std=c++17", "-shared", "-fPIC", "-pthread", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=undefined"]
    builds = [subprocess.Popen([cxx, *flags, "-o", str(tmp_path / f"{name}.so"), str(_native_build.SRC_DIR / f"{name}.cpp")],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for name in SANITIZED]
    for build in builds:
        log, _ = build.communicate(timeout=600)
        assert build.returncode == 0, log
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LD_PRELOAD=":".join(runtime), ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", SANITIZED_FUZZ, str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.strip().endswith("fuzzed"), run.stdout


def _pil_kind(kind: str, pix: np.ndarray, k: int) -> bytes:
    """chip_smoke's Zstandard kind, which PIL writes: RGB, L or CMYK by
    turns, predictor 2 every other file."""
    img = Image.fromarray(pix).convert(("RGB", "L", "CMYK")[k % 3])
    return _pil_tiff(img, compression="zstd", tiffinfo={317: 2} if k % 2 else {})


@pytest.mark.parametrize("kind", TIFF_CODING_KINDS + ("tiff_zstd",))
def test_tiff_coding_kinds_match_pil(kind):
    """The TIFF coding kinds of chip_smoke's tree (`write_kind`, and PIL's
    Zstandard) at CelebA's 178x218 and at small sizes, each option of `k`."""
    rng = np.random.default_rng(len(kind) + 23)
    for k, (h, w) in enumerate([(218, 178), (12, 14), (3, 7), (12, 15), (9, 9), (20, 33)]):
        pix = _smooth(rng, h, w)
        data = _pil_kind(kind, pix, k) if kind == "tiff_zstd" else write_kind(kind, pix, k)
        want = _pil(data)
        assert want is not None and want.shape == (h, w, 3)
        np.testing.assert_array_equal(decode_image(data, kind + ".jpg"), want)


@pytest.mark.parametrize("size", [32, 48])
def test_misnamed_coding_folder_matches_jax(tmp_path, size):
    """A folder of every TIFF coding kind named .png and .jpg, beside a
    real PNG and JPEG: `load_image_folder` and `load_image_folder_cached`
    equal the JAX package's PIL reader exactly."""
    from damc_tpu.data import datasets as jax_datasets

    rng = np.random.default_rng(23)
    root = str(tmp_path / "tree")
    for k, kind in enumerate(TIFF_CODING_KINDS + ("tiff_zstd",) + TIFF_CODING_KINDS[::3]):
        h, w = (int(v) for v in rng.integers(30, 90, 2))
        pix = _smooth(rng, h, w)
        sub = os.path.join(root, "a" if k % 2 else os.path.join("b", "c"))
        os.makedirs(sub, exist_ok=True)
        data = _pil_kind(kind, pix, k) if kind == "tiff_zstd" else write_kind(kind, pix, k)
        with open(os.path.join(sub, f"{k:02d}_{kind}.{('png', 'jpg', 'JPG')[k % 3]}"), "wb") as f:
            f.write(data)
    img = Image.fromarray(_smooth(rng, 40, 50))
    img.save(os.path.join(root, "a", "real.png"))
    img.save(os.path.join(root, "a", "real.jpg"), quality=90)
    want = jax_datasets.load_image_folder(root, size)
    np.testing.assert_array_equal(datasets.load_image_folder(root, size), want)
    np.testing.assert_array_equal(datasets.load_image_folder_cached(root, size), want)
