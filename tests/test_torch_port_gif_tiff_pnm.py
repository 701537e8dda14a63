"""The port's GIF, TIFF and PNM decoders (`damc_tpu_torch/data/gif.py`,
`tiff.py`, `pnm.py`, with the LZW and PackBits of
`csrc/host/lzw_decode.cpp`) against PIL's `Image.open(...).convert("RGB")`,
exactly, on files named anything (PIL picks its reader by content, and so
does the port):

  * GIF: the first frame on the logical screen, filled with index 0 or the
    transparency index, global, local, grey-ramp and absent colour tables,
    indices past a table, interlace, minimum code sizes 0 to 12, clear codes
    mid-stream, a code table left full, odd sizes;
  * TIFF: every entry of PIL's OPEN_INFO table (photometric interpretation,
    sample format, fill order, bits, extra samples, byte order) under no
    compression, LZW, Deflate and PackBits, in strips and in tiles, planar
    configuration 1 and 2, predictor 2 and 3, BigTIFF, page 0 of several,
    the Orientation tag (which PIL's reader applies);
  * PNM: P1 to P6 at maxvals 1, 15, 255, 1000 and 65535, plain and raw,
    comments anywhere in the header;
  * what PIL refuses raises ValueError naming the file; a coding PIL reads
    that the port does not yet raises NotImplementedError naming the file
    and the coding;
  * a seeded fuzz of corrupt files: the port gives PIL's pixels where PIL
    decodes and raises where PIL raises. The TIFF fuzz corrupts the image
    data, cuts the file and sets entry values; it leaves the entry table's
    types and counts alone, since libtiff, which PIL hands a compressed
    TIFF, reads the directory again by rules of its own;
  * a folder of such files named .png and .jpg read by `load_image_folder`
    equals the JAX package's reader.

The files come from `tools/image_writer.py` (PIL writes few of these
layouts) and from PIL. The card's machine has Pillow 12.2.0, which the
port follows; where this machine's Pillow is older, the module's fixture
patches in 12.2.0's two differences for these formats. Only the folder
test imports the JAX package, so the rest runs on the card's machine too
(`-k "not folder" --noconftest`)."""

from __future__ import annotations

import io
import itertools
import os
import struct
import warnings
import zlib

import numpy as np
import PIL
import pytest
from PIL import Image, TiffImagePlugin

from damc_tpu_torch.data import datasets
from damc_tpu_torch.data.datasets import decode_image, image_kind
from damc_tpu_torch.data.gif import decode_gif
from damc_tpu_torch.data.pnm import decode_pnm
from damc_tpu_torch.data.tiff import OPEN_INFO, decode_tiff
from damc_tpu_torch.tools.image_writer import (GIF_TIFF_PNM_KINDS, gif_blocks, gif_lzw, tiff_lzw, write_gif, write_kind,
                                               write_pnm, write_tiff)

warnings.filterwarnings("ignore", module="PIL")


class _SetimageAs12_2:
    """A PIL decoder whose `setimage` refuses a tile of no pixels, as
    Pillow 12.2.0's does (12.1.0 took extents (0, y0, 0, y1) for the whole
    image)."""

    def __init__(self, decoder):
        self._decoder = decoder

    def setimage(self, im, extents=None):
        if extents is not None and (extents[2] <= extents[0] or extents[3] <= extents[1]):
            raise ValueError("Size must be positive")
        return self._decoder.setimage(im) if extents is None else self._decoder.setimage(im, extents)

    def __getattr__(self, name):
        return getattr(self._decoder, name)


def _tiff_tags_as_12_2(tags):
    """Pillow 12.2.0's reading of a TIFF's tags where 12.1.0's differs: a
    sample format the same for every sample is that one format (12.1.0:
    only when it is 1), and under planar configuration 2 unspecified extra
    samples are dropped from the bits, the sample count and ExtraSamples."""
    fmt = tags.get(TiffImagePlugin.SAMPLEFORMAT)
    if fmt and len(fmt) > 1 and max(fmt) == min(fmt):
        tags[TiffImagePlugin.SAMPLEFORMAT] = (fmt[0],)
    extra = tags.get(TiffImagePlugin.EXTRASAMPLES, ())
    if tags.get(TiffImagePlugin.PLANAR_CONFIGURATION, 1) == 2 and extra and max(extra) == 0 and (
            TiffImagePlugin.SAMPLESPERPIXEL in tags):
        bits = tags.get(TiffImagePlugin.BITSPERSAMPLE, (1,))
        tags[TiffImagePlugin.BITSPERSAMPLE] = bits[:-len(extra)]
        tags[TiffImagePlugin.SAMPLESPERPIXEL] = tags[TiffImagePlugin.SAMPLESPERPIXEL] - len(extra)
        del tags[TiffImagePlugin.EXTRASAMPLES]


@pytest.fixture(autouse=True, scope="module")
def _pil_as_on_the_card():
    """The card's machine has Pillow 12.2.0, which the port follows; on an
    older Pillow its two differences for these formats are patched in."""
    if tuple(int(v) for v in PIL.__version__.split(".")[:2]) >= (12, 2):
        yield
        return
    getdecoder, setup = Image._getdecoder, TiffImagePlugin.TiffImageFile._setup

    def setup_as_12_2(self):
        _tiff_tags_as_12_2(self.tag_v2)
        return setup(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Image, "_getdecoder", lambda *a, **k: _SetimageAs12_2(getdecoder(*a, **k)))
        mp.setattr(TiffImagePlugin.TiffImageFile, "_setup", setup_as_12_2)
        yield


def _pil(data: bytes):
    """PIL's RGB pixels of the file, or None where PIL raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # PIL raises OSError, ValueError, SyntaxError, EOFError, KeyError, ...
        return None


def _same_as_pil(data: bytes, decode=decode_image, name: str = "f.png", deferred: bool = False):
    """The port's decode of `data` equals PIL's, or both raise (the port's
    ValueError naming the file). With `deferred`, a NotImplementedError
    naming the file also passes (a coding the port does not read yet)."""
    want = _pil(data)
    try:
        got = decode(data, name)
    except NotImplementedError as e:
        assert deferred and str(e).startswith(f"{name}: "), e
        return
    except ValueError as e:
        assert want is None, f"PIL reads the file, the port raises: {e}"
        assert str(e).startswith(f"{name}: "), e
        return
    assert want is not None, "PIL raises, the port decodes"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


SIZES = ((1, 1), (1, 13), (11, 1), (2, 3), (7, 5), (9, 16), (17, 9))  # (height, width)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(13))
def test_gif_code_sizes_match_pil(bits):
    """Minimum code sizes 0 to 12 (PIL refuses 0 and 1, reads 2 to 12; past
    8 the indices are the codes' low bytes), at odd sizes, plain and
    interlaced, with clear codes every few codes."""
    rng = np.random.default_rng(bits)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    for (h, w), interlace, clear_every in itertools.product(SIZES, (False, True), (0, 3)):
        idx = rng.integers(0, max(1, min(1 << bits, 256)), (h, w))
        _same_as_pil(write_gif(idx, palette, bits=bits, interlace=interlace, clear_every=clear_every))


@pytest.mark.parametrize("case", ["full_table", "clear_every_1", "clear_every_50", "clear_at_4096", "blocks_of_7"])
def test_gif_code_table_matches_pil(case):
    """A 300x200 frame of 256 colours: the code table left full at 4,096
    entries with no clear code, clear codes every code or every 50, the
    usual clear when the table fills, sub-blocks of 7 bytes."""
    rng = np.random.default_rng(len(case))
    idx = rng.integers(0, 256, (300, 200))
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    kw = {"full_table": dict(full_table=True), "clear_every_1": dict(clear_every=1),
          "clear_every_50": dict(clear_every=50), "clear_at_4096": {}, "blocks_of_7": dict(block_size=7)}[case]
    data = write_gif(idx, palette, **kw)
    np.testing.assert_array_equal(decode_gif(data, "f.gif"), palette[idx])
    _same_as_pil(data)


def test_gif_screen_fill_as_pil():
    """A 2x2 frame at (1, 1) of a 5x4 screen whose background index is 2:
    PIL fills the screen with index 0, not the background; with a
    transparency index, with that index (its colour shows in RGB); a frame
    past the screen grows it; without a colour table, grey levels."""
    rng = np.random.default_rng(1)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (2, 2))
    plain = decode_gif(write_gif(idx, palette, screen=(5, 4), offset=(1, 1), background=2), "f.gif")
    assert (plain[0, 0] == palette[0]).all() and (plain[1:3, 1:3] == palette[idx]).all()
    clear = decode_gif(write_gif(idx, palette, screen=(5, 4), offset=(1, 1), transparency=5), "f.gif")
    assert (clear[3, 4] == palette[5]).all()
    for data in (write_gif(idx, palette, screen=(5, 4), offset=(1, 1), background=2),
                 write_gif(idx, palette, screen=(5, 4), offset=(1, 1), transparency=5),
                 write_gif(idx, palette, screen=(2, 2), offset=(1, 1)),
                 write_gif(idx, palette, screen=(3, 9), offset=(2, 8)),
                 write_gif(idx * 10, screen=(3, 3), offset=(1, 1), transparency=7),
                 write_gif(idx, palette, screen=(3, 3), offset=(0, 0))):
        _same_as_pil(data)
    assert decode_gif(write_gif(idx, palette, screen=(2, 2), offset=(1, 1)), "f.gif").shape == (3, 3, 3)


def test_gif_colour_tables_as_pil():
    """A local table overrides the global one; a grey-ramp table is no
    table to PIL (a grey-ramp local one falls back to the global table, and
    with no other table the indices are grey levels); an index past a
    short table is black."""
    rng = np.random.default_rng(2)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    ramp = np.repeat(np.arange(16)[:, None], 3, 1).astype(np.uint8)
    idx = rng.integers(0, 16, (5, 6))
    np.testing.assert_array_equal(decode_gif(write_gif(idx, palette, local_palette=palette[::-1]), "f.gif"),
                                  palette[::-1][idx])
    np.testing.assert_array_equal(decode_gif(write_gif(idx, palette[:4], bits=4), "f.gif"),
                                  np.where(idx[..., None] < 4, palette[np.minimum(idx, 3)], 0))
    cases = [write_gif(idx, palette, local_palette=palette[::-1]), write_gif(idx + 100, ramp, bits=8),
             write_gif(idx + 100, palette, local_palette=ramp, bits=8), write_gif(idx + 100, None, ramp, bits=8),
             write_gif(idx, palette[:4], bits=4), write_gif(idx, palette[:2], bits=4, interlace=True),
             write_gif(idx, ramp[:8], bits=4)]
    for data in cases:
        _same_as_pil(data)


def test_gif_extensions_and_refusals_as_pil():
    """Comment, application (NETSCAPE2.0) and unknown extensions and stray
    bytes before the frame are skipped as PIL skips them; a header, table,
    graphic control extension or descriptor cut short, no frame, a frame
    of no pixels, LZW data cut short or broken: PIL refuses the file and
    the port raises ValueError naming it."""
    rng = np.random.default_rng(3)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = rng.integers(0, 16, (6, 7))
    ext = (b"\x21\xfe" + gif_blocks(b"a comment") + b"\x21\xff\x0bNETSCAPE2.0" + gif_blocks(b"\x01\x00\x00")
           + b"\x21\x01" + gif_blocks(b"plain text") + b"\x00\x07")
    good = write_gif(idx, palette, extensions=ext, transparency=3)
    np.testing.assert_array_equal(decode_gif(good, "f.gif"), palette[idx])
    _same_as_pil(good)
    stream = gif_blocks(gif_lzw(idx, 4))
    cut = [good[:12], good[:13 + 20], good[:-len(stream) - 3], write_gif(idx, palette, data=stream[:-8]),
           write_gif(idx, palette, data=stream[:3]), write_gif(idx, palette, data=b"\x02\xff\xff\x00"),
           write_gif(idx, palette)[:-len(stream) - 11] + b";", b"GIF89a" + bytes(7) + b";",
           write_gif(idx, palette, data=gif_blocks(gif_lzw(idx, 4, end_code=False))[:-4]),
           write_gif(idx, palette, extensions=b"\x21\xf9\x02\x01\x00\x00")]
    for field in (5, 7):  # a frame of width or height 0 at (0, 0), which Pillow 12.1.0 read as the whole screen
        zero = bytearray(write_gif(idx, palette))
        at = zero.index(b",", 13 + 48)
        zero[at + field:at + field + 2] = bytes(2)
        cut.append(bytes(zero))
    for data in cut:
        assert _pil(data) is None
        with pytest.raises(ValueError, match=r"^the\.gif: "):
            decode_gif(data, "the.gif")


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def _samples(rng, key, h, w):
    order, photo, fmt, fill, bps, extra = key
    if fmt == (3,):
        s = rng.uniform(-20, 300, (h, w, len(bps))).astype(np.float32)
        s.flat[0] = 0.5
        return s
    top, shape = 1 << bps[0], (h, w, len(bps))
    return rng.integers(0, top, shape) if fmt == (1,) else rng.integers(-top // 2, top // 2, shape)


TIFF_KEYS = sorted((k for k in OPEN_INFO if k[1] not in (6, 8)), key=repr)


@pytest.mark.parametrize("key", TIFF_KEYS, ids=lambda k: "-".join(map(str, (k[0].decode(),) + k[1:4])) + "-"
                         + "x".join(map(str, k[4])) + "-e" + "".join(map(str, k[5])))
def test_tiff_open_info_matches_pil(key):
    """Every mode PIL opens a TIFF in (photometric 0, 1, 2, 3 and 5 at every
    depth, sample format, fill order, extra samples and byte order of
    OPEN_INFO): no compression, LZW, Deflate and PackBits, in strips of two
    rows and in 16x16 tiles whose edges overhang, planar configuration 1
    and 2, predictor 2 (and 3 for float) under LZW and Deflate."""
    order, photo, fmt, fill, bps, extra = key
    rng = np.random.default_rng(abs(hash(repr(key))) % 2 ** 32)
    for comp, planar, tiled, pred in itertools.product((1, 5, 8, 32773), (1, 2), (False, True), (1, 2, 3)):
        if (pred == 2 and comp not in (5, 8)) or (pred == 3 and (comp not in (5, 8) or fmt != (3,))):
            continue
        for h, w in ((5, 7), (17, 19)):
            cmap = rng.integers(0, 65536, (3, 1 << min(bps[0], 8))) if photo == 3 else None
            data = write_tiff(_samples(rng, key, h, w), photo, bits=bps[0], compression=comp, predictor=pred,
                              endian="<" if order == b"II" else ">", tile=(16, 16) if tiled else None,
                              rows_per_strip=2, planar=planar, extra_samples=extra, colormap=cmap, fill_order=fill,
                              sample_format=fmt[0])
            _same_as_pil(data, decode_tiff, "f.tif")


def test_tiff_conversions_as_pil():
    """The conversions of convert("RGB"): MinIsWhite inverted (0, 100, 255
    read 255, 155, 0); 2- and 4-bit grey scaled by 85 and 17; 12- and
    16-bit grey clamped (256 reads 255); 16-bit RGB cut to its high byte
    ((4660, 300, 65535) reads (18, 1, 255), 0x80FF reads 128); associated
    alpha un-premultiplied ((100, 50, 10, 128) reads (199, 99, 19));
    CMYK multiplied ((255, 228, 34, 121) reads (0, 14, 116)); colour map
    entries divided by 256; float truncated and clamped (0.5 reads 0)."""
    cmap = np.zeros((3, 16), np.int64)
    cmap[:, 1] = (0x80FF, 0x1234, 0xFFFF)
    cases = [
        (write_tiff(np.array([[0, 100, 255]]), 0), [255, 155, 0]),
        (write_tiff(np.array([[0, 1, 2, 3]]), 1, bits=2), [0, 85, 170, 255]),
        (write_tiff(np.array([[0, 1, 15, 7]]), 1, bits=4, compression=5), [0, 17, 255, 119]),
        (write_tiff(np.array([[1, 255, 256, 4095]]), 1, bits=12), [1, 255, 255, 255]),
        (write_tiff(np.array([[1, 255, 256, 65535]]), 1, bits=16, compression=8), [1, 255, 255, 255]),
        (write_tiff(np.array([[0.5, 1.5, 300.0, -2.0]], np.float32), 1, bits=32, sample_format=3), [0, 1, 255, 0]),
    ]
    for data, grey in cases:
        np.testing.assert_array_equal(decode_tiff(data, "f.tif")[0, :, 0], grey)
        _same_as_pil(data, decode_tiff, "f.tif")
    rgb16 = write_tiff(np.array([[[4660, 300, 65535], [0x80FF, 0, 0]]]), 2, bits=16, endian=">", compression=5)
    assoc = write_tiff(np.array([[[100, 50, 10, 128], [200, 10, 10, 100], [3, 2, 1, 0]]]), 2, extra_samples=[1])
    cmyk = write_tiff(np.array([[[255, 228, 34, 121]]]), 5, compression=32773)
    palette = write_tiff(np.array([[1, 0]]), 3, bits=4, colormap=cmap)
    for data, rgb in ((rgb16, [[18, 1, 255], [128, 0, 0]]), (assoc, [[199, 99, 19], [255, 25, 25], [0, 0, 0]]),
                      (cmyk, [[0, 14, 116]]), (palette, [[128, 18, 255], [0, 0, 0]])):
        np.testing.assert_array_equal(decode_tiff(data, "f.tif")[0], rgb)
        _same_as_pil(data, decode_tiff, "f.tif")


@pytest.mark.parametrize("orientation", range(10))
def test_tiff_orientation_as_pil(orientation):
    """PIL's TIFF reader transposes the loaded image by the Orientation tag
    (1 to 8; 0 and 9 leave it), or with no tag by an XMP packet's
    tiff:Orientation: strips and tiles, LZW and none."""
    rng = np.random.default_rng(orientation)
    rgb = rng.integers(0, 256, (6, 9, 3))
    xmp = b'<x:xmpmeta><rdf:Description tiff:Orientation="%d"/></x:xmpmeta>' % orientation
    for kw in (dict(compression=5), dict(tile=(16, 16))):
        _same_as_pil(write_tiff(rgb, 2, tags={274: (3, [orientation])}, **kw), decode_tiff, "f.tif")
        _same_as_pil(write_tiff(rgb, 2, tags={700: (1, list(xmp))}, **kw), decode_tiff, "f.tif")


def test_tiff_pages_bigtiff_and_byte_orders_as_pil(tmp_path):
    """Page 0 of a multi-page TIFF (PIL's writer, raw and LZW), a
    little-endian BigTIFF under every compression, classic files in both
    byte orders, RowsPerStrip past the height, fill order 2."""
    rng = np.random.default_rng(4)
    pages = [Image.fromarray(rng.integers(0, 256, (7 + i, 9, 3), dtype=np.uint8)) for i in range(3)]
    for compression in ("raw", "tiff_lzw", "packbits"):
        buf = io.BytesIO()
        pages[0].save(buf, "TIFF", save_all=True, append_images=pages[1:], compression=compression)
        np.testing.assert_array_equal(decode_tiff(buf.getvalue(), "f.tif"), np.asarray(pages[0]))
        _same_as_pil(buf.getvalue(), decode_tiff, "f.tif")
    rgb = rng.integers(0, 256, (11, 13, 3))
    for comp, endian, big, fill in itertools.product((1, 5, 8, 32773), "<>", (False, True), (1, 2)):
        data = write_tiff(rgb, 2, compression=comp, endian=endian, bigtiff=big, rows_per_strip=40, fill_order=fill)
        _same_as_pil(data, decode_tiff, "f.tif")


def test_tiff_strip_data_as_libtiff_reads_it():
    """Compressed strips as libtiff reads them (PIL hands it every
    compressed TIFF): Deflate cut before or inside its checksum, with a bad
    checksum, holding more or less than the strip, trailing bytes; LZW
    without its first clear code, cut short, holding more; a strip byte
    count of zero in a one-strip image (libtiff estimates it)."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (6, 9, 3))
    raw = rgb.astype(np.uint8).tobytes()
    z, lz = zlib.compress(raw), tiff_lzw(raw)
    strips = [z[:-k] for k in (1, 2, 4, 5, 8)] + [z[:-1] + bytes([z[-1] ^ 1]), zlib.compress(raw + b"xyz"),
                                                  zlib.compress(raw[:-3]), z + b"junk"]
    for s in strips:
        _same_as_pil(write_tiff(rgb, 2, compression=8, rows_per_strip=6, strips=[s]), decode_tiff, "f.tif")
    for s in [lz[1:], lz[:-1], lz[:-5], tiff_lzw(raw + b"abc"), b"\x80" + bytes(20)]:
        _same_as_pil(write_tiff(rgb, 2, compression=5, rows_per_strip=6, strips=[s]), decode_tiff, "f.tif")
    for comp in (5, 8):
        data = write_tiff(rgb, 2, compression=comp, rows_per_strip=6, tags={279: (4, [0])})
        _same_as_pil(data, decode_tiff, "f.tif")


def test_tiff_deferred_codings_raise_not_implemented():
    """The TIFF codings this module once found deferred (JPEG and CCITT
    Group 4 from PIL's writer, YCbCr and CIELab, data opening as the
    pre-5.0 LZW codes do, Zstandard) raise NotImplementedError no more:
    each decodes as PIL does, or raises ValueError naming the file where
    PIL refuses it (tests/test_torch_port_tiff_codings.py holds each
    coding to PIL in full)."""
    rng = np.random.default_rng(6)
    img = Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    files = {}
    for name, image, kw in (("jpeg", img, dict(compression="jpeg")), ("group4", img.convert("1"),
                                                                      dict(compression="group4")),
                            ("ycbcr", img.convert("YCbCr"), {}), ("lab", img.convert("LAB"), {})):
        buf = io.BytesIO()
        image.save(buf, "TIFF", **kw)
        files[name] = buf.getvalue()
    rgb = np.asarray(img)
    files["old_lzw"] = write_tiff(rgb, 2, compression=5, rows_per_strip=16, strips=[b"\x00\x01" + bytes(40)])
    files["zstd"] = write_tiff(rgb, 2, compression=50000, rows_per_strip=16, strips=[bytes(40)])
    for name, data in files.items():
        _same_as_pil(data, name=f"{name}.png")
    assert all(_pil(files[name]) is not None for name in ("jpeg", "group4", "lab"))


def test_tiff_refusals_name_the_file():
    """What PIL refuses (no first IFD, no dimensions, a mode outside
    OPEN_INFO, predictor 2 at 4 bits, a strip past the file's end, an
    unknown compression) raises ValueError naming the file."""
    rgb = np.random.default_rng(7).integers(0, 256, (4, 5, 3))
    good = write_tiff(rgb, 2, compression=5)
    cases = [good[:4] + bytes(4), write_tiff(rgb, 2, tags={256: (4, [0])}), write_tiff(rgb[..., :2], 2),
             write_tiff(rgb[..., 0] >> 4, 1, bits=4, compression=5, predictor=2), good[:20],
             write_tiff(rgb, 2, compression=7777), write_tiff(rgb, 2, bits=8, tags={258: (3, [5, 5, 5])})]
    for data in cases:
        assert _pil(data) is None
        with pytest.raises(ValueError, match=r"^t\.jpg: "):
            decode_image(data, "t.jpg")


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("magic", ["P1", "P2", "P3", "P4", "P5", "P6"])
def test_pnm_matches_pil(magic):
    """Each magic number at maxvals 1, 15, 255, 1000 and 65535 (scaled by
    round(v / maxval * 255); grey past 255 through PIL's 32-bit mode,
    clamped), at the SIZES, with and without comments in the header."""
    rng = np.random.default_rng(int(magic[1]))
    channels = 3 if magic in ("P3", "P6") else 1
    for maxval, (h, w), comment in itertools.product((1, 15, 255, 1000, 65535), SIZES, (b"", b" a # comment")):
        top = 2 if magic in ("P1", "P4") else maxval + 1
        samples = rng.integers(0, top, (h, w, channels))
        _same_as_pil(write_pnm(samples if channels == 3 else samples[..., 0], magic, maxval, comment), name="f.jpg")
    assert decode_pnm(b"P5 2 1 15 \x07\x0f", "f")[0, :, 0].tolist() == [119, 255]
    assert decode_pnm(b"P5\n2 1\n1000\n" + np.array([500, 1000], ">u2").tobytes(), "f")[0, :, 0].tolist() == [255] * 2
    p6 = b"P6 2 1 65535 " + np.array([4660, 300, 65535, 0x80FF, 0, 0], ">u2").tobytes()
    assert decode_pnm(p6, "f").tolist() == [[[18, 1, 255], [128, 0, 0]]]


PNM_HEADERS = [
    b"P5\n#x\n2\n1\n255\n\x07\x0f", b"P6 1 1 255\r\x01\x02\x03", b"P2 2 1 15 7 8 9 x", b"P2 2 1 15 7 #c\n 8",
    b"P1 3 1 1#c\n0 1", b"P5 01 1 255 \x05", b"P5 +1 1 255 \x05", b"P5 1 1 1_0 \x05", b"P5 1 1 255 \x05\x06",
    b"P6 1 1 1000 " + bytes(6), b"P3 1 1 65535 65535 0 300",
]
PNM_REFUSED = [
    b"P5 1#c\n2 1 255 \x07\x0f\x01\x02", b"P2 2 1 15 7#c\n8", b"P1 3 1 102", b"P7 1 1 255 x", b"P5 2 1 255 \x07",
    b"P5 2 1 15 \x07", b"P2 2 1 15 7 16", b"P2 2 1 15 -1 3", b"P2 2 1 15 7 8 99999999999", b"P1 3 1 1 0 x",
    b"P5 1 1 0 \x00", b"P5 1 1 65536 \x00\x00", b"P5 0 1 255 ", b"P5 1 1 255", b"P5 1 1", b"P5",
    b"P6 1 1 1000 " + bytes(5), b"P3 1 1 255 1 2",
]
PNM_DEFERRED = [b"Pf 2 2 1 " + np.array([1.5, 2.5, 300, -3], ">f4").tobytes(), b"P0CMYK 1 1 255 \x07\x01\x02\x03",
                b"PyRGBA 1 1 255 \x07\x01\x02\x03", b"PyP 1 1 255 \x07", b"PyCMYK 1 1 100 \x07\x01\x02\x03"]


@pytest.mark.parametrize("data", PNM_HEADERS + PNM_REFUSED, ids=lambda d: repr(d[:24]))
def test_pnm_headers_and_refusals_as_pil(data):
    """Headers PIL reads (comments that do not end a token, signs and
    underscores in numbers) decode as PIL does; what PIL refuses (P7, a
    short file, a sample past maxval, maxval out of range, a zero size, a
    header cut short) raises naming the file."""
    assert (_pil(data) is None) == (data in PNM_REFUSED)
    _same_as_pil(data, name="p.png")


@pytest.mark.parametrize("data", PNM_DEFERRED, ids=lambda d: repr(d[:6]))
def test_pnm_variants_not_read_yet_raise(data):
    """PIL's other Pbmplus variants (PFM, P0CMYK and the Py test formats),
    which PIL reads, raise NotImplementedError naming the file and the
    format."""
    assert _pil(data) is not None
    with pytest.raises(NotImplementedError, match=r"^p\.png: PIL reads this (PFM|PPM extension) file"):
        decode_image(data, "p.png")


# ---------------------------------------------------------------------------
# Fuzz, kinds, folders
# ---------------------------------------------------------------------------

def _fuzz_bases(rng):
    gifs, tiffs, pnms = [], [], []
    for k in range(12):
        h, w = (int(v) for v in rng.integers(1, 20, 2))
        palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
        gifs.append(write_gif(rng.integers(0, 16, (h, w)), palette if k % 3 else None, local_palette=palette
                              if k % 4 == 1 else None, interlace=k % 2 == 1, transparency=k if k % 3 == 2 else None,
                              clear_every=5 if k % 5 == 0 else 0))
    for k in range(30):
        h, w = (int(v) for v in rng.integers(1, 20, 2))
        photo = (1, 2, 3, 5, 0)[k % 5]
        c = {1: 1, 2: 3, 3: 1, 5: 4, 0: 1}[photo]
        bits = {1: (1, 2, 4, 8, 12, 16)[k % 6], 2: (8, 16)[k % 2], 3: (4, 8)[k % 2], 5: 8, 0: (1, 4, 8)[k % 3]}[photo]
        comp = (1, 5, 8, 32773)[k % 4]
        cmap = rng.integers(0, 65536, (3, 1 << bits)) if photo == 3 else None
        tiffs.append(write_tiff(rng.integers(0, 1 << bits, (h, w, c)), photo, bits=bits, compression=comp,
                                predictor=2 if comp in (5, 8) and bits in (8, 16) and k % 3 == 0 else 1,
                                colormap=cmap, endian=">" if k % 7 == 0 and bits != 12 else "<",
                                tile=(16, 16) if k % 5 == 1 else None, rows_per_strip=3,
                                planar=2 if c > 1 and k % 3 == 1 else 1))
    for magic, maxval in itertools.product(("P1", "P2", "P3", "P4", "P5", "P6"), (1, 255, 1000)):
        h, w = (int(v) for v in rng.integers(1, 9, 2))
        c = 3 if magic in ("P3", "P6") else 1
        s = rng.integers(0, 2 if magic in ("P1", "P4") else maxval + 1, (h, w, c))
        pnms.append(write_pnm(s if c == 3 else s[..., 0], magic, maxval, b"c" if maxval == 1 else b""))
    return gifs, tiffs, pnms


def _mutate(data: bytes, fmt: str, rng) -> bytes:
    """GIF and PNM: bytes set to noise or to their format's delimiters, or
    the file cut. TIFF: image data bytes set to noise, the file cut, or a
    one-value SHORT or LONG entry set to a value PIL meets."""
    d = bytearray(data)
    kind = int(rng.integers(3))
    if kind == 1:
        return bytes(d[:rng.integers(1, len(d))])
    if fmt == "tiff":
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
            v = int(rng.choice([0, 1, 2, 3, 4, 5, 8, 16, 255, 256, 32773, 65535, int(rng.integers(40))]))
            struct.pack_into(e + ("H" if typ == 3 else "L"), d, at + 8, v)
        return bytes(d)
    marks = {"gif": [0, 1, 0x21, 0x2C, 0x3B, 0xF9, 255], "pnm": [32, 10, 35, 48, 49, 57]}[fmt]
    for _ in range(rng.integers(1, 4)):
        d[rng.integers(len(d))] = int(rng.choice(marks + [int(rng.integers(256))]))
    return bytes(d)


@pytest.mark.parametrize("seed", range(16))
def test_corrupt_files_as_pil(seed):
    """150 corrupt files a seed, drawn from small GIF, TIFF and PNM files of
    many layouts: where PIL decodes one, the port's pixels equal PIL's;
    where PIL raises, the port raises ValueError naming the file (or, for
    a TIFF coding it does not read yet, NotImplementedError)."""
    rng = np.random.default_rng(2000 + seed)
    bases = dict(zip(("gif", "tiff", "pnm"), _fuzz_bases(rng)))
    for _ in range(150):
        fmt = ("gif", "tiff", "pnm")[int(rng.integers(3))]
        data = _mutate(bases[fmt][int(rng.integers(len(bases[fmt])))], fmt, rng)
        if data[:4] in (b"II*\x00", b"MM\x00*"):
            _same_as_pil(data, name="f.jpg", deferred=True)
        elif data[:1] in b"GP":
            _same_as_pil(data, name="f.jpg")


@pytest.mark.parametrize("kind", GIF_TIFF_PNM_KINDS)
def test_gif_tiff_pnm_kinds_match_pil(kind):
    """The GIF, TIFF and PNM kinds of chip_smoke's tree (`write_kind`) at
    CelebA's 178x218 and at small sizes, each option of `k`."""
    rng = np.random.default_rng(len(kind))
    for k, (h, w) in enumerate([(218, 178), (12, 14), (3, 7), (12, 15), (9, 9), (20, 33)]):
        pix = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = write_kind(kind, pix, k)
        want = _pil(data)
        assert want is not None and want.shape == (h, w, 3)
        np.testing.assert_array_equal(decode_image(data, kind + ".jpg"), want)


def test_deferred_formats_raise_naming_the_format():
    """Formats PIL opens by content: those the port now reads (QOI, ICO,
    PCX, SGI, ICNS; `data/formats.py`) decode equal to PIL's, whatever the
    file's name; those it does not read yet raise NotImplementedError from
    `image_kind`, naming the file and PIL's format; what no format of PIL's
    takes raises ValueError naming the file."""
    rng = np.random.default_rng(8)
    img = Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    for fmt in ("QOI", "ICO", "PCX", "SGI", "ICNS"):
        buf = io.BytesIO()
        img.save(buf, fmt)
        want = _pil(buf.getvalue())
        assert want is not None and image_kind(buf.getvalue(), "x.png") == fmt.lower()
        np.testing.assert_array_equal(decode_image(buf.getvalue(), "x.png"), want)
    for fmt, mode in (("DDS", "RGB"), ("IM", "RGB"), ("DIB", "RGB"), ("BLP", "P"), ("XBM", "1")):
        buf = io.BytesIO()
        img.convert(mode).save(buf, fmt)
        assert _pil(buf.getvalue()) is not None
        with pytest.raises(NotImplementedError, match=rf"^x\.png: PIL reads this {fmt} file"):
            image_kind(buf.getvalue(), "x.png")
    with pytest.raises(ValueError, match=r"^x\.png: no format of PIL's takes this file"):
        image_kind(b"hello world!", "x.png")


def _misnamed_tree(root: str, rng) -> int:
    """Every GIF, TIFF and PNM kind named .png or .jpg (as such files reach
    the JAX reader), at sizes around CelebA's, beside a real PNG and JPEG;
    returns the file count."""
    n = 0
    for k, kind in enumerate(GIF_TIFF_PNM_KINDS + GIF_TIFF_PNM_KINDS[::3]):
        w, h = int(rng.integers(30, 90)), int(rng.integers(30, 90))
        low = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
        pix = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR))
        sub = os.path.join(root, "a" if k % 2 else os.path.join("b", "c"))
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, f"{k:02d}_{kind}.{('png', 'jpg', 'JPG')[k % 3]}"), "wb") as f:
            f.write(write_kind(kind, pix, k))
        n += 1
    img = Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8))
    img.save(os.path.join(root, "a", "real.png"))
    img.save(os.path.join(root, "a", "real.jpg"), quality=90)
    return n + 2


@pytest.mark.parametrize("size, batch_bytes", [(32, datasets.BATCH_BYTES), (48, 20000)])
def test_misnamed_folder_matches_jax(tmp_path, monkeypatch, size, batch_bytes):
    """A folder of GIF, TIFF and PNM files named .png and .jpg:
    `load_image_folder` and `load_image_folder_cached` equal the JAX
    package's PIL reader exactly, in one batch and in many."""
    from damc_tpu.data import datasets as jax_datasets

    root = str(tmp_path / "tree")
    n = _misnamed_tree(root, np.random.default_rng(22))
    monkeypatch.setattr(datasets, "BATCH_BYTES", batch_bytes)
    want = jax_datasets.load_image_folder(root, size)
    assert want.shape == (n, size, size, 3)
    np.testing.assert_array_equal(datasets.load_image_folder(root, size), want)
    np.testing.assert_array_equal(datasets.load_image_folder_cached(root, size), want)


def test_folder_with_a_deferred_format_raises_before_decoding(tmp_path, monkeypatch):
    """A DDS file (a format the port does not read yet) named .png in a
    folder raises NotImplementedError naming it from its probe, before any
    file is decoded."""
    root = tmp_path / "tree"
    root.mkdir()
    for k, kind in enumerate(("gif_global", "tiff_lzw_pred2", "pnm_p6")):
        (root / f"{k}.png").write_bytes(write_kind(kind, np.zeros((9, 9, 3), np.uint8), k))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, "DDS")
    (root / "z.png").write_bytes(buf.getvalue())
    calls = []
    monkeypatch.setitem(datasets.SINGLE_DECODERS, "gif", lambda d, p: calls.append(p))
    with pytest.raises(NotImplementedError, match=r"z\.png: PIL reads this DDS file"):
        datasets.load_image_folder(str(root), 8)
    assert calls == []
