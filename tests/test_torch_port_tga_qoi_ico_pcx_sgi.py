"""PIL's open order as the port's format table (`damc_tpu_torch/data/
formats.py`) and the decoders it brought (`data/tga.py`, `qoi.py`,
`ico.py`, `icns.py`, `pcx.py`, `sgi.py`, with the loops of
`csrc/host/rle_decode.cpp`) against PIL's `Image.open(...).convert("RGB")`,
exactly, on files named anything:

  * the table's order equals PIL's `Image.ID`;
  * TGA of image types 1, 2, 3, 9, 10 and 11 at every depth and colour-map
    depth, each orientation, id sections, run-length packets across rows,
    and the (type, depth) pairs PIL opens but cannot load; QOI through
    every op; ICO and CUR with PNG and 1- to 32-bit bitmap frames and
    masks; ICNS PNG and packed entries with masks; PCX at every depth and
    plane count, PIL's stride rule and box; DCX; SGI verbatim and
    run-length at 8 and 16 bits, 1, 3 and 4 channels;
  * the order's cases: a truecolour TGA with CUR's magic decodes as TGA;
    MSP, SUN, PSD, DDS, BLP and SPIDER files raise NotImplementedError
    naming PIL's format; an IM header that does not begin "Image type" is
    IM; a file no format takes raises ValueError naming it;
  * a seeded fuzz of cut and corrupt files of every new kind: the port
    gives PIL's pixels where PIL decodes (whatever format PIL then reads
    the file as) and raises where PIL raises;
  * a folder of the new kinds named .png and .jpg read by
    `load_image_folder` and `load_image_folder_cached`, and LSUN records of
    the new kinds, equal the JAX package's readers.

PIL reads each file here by its path, as the JAX folder reader does. The
card's machine has Pillow 12.2.0, which the port follows; on an older
Pillow the module's fixture patches in 12.2.0's one difference for these
formats (its TGA reader seeks 26 bytes before the end of an RGBA file).
Only the folder and LSUN tests import the JAX package, so the rest runs
on the card's machine too (`-k "not folder and not lsun" --noconftest`)."""

from __future__ import annotations

import io
import os
import struct
import tempfile
import warnings

import subprocess
import sys

import numpy as np
import PIL
import pytest
from PIL import Image

Image.preinit()  # PIL's own order first: a plugin imported before these goes to the front of Image.ID
Image.init()
from PIL import TgaImagePlugin  # noqa: E402

from damc_tpu_torch.data import _native_build, datasets, formats  # noqa: E402
from damc_tpu_torch.data.datasets import decode_image, image_kind  # noqa: E402
from damc_tpu_torch.tools.image_writer import (ORDER_KINDS, RLE4, RLE8, icns_pack, icns_rgb, icon_bitmap,  # noqa: E402
                                               qoi_file, write_bmp, write_dcx, write_icns, write_icon, write_kind,
                                               write_pcx, write_png, write_qoi, write_sgi, write_tga)

warnings.filterwarnings("ignore", module="PIL")
PIL_12_2 = tuple(int(v) for v in PIL.__version__.split(".")[:2]) >= (12, 2)


@pytest.fixture(autouse=True, scope="module")
def _pil_as_on_the_card():
    """Pillow 12.2.0's TGA reader looks for the TGA 2.0 footer 26 bytes
    before the end of an RGBA file (`load_end`), which fails on a shorter
    file opened by path; on an older Pillow that seek is patched in."""
    if PIL_12_2:
        yield
        return
    load_end = TgaImagePlugin.TgaImageFile.load_end

    def load_end_as_12_2(self):
        if self.mode == "RGBA":
            self.fp.seek(-26, os.SEEK_END)
        return load_end(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TgaImagePlugin.TgaImageFile, "load_end", load_end_as_12_2)
        yield


_TMP = tempfile.mkdtemp(prefix="pil_order_")


def _open(data: bytes):
    """(PIL's format, RGB pixels) of the file opened by its path, or
    (the error, None)."""
    path = os.path.join(_TMP, f"f{os.getpid()}.png")
    with open(path, "wb") as f:
        f.write(data)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(path) as im:
                fmt = im.format
                return fmt, np.asarray(im.convert("RGB"))
    except Exception as e:  # PIL raises OSError, ValueError, SyntaxError, EOFError, KeyError, ...
        return e, None


def _opened_as(data: bytes):
    """PIL's format for the file, or None where `Image.open` fails."""
    path = os.path.join(_TMP, f"g{os.getpid()}.png")
    with open(path, "wb") as f:
        f.write(data)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(path) as im:
                return im.format
    except Exception:
        return None


# The checks the port's PNG decoder keeps where PIL does not look (a chunk cut or a CRC broken after the
# image data: `test_torch_port_png_bmp.py::test_png_cut_after_its_image_data_raises`), met by the PNG
# frames of ICO and ICNS files
PNG_CHECKS = ("truncated b'", "CRC mismatch in the b'", "truncated PNG (no IEND chunk)")


def _same_as_pil(data: bytes, name: str = "f.png"):
    """The port's decode equals PIL's, or both raise (the port's
    ValueError naming the file); a NotImplementedError names the format
    PIL opens the file as."""
    fmt, want = _open(data)
    try:
        got = decode_image(data, name)
    except NotImplementedError as e:
        opened = _opened_as(data)
        assert opened is None or opened.replace("JPEG2000", "JPEG 2000") in str(e) or opened == "ICNS", (opened, e)
        assert str(e).startswith(f"{name}: "), e
        assert opened is not None or not isinstance(fmt, Image.UnidentifiedImageError), e
        return
    except ValueError as e:
        assert want is None or (fmt in ("ICO", "ICNS") and any(c in str(e) for c in PNG_CHECKS)), (
            f"PIL reads the file as {fmt}, the port raises: {e}")
        assert str(e).startswith(f"{name}: "), e
        return
    assert want is not None, f"PIL raises {fmt!r}, the port decodes"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pixels(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


SIZES = ((1, 1), (1, 13), (11, 1), (2, 3), (7, 5), (9, 16), (17, 9))  # (height, width)


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

def test_order_is_pils_image_id():
    """`formats.ORDER` lists PIL's formats in `Image.ID`'s order after
    `Image.open`'s preinit and init in a fresh interpreter (a plugin
    imported first goes to the front). FPX and MIC, PIL's olefile formats,
    are absent where olefile is; 12.1.0 and 12.2.0 list the same formats,
    and 12.2.0 tries the plugin of the file's extension first (here, only
    formats whose accept tests no other format's first bytes pass)."""
    code = "from PIL import Image; Image.preinit(); Image.init(); print(' '.join(Image.ID))"
    ids = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout.split()
    ids = [i for i in ids if i not in ("FPX", "MIC")]
    assert [f.name for f in formats.ORDER] == ids
    assert {f.outcome for f in formats.ORDER} == {formats.DECODE, formats.TODO, formats.STUB}
    decoded = {f.kind for f in formats.ORDER if f.outcome == formats.DECODE}
    assert decoded == {"bmp", "gif", "jpeg", "pnm", "png", "cur", "pcx", "dcx", "icns", "ico", "tiff", "qoi", "sgi",
                       "tga", "webp"}


def test_source_reads_only_what_the_probes_ask(tmp_path):
    """The folder reader's first pass: a `Source` over a file reads its
    head and then only the ranges asked for; a PCD probe at 2048 and a PCX
    palette at the end read past the head."""
    data = bytes(range(256)) * 40
    (tmp_path / "f").write_bytes(data)
    src = formats.Source(path=str(tmp_path / "f"))
    assert len(src) == len(data) and src[:16] == data[:16] and src[5000:5010] == data[5000:5010]
    assert src[len(data) - 3:len(data) + 5] == data[-3:] and src[20000:20004] == b""
    src.close()
    assert formats.Source(data)[3:9] == data[3:9]


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

def _tga_pixels(rng, image_type, depth, h, w, entries=256):
    if depth == 1:
        return rng.integers(0, 2, (h, w))
    if depth == 8:
        return rng.integers(0, entries, (h, w))
    if depth == 16:
        return rng.integers(0, 1 << 16, (h, w))
    return _pixels(rng, h, w, depth // 8)


@pytest.mark.parametrize("image_type", [1, 2, 3, 9, 10, 11])
@pytest.mark.parametrize("depth", [1, 8, 16, 24, 32])
@pytest.mark.parametrize("cmap", [None, 16, 24, 32])
def test_tga_types_depths_and_maps_as_pil(image_type, depth, cmap):
    """Every image type at every depth, without a colour map and with one
    of 16, 24 and 32 bits: PIL's pixels, or its refusal (the pairs outside
    its MODES, a colour-mapped type without a map, a map on a truecolour
    or 1-bit image, a 32-bit map, 1-bit run-length data)."""
    rng = np.random.default_rng(image_type * 100 + depth + (cmap or 0))
    for k, (h, w) in enumerate(SIZES):
        first = k % 3 * 5
        colormap = rng.integers(0, 256, (40, 3)) if cmap else None
        pix = _tga_pixels(rng, image_type, depth, h, w, 48)
        data = write_tga(pix, image_type, depth, colormap, cmap or 24, first, orientation=(0, 0x20, 0x10, 0x30)[k % 4],
                         ident=b"x" * (k % 3))
        _same_as_pil(data)


@pytest.mark.parametrize("orientation", [0, 0x10, 0x20, 0x30])
@pytest.mark.parametrize("image_type", [2, 10])
def test_tga_orientation_as_pil(orientation, image_type):
    """Bottom-up, top-down and right-to-left rows (the left-right flip PIL
    applies in `load_end`), raw and run-length, at 16, 24 and 32 bits."""
    rng = np.random.default_rng(orientation + image_type)
    for depth in (16, 24, 32):
        for h, w in ((5, 7), (12, 3), (30, 31)):
            pix = _tga_pixels(rng, image_type, depth, h, w)
            if depth > 8:
                pix = np.repeat(pix, 3, axis=1)[:, :w]  # runs
            data = write_tga(pix, image_type, depth, orientation=orientation)
            fmt, want = _open(data)
            assert fmt == "TGA"
            np.testing.assert_array_equal(decode_image(data, "t.jpg"), want)


def test_tga_run_length_packets_as_pil():
    """A literal packet that runs on into the next rows reads as PIL reads
    it; a run that crosses a row's end is PIL's buffer overrun; a packet cut
    by the file's end, and 1-bit run-length data, never finish."""
    rng = np.random.default_rng(3)
    for h, w in ((3, 4), (6, 2), (1, 9), (4, 1)):
        pix = _pixels(rng, h, w)
        rows = pix[::-1, :, ::-1].reshape(h, -1)
        hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24, 0)
        flat = rows.reshape(-1, 3)
        lit = b"".join(bytes((min(127, len(flat) - i - 1),)) + flat[i:i + 128].tobytes()
                       for i in range(0, len(flat), 128))
        _same_as_pil(hdr + lit)
        fmt, want = _open(hdr + lit)
        assert fmt == "TGA" and want is not None
        run = bytes((0x80 | (w * h - 1),)) + b"\x01\x02\x03"
        _same_as_pil(hdr + run)
        _same_as_pil(hdr + lit[:-1])
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, 10, 2, 1, 0)
    for body in (bytes((0x81, 0xFF, 0x01, 0x0F, 0xF0)), bytes((0x83, 0xAA)) * 8):
        _same_as_pil(hdr + body)
    data = write_tga(rng.integers(0, 3, (9, 20)) * 80, 11, 8, cross_rows=False)
    _same_as_pil(data)


def test_tga_with_cur_magic_decodes_as_tga():
    """F3: an uncompressed truecolour TGA starts 00 00 02 00, CUR's magic.
    PIL's CUR open falls through (no entry, or a bitmap it cannot read) and
    TGA, 38th of its formats, opens the file; so does the port."""
    rng = np.random.default_rng(4)
    for depth in (16, 24, 32):
        for h, w in ((3, 4), (40, 33)):
            data = write_tga(_tga_pixels(rng, 2, depth, h, w), 2, depth)
            assert data[:4] == b"\x00\x00\x02\x00"
            fmt, want = _open(data)
            assert fmt == "TGA"
            assert image_kind(data, "a.png") == "tga"
            np.testing.assert_array_equal(decode_image(data, "a.png"), want)
    data = write_tga(_tga_pixels(rng, 10, 24, 5, 5), 10, 24)
    assert data[:4] == b"\x00\x00\x0a\x00" and image_kind(data, "b.png") == "tga"


def test_tga_colour_map_first_index_and_size_as_pil():
    """Indices below the map's first index and past its end are black;
    a map of more than 256 entries in all is refused; a 16-bit map is
    5-5-5 BGR, each field v * 255 // 31."""
    rng = np.random.default_rng(5)
    for first, n in ((0, 256), (10, 246), (10, 247), (250, 10), (3, 2), (0, 300)):
        pix = rng.integers(0, 256, (6, 7))
        for map_depth in (16, 24):
            _same_as_pil(write_tga(pix, 1, 8, rng.integers(0, 256, (n, 3)), map_depth, first))
    words = np.arange(1 << 16).reshape(256, 256)
    data = write_tga(words, 2, 16)
    np.testing.assert_array_equal(decode_image(data, "w.png"), _open(data)[1])


def test_tga_rgba_shorter_than_the_footer_as_pil_12_2():
    """Pillow 12.2.0 seeks 26 bytes before the end of an RGBA TGA for the
    TGA 2.0 footer: a file opened by path that is shorter fails."""
    for depth, w in ((16, 1), (16, 3), (32, 1), (32, 2), (24, 1)):
        data = write_tga(np.full((1, w, 3) if depth == 24 else (1, w) if depth == 16 else (1, w, 4), 7), 2, depth)
        _same_as_pil(data)
        assert (_open(data)[1] is None) == (depth != 24 and len(data) < 26)


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_qoi_as_pil(channels):
    """PIL-written and port-written QOI files (every op: RGB, RGBA, INDEX,
    DIFF, LUMA, RUN), and op streams PIL reads oddly: an index never
    written (black, alpha 0), a run past the last pixel, a channel count
    other than 3 (RGBA), a stream that stops early."""
    rng = np.random.default_rng(channels)
    for h, w in SIZES + ((40, 50),):
        base = rng.integers(0, 256, (max(h // 3, 1), max(w // 3, 1), 4), dtype=np.uint8)
        pix = np.resize(np.repeat(np.repeat(base, 3, 0), 3, 1), (h, w, 4))
        pix[..., :3] += rng.integers(0, 3, (h, w, 3), dtype=np.uint8)
        _same_as_pil(write_qoi(pix[..., :channels], channels))
        buf = io.BytesIO()
        Image.fromarray(pix if channels == 4 else pix[..., :3]).save(buf, "QOI")
        _same_as_pil(buf.getvalue())
    for ops in (bytes((5, 0xFE, 1, 2, 3, 0x40 | 0x3F, 0x80 | 40, 0x9A, 0xC3)), bytes((0xFF, 9, 8, 7, 6, 0xFD)),
                bytes((0xFE, 1, 2, 3, 0xDF)), bytes((0xFE, 1, 2)), bytes((0x80 | 33,))):
        for ch in (3, 4, 0, 7):
            _same_as_pil(qoi_file(3, 2, ch, ops))


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------

def _bitmap_frame(rng, bits, h, w, with_mask=True, header=40):
    if bits <= 8:
        pix = rng.integers(0, 1 << bits, (h, w))
        palette = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
    elif bits == 16:
        pix, palette = rng.integers(0, 1 << 15, (h, w)), None
    else:
        pix, palette = _pixels(rng, h, w), None
    mask = rng.integers(0, 2, (h, w)) if with_mask else None
    return icon_bitmap(pix, bits, palette, mask, header)


@pytest.mark.parametrize("bits", [1, 4, 8, 16, 24, 32])
@pytest.mark.parametrize("cursor", [False, True])
def test_icon_bitmap_frames_as_pil(bits, cursor):
    """ICO and CUR files of bitmap frames at every depth, with AND masks
    (cut short: PIL fails at any depth but 32, whose alpha it reads from
    the pixels), one entry or several (PIL's ICO takes the largest, then
    the shallowest; its CUR the first or a wider and taller one)."""
    rng = np.random.default_rng(bits + 100 * cursor)
    for k, (h, w) in enumerate(SIZES + ((33, 40), (64, 64))):
        frame = (_bitmap_frame(rng, bits, h, w, header=(40, 124, 12)[k % 3] if bits <= 24 else 40), w, h, bits, 0)
        other = (_bitmap_frame(rng, 4, 8, 8), 8, 8, 4, 16)
        frames = [frame, other] if k % 2 else [other, frame]
        _same_as_pil(write_icon(frames, cursor=cursor))
        data = write_icon([frame], cursor=cursor)
        _same_as_pil(data)
        _same_as_pil(data[:-3])


@pytest.mark.parametrize("bits", [4, 8])
def test_icon_run_length_bitmap_frames_as_pil(bits):
    """ICO frames of RLE4 and RLE8 bitmaps: PIL's run-length reader over
    the image's half of the doubled height, the mask after the runs."""
    rng = np.random.default_rng(30 + bits)
    for h, w in ((5, 7), (16, 16), (9, 30)):
        idx = rng.integers(0, 1 << bits, (h, w))
        idx[:, ::3] = idx[:, :1]
        palette = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        dib = bytearray(write_bmp(idx, bits, palette, compression={4: RLE4, 8: RLE8}[bits])[14:])
        struct.pack_into("<i", dib, 8, 2 * h)
        mask = (w + 31) // 32 * 4 * h
        data = write_icon([(bytes(dib) + bytes(mask), w, h, bits, 0)])
        fmt, want = _open(data)
        assert fmt == "ICO" and want is not None
        np.testing.assert_array_equal(decode_image(data, "r.png"), want)
        _same_as_pil(data[:-mask])  # the mask cut off: PIL refuses


def test_ico_png_frames_and_pils_own_icons():
    """ICO files with PNG frames (the port's PNG decoder), PIL-written ICO
    files of PNG and of bitmap frames, and an entry order PIL sorts."""
    rng = np.random.default_rng(11)
    for mode in ("RGB", "RGBA", "P", "L"):
        img = Image.fromarray(_pixels(rng, 40, 48)).convert(mode)
        for kw in ({}, {"bitmap_format": "bmp"}, {"sizes": [(16, 16), (32, 32), (40, 48)]}):
            buf = io.BytesIO()
            img.save(buf, "ICO", **kw)
            fmt, want = _open(buf.getvalue())
            assert fmt == "ICO"
            np.testing.assert_array_equal(decode_image(buf.getvalue(), "i.png"), want)
    pngs = [(write_png(_pixels(rng, h, w), 2, 8), w, h, 32, 0) for h, w in ((16, 16), (24, 24), (20, 30))]
    bmp = (_bitmap_frame(rng, 8, 24, 24), 24, 24, 8, 0)
    for frames in (pngs, pngs[::-1], pngs + [bmp], [bmp] + pngs[:2]):
        _same_as_pil(write_icon(frames))


def test_cur_entry_choice_and_offsets_as_pil():
    """PIL's CUR open takes an entry wider and taller than the first; an
    entry offset of 0 reads the bitmap right after the directory; an empty
    directory or a bitmap of one row falls through (here to TGA, which
    refuses these files too)."""
    rng = np.random.default_rng(12)
    a = (_bitmap_frame(rng, 24, 6, 5), 5, 6, 24, 0)
    b = (_bitmap_frame(rng, 8, 9, 8), 8, 9, 8, 0)
    c = (_bitmap_frame(rng, 4, 9, 4), 4, 9, 4, 0)
    for frames in ([a, b], [b, a], [a, c], [c, a, b]):
        _same_as_pil(write_icon(frames, cursor=True))
    data = bytearray(write_icon([a], cursor=True))
    struct.pack_into("<I", data, 18, 0)
    _same_as_pil(bytes(data))
    _same_as_pil(struct.pack("<HHH", 0, 2, 0) + bytes(30))
    _same_as_pil(write_icon([(_bitmap_frame(rng, 24, 1, 5), 5, 1, 24, 0)], cursor=True))


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------

def test_icns_packed_entries_and_masks_as_pil():
    """is32, il32, ih32 and it32 packed (or, at exactly 3 x size bytes,
    interleaved) with their masks; PIL loads the largest size; a mask or
    channel cut short, a bad it32 signature and runs that overshoot a
    channel are refused as PIL refuses them."""
    rng = np.random.default_rng(13)
    entries = {16: (b"is32", b"s8mk"), 32: (b"il32", b"l8mk"), 48: (b"ih32", b"h8mk"), 128: (b"it32", b"t8mk")}
    for side, (rgb_type, mask_type) in entries.items():
        base = rng.integers(0, 256, (side // 4, side // 4, 3), dtype=np.uint8)
        pix = np.repeat(np.repeat(base, 4, 0), 4, 1)
        pix[::3] = rng.integers(0, 256, pix[::3].shape, dtype=np.uint8)
        for packed in (True, False):
            body = icns_rgb(pix, packed, it32=rgb_type == b"it32")
            for mask in (bytes(side * side), bytes(side * side - 1), None):
                items = [(rgb_type, body)] + ([(mask_type, mask)] if mask is not None else [])
                _same_as_pil(write_icns(items))
                _same_as_pil(write_icns(items + [(b"is32", icns_rgb(pix[:16, :16]))]))
    channel = bytes(range(256)) * 3
    assert icns_pack(channel) != channel
    _same_as_pil(write_icns([(b"is32", b"\x00\x00\x00\x00" + icns_rgb(np.zeros((16, 16, 3), np.uint8)))]))
    _same_as_pil(write_icns([(b"it32", b"\x01\x02\x03\x04" + icns_rgb(np.zeros((128, 128, 3), np.uint8)))]))
    _same_as_pil(write_icns([(b"is32", bytes((0xFF, 1)) * 3)]))
    _same_as_pil(write_icns([(b"s8mk", bytes(256))]))


def test_icns_png_entries_and_jpeg2000_as_pil():
    """PNG entries at their sizes and at a whole fraction of one; a PNG of
    a size that fits none is refused as PIL's size check refuses it; a
    PIL-written ICNS; a JPEG 2000 entry raises NotImplementedError naming
    JPEG 2000 (ROADMAP queue 3), where PIL decodes it."""
    rng = np.random.default_rng(14)
    for kind, side, png_side in ((b"icp4", 16, 16), (b"ic07", 128, 128), (b"ic07", 128, 64), (b"ic08", 256, 100),
                                 (b"icp5", 32, 32), (b"ic12", 32, 64)):
        png = write_png(_pixels(rng, png_side, png_side), 2, 8)
        _same_as_pil(write_icns([(kind, png)]))
        _same_as_pil(write_icns([(kind, png), (b"il32", icns_rgb(_pixels(rng, 32, 32))), (b"l8mk", bytes(1024))]))
    buf = io.BytesIO()
    Image.fromarray(_pixels(rng, 16, 16)).save(buf, "ICNS")
    fmt, want = _open(buf.getvalue())
    assert fmt == "ICNS"
    np.testing.assert_array_equal(decode_image(buf.getvalue(), "n.png"), want)
    j2k = io.BytesIO()
    Image.fromarray(_pixels(rng, 32, 32)).save(j2k, "JPEG2000")
    data = write_icns([(b"icp5", j2k.getvalue())])
    assert _open(data)[1] is not None
    with pytest.raises(NotImplementedError, match=r"^n\.jpg: .*JPEG 2000"):
        decode_image(data, "n.jpg")


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits, planes", [(1, 1), (1, 2), (1, 4), (8, 1), (8, 3)])
def test_pcx_depths_strides_and_boxes_as_pil(bits, planes):
    """1 bit at 1, 2 and 4 planes with the header's palette; 8 bits with
    and without the 769-byte palette (a grey ramp: grey levels); 24 bits as
    3 planes; the stride the header gives odd, even or wrong (PIL's stride
    rule, and its plane moves that misread narrow RGB rows as PIL does);
    the box from xmin and ymin."""
    rng = np.random.default_rng(bits * 10 + planes)
    for k, (h, w) in enumerate(SIZES + ((20, 33), (3, 64))):
        plane = (w * bits + 7) // 8
        for stride in (plane, plane + plane % 2, plane + 2):
            if bits == 8 and planes == 3:
                pix = _pixels(rng, h, w)
            else:
                pix = rng.integers(0, 1 << (bits * planes if bits == 1 else 8), (h, w))
            palette = rng.integers(0, 256, (16, 3))
            vga = rng.integers(0, 256, (256, 3)) if k % 3 else np.repeat(np.arange(256)[:, None], 3, axis=1)
            data = write_pcx(pix, bits, planes, palette, vga if bits == 8 and planes == 1 and k % 4 else None,
                             stride=stride, origin=(k % 3, k % 4))
            _same_as_pil(data)
            _same_as_pil(data[:-2])


def test_pcx_refusals_and_pils_own_files():
    """PIL-written PCX (1, L, P, RGB); an unknown bits/planes pair, a
    version below 5 at 8 bits and an empty box; runs past a row's end."""
    rng = np.random.default_rng(15)
    img = Image.fromarray(_pixels(rng, 30, 41))
    for mode in ("1", "L", "P", "RGB"):
        buf = io.BytesIO()
        img.convert(mode).save(buf, "PCX")
        fmt, want = _open(buf.getvalue())
        assert fmt == "PCX"
        np.testing.assert_array_equal(decode_image(buf.getvalue(), "p.jpg"), want)
    good = write_pcx(_pixels(rng, 4, 6), 8, 3)
    for at, value in ((3, 2), (65, 2), (1, 3), (1, 0), (8, 0), (8, 255), (10, 0), (5, 9)):
        d = bytearray(good)
        d[at] = value
        _same_as_pil(bytes(d))
    _same_as_pil(good[:128] + bytes((0xFF, 7)) * 20)


def test_dcx_first_page_as_pil():
    """DCX files of one and of two pages (PIL reads the first), a
    directory cut short or empty, a page offset past the file."""
    rng = np.random.default_rng(16)
    pages = [write_pcx(_pixels(rng, 9, 11), 8, 3), write_pcx(rng.integers(0, 2, (5, 17)), 1, 1)]
    for p in (pages, pages[::-1], pages[:1]):
        data = write_dcx(p)
        fmt, want = _open(data)
        assert fmt == "DCX"
        np.testing.assert_array_equal(decode_image(data, "d.png"), want)
    _same_as_pil(write_dcx(pages)[:10])
    _same_as_pil(struct.pack("<II", 0x3ADE68B1, 0) + pages[0])
    _same_as_pil(struct.pack("<III", 0x3ADE68B1, 9999, 0) + pages[0])


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("rle", [False, True])
def test_sgi_as_pil(bpc, channels, rle):
    """Verbatim and run-length SGI at 1 and 2 bytes a sample (2: the high
    byte kept), 1, 3 and 4 channels, dimension 1 or 2 for grey; files cut
    short."""
    rng = np.random.default_rng(bpc * 100 + channels * 10 + rle)
    for k, (h, w) in enumerate(SIZES + ((30, 41),)):
        base = rng.integers(0, 1 << (8 * bpc), (h, max(w // 3, 1), channels))
        s = np.resize(np.repeat(base, 3, axis=1), (h, w, channels))
        data = write_sgi(s[..., 0] if channels == 1 else s, bpc, rle, dimension=(1, 2)[k % 2] if channels == 1 else 3)
        fmt, want = _open(data)
        assert fmt == "SGI"
        np.testing.assert_array_equal(decode_image(data, "s.jpg"), want)
        _same_as_pil(data[:-1])
    img = Image.fromarray(_pixels(rng, 13, 17))
    for mode in ("L", "RGB", "RGBA"):
        buf = io.BytesIO()
        img.convert(mode).save(buf, "SGI")
        _same_as_pil(buf.getvalue())


def test_sgi_refused_modes_and_run_tables_as_pil():
    """Modes outside PIL's table (2 channels; dimension 3 with 1 channel;
    3 bytes a sample) and storage other than 0 or 1 raise as PIL raises;
    run tables pointing into the header or past the file, and a row whose
    chunk count ends on a non-zero chunk (PIL ends the image there, the
    rows after it black), as PIL reads them."""
    rng = np.random.default_rng(17)
    good = write_sgi(_pixels(rng, 6, 5), 1, rle=True)
    for at, fmt, value in ((3, "B", 3), (5, "B", 2), (11, "B", 2), (2, "B", 2), (4, ">H", 3), (10, ">H", 1)):
        d = bytearray(good)
        struct.pack_into(fmt, d, at, value)
        _same_as_pil(bytes(d))
    n = 6 * 3
    for row in (0, 3, 17):
        for field, value in ((0, 100), (0, 10**6), (1, 1), (1, 0), (1, 10**6)):
            d = bytearray(good)
            struct.pack_into(">I", d, 512 + 4 * (row + field * n), value)
            _same_as_pil(bytes(d))


# ---------------------------------------------------------------------------
# The order's cases
# ---------------------------------------------------------------------------

def _sun(rng):
    pix = rng.integers(0, 256, (5, 6), dtype=np.uint8)
    return struct.pack(">8I", 0x59A66A95, 6, 5, 8, 30, 1, 0, 0) + pix.tobytes()


def _psd(rng):
    pix = rng.integers(0, 256, (3, 4, 5), dtype=np.uint8)
    return (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, 4, 5, 8, 3) + struct.pack(">III", 0, 0, 0) + b"\x00\x00"
            + pix.tobytes())


def _pil_saved(rng, fmt, mode):
    buf = io.BytesIO()
    Image.fromarray(_pixels(rng, 12, 10)).convert(mode).save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["MSP", "SUN", "PSD", "DDS", "BLP", "SPIDER", "IM", "XBM", "DIB", "JPEG2000"])
def test_formats_still_to_port_raise_naming_the_format(fmt):
    """A file PIL opens as a format the port does not read yet raises
    NotImplementedError from `image_kind`, naming the file and PIL's
    format, whatever the file's name."""
    rng = np.random.default_rng(len(fmt))
    data = {"SUN": lambda: _sun(rng), "PSD": lambda: _psd(rng), "MSP": lambda: _pil_saved(rng, "MSP", "1"),
            "DDS": lambda: _pil_saved(rng, "DDS", "RGB"), "BLP": lambda: _pil_saved(rng, "BLP", "P"),
            "SPIDER": lambda: _pil_saved(rng, "SPIDER", "L"), "IM": lambda: _pil_saved(rng, "IM", "RGB"),
            "XBM": lambda: _pil_saved(rng, "XBM", "1"), "DIB": lambda: _pil_saved(rng, "DIB", "RGB"),
            "JPEG2000": lambda: _pil_saved(rng, "JPEG2000", "RGB")}[fmt]()
    label = {"JPEG2000": "JPEG 2000"}.get(fmt, fmt)
    assert _opened_as(data) == fmt
    with pytest.raises(NotImplementedError, match=rf"^x\.png: PIL reads this {label} file; the port does not yet"):
        image_kind(data, "x.png")
    with pytest.raises(NotImplementedError, match=rf"^x\.jpg: PIL reads this {label} file"):
        decode_image(data, "x.jpg")


def _to_port_bases(rng):
    """Small valid files of formats still to port: PIL-written where PIL
    writes them, else made by hand."""
    def saved(fmt, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(_pixels(rng, 12, 10)).convert(mode).save(buf, fmt, **kw)
        return buf.getvalue()

    fits = b"".join(c.ljust(80) for c in (b"SIMPLE  =                    T", b"BITPIX  =                    8",
                                           b"NAXIS   =                    2", b"NAXIS1  =                    3",
                                           b"NAXIS2  =                    2", b"END")) + bytes(2880)
    return [saved("DDS", "RGB"), saved("DDS", "RGBA"), saved("MSP", "1"), saved("SPIDER", "L"), saved("IM", "RGB"),
            saved("XBM", "1"), saved("DIB", "RGB"), saved("DIB", "P"), saved("JPEG2000", "RGB", no_jp2=True),
            saved("JPEG2000", "RGB"), saved("BLP", "P"), saved("BLP", "P", blp_version="BLP1"), _sun(rng), _psd(rng),
            b'/* XPM */\nstatic char *x[] = {\n"2 2 2 1",\n"a c #ff0000",\n"b c None",\n"ab",\n"ba"\n};\n',
            b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n2 2 255\n" + bytes(4),
            bytes(2048) + b"PCD_IPI" + bytes(1600), b"width 4\nheight 2\npixel n8\n\x0c" + bytes(8),
            b"\x1c\x03\x3c\x00\x02\x01\x00\x1c\x03\x14\x00\x01\x04\x1c\x03\x1e\x00\x01\x02\x1c\x03\x78\x00\x01\x01"
            b"\x1c\x08\x0a\x00\x08" + bytes(8),
            struct.pack("!64i", *([0] * 3 + [4] + [0] * 4 + [2, 3, 1] + [0] * 3 + [1] + [0] * 49)),
            b"\x80\xe8\x00\x00" + bytes(412) + struct.pack("<HHxxxxHH", 2, 3, 14, 2) + bytes(600),
            struct.pack("<IHHHHHHI", 144, 0xAF12, 1, 4, 3, 8, 0, 5) + bytes(108) + struct.pack("<IHH", 16, 0xF1FA, 0)
            + bytes(48), struct.pack(">IIIIIII", 30, 2, 3, 2, 1, 0x47494D50, 10) + b"x\x00" + bytes(6), fits,
            b"FTEX" + struct.pack("<7i", 1, 4, 4, 1, 1, 1, 32) + struct.pack("<i", 48) + bytes(48),
            b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<hhhhH", 0, 0, 100, 100, 1440) + bytes(6) + b"\x01\x00\t\x00"
            + bytes(30), b"\x00\x00\x01\xb3\x01\x00\x10" + bytes(40)]


@pytest.mark.parametrize("seed", range(6))
def test_formats_still_to_port_fall_through_as_pil(seed):
    """150 cut and corrupt files a seed, drawn from small files of the
    formats still to port (and the stubs): the port's probes fall through
    where PIL's opens do. Where PIL opens the file as a format, the port
    names that format (or decodes it); where no format takes it, the port
    says so; where PIL's open raises, the port raises too."""
    rng = np.random.default_rng(2450 + seed)
    bases = _to_port_bases(rng)
    for _ in range(150):
        d = _mutate(bases[int(rng.integers(len(bases)))], rng)
        pil = _opened_as(d)
        path = os.path.join(_TMP, f"h{os.getpid()}.png")
        with open(path, "wb") as f:
            f.write(d)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                Image.open(path).close()
            unidentified = False
        except Image.UnidentifiedImageError:
            unidentified = True
        except Exception:
            unidentified = False
        try:
            port = formats.identify(d, "f.png").name
        except (NotImplementedError, ValueError) as e:
            port = str(e)
        label = {"JPEG2000": "JPEG 2000"}.get(pil, pil)
        if unidentified:
            assert port.startswith("f.png: no format of PIL's takes this file"), (d[:40], port)
        elif pil is None:
            assert port.startswith("f.png: ") and "no format of PIL's" not in port, (d[:40], port)
        else:
            assert port == pil or f"this {label} file" in port, (d[:40], pil, port)


def test_im_header_in_any_order_is_im():
    """F4: PIL's IM reader takes any `key: value` header with one of IM's
    keys, not only one that begins "Image type"; a text file of other
    lines is not IM."""
    body = bytes(range(16))
    for header in (b"Image size (x*y): 4*4\r\nImage type: L\r\n", b"Name: x\nImage type: L\nImage size (x*y): 4*4\n",
                   b"Comment: hello\nImage size (x*y): 4*4\n"):
        data = header + b"\x1a" + body
        assert _opened_as(data) == "IM"
        with pytest.raises(NotImplementedError, match=r"^m\.png: PIL reads this IM file"):
            image_kind(data, "m.png")
    for text in (b"key: value\nother: thing\n\x1a" + body, b"no colon here\n"):
        assert _opened_as(text) is None
        with pytest.raises(ValueError, match=r"^t\.png: no format of PIL's takes this file"):
            image_kind(text, "t.png")


def test_unidentified_and_stub_files_raise_value_error():
    """A file no format takes raises ValueError naming the file; so do the
    formats PIL opens but cannot load (BUFR, GRIB, HDF5, MPEG and WMF
    stubs; EPS without Ghostscript)."""
    for data in (b"hello world, this is not an image\x00", b"", b"\x00" * 40, b"P7 nothing"):
        assert _opened_as(data) is None
        with pytest.raises(ValueError, match=r"^u\.png: no format of PIL's takes this file"):
            image_kind(data, "u.png")
    stubs = {"BUFR": b"BUFR" + bytes(40), "GRIB": b"GRIB\x00\x00\x00\x01" + bytes(40),
             "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(40), "MPEG": b"\x00\x00\x01\xb3\x01\x00\x10" + bytes(40)}
    for fmt, data in stubs.items():
        assert _opened_as(data) == fmt and _open(data)[1] is None
        with pytest.raises(ValueError, match=rf"^s\.png: PIL opens this {fmt} file but cannot load it"):
            decode_image(data, "s.png")


# ---------------------------------------------------------------------------
# Fuzz, kinds, folders, LSUN
# ---------------------------------------------------------------------------

def _fuzz_bases(rng):
    bases = []
    for k, kind in enumerate(ORDER_KINDS):
        if kind.startswith("icns"):
            continue  # 128 x 128 at least: fuzzed below through small entries
        h, w = (int(v) for v in rng.integers(1, 14, 2))
        bases.append(write_kind(kind, _pixels(rng, h, w), k))
    small = _pixels(rng, 16, 16)
    bases += [write_icns([(b"is32", icns_rgb(small)), (b"s8mk", bytes(256))]),
              write_icns([(b"icp4", write_png(small, 2, 8))]),
              write_tga(rng.integers(0, 30, (5, 6)), 9, 8, rng.integers(0, 256, (30, 3)), 16, 2),
              write_pcx(rng.integers(0, 4, (4, 9)), 1, 2, rng.integers(0, 256, (16, 3))),
              write_icon([(_bitmap_frame(rng, 1, 5, 7), 7, 5, 1, 2)])]
    return bases


def _mutate(data: bytes, rng) -> bytes:
    """Header or data bytes set to noise or to small values, or the file
    cut."""
    d = bytearray(data)
    kind = int(rng.integers(4))
    if kind == 0:
        return bytes(d[:rng.integers(1, len(d))])
    for _ in range(rng.integers(1, 4)):
        at = int(rng.integers(min(len(d), 40))) if kind == 1 else int(rng.integers(len(d)))
        d[at] = int(rng.choice([0, 1, 2, 3, 8, 16, 24, 32, 255, int(rng.integers(256))]))
    return bytes(d)


@pytest.mark.parametrize("seed", range(16))
def test_corrupt_files_as_pil(seed):
    """120 corrupt files a seed, drawn from small files of every new kind:
    where PIL decodes one (as whatever format it then opens it as), the
    port's pixels equal PIL's; where PIL raises, the port raises ValueError
    naming the file, or NotImplementedError naming the format PIL opened."""
    rng = np.random.default_rng(2400 + seed)
    bases = _fuzz_bases(rng)
    for _ in range(120):
        _same_as_pil(_mutate(bases[int(rng.integers(len(bases)))], rng), "f.jpg")


SANITIZED_FUZZ = """
import ctypes, sys
from damc_tpu_torch.data import _native_build, rle
import test_torch_port_tga_qoi_ico_pcx_sgi as t
lib = ctypes.CDLL(f"{sys.argv[1]}/rle_decode.so")
rle._configure(lib)
_native_build._loaded["rle_decode"] = lib
with t.pytest.MonkeyPatch.context() as mp:
    if not t.PIL_12_2:
        load_end = t.TgaImagePlugin.TgaImageFile.load_end
        def load_end_as_12_2(self):
            if self.mode == "RGBA":
                self.fp.seek(-26, t.os.SEEK_END)
            return load_end(self)
        mp.setattr(t.TgaImagePlugin.TgaImageFile, "load_end", load_end_as_12_2)
    for seed in range(8):
        t.test_corrupt_files_as_pil(seed)
    t.test_tga_run_length_packets_as_pil()
    t.test_sgi_refused_modes_and_run_tables_as_pil()
    t.test_icns_packed_entries_and_masks_as_pil()
    t.test_qoi_as_pil(3)
    t.test_qoi_as_pil(4)
print("fuzzed")
"""


def test_corrupt_files_under_sanitizers(tmp_path):
    """`rle_decode.cpp` built with AddressSanitizer and UBSan, where any
    read or write out of bounds and any undefined operation stops the
    process, runs 8 seeds of the corrupt-file fuzz and the run-length,
    run-table, packed-channel and QOI op cases in a child process, which
    must exit 0 (as tests/test_torch_port_tiff_codings.py does for its
    libraries)."""
    cxx = _native_build.compiler()[0]
    runtime = [subprocess.run([cxx, f"-print-file-name={name}"], capture_output=True, text=True,
                              timeout=60).stdout.strip() for name in ("libasan.so", "libubsan.so")]
    if not all(os.path.isabs(path) for path in runtime):
        pytest.skip(f"{cxx} has no sanitizer runtime")
    flags = ["-O1", "-g", "-std=c++17", "-shared", "-fPIC", "-pthread", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=undefined"]
    build = subprocess.run([cxx, *flags, "-o", str(tmp_path / "rle_decode.so"),
                            str(_native_build.SRC_DIR / "rle_decode.cpp")], capture_output=True, text=True, timeout=600)
    assert build.returncode == 0, build.stdout + build.stderr
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LD_PRELOAD=":".join(runtime), ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", SANITIZED_FUZZ, str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.strip().endswith("fuzzed"), run.stdout


@pytest.mark.parametrize("kind", ORDER_KINDS)
def test_order_kinds_match_pil(kind):
    """The new kinds of chip_smoke's tree (`write_kind`) at CelebA's
    178x218 and at small sizes, each option of `k`."""
    rng = np.random.default_rng(len(kind) + 7)
    for k, (h, w) in enumerate([(218, 178), (12, 14), (3, 7), (12, 15), (9, 9), (20, 33)]):
        data = write_kind(kind, _pixels(rng, h, w), k)
        fmt, want = _open(data)
        assert want is not None, fmt
        assert image_kind(data, kind + ".jpg") == kind.split("_")[0]
        np.testing.assert_array_equal(decode_image(data, kind + ".jpg"), want)


def _order_tree(root: str, rng) -> int:
    """Every new kind named .png or .jpg, at sizes around CelebA's, beside
    a real PNG and JPEG; returns the file count."""
    n = 0
    for k, kind in enumerate(ORDER_KINDS + ORDER_KINDS[::4]):
        w, h = int(rng.integers(30, 90)), int(rng.integers(30, 90))
        low = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
        pix = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR))
        sub = os.path.join(root, "a" if k % 2 else os.path.join("b", "c"))
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, f"{k:02d}_{kind}.{('png', 'jpg', 'JPEG')[k % 3]}"), "wb") as f:
            f.write(write_kind(kind, pix, k))
        n += 1
    img = Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8))
    img.save(os.path.join(root, "a", "real.png"))
    img.save(os.path.join(root, "a", "real.jpg"), quality=90)
    return n + 2


@pytest.mark.parametrize("size, batch_bytes", [(32, datasets.BATCH_BYTES), (48, 20000)])
def test_order_kinds_folder_matches_jax(tmp_path, monkeypatch, size, batch_bytes):
    """A folder of every new kind named .png and .jpg: `load_image_folder`
    and `load_image_folder_cached` equal the JAX package's PIL reader
    (`damc_tpu/data/datasets.py::load_image_folder`) exactly, in one batch
    and in many."""
    from damc_tpu.data import datasets as jax_datasets

    root = str(tmp_path / "tree")
    n = _order_tree(root, np.random.default_rng(24))
    monkeypatch.setattr(datasets, "BATCH_BYTES", batch_bytes)
    want = jax_datasets.load_image_folder(root, size)
    assert want.shape == (n, size, size, 3)
    np.testing.assert_array_equal(datasets.load_image_folder(root, size), want)
    np.testing.assert_array_equal(datasets.load_image_folder_cached(root, size), want)


def test_folder_with_a_format_still_to_port_raises_before_decoding(tmp_path, monkeypatch):
    """An MSP file named .png in a folder of new kinds raises
    NotImplementedError naming it from its probe, before any file is
    decoded."""
    root = tmp_path / "tree"
    root.mkdir()
    for k, kind in enumerate(("tga_rgb24", "pcx_rgb", "sgi_rle_rgb")):
        (root / f"{k}.png").write_bytes(write_kind(kind, np.zeros((9, 9, 3), np.uint8), k))
    (root / "z.png").write_bytes(_pil_saved(np.random.default_rng(0), "MSP", "1"))
    calls = []
    for kind in ("tga", "pcx", "sgi"):
        monkeypatch.setitem(datasets.SINGLE_DECODERS, kind, lambda d, p: calls.append(p))
    with pytest.raises(NotImplementedError, match=r"z\.png: PIL reads this MSP file"):
        datasets.load_image_folder(str(root), 8)
    assert calls == []


def test_lsun_records_of_the_new_kinds_equal_jax(tmp_path, monkeypatch):
    """An LSUN database with a record of every new kind beside a JPEG:
    `load_lsun`, a batch of `LSUNClassImages` and one item equal the JAX
    package's PIL path."""
    import damc_tpu.data.native_jpeg as jax_native_jpeg
    from damc_tpu.data import datasets as jax_datasets
    from lmdb_fixture import build_lmdb

    monkeypatch.setattr(jax_native_jpeg, "native_jpeg_available", lambda: False)
    rng = np.random.default_rng(25)
    items = {f"{k:03d}".encode(): write_kind(kind, _pixels(rng, 40 + k, 60 - k), k)
             for k, kind in enumerate(ORDER_KINDS)}
    buf = io.BytesIO()
    Image.fromarray(_pixels(rng, 40, 52)).save(buf, "JPEG")
    items[b"jpeg"] = buf.getvalue()
    root = str(tmp_path)
    build_lmdb(os.path.join(root, "tower_val_lmdb"), items)
    want = jax_datasets.load_lsun(root, ["tower_val"], 36)
    os.remove(os.path.join(root, "tower_val_lmdb", "_keys_cache.pkl"))
    got = datasets.load_lsun(root, ["tower_val"], 36)
    assert got.shape == (len(ORDER_KINDS) + 1, 36, 36, 3)
    np.testing.assert_array_equal(got, want)
    idx = np.array([len(ORDER_KINDS), 2, 9, 4, 17, 0])
    np.testing.assert_array_equal(datasets.LSUNClassImages(os.path.join(root, "tower_val_lmdb"), 36)[idx], want[idx])
    for key in (b"000", b"006", b"015"):
        np.testing.assert_array_equal(datasets._decode_crop_resize(items[key], 20, "item.png"),
                                      jax_datasets._decode_crop_resize(items[key], 20))

