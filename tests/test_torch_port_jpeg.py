"""The port's JPEG decoder (`damc_tpu_torch/data/jpeg.py`, the C++
`csrc/host/jpeg_decode.cpp`) against PIL's `Image.open(...).convert("RGB")`
(PIL bundles libjpeg-turbo): every comparison is exact, uint8 equality,
on seeded images. PIL writes the 4:4:4, 4:2:2, 4:2:0 and greyscale files,
baseline and progressive, and the CMYK ones (with its Adobe marker's
transform byte set to 2 the same file is YCCK, and PIL decodes it so); the
4:4:0 files and the other layouts PIL's encoder does not make (RGB or
Adobe colour spaces without JFIF, single-component scans, unusual sampling
factors) come from the small baseline writer below, and PIL decodes them
as the reference."""

from __future__ import annotations

import io
import struct
import warnings
from typing import Optional

import numpy as np
import pytest
from PIL import Image

from damc_tpu_torch.data.jpeg import decode_jpeg, decode_jpegs, jpeg_size

# ---------------------------------------------------------------------------
# A baseline JPEG writer: forward DCT, one quantisation table, the standard
# Huffman tables of Annex K, any sampling factors, optional restart
# intervals and single-component scans.
# ---------------------------------------------------------------------------

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_VALS = list(range(12))
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435"
    "363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798"
    "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
    "f5f6f7f8f9fa")
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                   14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])


def _codes(bits, vals):
    code, k, table = 0, 0, {}
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


DC_CODES, AC_CODES = _codes(DC_BITS, DC_VALS), _codes(AC_BITS, list(AC_VALS))
_n = np.arange(8)
DCT = np.sqrt(2 / 8) * np.cos((2 * _n[None, :] + 1) * _n[:, None] * np.pi / 16)
DCT[0] /= np.sqrt(2)


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out += b"\xff\x00" if self.acc == 0xFF else bytes([self.acc])
                self.acc, self.n = 0, 0

    def flush(self):  # pad with one bits
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _put_block(bits, blk, pred):
    s, val = _magnitude(blk[0] - pred)
    bits.put(*DC_CODES[s])
    if s:
        bits.put(val, s)
    last = max([k for k in range(1, 64) if blk[k]], default=0)
    run = 0
    for k in range(1, last + 1):
        if blk[k] == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*AC_CODES[0xF0])
            run -= 16
        s, val = _magnitude(blk[k])
        bits.put(*AC_CODES[(run << 4) | s])
        bits.put(val, s)
        run = 0
    if last < 63:
        bits.put(*AC_CODES[0x00])


def write_jpeg(img, sampling, quality=75, restart=0, interleaved=True, marker="jfif", ids=None):
    """Baseline JPEG bytes of `img`, (H, W) grey, (H, W, 3) RGB or
    (H, W, 4) samples written as they are (CMYK, or YCCK's Y, Cb, Cr, K),
    with `sampling` = [(h, v)] per component. `marker` is "jfif",
    "adobe-rgb" (Adobe APP14, transform 0: the samples are RGB),
    "adobe-ycc" (transform 1), "adobe-cmyk" (transform 0), "adobe-ycck"
    (transform 2) or "none"; `ids` the component IDs ((82, 71, 66) is 'R',
    'G', 'B': RGB samples)."""
    img = np.asarray(img, np.float64)
    rgb_samples = marker == "adobe-rgb" or ids == (82, 71, 66)
    if img.ndim == 2:
        planes = [img]
    elif img.shape[2] == 4:
        planes = [img[..., c] for c in range(4)]
    elif rgb_samples:
        planes = [img[..., 0], img[..., 1], img[..., 2]]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                  128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
    height, width = img.shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    scale = (5000 / quality if quality < 50 else 200 - 2 * quality) / 100  # libjpeg's quality scaling
    q = np.clip(np.floor(LUMA_Q * scale + 0.5), 1, 255).astype(np.int64)
    ids = ids or tuple(range(1, len(planes) + 1))
    blocks = []
    for p, (h, v) in zip(planes, sampling):
        fy, fx = vmax // v, hmax // h
        ph, pw = -(-height // fy) * fy, -(-width // fx) * fx
        p = np.pad(p, ((0, ph - height), (0, pw - width)), mode="edge")
        p = p.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        bh, bw = mcuy * v * 8, mcux * h * 8
        p = np.pad(p, ((0, bh - p.shape[0]), (0, bw - p.shape[1])), mode="edge") - 128
        tiles = p.reshape(bh // 8, 8, bw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", DCT, tiles, DCT).reshape(bh // 8, bw // 8, 64)
        blocks.append(np.round(coef / q).astype(np.int64)[..., NATURAL])
    seg = lambda m, body: struct.pack(">BBH", 0xFF, m, len(body) + 2) + body
    out = bytearray(b"\xff\xd8")
    if marker == "jfif":
        out += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    elif marker.startswith("adobe"):
        transform = {"adobe-rgb": 0, "adobe-ycc": 1, "adobe-cmyk": 0, "adobe-ycck": 2}[marker]
        out += seg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([transform]))
    out += seg(0xDB, b"\0" + bytes(q[NATURAL].tolist()))
    sof = struct.pack(">BHHB", 8, height, width, len(planes))
    for cid, (h, v) in zip(ids, sampling):
        sof += bytes([cid, (h << 4) | v, 0])
    out += seg(0xC0, sof)
    out += seg(0xC4, b"\x00" + bytes(DC_BITS) + bytes(DC_VALS) + b"\x10" + bytes(AC_BITS) + AC_VALS)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    scans = [list(range(len(planes)))] if interleaved or len(planes) == 1 else [[c] for c in range(len(planes))]
    for comps in scans:
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], 0]) for c in comps) + b"\0\x3f\0")
        if len(comps) == 1:  # one block an MCU, over the component's own size
            c = comps[0]
            h, v = sampling[c]
            rows, cols = -(-(-(-height * v // vmax)) // 8), -(-(-(-width * h // hmax)) // 8)
            units = [[(c, by, bx)] for by in range(rows) for bx in range(cols)]
        else:
            units = [[(c, my * sampling[c][1] + y, mx * sampling[c][0] + x) for c in comps
                      for y in range(sampling[c][1]) for x in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        bits, pred, rst = _BitWriter(), [0] * len(planes), 0
        for m, unit in enumerate(units):
            if restart and m and m % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst, pred = (rst + 1) % 8, [0] * len(planes)
            for c, by, bx in unit:
                _put_block(bits, blocks[c][by, bx], pred[c])
                pred[c] = blocks[c][by, bx][0]
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------------------


def _photo(rng, h, w):
    """Seeded smooth colour pixels with a little noise, as a photo has."""
    low = rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2), 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR)).astype(np.int16)
    return np.clip(img + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


PIL_SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _encode(mode, quality, size, restart, rng):
    w, h = size
    pix = _photo(rng, h, w)
    if mode == "4:4:0":  # PIL's encoder has no 4:4:0: the writer above makes it
        return write_jpeg(pix, [(1, 2), (1, 1), (1, 1)], quality, restart=2 if restart else 0)
    kw = dict(quality=quality, restart_marker_blocks=3) if restart else dict(quality=quality)
    if mode == "grey":
        return _pil_jpeg(Image.fromarray(pix).convert("L"), **kw)
    return _pil_jpeg(Image.fromarray(pix), subsampling=PIL_SUBSAMPLING[mode], **kw)


@pytest.mark.parametrize("restart", [False, True], ids=["no_rst", "rst"])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (178, 218), (255, 257)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "grey"])
def test_decode_matches_pil(mode, quality, size, restart):
    """Width x height at each sampling mode and quality, with and without
    restart markers: the port's pixels equal PIL's, byte for byte (1x1 and
    7x9 are partial MCUs whose chroma is at most 2 samples wide, where
    libjpeg replicates in place of its triangle filter)."""
    rng = np.random.default_rng([quality, *size, int(restart), len(mode)])
    data = _encode(mode, quality, size, restart, rng)
    if restart:
        assert b"\xff\xdd" in data and (size[0] * size[1] <= 64 or b"\xff\xd0" in data)
    got = decode_jpeg(data, "case.jpg")
    want = _pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, want)


VARIANTS = {
    "rgb_adobe": dict(sampling=[(1, 1)] * 3, marker="adobe-rgb"),
    "rgb_ids_no_marker": dict(sampling=[(1, 1)] * 3, marker="none", ids=(82, 71, 66)),
    "ycc_adobe": dict(sampling=[(2, 2), (1, 1), (1, 1)], marker="adobe-ycc"),
    "ycc_no_marker": dict(sampling=[(2, 1), (1, 1), (1, 1)], marker="none", ids=(5, 6, 7)),
    "single_component_scans": dict(sampling=[(2, 2), (1, 1), (1, 1)], interleaved=False, restart=3),
    "h4v1": dict(sampling=[(4, 1), (1, 1), (1, 1)]),
    "mixed_chroma": dict(sampling=[(2, 2), (2, 1), (1, 2)], restart=1),
    "chroma_larger_than_luma": dict(sampling=[(1, 1), (2, 2), (1, 1)]),
    "grey_2x2_sampling": dict(sampling=[(2, 2)], restart=2),
}


@pytest.mark.parametrize("size", [(3, 3), (37, 21)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_layouts_pil_does_not_write(variant, size):
    """Colour spaces inferred from Adobe APP14, from component IDs and by
    default; scans of one component; integral sampling factors other than
    2: each equal to PIL's decode of the same file."""
    rng = np.random.default_rng([len(variant), *size])
    kw = dict(VARIANTS[variant])
    pix = _photo(rng, size[1], size[0])
    data = write_jpeg(pix[..., 0] if len(kw["sampling"]) == 1 else pix, quality=80, **kw)
    want = _pil_rgb(data)
    np.testing.assert_array_equal(decode_jpeg(data), want)
    if len(kw["sampling"]) == 3 and size[0] > 8:  # the writer's files are images of `pix`, not noise
        assert np.abs(want.astype(int) - pix).mean() < 12


PROGRESSIVE_OPTIONS = {
    "plain": {}, "optimize": dict(optimize=True), "restart": dict(restart_marker_blocks=2),
}


@pytest.mark.parametrize("options", sorted(PROGRESSIVE_OPTIONS))
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 91), (178, 218)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_progressive_decode_matches_pil(mode, quality, size, options):
    """Progressive files (libjpeg's scan script: DC first and refined,
    spectral bands, AC refinement with EOB runs), with Huffman tables
    optimised per scan and with restart markers inside the scans: the
    port's pixels equal PIL's, byte for byte."""
    rng = np.random.default_rng([quality, *size, len(mode), len(options)])
    pix = Image.fromarray(_photo(rng, size[1], size[0]))
    kw = dict(quality=quality, progressive=True, **PROGRESSIVE_OPTIONS[options])
    if mode == "grey":
        data = _pil_jpeg(pix.convert("L"), **kw)
    else:
        data = _pil_jpeg(pix, subsampling=PIL_SUBSAMPLING[mode], **kw)
    assert b"\xff\xc2" in data
    got = decode_jpeg(data, "case.jpg")
    assert got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


def _adobe_transform(data: bytes, transform: Optional[int]) -> bytes:
    """`data` with its Adobe APP14 marker's transform byte set, or, for
    None, with the marker taken out."""
    i = data.index(b"\xff\xee")
    length = struct.unpack(">H", data[i + 2:i + 4])[0]
    if transform is None:
        return data[:i] + data[i + 2 + length:]
    return data[:i + 4 + 11] + bytes([transform]) + data[i + 4 + 12:]


@pytest.mark.parametrize("size", [(7, 13), (64, 40)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("coding", ["baseline", "progressive"])
@pytest.mark.parametrize("space", ["cmyk", "ycck", "cmyk_no_adobe", "rgb_adobe"])
def test_four_component_and_adobe_rgb_match_pil(space, coding, quality, size):
    """CMYK (Adobe transform 0), YCCK (transform 2: libjpeg's YCC to CMYK
    tables), 4 components with no Adobe marker (CMYK), each read by PIL as
    inverted CMYK and converted by its cmyk2rgb; and a 3-component file
    with Adobe transform 0 (RGB samples, no YCbCr step). Equal to PIL."""
    rng = np.random.default_rng([quality, *size, len(space), len(coding)])
    pix = Image.fromarray(_photo(rng, size[1], size[0]))
    kw = dict(quality=quality, progressive=coding == "progressive")
    if space == "rgb_adobe":
        data = _pil_jpeg(pix, keep_rgb=True, **kw)
        assert data[data.index(b"\xff\xee") + 4 + 11] == 0
    else:
        data = _pil_jpeg(pix.convert("CMYK"), **kw)
        data = _adobe_transform(data, {"cmyk": 0, "ycck": 2, "cmyk_no_adobe": None}[space])
    want = _pil_rgb(data)
    np.testing.assert_array_equal(decode_jpeg(data, "case.jpg"), want)
    if space in ("cmyk", "rgb_adobe"):  # the colour survives the round trip
        assert np.abs(want.astype(int) - np.asarray(pix)).mean() < 12


FOUR_COMPONENT_LAYOUTS = {
    "ycck_h2v2": dict(sampling=[(2, 2), (1, 1), (1, 1), (2, 2)], marker="adobe-ycck"),
    "cmyk_h2v1_restart": dict(sampling=[(2, 1), (1, 1), (1, 1), (1, 1)], marker="adobe-cmyk", restart=2),
    "cmyk_no_marker_scans": dict(sampling=[(1, 1)] * 4, marker="none", interleaved=False),
    "ycck_h1v2_scans_restart": dict(sampling=[(1, 2), (1, 1), (1, 1), (1, 2)], marker="adobe-ycck",
                                    interleaved=False, restart=1),
}


@pytest.mark.parametrize("size", [(5, 3), (37, 21)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", sorted(FOUR_COMPONENT_LAYOUTS))
def test_four_component_layouts_pil_does_not_write(layout, size):
    """4-component files with subsampled components (fancy upsampling of
    each, YCCK's luma and K at 2x2 as libjpeg writes YCCK), restart
    intervals and one scan a component: equal to PIL's decode."""
    rng = np.random.default_rng([len(layout), *size])
    pix = np.concatenate([_photo(rng, size[1], size[0]), _photo(rng, size[1], size[0])[..., :1]], axis=2)
    data = write_jpeg(pix, quality=80, **FOUR_COMPONENT_LAYOUTS[layout])
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def _scans_dropped(data: bytes, keep: int) -> bytes:
    """A progressive file cut after its first `keep` scans, with an EOI."""
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:starts[keep]] + b"\xff\xd9"


def test_incomplete_progressive_file_refused_where_libjpeg_smooths():
    """A progressive file whose last scans are missing: libjpeg smooths its
    blocks (jdcoefct.c), which the port does not reproduce, so the port
    refuses it with ValueError while PIL decodes it; with every scan
    present the same file decodes equal to PIL."""
    rng = np.random.default_rng(11)
    data = _pil_jpeg(Image.fromarray(_photo(rng, 40, 56)), progressive=True, quality=80)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))
    for keep in (1, 3, 6):
        cut = _scans_dropped(data, keep)
        assert _pil_rgb(cut).shape == (40, 56, 3)
        with pytest.raises(ValueError, match=r"cut\.jpg: .*block smoothing"):
            decode_jpeg(cut, "cut.jpg")


def _baseline(rng):
    return _pil_jpeg(Image.fromarray(_photo(rng, 24, 40)), quality=75)


UNSUPPORTED = {
    "12-bit": (lambda rng: _baseline(rng).replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1),
               "12-bit samples"),
    "arithmetic": (lambda rng: _baseline(rng).replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic coding"),
    "lossless": (lambda rng: _baseline(rng).replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless coding"),
    "hierarchical": (lambda rng: _baseline(rng).replace(b"\xff\xc0", b"\xff\xc5", 1), "hierarchical"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_kinds_raise_naming_item_4c(case):
    """A JPEG kind the port does not decode raises NotImplementedError
    naming the file, the feature, ROADMAP item 4c and the .npy way round,
    from the header alone (`jpeg_size`) as from the decode."""
    make, feature = UNSUPPORTED[case]
    data = make(np.random.default_rng(1))
    for call in (lambda: jpeg_size(data, "the_file.jpg"), lambda: decode_jpeg(data, "the_file.jpg")):
        with pytest.raises(NotImplementedError, match=f"the_file.jpg: .*{feature}.*item 4c.*npy"):
            call()


CORRUPT = {
    "truncated": lambda rng: _baseline(rng)[: len(_baseline(rng)) // 2],
    "truncated_header": lambda rng: _baseline(rng)[:40],
    "garbage": lambda rng: rng.integers(0, 256, 600, dtype=np.uint8).tobytes(),
    "soi_then_garbage": lambda rng: b"\xff\xd8" + rng.integers(0, 256, 600, dtype=np.uint8).tobytes(),
    "empty": lambda rng: b"",
    "no_scan": lambda rng: _baseline(rng).split(b"\xff\xda")[0] + b"\xff\xd9",
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_or_truncated_raise_value_error(case):
    data = CORRUPT[case](np.random.default_rng(2))
    with pytest.raises(ValueError, match="bad.jpg: "):
        decode_jpeg(data, "bad.jpg")


def _after_soi(data: bytes, segment: bytes) -> bytes:
    return data[:2] + segment + data[2:]


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _longer_sof(data: bytes) -> bytes:
    """The SOF0 segment one byte longer than its components need."""
    i = data.index(b"\xff\xc0")
    length = struct.unpack(">H", data[i + 2:i + 4])[0]
    return data[:i + 2] + struct.pack(">H", length + 1) + data[i + 4:i + 2 + length] + b"\0" + data[i + 2 + length:]


def _dc_symbol_16(rng) -> bytes:
    """A file whose DC table lists a symbol 16 that no block uses."""
    data = write_jpeg(_photo(rng, 16, 16), [(1, 1)] * 3)
    table = bytes(DC_BITS) + bytes(DC_VALS)
    return data.replace(table, table[:-1] + b"\x10", 1)


PIL_REFUSES = {
    "no_eoi": lambda rng: _baseline(rng)[:-2],
    "junk_after_soi": lambda rng: b"\xff\xd8\x00" + _baseline(rng)[2:],
    "tem_before_scan": lambda rng: _after_soi(_baseline(rng), b"\xff\x01"),
    "jpg_marker": lambda rng: _after_soi(_baseline(rng), _segment(0xC8, b"\0\0")),
    "short_adobe": lambda rng: _after_soi(_baseline(rng), _segment(0xEE, b"Adobe")),
    "short_icc_profile": lambda rng: _after_soi(_baseline(rng), _segment(0xE2, b"ICC_PROFILE\0\x01")),
    "cut_photoshop_block": lambda rng: _after_soi(_baseline(rng), _segment(0xED, b"Photoshop 3.0\x008BIM\x03\xed")),
    "longer_sof": lambda rng: _longer_sof(_baseline(rng)),
    "dc_symbol_16": _dc_symbol_16,
    "second_scan_in_single_scan_file": lambda rng: (lambda d: d[:-2] + d[d.index(b"\xff\xda"):])(_baseline(rng)),
}


@pytest.mark.parametrize("case", sorted(PIL_REFUSES))
def test_files_pil_refuses_raise_value_error(case):
    """Files that libjpeg refuses (an unknown marker, a frame header longer
    than its components, a DC table with a symbol above 15, a second scan
    after one that held every component) or that PIL's own
    header parser refuses (no EOI, no marker right after SOI, TEM before
    the first scan, segments too short for the fields it reads) raise
    ValueError in the port, and PIL refuses each of them too."""
    data = PIL_REFUSES[case](np.random.default_rng(12))
    assert _pil_rgb_or_none(data) is None
    with pytest.raises(ValueError, match="bad.jpg: "):
        decode_jpeg(data, "bad.jpg")


@pytest.mark.parametrize("frame_ids, scan_ids", [((1, 1, 3), (1, 1, 3)), ((2, 2, 2), (2, 2, 2)),
                                                 ((1, 2, 3), (1, 3, 2)), ((1, 2, 3), (1, 2, 2))],
                         ids=["1,1,3", "2,2,2", "out_of_order", "repeated"])
def test_scan_component_ids_resolved_as_libjpeg(frame_ids, scan_ids):
    """libjpeg-turbo gives scan slot i the first component with its ID at
    an index >= i: a frame that repeats IDs decodes when its scans list
    them in order, and a scan out of frame order, or repeating an ID the
    frame does not, is refused; the port and PIL agree on each."""
    data = write_jpeg(_photo(np.random.default_rng(13), 16, 24), [(1, 1)] * 3, ids=frame_ids)
    i = data.index(b"\xff\xda")
    data = data[:i + 5] + b"".join(bytes([c, 0]) for c in scan_ids) + data[i + 11:]
    want = _pil_rgb_or_none(data)
    if frame_ids == scan_ids:
        assert want is not None
        np.testing.assert_array_equal(decode_jpeg(data), want)
    else:
        assert want is None
        with pytest.raises(ValueError, match="unknown component"):
            decode_jpeg(data)


def test_batch_error_names_its_file():
    rng = np.random.default_rng(3)
    good = _baseline(rng)
    with pytest.raises(ValueError, match="second.jpg: corrupt or truncated"):
        decode_jpegs([good, good[:300], good], ["first.jpg", "second.jpg", "third.jpg"])


def test_thread_pool_gives_the_same_output():
    """A batch of 24 files of mixed sizes and modes decoded on 1 thread and
    on 8 threads: identical, and each equal to PIL's."""
    rng = np.random.default_rng(4)
    blobs = []
    for i in range(24):
        mode = ["4:4:4", "4:2:2", "4:2:0", "grey"][i % 4]
        size = (int(rng.integers(1, 90)), int(rng.integers(1, 90)))
        blobs.append(_encode(mode, int(rng.integers(40, 101)), size, i % 3 == 0, rng))
    for i in range(8):  # progressive and CMYK files in the same batch
        pix = Image.fromarray(_photo(rng, int(rng.integers(1, 90)), int(rng.integers(1, 90))))
        blobs.append(_pil_jpeg(pix.convert("CMYK") if i % 2 else pix, progressive=i % 4 < 2))
    one, eight = decode_jpegs(blobs, threads=1), decode_jpegs(blobs, threads=8)
    for a, b, data in zip(one, eight, blobs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _pil_rgb(data))


def mutation_bases(rng):
    """Seeded JPEG files for the mutation fuzz: baseline 4:2:0, 4:4:4 with
    restart markers, single-component scans, and progressive files with
    restart markers every block and every row (so EOB runs meet restart
    intervals), grey and CMYK among them."""
    pix = _photo(rng, 21, 37)
    return [_pil_jpeg(Image.fromarray(pix), quality=75),
            _pil_jpeg(Image.fromarray(pix), subsampling=0, restart_marker_blocks=2),
            write_jpeg(pix, [(1, 2), (1, 1), (1, 1)], interleaved=False, restart=1),
            _pil_jpeg(Image.fromarray(pix), progressive=True),
            _pil_jpeg(Image.fromarray(pix), progressive=True, subsampling=0, restart_marker_blocks=1),
            _pil_jpeg(Image.fromarray(pix).convert("L"), progressive=True, restart_marker_rows=1),
            _pil_jpeg(Image.fromarray(pix).convert("CMYK"), progressive=True)]


def _pil_rgb_or_none(data: bytes):
    """PIL's RGB pixels of `data`, or None where PIL refuses it, whatever
    its error (corrupt data makes PIL raise many kinds)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def mutate_and_decode(decode, bases, rng, n, errors=(ValueError,)):
    """`n` files made from `bases` by turns, each with 1 to 5 random bytes
    changed and every fifth also cut short, each decoded twice in one batch
    on 2 threads by `decode`. A file must raise one of `errors` or decode,
    on both threads, to exactly the pixels PIL decodes it to (PIL refusing
    it is a failure too). Returns how many did which."""
    outcomes = {"ok": 0, "raised": 0}
    for i in range(n):
        b = bytearray(bases[i % len(bases)])
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        if i % 5 == 0:
            b = b[: int(rng.integers(0, len(b)))]
        b = bytes(b)
        try:
            got = decode([b] * 2, threads=2)
        except errors:
            outcomes["raised"] += 1
            continue
        want = _pil_rgb_or_none(b)
        assert want is not None, f"mutated file {i} (base {i % len(bases)}) decodes, but PIL refuses it"
        for pixels in got:
            np.testing.assert_array_equal(pixels, want, err_msg=f"mutated file {i} (base {i % len(bases)})")
        outcomes["ok"] += 1
    return outcomes


def test_mutated_files_decode_or_raise():
    """Files with random bytes changed or cut short either raise ValueError
    / NotImplementedError or decode equal to PIL, byte for byte (the port
    refuses what libjpeg or PIL's header parser refuses, and blocks where
    libjpeg-turbo's SIMD IDCT would leave its C version's range); the
    decoder never reads or writes out of bounds (`tests/test_torch_port_webp.py::
    test_mutated_files_under_sanitizers` runs this loop on a build with
    AddressSanitizer and UBSan)."""
    rng = np.random.default_rng(5)
    outcomes = mutate_and_decode(decode_jpegs, mutation_bases(rng), rng, 600, (ValueError, NotImplementedError))
    assert outcomes["ok"] > 0 and outcomes["raised"] > 0
