"""The port's baseline JPEG decoder (`damc_tpu_torch/data/jpeg.py`, the C++
`csrc/host/jpeg_decode.cpp`) against PIL's `Image.open(...).convert("RGB")`
(PIL bundles libjpeg-turbo): every comparison is exact, uint8 equality,
on seeded images. PIL writes the 4:4:4, 4:2:2, 4:2:0 and greyscale files;
the 4:4:0 files and the other layouts PIL's encoder does not make (RGB or
Adobe colour spaces without JFIF, single-component scans, unusual sampling
factors) come from the small baseline writer below, and PIL decodes them
as the reference."""

from __future__ import annotations

import io
import struct

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
    """Baseline JPEG bytes of `img`, (H, W) grey or (H, W, 3) RGB, with
    `sampling` = [(h, v)] per component. `marker` is "jfif", "adobe-rgb"
    (Adobe APP14, transform 0: the samples are RGB), "adobe-ycc"
    (transform 1) or "none"; `ids` the component IDs ((82, 71, 66) is
    'R', 'G', 'B': RGB samples)."""
    img = np.asarray(img, np.float64)
    rgb_samples = marker == "adobe-rgb" or ids == (82, 71, 66)
    if img.ndim == 2:
        planes = [img]
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
        out += seg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([0 if marker == "adobe-rgb" else 1]))
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


def _progressive(rng):
    return _pil_jpeg(Image.fromarray(_photo(rng, 24, 40)), progressive=True)


def _baseline(rng):
    return _pil_jpeg(Image.fromarray(_photo(rng, 24, 40)), quality=75)


UNSUPPORTED = {
    "progressive": (_progressive, "progressive coding"),
    "cmyk": (lambda rng: _pil_jpeg(Image.fromarray(_photo(rng, 24, 40)).convert("CMYK")), "4 components"),
    "12-bit": (lambda rng: _baseline(rng).replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1),
               "12-bit samples"),
    "arithmetic": (lambda rng: _baseline(rng).replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic coding"),
    "lossless": (lambda rng: _baseline(rng).replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless coding"),
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
    one, eight = decode_jpegs(blobs, threads=1), decode_jpegs(blobs, threads=8)
    for a, b, data in zip(one, eight, blobs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _pil_rgb(data))


def test_mutated_files_decode_or_raise():
    """Files with random bytes changed or cut short either decode or raise
    ValueError / NotImplementedError; the decoder never reads or writes
    out of bounds (the same loop ran under AddressSanitizer)."""
    rng = np.random.default_rng(5)
    pix = _photo(rng, 21, 37)
    bases = [_pil_jpeg(Image.fromarray(pix), quality=75), _pil_jpeg(Image.fromarray(pix), subsampling=0,
                                                                      restart_marker_blocks=2),
             write_jpeg(pix, [(1, 2), (1, 1), (1, 1)], interleaved=False, restart=1)]
    outcomes = {"ok": 0, "raised": 0}
    for i in range(300):
        b = bytearray(bases[i % len(bases)])
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        if i % 5 == 0:
            b = b[: int(rng.integers(0, len(b)))]
        try:
            decode_jpegs([bytes(b)] * 2, threads=2)
            outcomes["ok"] += 1
        except (ValueError, NotImplementedError):
            outcomes["raised"] += 1
    assert outcomes["ok"] > 0 and outcomes["raised"] > 0
