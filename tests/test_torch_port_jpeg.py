"""The port's JPEG decoder (`damc_tpu_torch/data/jpeg.py`, the C++
`csrc/host/jpeg_decode.cpp`) against PIL's `Image.open(...).convert("RGB")`
(PIL bundles libjpeg-turbo): every comparison is exact, uint8 equality,
on seeded images. PIL writes the 4:4:4, 4:2:2, 4:2:0 and greyscale files,
baseline and progressive, and the CMYK ones (with its Adobe marker's
transform byte set to 2 the same file is YCCK, and PIL decodes it so); the
4:4:0 files, the other layouts PIL's encoder does not make (RGB or Adobe
colour spaces without JFIF, single-component scans, unusual sampling
factors), the arithmetic-coded and the lossless files come from the
port's numpy writer (`damc_tpu_torch/tools/jpeg_writer.py`, itself held to
PIL below), and PIL decodes them as the reference.

    python -m pytest tests/test_torch_port_jpeg.py -q
"""

from __future__ import annotations

import io
import struct
import warnings
from typing import Optional

import numpy as np
import pytest
from PIL import Image

from damc_tpu_torch.data.jpeg import decode_jpeg, decode_jpegs, jpeg_size
from damc_tpu_torch.tools.jpeg_writer import (DC_BITS, DC_VALS, lossless_expected, write_jpeg,
                                              write_lossless_jpeg)


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


ARITH_OPTIONS = {
    "plain": {}, "restart": dict(restart=2), "restart_every_mcu": dict(restart=1),
    "dac": dict(dac={(0, 0): 0x21, (1, 0): 2, (0, 1): 0x50, (1, 1): 30}),
}
SAMPLINGS = {"4:2:0": [(2, 2), (1, 1), (1, 1)], "4:2:2": [(2, 1), (1, 1), (1, 1)], "4:4:0": [(1, 2), (1, 1), (1, 1)],
             "4:4:4": [(1, 1)] * 3, "grey": [(1, 1)]}


@pytest.mark.parametrize("options", sorted(ARITH_OPTIONS))
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 21), (64, 48)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", sorted(SAMPLINGS))
@pytest.mark.parametrize("coding", ["sequential", "progressive"])
def test_arithmetic_decode_matches_pil(coding, mode, size, options):
    """Arithmetic-coded files (SOF9 sequential, SOF10 progressive in
    libjpeg's simple progression), at each sampling mode, with restart
    markers every MCU or every second (the statistics, predictions and
    decoder registers start anew) and with DAC conditioning other than the
    defaults: the port's pixels equal PIL's, byte for byte."""
    rng = np.random.default_rng([len(coding), len(mode), *size, len(options)])
    pix = _photo(rng, size[1], size[0])
    data = write_jpeg(pix[..., 0] if mode == "grey" else pix, SAMPLINGS[mode], 70 + 5 * len(options),
                      arithmetic=True, progressive=coding == "progressive", **ARITH_OPTIONS[options])
    assert data[data.index(b"\xff\xdb") + 69:][:2] == (b"\xff\xca" if coding == "progressive" else b"\xff\xc9")
    got = decode_jpeg(data, "case.jpg")
    assert got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("coding", ["sequential", "progressive"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_arithmetic_layouts_pil_does_not_write(variant, coding):
    """The layouts of `test_decode_layouts_pil_does_not_write` (colour
    spaces from Adobe APP14 and component IDs, single-component scans,
    sampling factors other than 2), arithmetic-coded: equal to PIL."""
    rng = np.random.default_rng([len(variant), len(coding)])
    kw = dict(VARIANTS[variant])
    if coding == "progressive":
        kw.pop("interleaved", None)
    pix = _photo(rng, 21, 37)
    data = write_jpeg(pix[..., 0] if len(kw["sampling"]) == 1 else pix, quality=80, arithmetic=True,
                      progressive=coding == "progressive", **kw)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("coding", ["sequential", "progressive"])
@pytest.mark.parametrize("space", ["cmyk", "ycck", "cmyk_no_marker"])
def test_arithmetic_four_components_match_pil(space, coding):
    """CMYK and YCCK, arithmetic-coded, read by PIL as inverted CMYK: equal
    to PIL."""
    rng = np.random.default_rng([len(space), len(coding)])
    pix = np.concatenate([_photo(rng, 19, 29), _photo(rng, 19, 29)[..., :1]], axis=2)
    sampling = [(2, 2), (1, 1), (1, 1), (2, 2)] if space == "ycck" else [(1, 1)] * 4
    data = write_jpeg(pix, sampling, 85, marker={"cmyk": "adobe-cmyk", "ycck": "adobe-ycck", "cmyk_no_marker": "none"}[space],
                      arithmetic=True, progressive=coding == "progressive", restart=3)
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


def test_sof9_rewritten_baseline_matches_pil():
    """A baseline file with SOF0 rewritten to SOF9: libjpeg's arithmetic
    decoder reads the Huffman bytes as arithmetic data (a bad code stops
    the decoding, the rest decodes as zeros) and PIL returns the pixels;
    the port returns the same pixels."""
    data = _baseline(np.random.default_rng(1)).replace(b"\xff\xc0", b"\xff\xc9", 1)
    np.testing.assert_array_equal(decode_jpeg(data, "arith.jpg"), _pil_rgb(data))


def _comment(n: int) -> bytes:
    """A COM segment n bytes long in all."""
    return _segment(0xFE, b"\0" * (n - 4))


@pytest.mark.parametrize("shift", [-200, -2, -1, 0, 1, 30], ids=lambda s: f"header_end_at_64KiB{s:+d}")
def test_arithmetic_scan_past_pils_read_refused_as_pil_refuses(shift):
    """PIL gives libjpeg a file in reads of 64 KiB, more only where libjpeg
    suspends for them, and jdarith.c cannot suspend inside a scan: a scan
    whose data runs past the bytes read by the end of its header fails.
    A 28 KB arithmetic scan placed, by a comment before it, so that its
    header ends near a 64 KiB boundary: where the data crosses one, both
    PIL and the port refuse the file (ValueError), else both decode it
    to the same pixels."""
    data = write_jpeg(np.random.default_rng(0).integers(0, 256, (110, 110, 3), dtype=np.uint8), [(1, 1)] * 3, 95,
                      arithmetic=True)
    sos = data.index(b"\xff\xda")
    header_end = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    data = data[:sos] + _comment(65536 + shift - header_end) + data[sos:]
    want = _pil_rgb_or_none(data)
    assert (want is None) == (shift <= 0)
    if want is None:
        with pytest.raises(ValueError, match="big.jpg: .*64 KiB"):
            decode_jpeg(data, "big.jpg")
    else:
        np.testing.assert_array_equal(decode_jpeg(data, "big.jpg"), want)


@pytest.mark.parametrize("aligned", [True, False], ids=["each_scan_after_a_read", "scans_cross_reads"])
def test_arithmetic_progressive_file_over_64kib_as_pil(aligned):
    """An 89 KB arithmetic progressive file: as written, a scan crosses a
    64 KiB read and PIL refuses it; with a comment before every scan that
    ends its header just past a 64 KiB boundary (marker reading suspends,
    so PIL reads up to there), no scan crosses a read and PIL decodes it.
    The port agrees either way."""
    rng = np.random.default_rng(0)
    data = write_jpeg(rng.integers(0, 256, (200, 200, 3), dtype=np.uint8), [(1, 1)] * 3, 95, arithmetic=True,
                      progressive=True)
    if aligned:
        starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"] + [len(data)]
        out = bytearray(data[:starts[0]])
        for a, b in zip(starts, starts[1:]):
            header = 2 + struct.unpack(">H", data[a + 2:a + 4])[0]
            need = (len(out) // 65536 + 1) * 65536 + 1 - header - len(out)
            out += _comment(need if need >= 4 else need + 65536) + data[a:b]
        data = bytes(out)
    want = _pil_rgb_or_none(data)
    assert (want is not None) == aligned
    if aligned:
        np.testing.assert_array_equal(decode_jpeg(data), want)
    else:
        with pytest.raises(ValueError, match="64 KiB"):
            decode_jpeg(data)


@pytest.mark.parametrize("restart", [0, 1, 3], ids=lambda r: f"restart_rows_{r}")
@pytest.mark.parametrize("pt", [0, 1, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_decode_matches_pil(predictor, pt, restart):
    """Lossless files (SOF3) at each predictor and point transform, with a
    restart interval of 1 or 3 MCU rows (the first-row predictor after
    each): equal to PIL's decode, which is each sample shifted right and
    back by the point transform."""
    rng = np.random.default_rng([predictor, pt, restart])
    pix = _photo(rng, 23, 37)
    data = write_lossless_jpeg(pix, predictor=predictor, pt=pt, restart_rows=restart)
    got = decode_jpeg(data, "lossless.jpg")
    np.testing.assert_array_equal(got, _pil_rgb(data))
    np.testing.assert_array_equal(got, pix >> pt << pt)


LOSSLESS_LAYOUTS = {
    "h2v2": dict(sampling=[(2, 2), (1, 1), (1, 1)]),
    "h2v2_restart": dict(sampling=[(2, 2), (1, 1), (1, 1)], restart_rows=2),
    "h1v2_scans": dict(sampling=[(1, 2), (1, 1), (1, 1)], interleaved=False),
    "h1v2_scans_restart": dict(sampling=[(1, 2), (1, 1), (1, 1)], interleaved=False, restart_rows=2),
    "mixed_h2v1_h2v2": dict(sampling=[(2, 1), (1, 1), (2, 2)], restart_rows=1),
    "scans": dict(interleaved=False, restart_rows=3),
    "adobe_rgb": dict(marker="adobe-rgb"),
    "rgb_ids": dict(ids=(82, 71, 66)),
    "other_ids": dict(ids=(5, 6, 7)),
}


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (37, 23)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", sorted(LOSSLESS_LAYOUTS))
def test_lossless_layouts_match_pil(layout, size):
    """Lossless files with sampling factors (libjpeg replicates the samples
    of a file of DCT size 1, no triangle filter), one scan a component,
    restarts, and the markers and IDs libjpeg-turbo takes for RGB: equal
    to PIL, and to the samples the writer stored."""
    rng = np.random.default_rng([len(layout), *size])
    kw = dict(LOSSLESS_LAYOUTS[layout])
    pix = _photo(rng, size[1], size[0])
    data = write_lossless_jpeg(pix, predictor=1 + len(layout) % 7, **kw)
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    np.testing.assert_array_equal(got, lossless_expected(pix, kw.get("sampling", [(1, 1)] * 3)))


@pytest.mark.parametrize("kind", ["grey", "grey_jfif", "cmyk", "cmyk_adobe"])
def test_lossless_grey_and_cmyk_match_pil(kind):
    """Grey (with or without JFIF) and CMYK lossless files (no Adobe
    marker or transform 0; PIL reads the samples as inverted CMYK):
    equal to PIL."""
    rng = np.random.default_rng(len(kind))
    pix = _photo(rng, 19, 33)
    if kind.startswith("grey"):
        data = write_lossless_jpeg(pix[..., 0], predictor=6, restart_rows=2, marker="jfif" if kind == "grey_jfif" else "none")
    else:
        data = write_lossless_jpeg(np.dstack([pix, pix[..., :1]]), predictor=3,
                                   marker="adobe-cmyk" if kind == "cmyk_adobe" else "none")
    np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))


@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4", "grey"])
@pytest.mark.parametrize("coding", ["sequential", "progressive"])
def test_writer_arithmetic_equals_huffman_in_pil(coding, mode):
    """The writer, held to PIL on its own: an arithmetic-coded file and the
    baseline Huffman file of the same coefficients decode in PIL to the
    same pixels, close to the image written."""
    rng = np.random.default_rng([len(coding), len(mode)])
    pix = _photo(rng, 40, 56)
    img = pix[..., 0] if mode == "grey" else pix
    sampling = SAMPLINGS[mode]
    want = _pil_rgb(write_jpeg(img, sampling, 90))
    np.testing.assert_array_equal(_pil_rgb(write_jpeg(img, sampling, 90, arithmetic=True, restart=5,
                                                      progressive=coding == "progressive")), want)
    assert np.abs(want.astype(int) - (pix if mode != "grey" else pix[..., :1])).mean() < 12


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("pt", [0, 3])
def test_writer_lossless_decodes_to_its_samples_in_pil(pt, restart):
    """The writer's lossless files, held to PIL on their own: PIL decodes
    each to the samples written, shifted by the point transform, with
    every predictor."""
    pix = _photo(np.random.default_rng([pt, restart]), 17, 29)
    for predictor in range(1, 8):
        data = write_lossless_jpeg(pix, predictor=predictor, pt=pt, restart_rows=restart)
        np.testing.assert_array_equal(_pil_rgb(data), pix >> pt << pt)


def test_thread_pool_new_codings_give_the_same_output():
    """A batch of arithmetic-coded, lossless and smoothed progressive files
    decoded on 1 thread and on 8 threads: identical, and each equal to
    PIL's."""
    rng = np.random.default_rng(14)
    blobs = []
    for i in range(18):
        pix = _photo(rng, int(rng.integers(1, 60)), int(rng.integers(1, 60)))
        sampling = [[(2, 2), (1, 1), (1, 1)], [(1, 1)] * 3][i % 2]
        if i % 3 == 0:
            blobs.append(write_jpeg(pix, sampling, 80, arithmetic=True, progressive=i % 2 == 0, restart=i % 4))
        elif i % 3 == 1:
            blobs.append(write_lossless_jpeg(pix, sampling, predictor=1 + i % 7, pt=i % 2))
        else:
            blobs.append(_scans_dropped(_pil_jpeg(Image.fromarray(pix), progressive=True), 1 + i % 8))
    one, eight = decode_jpegs(blobs, threads=1), decode_jpegs(blobs, threads=8)
    for a, b, data in zip(one, eight, blobs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _pil_rgb(data))


def _scans_dropped(data: bytes, keep: int) -> bytes:
    """A progressive file cut after its first `keep` scans, with an EOI."""
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:starts[keep]] + b"\xff\xd9"


def test_incomplete_progressive_file_refused_where_libjpeg_smooths():
    """A progressive file whose last scans are missing, Huffman-coded (by
    PIL) and arithmetic-coded: libjpeg smooths its blocks (jdcoefct.c,
    the 5x5 neighbourhood; after the DC scans alone the DC values too),
    and the port now smooths them as it does (the name is from when the
    port refused such files): cut after 1, 3 and 6 scans each decodes
    equal to PIL, and differs from the file's unsmoothed decode; with
    every scan present it decodes equal to PIL too."""
    rng = np.random.default_rng(11)
    pix = _photo(rng, 40, 56)
    for data in (_pil_jpeg(Image.fromarray(pix), progressive=True, quality=80),
                 write_jpeg(pix, [(2, 2), (1, 1), (1, 1)], 80, arithmetic=True, progressive=True)):
        np.testing.assert_array_equal(decode_jpeg(data), _pil_rgb(data))
        for keep in (1, 3, 6):
            cut = _scans_dropped(data, keep)
            want = _pil_rgb(cut)
            assert want.shape == (40, 56, 3)
            np.testing.assert_array_equal(decode_jpeg(cut, "cut.jpg"), want)


@pytest.mark.parametrize("size", [(9, 17), (16, 24), (37, 91), (178, 218)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["4:2:0", "4:2:2", "4:4:4", "grey"])
@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
def test_smoothed_progressive_files_match_pil(coding, mode, size):
    """Every cut of a progressive file (after each of its scans but the
    last, plus an EOI), at sizes whose last iMCU row holds fewer block rows
    than the others (libjpeg's edge tests there count rows in units of that
    row): each decodes equal to PIL's smoothed decode."""
    rng = np.random.default_rng([len(coding), len(mode), *size])
    pix = _photo(rng, size[1], size[0])
    if coding == "huffman":
        img = Image.fromarray(pix).convert("L") if mode == "grey" else Image.fromarray(pix)
        kw = {} if mode == "grey" else dict(subsampling=PIL_SUBSAMPLING[mode])
        data = _pil_jpeg(img, quality=85, progressive=True, **kw)
    else:
        sampling = {"4:2:0": [(2, 2), (1, 1), (1, 1)], "4:2:2": [(2, 1), (1, 1), (1, 1)],
                    "4:4:4": [(1, 1)] * 3, "grey": [(1, 1)]}[mode]
        data = write_jpeg(pix[..., 0] if mode == "grey" else pix, sampling, 85, arithmetic=True, progressive=True)
    scans = data.count(b"\xff\xda")
    assert scans >= 6
    cuts = [_scans_dropped(data, keep) for keep in range(1, scans)]
    for cut, got in zip(cuts, decode_jpegs(cuts, threads=2)):
        np.testing.assert_array_equal(got, _pil_rgb(cut))


def _baseline(rng):
    return _pil_jpeg(Image.fromarray(_photo(rng, 24, 40)), quality=75)


def _sof(marker: int, precision: int = 8):
    """The baseline file with its SOF0 turned into SOFn at `precision`."""
    return lambda rng: _baseline(rng).replace(b"\xff\xc0\x00\x11\x08", bytes([0xFF, marker, 0, 0x11, precision]), 1)


def _lossless_at(precision: int):
    return lambda rng: write_lossless_jpeg(_photo(rng, 12, 20)).replace(
        b"\xff\xc3\x00\x11\x08", bytes([0xFF, 0xC3, 0, 0x11, precision]), 1)


UNSUPPORTED = {
    "12-bit": (_sof(0xC0, 12), "12-bit samples"),
    "12-bit_progressive": (_sof(0xC2, 12), "12-bit samples"),
    "lossless_12-bit": (_lossless_at(12), "12-bit samples"),
    "lossless_16-bit": (_lossless_at(16), "16-bit samples"),
    "hierarchical": (_sof(0xC5), "hierarchical"),
    **{f"sof{m - 0xC0}": (_sof(m), "hierarchical") for m in (0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "sof11": (_sof(0xCB), "lossless arithmetic coding"),
    "sof11_lossless_scan": (lambda rng: write_lossless_jpeg(_photo(rng, 12, 20)).replace(b"\xff\xc3", b"\xff\xcb", 1),
                            "lossless arithmetic coding"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_kinds_raise_naming_item_4c(case):
    """A JPEG kind that PIL does not decode either (samples other than
    8-bit, refused by PIL's own header parser; hierarchical SOF5-7 and
    SOF13-15 and lossless arithmetic SOF11, refused by libjpeg-turbo)
    raises NotImplementedError naming the file and the feature, from the
    header alone (`jpeg_size`) as from the decode; PIL raises on the same
    bytes. (The name is from when the error named ROADMAP item 4c; with
    the port decoding all that PIL decodes it names no way round.)"""
    make, feature = UNSUPPORTED[case]
    data = make(np.random.default_rng(1))
    assert _pil_rgb_or_none(data) is None
    for call in (lambda: jpeg_size(data, "the_file.jpg"), lambda: decode_jpeg(data, "the_file.jpg")):
        with pytest.raises(NotImplementedError, match=f"the_file.jpg: .*{feature}.*neither by the port nor by PIL") as e:
            call()
        assert "item 4c" not in str(e.value) and ".npy" not in str(e.value)


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
    # A baseline scan under an arithmetic progressive or a lossless frame header.
    "sof10_rewritten_baseline": lambda rng: _baseline(rng).replace(b"\xff\xc0", b"\xff\xca", 1),
    "sof3_rewritten_baseline": lambda rng: _baseline(rng).replace(b"\xff\xc0", b"\xff\xc3", 1),
    # Lossless files libjpeg-turbo would have to convert lossily (JFIF or an
    # Adobe transform other than 0 mean YCbCr, transform 2 YCCK).
    "lossless_jfif": lambda rng: write_lossless_jpeg(_photo(rng, 12, 20), marker="jfif"),
    "lossless_adobe_ycc": lambda rng: write_lossless_jpeg(_photo(rng, 12, 20), marker="adobe-ycc"),
    "lossless_ycck": lambda rng: write_lossless_jpeg(np.dstack([_photo(rng, 12, 20)] * 2)[..., :4], marker="adobe-ycck"),
    "lossless_restart_not_whole_rows": lambda rng: _with_dri(write_lossless_jpeg(_photo(rng, 12, 20)), 7),
    "lossless_predictor_0": lambda rng: _scan_byte(write_lossless_jpeg(_photo(rng, 12, 20)), -3, 0),
    "lossless_predictor_8": lambda rng: _scan_byte(write_lossless_jpeg(_photo(rng, 12, 20)), -3, 8),
    "lossless_pt_8": lambda rng: _scan_byte(write_lossless_jpeg(_photo(rng, 12, 20)), -1, 8),
    "lossless_component_without_scan": lambda rng: _first_scan_dropped(
        write_lossless_jpeg(_photo(rng, 12, 20), interleaved=False)),
    "arithmetic_truncated": lambda rng: write_jpeg(_photo(rng, 24, 40), [(2, 2), (1, 1), (1, 1)], arithmetic=True)[:300],
    "arithmetic_dac_l_above_u": lambda rng: write_jpeg(_photo(rng, 24, 40), [(1, 1)] * 3, arithmetic=True,
                                                       dac={(0, 0): 0x12}),
}


def _with_dri(data: bytes, interval: int) -> bytes:
    i = data.index(b"\xff\xda")
    return data[:i] + _segment(0xDD, struct.pack(">H", interval)) + data[i:]


def _scan_byte(data: bytes, at: int, value: int) -> bytes:
    """`data` with byte `at` of its first scan header's body (from its end) set."""
    i = data.index(b"\xff\xda")
    end = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return data[:end + at] + bytes([value]) + data[end + at + 1:]


def _first_scan_dropped(data: bytes) -> bytes:
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:starts[0]] + data[starts[1]:]


@pytest.mark.parametrize("case", sorted(PIL_REFUSES))
def test_files_pil_refuses_raise_value_error(case):
    """Files that libjpeg refuses (an unknown marker, a frame header longer
    than its components, a DC table with a symbol above 15, a second scan
    after one that held every component, a sequential scan under a
    progressive or lossless frame header, lossless files it would have to
    convert to RGB or CMYK lossily, a lossless restart interval that is not
    whole MCU rows, a lossless predictor or point transform out of range, a
    lossless component no scan holds, arithmetic-coded data cut short, a
    DAC lower bound above its upper) or that PIL's own header parser
    refuses (no EOI, no marker right after SOI, TEM before the first scan,
    segments too short for the fields it reads) raise ValueError in the
    port, and PIL refuses each of them too."""
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
    intervals), grey and CMYK among them; arithmetic-coded files,
    sequential (with DAC conditioning and restart markers) and progressive;
    lossless files, interleaved with restarts, subsampled, and one scan a
    component; progressive files cut short, which libjpeg smooths."""
    pix = _photo(rng, 21, 37)
    return [_pil_jpeg(Image.fromarray(pix), quality=75),
            _pil_jpeg(Image.fromarray(pix), subsampling=0, restart_marker_blocks=2),
            write_jpeg(pix, [(1, 2), (1, 1), (1, 1)], interleaved=False, restart=1),
            _pil_jpeg(Image.fromarray(pix), progressive=True),
            _pil_jpeg(Image.fromarray(pix), progressive=True, subsampling=0, restart_marker_blocks=1),
            _pil_jpeg(Image.fromarray(pix).convert("L"), progressive=True, restart_marker_rows=1),
            _pil_jpeg(Image.fromarray(pix).convert("CMYK"), progressive=True),
            write_jpeg(pix, [(2, 2), (1, 1), (1, 1)], arithmetic=True),
            write_jpeg(pix, [(1, 1)] * 3, arithmetic=True, restart=2, dac={(0, 0): 0x21, (1, 0): 3, (1, 1): 9}),
            write_jpeg(pix, [(2, 1), (1, 1), (1, 1)], arithmetic=True, progressive=True, restart=1),
            write_lossless_jpeg(pix, predictor=4, restart_rows=2),
            write_lossless_jpeg(pix, [(2, 2), (1, 1), (1, 1)], predictor=7, pt=1),
            write_lossless_jpeg(pix, predictor=5, interleaved=False, restart_rows=1),
            _scans_dropped(_pil_jpeg(Image.fromarray(pix), progressive=True), 3),
            _scans_dropped(write_jpeg(pix, [(2, 2), (1, 1), (1, 1)], arithmetic=True, progressive=True), 5)]


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
    outcomes = mutate_and_decode(decode_jpegs, mutation_bases(rng), rng, 1200, (ValueError, NotImplementedError))
    assert outcomes["ok"] > 0 and outcomes["raised"] > 0
