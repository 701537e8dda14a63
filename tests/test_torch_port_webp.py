"""The port's WebP decoder (`damc_tpu_torch/data/webp.py`, the C++
`csrc/host/webp_decode.cpp`) against PIL's `Image.open(...).convert("RGB")`
(PIL decodes WebP through libwebp's animation decoder): every comparison is
exact, uint8 equality, on seeded images. PIL writes the lossy, lossless,
alpha and animated files; the lossy codings its encoder never chooses (the
simple loop filter, several token partitions, one segment, the filter at
its limits) come from the libwebp that PIL bundles, driven through its
advanced encoding API with ctypes, and PIL decodes them as the reference."""

from __future__ import annotations

import ctypes
import glob
import io
import os
import struct
import subprocess
import sys

import numpy as np
import PIL
import pytest
from PIL import Image

from damc_tpu_torch.data import _native_build
from damc_tpu_torch.data.webp import decode_webp, decode_webps, webp_size
from test_torch_port_jpeg import _photo, _pil_rgb_or_none, mutate_and_decode


def _image(kind, rng, h, w):
    if kind == "photo":
        return _photo(rng, h, w)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    flat = np.full((h, w, 3), 77, np.uint8)  # skipped macroblocks but for one edge
    flat[h // 2:, : w // 3] = (10, 200, 30)
    return flat


def _pil_webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _check(data: bytes, name: str = "case.webp") -> np.ndarray:
    want = _pil_rgb(data)
    got = decode_webp(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert webp_size(data) == Image.open(io.BytesIO(data)).size
    return got


SIZES = [(1, 1), (2, 3), (7, 13), (16, 16), (17, 33), (37, 91), (178, 218)]


@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("quality", [0, 20, 50, 80, 100])
@pytest.mark.parametrize("kind", ["photo", "flat", "noise"])
def test_lossy_matches_pil(kind, quality, method):
    """Lossy files across quality and method on photo-like, flat (skipped
    macroblocks) and noise images (every segment, the loop filter near its
    limits), at odd sizes: equal to PIL's decode, byte for byte."""
    rng = np.random.default_rng([quality, method, len(kind)])
    w, h = SIZES[(quality // 20 + method) % len(SIZES)]
    _check(_pil_webp(Image.fromarray(_image(kind, rng, h, w)), quality=quality, method=method))


@pytest.mark.parametrize("quality", [10, 90])
@pytest.mark.parametrize("method", range(7))
def test_lossy_every_method_matches_pil(method, quality):
    """Every encoder effort, 0 to 6 (token buffers and trellis
    quantisation from 3, one token partition), at CelebA's 178x218."""
    rng = np.random.default_rng([method, quality, 7])
    _check(_pil_webp(Image.fromarray(_photo(rng, 218, 178)), quality=quality, method=method))


@pytest.mark.parametrize("method", [0, 4])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_lossy_sizes_match_pil(size, method):
    """Widths and heights from 1x1 to CelebA's 178x218, odd and even: the
    chroma upsampler's edge rows and columns and partial macroblocks."""
    rng = np.random.default_rng([*size, method])
    _check(_pil_webp(Image.fromarray(_photo(rng, size[1], size[0])), quality=75, method=method))


# ---------------------------------------------------------------------------
# libwebp's own encoder, for the codings PIL's options do not reach
# ---------------------------------------------------------------------------

CONFIG_FIELDS = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
                 "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
                 "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
                 "preprocessing", "partitions"]
ENCODER_ABI = 0x0210  # any 0x02xx passes libwebp's check


def _libwebp():
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    paths = sorted(glob.glob(os.path.join(libs, "libwebp-*.so*")))
    assert paths, f"no libwebp next to PIL in {libs}"
    return ctypes.CDLL(paths[0])


WRITER = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p)


def libwebp_encode(pix: np.ndarray, **fields) -> bytes:
    """Lossy WebP bytes of RGB `pix` by libwebp's WebPEncode with the
    default config changed in `fields` (WebPConfig's int fields by name).
    The config's layout is checked against the defaults WebPConfigInit
    sets; the picture's writer hook is the one field WebPPictureInit sets."""
    lib = _libwebp()
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), ENCODER_ABI)
    assert [cfg[CONFIG_FIELDS.index(k)] for k in ("method", "segments", "sns_strength", "filter_strength",
                                                  "filter_type", "partitions")] == [4, 4, 50, 60, 1, 0]
    for key, value in fields.items():
        cfg[CONFIG_FIELDS.index(key)] = value
    assert lib.WebPValidateConfig(cfg)
    pic = (ctypes.c_uint8 * 1024)()
    assert lib.WebPPictureInitInternal(pic, ENCODER_ABI)
    set_words = np.nonzero(np.frombuffer(pic, np.uint64))[0]
    assert len(set_words) == 1
    h, w, _ = pix.shape
    ctypes.c_int32.from_buffer(pic, 8).value = w  # use_argb, colorspace, width, height lead the struct
    ctypes.c_int32.from_buffer(pic, 12).value = h
    pix = np.ascontiguousarray(pix)
    assert lib.WebPPictureImportRGB(pic, pix.ctypes.data_as(ctypes.c_void_p), w * 3)
    out = bytearray()

    @WRITER
    def write(data, size, _picture):
        out.extend(ctypes.string_at(data, size))
        return 1

    ctypes.c_void_p.from_buffer(pic, int(set_words[0]) * 8).value = ctypes.cast(write, ctypes.c_void_p).value
    ok = lib.WebPEncode(cfg, pic)
    lib.WebPPictureFree(pic)
    assert ok
    return bytes(out)


LIBWEBP_CONFIGS = {
    "simple_filter": dict(filter_type=0),
    "simple_filter_strong": dict(filter_type=0, filter_strength=100),
    "simple_filter_sharp": dict(filter_type=0, filter_sharpness=7),
    "two_partitions": dict(partitions=1, method=0),
    "four_partitions_simple": dict(partitions=2, method=1, filter_type=0),
    "eight_partitions": dict(partitions=3, method=0, quality=5),
    "one_segment": dict(segments=1),
    "no_filter": dict(filter_strength=0),
    "strongest_filter": dict(filter_strength=100, filter_sharpness=3),
    "sharpest": dict(filter_sharpness=7),
    "full_sns": dict(sns_strength=100),
}


@pytest.mark.parametrize("size", [(13, 9), (100, 70), (178, 218)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("config", sorted(LIBWEBP_CONFIGS))
def test_libwebp_encoder_codings_match_pil(config, size):
    """The simple loop filter, 2, 4 and 8 token partitions, one segment, no
    filter and the filter at its strongest and sharpest: equal to PIL."""
    rng = np.random.default_rng([*size, len(config)])
    fields = dict(LIBWEBP_CONFIGS[config])
    if "quality" in fields:
        fields["quality"] = struct.unpack("<i", struct.pack("<f", fields["quality"]))[0]
    _check(libwebp_encode(_photo(rng, size[1], size[0]), **fields))


# ---------------------------------------------------------------------------
# Lossless, alpha, animation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [0, 50, 100])
@pytest.mark.parametrize("method", [0, 3, 6])
def test_lossless_matches_pil(method, quality):
    """Lossless files: the prefix codes, meta codes, colour cache, LZ77
    references and the predictor, cross-colour and subtract-green
    transforms the encoder picks at each effort."""
    rng = np.random.default_rng([method, quality])
    w, h = SIZES[(method + quality // 50) % len(SIZES)]
    got = _check(_pil_webp(Image.fromarray(_photo(rng, h, w)), lossless=True, quality=quality, method=method))
    np.testing.assert_array_equal(got, _photo(np.random.default_rng([method, quality]), h, w))


@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("colors", [2, 4, 16, 200])
def test_lossless_palettes_match_pil(colors, method):
    """Colour indexing with 8, 4, 2 and 1 pixels a byte (2, 4, 16 and 200
    colours), at widths that leave a partial byte."""
    rng = np.random.default_rng([colors, method])
    palette = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
    pix = palette[rng.integers(0, colors, (41, 37))]
    got = _check(_pil_webp(Image.fromarray(pix), lossless=True, method=method))
    np.testing.assert_array_equal(got, pix)


def test_lossless_exact_matches_pil():
    rng = np.random.default_rng(9)
    _check(_pil_webp(Image.fromarray(_image("noise", rng, 33, 29)), lossless=True, exact=True))


def _chunks(data: bytes):
    """[(fourcc, payload)] of a RIFF/WEBP file."""
    out, pos = [], 12
    while pos < len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _riff(chunks) -> bytes:
    body = b"".join(c + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1) for c, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


ALPHA_OPTIONS = {
    "lossy": dict(quality=80), "lossy_low_alpha_quality": dict(quality=20, alpha_quality=30),
    "lossy_exact": dict(quality=90, exact=True), "lossless": dict(lossless=True),
    "lossless_exact": dict(lossless=True, exact=True),
}


@pytest.mark.parametrize("options", sorted(ALPHA_OPTIONS))
def test_alpha_matches_pil_and_rgb_does_not_depend_on_alpha(options):
    """Files with alpha, half of them fully transparent: the RGB equals
    PIL's RGBA decode with alpha dropped. For a lossy file, PIL's RGB is
    the same with the ALPH chunk taken out (flag cleared), which is why the
    port does not decode the alpha plane."""
    rng = np.random.default_rng(len(options))
    alpha = rng.integers(0, 256, (30, 46), dtype=np.uint8)
    alpha[:15] = 0
    rgba = np.dstack([_photo(rng, 30, 46), alpha])
    data = _pil_webp(Image.fromarray(rgba, "RGBA"), **ALPHA_OPTIONS[options])
    assert Image.open(io.BytesIO(data)).mode == "RGBA"
    got = _check(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data)))[..., :3])
    chunks = _chunks(data)
    if any(c == b"ALPH" for c, _ in chunks):
        vp8x = chunks[0][1]
        no_alpha_flag = (b"VP8X", bytes([vp8x[0] & ~0x10]) + vp8x[1:])
        stripped = _riff([no_alpha_flag] + [(c, p) for c, p in chunks[1:] if c != b"ALPH"])
        assert Image.open(io.BytesIO(stripped)).mode == "RGB"
        np.testing.assert_array_equal(_pil_rgb(stripped), got)
        np.testing.assert_array_equal(decode_webp(stripped), got)


def _anim(frames, canvas, offsets) -> bytes:
    """An animation by hand: VP8X, ANIM and one ANMF for each still WebP in
    `frames`, at the even (x, y) of `offsets` on a `canvas` (w, h)."""
    chunks = [(b"VP8X", bytes([0x12, 0, 0, 0]) + struct.pack("<I", canvas[0] - 1)[:3]
               + struct.pack("<I", canvas[1] - 1)[:3]), (b"ANIM", b"\0\0\0\0\0\0")]
    for data, (x, y) in zip(frames, offsets):
        w, h = Image.open(io.BytesIO(data)).size
        image = [(c, p) for c, p in _chunks(data) if c in (b"ALPH", b"VP8 ", b"VP8L")]
        head = b"".join(struct.pack("<I", v)[:3] for v in (x // 2, y // 2, w - 1, h - 1, 100)) + b"\0"
        body = b"".join(c + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1) for c, p in image)
        chunks.append((b"ANMF", head + body))
    return _riff(chunks)


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
def test_animated_first_frame_matches_pil(lossless):
    """A 3-frame animation written by PIL, and one made by hand whose first
    frame lies at an offset on a larger canvas: the first frame on a canvas
    of zeros, equal to PIL's."""
    rng = np.random.default_rng(int(lossless))
    frames = [Image.fromarray(_photo(rng, 26, 34)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50, lossless=lossless)
    assert Image.open(io.BytesIO(buf.getvalue())).n_frames == 3
    _check(buf.getvalue())
    stills = [_pil_webp(f, lossless=lossless) for f in frames]
    data = _anim(stills, (50, 44), [(6, 10), (0, 0), (16, 2)])
    got = _check(data)
    assert got.shape == (44, 50, 3) and not got[:10].any() and not got[:, :6].any()
    np.testing.assert_array_equal(got[10:36, 6:40], decode_webp(stills[0]))


def test_metadata_chunks_are_skipped():
    """ICC, EXIF and XMP chunks (a VP8X file) do not change the pixels."""
    rng = np.random.default_rng(12)
    img = Image.fromarray(_photo(rng, 30, 40))
    exif = b"Exif\0\0II*\0\x08\0\0\0\0\0\0\0"
    for kw in (dict(icc_profile=b"\0" * 200), dict(exif=exif), dict(xmp=b"<x:xmpmeta/>")):
        data = _pil_webp(img, **kw)
        assert _chunks(data)[0][0] == b"VP8X"
        _check(data)


# ---------------------------------------------------------------------------
# Errors and the thread pool
# ---------------------------------------------------------------------------


def _lossy(rng):
    return _pil_webp(Image.fromarray(_photo(rng, 24, 40)), quality=60)


CORRUPT = {
    "truncated": lambda rng: _lossy(rng)[: len(_lossy(rng)) // 2],
    "truncated_header": lambda rng: _lossy(rng)[:20],
    "garbage": lambda rng: b"RIFF\0\1\0\0WEBP" + rng.integers(0, 256, 600, dtype=np.uint8).tobytes(),
    "empty": lambda rng: b"",
    "not_a_key_frame": lambda rng: (lambda d: d[:20] + bytes([d[20] | 1]) + d[21:])(_lossy(rng)),
    "bad_start_code": lambda rng: (lambda d: d[:23] + b"\0" + d[24:])(_lossy(rng)),
    "lossless_truncated": lambda rng: (lambda d: d[: len(d) - 40])(
        _pil_webp(Image.fromarray(_photo(rng, 24, 40)), lossless=True)),
    "lossless_bad_version": lambda rng: (lambda d: d[:24] + bytes([d[24] | 0x20]) + d[25:])(
        _pil_webp(Image.fromarray(_photo(rng, 24, 40)), lossless=True)),
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_or_truncated_raise_value_error(case):
    data = CORRUPT[case](np.random.default_rng(2))
    with pytest.raises(ValueError, match="bad.webp: corrupt or truncated WebP"):
        decode_webp(data, "bad.webp")


def _with_chunk(data: bytes, fourcc: bytes, new: bytes, index: int = 0) -> bytes:
    """`data` with the payload of its `index`-th `fourcc` chunk replaced."""
    chunks = _chunks(data)
    k = [i for i, (c, _) in enumerate(chunks) if c == fourcc][index]
    chunks[k] = (fourcc, new)
    return _riff(chunks)


def _alpha_file(rng, header=None, alpha_quality=50):
    a = rng.integers(0, 256, (20, 24), dtype=np.uint8)
    data = _pil_webp(Image.fromarray(np.dstack([_photo(rng, 20, 24), a]), "RGBA"), alpha_quality=alpha_quality)
    alph = dict(_chunks(data))[b"ALPH"]
    return _with_chunk(data, b"ALPH", bytes([header if header is not None else alph[0]]) + alph[1:])


def _anim_frame_start_code_broken(rng):
    frames = [Image.fromarray(_photo(rng, 20, 24)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40)
    data = buf.getvalue()
    at = [i for i in range(len(data) - 4) if data[i:i + 4] == b"VP8 "][1] + 8 + 3  # the second frame's start code
    return data[:at] + b"\0" + data[at + 1:]


def _vp8x_of_size(rng, size):
    data = _pil_webp(Image.fromarray(_photo(rng, 20, 24)), icc_profile=b"\0" * 20)
    chunks = _chunks(data)
    chunks[0] = (b"VP8X", chunks[0][1] + b"\0" * (size - 10))
    return _riff(chunks)


def _chunks_reordered(rng, order):
    stills = [_pil_webp(Image.fromarray(_photo(rng, 16, 20)))] * 2
    chunks = _chunks(_anim(stills, (24, 20), [(0, 0), (2, 2)]))
    return _riff([chunks[i] for i in order])


LIBWEBP_REFUSES = {
    "vp8x_of_12_bytes": lambda rng: _vp8x_of_size(rng, 12),  # the demuxer takes it; WebPGetFeatures does not
    "alpha_reserved_bits": lambda rng: _alpha_file(rng, header=0xC1),
    "alpha_raw_too_short": lambda rng: _alpha_file(rng, header=0x00),
    "alpha_stream_cut": lambda rng: (lambda d: _with_chunk(d, b"ALPH", dict(_chunks(d))[b"ALPH"][:30]))(_alpha_file(rng)),
    "second_frame_start_code": _anim_frame_start_code_broken,
    "anmf_before_anim": lambda rng: _chunks_reordered(rng, [0, 2, 1, 3]),
    "still_image_in_animation": lambda rng: _riff([_chunks(_chunks_reordered(rng, [0, 1, 2]))[0],
                                                    (b"VP8 ", dict(_chunks(_pil_webp(Image.fromarray(_photo(rng, 20, 24)))))[b"VP8 "])]),
}


@pytest.mark.parametrize("case", sorted(LIBWEBP_REFUSES))
def test_files_libwebp_refuses_raise_value_error(case):
    """Files that libwebp refuses in PIL's path, where the first frame alone
    would decode: its whole-file feature check (a VP8X chunk of 12 bytes),
    its alpha decoder (reserved header bits, a raw plane shorter than the
    image, a cut lossless plane), its demuxer (a later frame's bad header,
    ANMF before ANIM, a still image chunk in an animation). The port raises
    ValueError, and PIL refuses each of them too."""
    data = LIBWEBP_REFUSES[case](np.random.default_rng(14))
    assert _pil_rgb_or_none(data) is None
    with pytest.raises(ValueError, match="bad.webp: corrupt or truncated WebP"):
        decode_webp(data, "bad.webp")


def test_batch_error_names_its_file():
    rng = np.random.default_rng(3)
    good = _lossy(rng)
    with pytest.raises(ValueError, match="second.webp: corrupt or truncated"):
        decode_webps([good, good[:60], good], ["first.webp", "second.webp", "third.webp"])


def test_thread_pool_gives_the_same_output():
    """A batch of lossy, lossless, alpha and animated files of mixed sizes
    decoded on 1 thread and on 8 threads: identical, and each equal to
    PIL's."""
    rng = np.random.default_rng(4)
    blobs = []
    for i in range(24):
        w, h = int(rng.integers(1, 90)), int(rng.integers(1, 90))
        pix = _photo(rng, h, w)
        if i % 4 == 3:
            pix = np.dstack([pix, rng.integers(0, 256, (h, w), dtype=np.uint8)])
        blobs.append(_pil_webp(Image.fromarray(pix), lossless=i % 2 == 1, quality=int(rng.integers(0, 101))))
    frames = [Image.fromarray(_photo(rng, 20, 30)) for _ in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:])
    blobs.append(buf.getvalue())
    one, eight = decode_webps(blobs, threads=1), decode_webps(blobs, threads=8)
    for a, b, data in zip(one, eight, blobs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _pil_rgb(data))


def mutation_bases(rng):
    """Seeded WebP files for the mutation fuzz: lossy at two qualities,
    lossless, alpha (lossy with a compressed alpha plane, and lossless), a
    PIL-written animation, a hand-made one whose first frame has alpha and
    an offset, a palette, 8 token partitions with the simple filter, and a
    still image with ICC and EXIF chunks."""
    pix = _photo(rng, 21, 37)
    rgba = np.dstack([pix, rng.integers(0, 256, (21, 37), dtype=np.uint8)])
    frames = [Image.fromarray(_photo(rng, 21, 37)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:])
    stills = [_pil_webp(Image.fromarray(rgba[:16, :20], "RGBA"), alpha_quality=40), _pil_webp(frames[1], lossless=True)]
    exif = b"Exif\0\0II*\0\x08\0\0\0\0\0\0\0"
    return [_pil_webp(Image.fromarray(pix), quality=10), _pil_webp(Image.fromarray(pix), quality=80),
            _pil_webp(Image.fromarray(pix), lossless=True), _pil_webp(Image.fromarray(rgba, "RGBA"), alpha_quality=50),
            _pil_webp(Image.fromarray(rgba, "RGBA"), lossless=True), buf.getvalue(),
            _anim(stills, (44, 30), [(4, 6), (0, 0)]),
            _pil_webp(Image.fromarray(pix // 64 * 64), lossless=True),
            libwebp_encode(pix, partitions=3, method=0, filter_type=0),
            _pil_webp(Image.fromarray(pix), quality=50, icc_profile=b"\0" * 40, exif=exif)]


def test_mutated_files_decode_or_raise():
    """Lossy, lossless, alpha and animated files with random bytes changed
    or cut short either raise ValueError or decode equal to PIL, byte for
    byte (the port refuses what libwebp's feature check, demuxer, decoder
    or alpha decoder refuses); the decoder never reads or writes out of
    bounds (`test_mutated_files_under_sanitizers`)."""
    rng = np.random.default_rng(5)
    outcomes = mutate_and_decode(decode_webps, mutation_bases(rng), rng, 800)
    assert outcomes["ok"] > 0 and outcomes["raised"] > 0


SANITIZED_FUZZ = """
import ctypes, sys
import numpy as np
from damc_tpu_torch.data import _native_build, jpeg, webp
import test_torch_port_jpeg as j, test_torch_port_webp as w
for name, module in (("jpeg_decode", jpeg), ("webp_decode", webp)):
    lib = ctypes.CDLL(f"{sys.argv[1]}/{name}.so")
    module._configure(lib)
    _native_build._loaded[name] = lib
rng = np.random.default_rng(6)
print(j.mutate_and_decode(jpeg.decode_jpegs, j.mutation_bases(rng), rng, 300, (ValueError, NotImplementedError)),
      w.mutate_and_decode(webp.decode_webps, w.mutation_bases(rng), rng, 300))
"""


def test_mutated_files_under_sanitizers(tmp_path):
    """Both decoders built with AddressSanitizer and UBSan, where any read
    or write out of bounds and any undefined operation stops the process,
    run the two mutation fuzzes (300 files each) in a child process, which
    must exit 0 having decoded some files and refused others."""
    cxx = _native_build.compiler()[0]
    runtime = [subprocess.run([cxx, f"-print-file-name={name}"], capture_output=True, text=True, timeout=60).stdout.strip()
               for name in ("libasan.so", "libubsan.so")]
    if not all(os.path.isabs(path) for path in runtime):
        pytest.skip(f"{cxx} has no sanitizer runtime")
    flags = ["-O1", "-g", "-std=c++17", "-shared", "-fPIC", "-pthread", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=undefined"]
    builds = [subprocess.Popen([cxx, *flags, "-o", str(tmp_path / f"{name}.so"), str(_native_build.SRC_DIR / f"{name}.cpp")],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for name in ("jpeg_decode", "webp_decode")]
    for build in builds:
        log, _ = build.communicate(timeout=600)
        assert build.returncode == 0, log
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LD_PRELOAD=":".join(runtime), ASAN_OPTIONS="detect_leaks=0",
               PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", SANITIZED_FUZZ, str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "'ok': 0" not in run.stdout and "'raised': 0" not in run.stdout, run.stdout
