"""The port's image-folder reader on the CPU: `damc_tpu_torch/data/images.py`
(PNG and BMP decoding, PIL's bilinear and Lanczos resize) against PIL
itself, and
`data/datasets.py::load_image_folder{,_cached}` and
`cli/common.py::load_dataset` against the JAX package's PIL-based reader.
Every comparison is exact (uint8 equality): the port's training data must
equal the JAX package's bit for bit. All inputs come from seeds."""

from __future__ import annotations

import dataclasses
import io
import os
import shutil
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from damc_tpu.cli import common as jax_common
from damc_tpu.data import datasets as jax_datasets
from damc_tpu.utils.config import preset as jax_preset
from damc_tpu_torch.cli import common
from damc_tpu_torch.config import preset
from damc_tpu_torch.data import datasets
from damc_tpu_torch.data.device_data import DeviceDataset
from damc_tpu_torch.data import images
from damc_tpu_torch.data.images import decode_parsed, decode_png, parse_png, resize_bilinear
from damc_tpu_torch.utils.logging import encode_png
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


def _smooth(rng, h, w, c):
    """Seeded smooth uint8 pixels (random walks along the rows), on which
    PIL's encoder picks a mix of the five row filters."""
    steps = rng.integers(-4, 5, (h, w, c))
    return np.clip(np.cumsum(steps, axis=1) + rng.integers(60, 200, (h, 1, c)), 0, 255).astype(np.uint8)


def _pil_png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG")
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_png_matches_pil(mode):
    """PIL-written 8-bit PNGs of every colour type, decoded and converted to
    RGB as PIL's `convert("RGB")` gives them."""
    rng = np.random.default_rng(1)
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    pix = _smooth(rng, 37, 53, channels)
    img = Image.fromarray(pix[..., 0] if channels == 1 else pix, mode)
    if mode == "P":  # 256 palette entries: PIL writes 8 bits a sample
        img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    data = _pil_png(img)
    got = decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    if mode != "P":  # PIL filters each row adaptively: more than one filter type is met
        assert len(set(parse_png(data).ftypes.tolist())) >= 2


def test_decode_png_on_synthetic_tree_files(tmp_path):
    """`synthetic_image_tree` files (rows cycling through all five filters)
    decode as PIL decodes them, and `decode_parsed` over files of two sizes
    together equals `decode_png` file by file."""
    datasets.synthetic_image_tree(str(tmp_path / "a"), 3, (41, 30), seed=2)
    datasets.synthetic_image_tree(str(tmp_path / "b"), 2, (17, 23), seed=3, start=3)
    paths = sorted(str(p) for p in tmp_path.rglob("*.png"))
    assert [os.path.basename(p) for p in paths] == [f"00000{i}.png" for i in range(5)]
    blobs = [open(p, "rb").read() for p in paths]
    assert sorted(set(parse_png(blobs[0]).ftypes.tolist())) == [0, 1, 2, 3, 4]
    singles = [decode_png(b, p) for b, p in zip(blobs, paths)]
    for got, p in zip(singles, paths):
        np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGB")))
    batched = decode_parsed([parse_png(b, p) for b, p in zip(blobs, paths)])
    for a, b in zip(batched, singles):
        np.testing.assert_array_equal(a, b)


def test_encode_png_filters_read_back_by_pil():
    """The port's writer with each filter type (and a cycle of them) on RGB
    and grey pixels: PIL reads the pixels back."""
    rng = np.random.default_rng(4)
    for pix in (_smooth(rng, 12, 9, 3), _smooth(rng, 12, 9, 1)[..., 0]):
        for filters in (0, 1, 2, 3, 4, np.arange(12) % 5):
            data = encode_png(pix, filters=filters)
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), pix)
            np.testing.assert_array_equal(decode_png(data), pix if pix.ndim == 3 else np.repeat(pix[..., None], 3, 2))


def _unsupported(case: str) -> bytes:
    rng = np.random.default_rng(5)
    rgb = _pil_png(Image.fromarray(_smooth(rng, 8, 8, 3)))
    if case == "16-bit":
        return _pil_png(Image.fromarray(rng.integers(0, 65535, (8, 8), dtype=np.uint16)))  # mode I;16
    if case == "1-bit":
        return _pil_png(Image.fromarray(rng.integers(0, 2, (8, 8), dtype=np.uint8) * 255).convert("1"))
    if case == "Adam7":  # PIL writes no Adam7 file
        from damc_tpu_torch.tools.image_writer import write_png

        return write_png(_smooth(rng, 8, 8, 3), 2, 8, interlace=True, filters=[0, 1, 2, 3, 4])
    if case == "CRC":
        return rgb[:40] + bytes([rgb[40] ^ 1]) + rgb[41:]
    if case == "critical":
        chunk = b"ABCD"
        extra = struct.pack(">I", 0) + chunk + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF)
        return rgb[:33] + extra + rgb[33:]
    raise ValueError(case)


DECODED_SINCE_SLICE_21 = {"16-bit", "1-bit", "Adam7"}  # refused until then; PIL decodes them


@pytest.mark.parametrize("case, match", [
    ("16-bit", "bit depth 16"), ("1-bit", "bit depth 1"), ("Adam7", "Adam7"), ("CRC", "CRC mismatch"),
    ("critical", "unknown critical chunk"),
])
def test_unsupported_or_corrupt_pngs_raise(case, match):
    """A corrupt PNG raises ValueError naming the file and the fault, before
    any pixel is produced. The 16-bit, 1-bit and Adam7 files, which the
    reader once refused (`match` names their feature), decode as PIL's
    `convert("RGB")` does."""
    data = _unsupported(case)
    if case in DECODED_SINCE_SLICE_21:
        np.testing.assert_array_equal(decode_png(data, "the_file.png"), _pil_rgb(data))
        return
    with pytest.raises(ValueError, match=f"the_file.png: .*{match}"):
        decode_png(data, "the_file.png")


@pytest.mark.parametrize("src, dst", [
    ((178, 218), (64, 78)),  # CelebA's aligned size to celeba64's shorter side: both downscales
    ((1024, 1024), (256, 256)),  # CelebA-HQ to 256
    ((97, 64), (64, 42)),
    ((40, 50), (64, 80)),  # upscale
    ((40, 218), (64, 78)),  # one side up, one down
    ((64, 64), (64, 64)),  # identity
], ids=lambda s: "x".join(map(str, s)))
def test_resize_matches_pil_bilinear(src, dst):
    """`resize_bilinear` equals PIL's `Image.resize(size, BILINEAR)` on 8-bit
    RGB, exactly; (width, height) in and out."""
    rng = np.random.default_rng(list(src + dst))
    img = rng.integers(0, 256, (src[1], src[0], 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BILINEAR))
    got = resize_bilinear(img, dst)
    assert got.shape == (dst[1], dst[0], 3)
    np.testing.assert_array_equal(got, want)


def _mixed_tree(root, rng):
    """A seeded tree with nested directories, mixed sizes and colour types,
    upper-case extensions and a file that is not an image."""
    specs = [
        ("b/x.png", "RGB", (45, 30)), ("a.png", "L", (20, 33)), ("b/c/y.PNG", "RGBA", (64, 64)),
        ("b/c/z.png", "LA", (30, 70)), ("d/w.png", "RGB", (178, 218)), ("d/v.png", "P", (25, 25)),
    ]
    for rel, mode, (w, h) in specs:
        channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
        pix = _smooth(rng, h, w, channels)
        img = Image.fromarray(pix[..., 0] if channels == 1 else pix, mode)
        if mode == "P":
            img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        img.save(path, "PNG")
    with open(os.path.join(root, "b", "notes.txt"), "w") as f:
        f.write("not an image")


@pytest.mark.parametrize("size, limit, batch_bytes", [(32, None, datasets.BATCH_BYTES), (64, 4, 4000)])
def test_load_image_folder_matches_jax(tmp_path, monkeypatch, size, limit, batch_bytes):
    """The JAX package's reader and the port's on one seeded tree; the
    second case decodes a file or two a batch."""
    _mixed_tree(str(tmp_path), np.random.default_rng(6))
    monkeypatch.setattr(datasets, "BATCH_BYTES", batch_bytes)
    want = jax_datasets.load_image_folder(str(tmp_path), size, limit=limit)
    got = datasets.load_image_folder(str(tmp_path), size, limit=limit)
    assert got.shape == want.shape == (limit or 6, size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_load_image_folder_empty_raises(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "notes.txt").write_text("no images here")
    with pytest.raises(FileNotFoundError, match="no images under"):
        datasets.load_image_folder(str(tmp_path), 16)


def test_load_image_folder_jpeg_raises_before_decoding(tmp_path, monkeypatch):
    """JPEGs decode (item 4b), and so do WebP and progressive JPEG files
    (item 4c; the name predates both): here they decode equal to the JAX
    package's reader. A JPEG coding that neither the port nor PIL decodes
    (12-bit samples) raises NotImplementedError naming the file and the
    feature, from its header, before any image of the folder is decoded.
    A file that `limit` leaves out does not raise."""
    _mixed_tree(str(tmp_path), np.random.default_rng(7))
    decoded = []
    for name in ("decode_parsed", "decode_jpegs", "decode_webps", "decode_bmp"):
        original = getattr(datasets, name)
        monkeypatch.setattr(datasets, name, lambda *a, _o=original, _n=name, **k: (decoded.append(_n), _o(*a, **k))[1])
    pix = _smooth(np.random.default_rng(8), 16, 16, 3)
    Image.fromarray(pix).save(tmp_path / "d" / "zy.webp", "WEBP")
    Image.fromarray(pix).save(tmp_path / "d" / "zy.jpg", "JPEG", progressive=True)
    buf = io.BytesIO()
    Image.fromarray(pix).save(buf, "JPEG")
    (tmp_path / "d" / "zz.jpg").write_bytes(buf.getvalue().replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1))
    with pytest.raises(NotImplementedError, match=r"zz\.jpg: a JPEG with 12-bit samples.*neither by the port nor by PIL"):
        datasets.load_image_folder(str(tmp_path), 16)
    assert decoded == []
    got = datasets.load_image_folder(str(tmp_path), 16, limit=8)
    assert got.shape == (8, 16, 16, 3) and set(decoded) == {"decode_parsed", "decode_jpegs", "decode_webps"}
    np.testing.assert_array_equal(got, jax_datasets.load_image_folder(str(tmp_path), 16, limit=8))


@pytest.mark.parametrize("size", [16, 64])
def test_load_image_folder_arithmetic_and_lossless_match_jax(tmp_path, size):
    """Arithmetic-coded JPEGs (sequential and progressive, one cut after
    its third scan, which libjpeg smooths) and lossless JPEGs (subsampled,
    with restarts) in a folder: `load_image_folder_cached` equals the JAX
    package's PIL reader, and the JAX package's cache is read as it is."""
    from damc_tpu_torch.tools.jpeg_writer import write_jpeg, write_lossless_jpeg

    rng = np.random.default_rng(22)
    root = tmp_path / "tree"
    root.mkdir()
    pics = [_smooth(rng, h, w, 3) for w, h in [(178, 218), (40, 52), (33, 21), (64, 64), (50, 70)]]
    progressive = write_jpeg(pics[2], [(2, 2), (1, 1), (1, 1)], 85, arithmetic=True, progressive=True)
    starts = [i for i in range(len(progressive) - 1) if progressive[i:i + 2] == b"\xff\xda"]
    files = {"a_arith.jpg": write_jpeg(pics[0], [(2, 2), (1, 1), (1, 1)], 80, arithmetic=True, restart=4),
             "b_arith_progressive.jpg": write_jpeg(pics[1], [(1, 1)] * 3, 90, arithmetic=True, progressive=True),
             "c_arith_cut.jpg": progressive[:starts[3]] + b"\xff\xd9",
             "d_lossless.jpg": write_lossless_jpeg(pics[3], predictor=4, restart_rows=8),
             "e_lossless_h2v2.jpg": write_lossless_jpeg(pics[4], [(2, 2), (1, 1), (1, 1)], predictor=7, pt=1)}
    for name, data in files.items():
        (root / name).write_bytes(data)
    want = jax_datasets.load_image_folder(str(root), size)
    assert want.shape == (5, size, size, 3)
    np.testing.assert_array_equal(datasets.load_image_folder_cached(str(root), size), want)
    (tmp_path / "again").mkdir()
    for name, data in files.items():
        (tmp_path / "again" / name).write_bytes(data)
    np.testing.assert_array_equal(datasets.load_image_folder_cached(str(tmp_path / "again"), size),
                                  jax_datasets.load_image_folder_cached(str(tmp_path / "again"), size))


def _adobe_ycck(data: bytes) -> bytes:
    """A PIL-written CMYK JPEG with its Adobe transform byte set to 2: the
    same file read as YCCK (libjpeg's colour-space rule)."""
    i = data.index(b"\xff\xee") + 4 + 11
    return data[:i] + b"\x02" + data[i + 1:]


def _every_kind_tree(root, rng):
    """One file of every kind the readers take: PNG; baseline, progressive
    (with restart markers), grey progressive, CMYK and YCCK JPEG; lossy,
    lossless, alpha and animated WebP; BMP. Sizes up to CelebA's."""
    os.makedirs(os.path.join(root, "s"), exist_ok=True)

    def save(rel, img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        data = buf.getvalue()
        with open(os.path.join(root, rel), "wb") as f:
            f.write(_adobe_ycck(data) if rel.endswith("ycck.jpg") else data)

    pics = [Image.fromarray(_smooth(rng, h, w, 3)) for w, h in
            [(178, 218), (40, 52), (33, 21), (64, 64), (50, 70), (29, 45), (80, 60), (37, 91), (52, 40), (45, 45),
             (61, 31), (20, 24)]]
    alpha = Image.fromarray(np.dstack([_smooth(rng, 45, 29, 3), rng.integers(0, 256, (45, 29), dtype=np.uint8)]))
    save("a.png", pics[0], "PNG")
    save("b_baseline.jpg", pics[1], "JPEG", quality=90)
    save("c_progressive.jpg", pics[2], "JPEG", progressive=True, subsampling=0, restart_marker_blocks=2)
    save("d_grey.jpeg", pics[3].convert("L"), "JPEG", progressive=True)
    save("e_cmyk.jpg", pics[4].convert("CMYK"), "JPEG", quality=85)
    save("s/f_ycck.jpg", pics[5].convert("CMYK"), "JPEG", progressive=True)
    save("s/g_lossy.webp", pics[6], "WEBP", quality=70)
    save("s/h_lossless.WEBP", pics[7], "WEBP", lossless=True)
    save("s/i_alpha.webp", alpha, "WEBP", quality=85)
    save("s/j_anim.webp", pics[8], "WEBP", save_all=True, append_images=[pics[9].resize(pics[8].size)], duration=40)
    save("s/k.bmp", pics[10], "BMP")
    save("s/l_palette.webp", pics[11].quantize(16).convert("RGB"), "WEBP", lossless=True)


@pytest.mark.parametrize("size, batch_bytes", [(32, datasets.BATCH_BYTES), (64, 4000)])
def test_every_image_kind_matches_jax(tmp_path, monkeypatch, size, batch_bytes):
    """A tree of every kind: `load_image_folder` and
    `load_image_folder_cached` equal the JAX package's PIL reader exactly,
    with every file in one batch and with a file or two a batch."""
    root = str(tmp_path / "tree")
    _every_kind_tree(root, np.random.default_rng(21))
    monkeypatch.setattr(datasets, "BATCH_BYTES", batch_bytes)
    want = jax_datasets.load_image_folder(root, size)
    assert want.shape == (12, size, size, 3)
    np.testing.assert_array_equal(datasets.load_image_folder(root, size), want)
    np.testing.assert_array_equal(datasets.load_image_folder_cached(root, size), want)
    np.testing.assert_array_equal(jax_datasets.load_image_folder_cached(root, size), want)  # the port's cache


def _bmp(pix: np.ndarray, bits: int, top_down: bool) -> bytes:
    """A BITMAPINFOHEADER BMP of RGB `pix` at 24 or 32 bits a pixel (the
    fourth byte of a 32-bit pixel set to 0x5A), written by hand: PIL writes
    bottom-up 24-bit files only."""
    h, w, _ = pix.shape
    step = bits // 8
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    px = np.full((h, w, step), 0x5A, np.uint8)
    px[..., :3] = pix[..., ::-1]
    rows[:, :w * step] = px.reshape(h, w * step)
    if not top_down:
        rows = rows[::-1]
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, rows.size, 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 14 + 40 + rows.size, 0, 0, 54) + info + rows.tobytes()


@pytest.mark.parametrize("case", ["pil_rgb", "pil_palette", "pil_grey", "pil_1x1", "24_top_down", "32_bottom_up",
                                  "32_top_down"])
def test_decode_bmp_matches_pil(case):
    """BI_RGB BMPs at 24 and 32 bits and with an 8-bit palette (colour or
    grey), bottom-up and top-down: `decode_bmp` equals PIL's
    `convert("RGB")`."""
    rng = np.random.default_rng(len(case))
    pix = _smooth(rng, 13, 1 if case == "pil_1x1" else 21, 3)[: 1 if case == "pil_1x1" else 13]
    if case.startswith("pil"):
        img = {"pil_palette": Image.fromarray(pix).quantize(41), "pil_grey": Image.fromarray(pix).convert("L")}.get(
            case, Image.fromarray(pix))
        buf = io.BytesIO()
        img.save(buf, "BMP")
        data = buf.getvalue()
    else:
        bits, top_down = int(case[:2]), case.endswith("top_down")
        data = _bmp(pix, bits, top_down)
    got = images.decode_bmp(data, "x.bmp")
    np.testing.assert_array_equal(got, _pil_rgb(data))
    if not case.startswith("pil"):
        np.testing.assert_array_equal(got, pix)


@pytest.mark.parametrize("edit, match", [
    (lambda d: d[:30] + struct.pack("<I", 1) + d[34:], "compression RLE8"),
    (lambda d: d[:28] + struct.pack("<H", 16) + d[30:], "16 bits a pixel"),
    (lambda d: d[:14] + struct.pack("<I", 20) + d[18:], "info header of 20 bytes"),
    (lambda d: d[:-40], "truncated BMP pixel data"),
    (lambda d: b"BX" + d[2:], "not a BMP file"),
], ids=["rle8", "16-bit", "header", "truncated", "signature"])
def test_unsupported_or_corrupt_bmps_raise(edit, match):
    """An edited 24-bit BMP: a bad header, signature or a file cut short
    raises ValueError naming the file and the fault. Set to RLE8 or to 16
    bits a pixel (which the reader once refused; `match` names the
    feature), the file is read as PIL reads it: pixels equal to PIL's, or
    a ValueError naming the file where PIL raises too."""
    data = edit(_bmp(_smooth(np.random.default_rng(9), 6, 7, 3), 24, False))
    if match in ("compression RLE8", "16 bits a pixel"):
        try:
            want = _pil_rgb(data)
        except (OSError, ValueError):
            with pytest.raises(ValueError, match="x.bmp: "):
                images.decode_bmp(data, "x.bmp")
            return
        np.testing.assert_array_equal(images.decode_bmp(data, "x.bmp"), want)
        return
    with pytest.raises(ValueError, match=f"x.bmp: .*{match}"):
        images.decode_bmp(data, "x.bmp")


def _mixed_format_tree(root, rng):
    """PNG, JPEG (4:2:0, 4:4:4 with restart markers, greyscale, an upper-
    case extension) and BMP (24-bit and palette) files in one tree, a
    .jpeg file that holds a PNG (decoded by its first bytes, as PIL opens
    it), a file that is not an image, and one file of each PNG and BMP kind
    of `tools/image_writer.py::KINDS` (1-, 2-, 4- and 16-bit and Adam7 PNG;
    1-, 4- and 16-bit, bit-field and RLE BMP), two of them of one size."""
    from damc_tpu_torch.tools.image_writer import KINDS, write_kind

    _mixed_tree(root, rng)
    for k, kind in enumerate(KINDS):
        w, h = (40, 30) if kind.startswith("png_adam7") else (int(rng.integers(20, 120)), int(rng.integers(20, 120)))
        rel = os.path.join("f" if k % 2 else os.path.join("b", "g"), f"{kind}.{kind[:3]}")
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(root, rel), "wb") as f:
            f.write(write_kind(kind, _smooth(rng, h, w, 3), k))
    specs = [("b/j1.jpg", dict(quality=75)), ("b/c/j2.JPEG", dict(quality=95, subsampling=0, restart_marker_blocks=2)),
             ("e/j3.jpg", dict(quality=50, mode="L")), ("e/b1.bmp", dict()), ("e/b2.bmp", dict(mode="P")),
             ("e/png_named.jpeg", dict(fmt="PNG"))]
    for rel, kw in specs:
        w, h = int(rng.integers(20, 200)), int(rng.integers(20, 200))
        img = Image.fromarray(_smooth(rng, h, w, 3))
        mode = kw.pop("mode", None)
        img = img.convert(mode) if mode == "L" else img.quantize(30) if mode == "P" else img
        fmt = kw.pop("fmt", None) or ("BMP" if rel.endswith(".bmp") else "JPEG")
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        img.save(path, fmt, **kw)


@pytest.mark.parametrize("size, batch_bytes", [(64, datasets.BATCH_BYTES), (32, 20000)])
def test_mixed_format_folder_matches_jax(tmp_path, monkeypatch, size, batch_bytes):
    """A folder of PNG, JPEG and BMP files of every kind the port reads:
    the port's `load_image_folder` equals the JAX package's PIL reader
    exactly, in one batch and in many."""
    _mixed_format_tree(str(tmp_path), np.random.default_rng(12))
    monkeypatch.setattr(datasets, "BATCH_BYTES", batch_bytes)
    want = jax_datasets.load_image_folder(str(tmp_path), size)
    got = datasets.load_image_folder(str(tmp_path), size)
    assert got.shape == want.shape == (31, size, size, 3)
    np.testing.assert_array_equal(got, want)


def _palette_png(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """An 8-bit palette PNG of `indices` with the PLTE `palette`, by hand."""
    chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF)
    h, w = indices.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), indices.astype(np.uint8)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", palette.tobytes()) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _palette_bmp(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """An 8-bit BMP of `indices` whose header counts len(palette) colours."""
    h, w = indices.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = indices[::-1]
    table = np.zeros((len(palette), 4), np.uint8)
    table[:, :3] = palette[:, ::-1]
    offset = 14 + 40 + table.size
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.size, 2835, 2835, len(palette), 0)
    return b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset) + info + table.tobytes() + rows.tobytes()


@pytest.mark.parametrize("fmt", ["png", "bmp"])
def test_palette_index_past_the_palette_is_black(fmt):
    """A palette of 2 colours and an index 5 (a PNG's PLTE; an 8-bit BMP
    whose header counts 2 colours): PIL decodes the index as black, and so
    does the port, where it used to raise."""
    indices = np.array([[0, 1, 5], [5, 1, 0]])
    palette = np.array([[10, 200, 30], [250, 40, 90]], np.uint8)
    data = (_palette_png if fmt == "png" else _palette_bmp)(indices, palette)
    want = _pil_rgb(data)
    got = decode_png(data, "x.png") if fmt == "png" else images.decode_bmp(data, "x.bmp")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[indices == 5], np.zeros((2, 3), np.uint8))
    np.testing.assert_array_equal(got[indices < 2], palette[indices[indices < 2]])


@pytest.mark.parametrize("src, dst", [
    ((178, 218), (64, 64)), ((256, 340), (256, 256)), ((40, 40), (256, 256)), ((1024, 1024), (256, 256)),
    ((64, 64), (64, 64)), ((97, 64), (64, 42)),
], ids=lambda s: "x".join(map(str, s)))
def test_resize_matches_pil_lanczos(src, dst):
    """`resize_lanczos` equals PIL's `Image.resize(size, LANCZOS)` on 8-bit
    RGB, exactly, down and up (negative weights included)."""
    rng = np.random.default_rng(list(src + dst) + [1])
    img = rng.integers(0, 256, (src[1], src[0], 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.LANCZOS))
    np.testing.assert_array_equal(images.resize_lanczos(img, dst), want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npy_cache_interchanges(tmp_path, writer):
    """A `<root>_<size>.npy` cache written by either package's
    load_image_folder_cached loads, memory-mapped and equal, in the other,
    without the images (they are removed after the write)."""
    root = str(tmp_path / "celeba64_train")
    datasets.synthetic_image_tree(root, 4, (40, 48), seed=9)
    write, read = (jax_datasets, datasets) if writer == "jax" else (datasets, jax_datasets)
    made = np.array(write.load_image_folder_cached(root, 24))
    assert os.path.exists(root + "_24.npy")
    shutil.rmtree(root)
    loaded = read.load_image_folder_cached(root, 24)
    assert isinstance(loaded, np.memmap) and loaded.mode == "r"
    np.testing.assert_array_equal(loaded, made)


def _celeba_tree(data, name, rng):
    """celeba64's or celebaHQ's folders under `data`, a few seeded PNGs each."""
    train, test = ("celeba64_train", "celeba64_test") if name == "celeba64" else ("train", "test")
    datasets.synthetic_image_tree(os.path.join(data, train), 3, (45, 55), seed=int(rng.integers(1 << 30)))
    datasets.synthetic_image_tree(os.path.join(data, test, "nested"), 2, (70, 60), seed=int(rng.integers(1 << 30)))


@pytest.mark.parametrize("name", ["celeba64", "celebaHQ"])
def test_load_dataset_matches_jax(tmp_path, name):
    """The port's `load_dataset` against JAX's for the image-folder presets,
    each package on its own copy of one seeded tree (both write the train
    split's cache): the uint8 train and FID arrays and the [-1, 1] test
    array, exactly."""
    _celeba_tree(str(tmp_path / "port"), name, np.random.default_rng(10))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    cfg_p, cfg_j = preset(name), jax_preset(name)
    cfg_p = dataclasses.replace(cfg_p, train=dataclasses.replace(cfg_p.train, data_path=str(tmp_path / "port")))
    cfg_j = dataclasses.replace(cfg_j, train=dataclasses.replace(cfg_j.train, data_path=str(tmp_path / "jax")))
    got, want = common.load_dataset(cfg_p), jax_common.load_dataset(cfg_j)
    size = cfg_p.model.image_size
    assert got[0].shape == (3, size, size, 3) and got[2].shape == (2, size, size, 3)
    assert got[0].dtype == np.uint8 and got[2].dtype == np.float32
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_device_dataset_takes_the_read_only_cache(tmp_path):
    """The memory-mapped cache goes into the store as it is, with no
    warning, and its batches are the cached images in [-1, 1]."""
    root = str(tmp_path / "train")
    datasets.synthetic_image_tree(root, 4, (20, 20), seed=11)
    store = datasets.load_image_folder_cached(root, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ds = DeviceDataset(store, batch_size=2, seed=0, device="cpu")
    x, idx = next(ds.stream())
    want = np.asarray(store)[idx.numpy()].astype(np.float32) / 255.0 * 2.0 - 1.0
    np.testing.assert_allclose(x.numpy(), want, atol=1e-6)
