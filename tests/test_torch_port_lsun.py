"""LSUN in the port on the CPU: the read-only LMDB reader
(`damc_tpu_torch/data/native_lmdb.py`, `csrc/host/lmdb_reader.cpp`) over the
spec-conformant databases of tests/lmdb_fixture.py, after
tests/test_native_lmdb.py; `LSUNClassImages`, `LSUNImages` and `load_lsun`
against the JAX package's readers over fixture databases of JPEGs
(exactly: JAX's PIL path), JPEG, WebP, PNG and BMP payloads of every kind;
`_decode_crop_resize` (decode, centre crop, PIL's LANCZOS) against JAX's; and the port against JAX's libjpeg batch path
within that path's own bound."""

from __future__ import annotations

import io
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

import damc_tpu.data.native_jpeg as jax_native_jpeg
from damc_tpu.data import datasets as jax_datasets
from damc_tpu_torch.data import datasets
from damc_tpu_torch.data.native_lmdb import NativeLMDBEnv
from lmdb_fixture import PSIZE, build_lmdb
from torch_port_helpers import lsun_jpeg_db


def _items(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return {f"key_{i:05d}".encode(): rng.bytes(int(rng.randint(1, 400))) for i in range(n)}


# ---------------------------------------------------------------------------
# The LMDB reader
# ---------------------------------------------------------------------------


def _check_all(env, items):
    with env.begin() as txn:
        assert txn.stat()["entries"] == len(items)
        for k, v in items.items():
            assert txn.get(k) == v
        assert list(txn.cursor().iternext(keys=True, values=False)) == sorted(items)


LAYOUTS = {
    "flat": lambda rng: (_items(64, 0), {}),
    "two_hundred": lambda rng: (_items(200, 1), {}),
    "overflow": lambda rng: ({b"small": b"x" * 10, b"one_page": rng.bytes(3000),
                              b"three_pages": rng.bytes(2 * PSIZE + 500), b"ten_pages": rng.bytes(9 * PSIZE + 123)},
                             {}),
    "deep_tree": lambda rng: (_items(150, 3), dict(max_leaf_entries=4, max_branch_entries=3)),
    "live_meta_1": lambda rng: (_items(16, 4), dict(live_meta_slot=1)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reader_point_reads_and_sorted_scan(tmp_path, layout):
    """Every value read back by its key and the key scan in sorted order:
    small values, overflow chains of 1 to 10 pages, a tree four levels deep
    (the implicit -inf key on each branch page) and the newer meta page in
    either slot (the stale one describes an empty database)."""
    items, kw = LAYOUTS[layout](np.random.RandomState(2))
    env = NativeLMDBEnv(build_lmdb(str(tmp_path / "db_lmdb"), items, **kw))
    _check_all(env, items)
    with env.begin() as txn:
        assert txn.get(b"absent") is None and txn.get(b"") is None and txn.get(b"zzzz_beyond_all") is None
    env.close()
    with pytest.raises(RuntimeError, match="closed"):
        env.begin()


def test_reader_nosubdir_and_empty(tmp_path):
    items = _items(8, 5)
    env = NativeLMDBEnv(build_lmdb(str(tmp_path / "standalone.mdb"), items, subdir=False))
    _check_all(env, items)
    empty = NativeLMDBEnv(build_lmdb(str(tmp_path / "empty_lmdb"), {}))
    _check_all(empty, {})


def test_reader_refuses_garbage_missing_and_writes(tmp_path):
    bad = tmp_path / "bad_lmdb"
    bad.mkdir()
    (bad / "data.mdb").write_bytes(b"\x00" * (4 * PSIZE))
    with pytest.raises(OSError, match="magic"):
        NativeLMDBEnv(str(bad))
    with pytest.raises(OSError, match="stat|data.mdb"):
        NativeLMDBEnv(str(tmp_path / "does_not_exist"))
    env = NativeLMDBEnv(build_lmdb(str(tmp_path / "db_lmdb"), _items(8)))
    with pytest.raises(NotImplementedError):
        env.begin(write=True)


def test_reader_on_corrupted_databases_never_crashes(tmp_path):
    """Random byte corruptions of a valid database surface as OSError or as
    bounded wrong reads, never as a crash; and leaf pages whose `lower`
    field is 0xFFFF (the last page of the file included) are bounded."""
    items = _items(120, 11)
    items[b"big_val"] = np.random.RandomState(12).bytes(2 * PSIZE)
    base_dir = tmp_path / "base_lmdb"
    build_lmdb(str(base_dir), items, max_leaf_entries=8, max_branch_entries=4)
    base = (base_dir / "data.mdb").read_bytes()
    rng = np.random.RandomState(13)
    probe = list(items)[::7] + [b"big_val", b"absent"]
    for trial in range(60):
        data = bytearray(base)
        for _ in range(int(rng.randint(1, 8))):
            data[int(rng.randint(0, len(data)))] = int(rng.randint(0, 256))
        if trial == 0:  # every leaf's `lower` at its maximum
            for off in range(0, len(data), PSIZE):
                if struct.unpack_from("<H", data, off + 10)[0] == 0x02:
                    struct.pack_into("<H", data, off + 12, 0xFFFF)
        d = tmp_path / f"fuzz_{trial}_lmdb"
        d.mkdir()
        (d / "data.mdb").write_bytes(bytes(data))
        try:
            env = NativeLMDBEnv(str(d))
        except OSError:
            continue
        with env.begin() as txn:
            txn.stat()
            for k in probe:
                try:
                    txn.get(k)
                except OSError:
                    pass
            try:
                list(txn.cursor().iternext(keys=True, values=False))
            except OSError:
                pass
        env.close()


# ---------------------------------------------------------------------------
# LSUN readers against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_pil_path(monkeypatch):
    """JAX's LSUN batches through PIL, item by item (its libjpeg batch path,
    which the port does not copy, switched off)."""
    monkeypatch.setattr(jax_native_jpeg, "native_jpeg_available", lambda: False)


@pytest.mark.parametrize("size", [16, 64, 256])
def test_load_lsun_equals_jax(tmp_path, jax_pil_path, size):
    """Two classes of JPEGs up to 256x340 (4:2:0 and 4:4:4 by turns),
    shrunk or enlarged to `size`: the port's `load_lsun`, its `limit` and
    batch indexing across the two databases equal JAX's exactly."""
    root = str(tmp_path)
    lsun_jpeg_db(root, "tower_val", 7, seed=1, max_size=(256, 340), max_leaf_entries=3)
    lsun_jpeg_db(root, "bedroom_val", 5, seed=2, max_size=(90, 60))
    classes = ["tower_val", "bedroom_val"]
    want = jax_datasets.load_lsun(root, classes, size)
    for name in ("tower_val", "bedroom_val"):  # the port writes its own key caches
        os.remove(os.path.join(root, f"{name}_lmdb", "_keys_cache.pkl"))
    got = datasets.load_lsun(root, classes, size)
    assert got.shape == (12, size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(datasets.load_lsun(root, classes, size, limit=4), want[:4])
    view_p, view_j = datasets.LSUNImages(root, classes, size), jax_datasets.LSUNImages(root, classes, size)
    idx = np.array([11, 0, 7, 3, 6, 7])
    np.testing.assert_array_equal(view_p[idx], view_j[idx])
    np.testing.assert_array_equal(view_p[8], view_j[8])


def test_lsun_class_cache_and_errors_as_jax(tmp_path, jax_pil_path):
    """The key cache `_keys_cache.pkl` written by JAX is read by the port and
    the other way round; a stale cache and a missing key raise as in JAX;
    the class names expand as JAX expands them."""
    root = str(tmp_path)
    items = lsun_jpeg_db(root, "tower_train", 6, seed=3)
    db = os.path.join(root, "tower_train_lmdb")
    jax_view = jax_datasets.LSUNClassImages(db, size=32)
    port_view = datasets.LSUNClassImages(db, size=32)  # reads JAX's cache
    assert port_view.keys == jax_view.keys == sorted(items)
    np.testing.assert_array_equal(port_view[np.arange(6)], jax_view[np.arange(6)])
    with open(os.path.join(db, "_keys_cache.pkl"), "wb") as f:
        pickle.dump(port_view.keys[:4], f)
    for cls in (datasets.LSUNClassImages, jax_datasets.LSUNClassImages):
        with pytest.raises(ValueError, match="stale key cache"):
            cls(db, size=32)
    os.remove(os.path.join(db, "_keys_cache.pkl"))
    view = datasets.LSUNClassImages(db, size=32)
    view.keys[2] = b"not_a_key"
    with pytest.raises(KeyError, match="missing lmdb key at index 2"):
        view[np.arange(4)]
    for cls in (datasets.LSUNImages, jax_datasets.LSUNImages):
        assert cls._expand_classes("val") == [f"{c}_val" for c in datasets.LSUN_CATEGORIES]
        assert cls._expand_classes("test") == ["test"]
        with pytest.raises(ValueError, match="unknown LSUN class"):
            cls._expand_classes(["tower_dev"])


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (max(h // 12, 2), max(w // 12, 2), 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR))


def _encode(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


PAYLOADS = {  # format name: (PIL format, save options, PIL mode)
    "JPEG": ("JPEG", dict(quality=85), "RGB"), "PNG": ("PNG", {}, "RGB"), "BMP": ("BMP", {}, "RGB"),
    "WEBP": ("WEBP", dict(quality=80), "RGB"), "WEBP_LOSSLESS": ("WEBP", dict(lossless=True), "RGB"),
    "JPEG_PROGRESSIVE": ("JPEG", dict(quality=85, progressive=True), "RGB"),
    "JPEG_CMYK": ("JPEG", dict(quality=85), "CMYK"),
}


def _payload(img, fmt):
    kind, kw, mode = PAYLOADS[fmt]
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, kind, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", sorted(PAYLOADS))
@pytest.mark.parametrize("hw, size", [((340, 256), 256), ((96, 128), 64), ((40, 30), 64), ((50, 64), 50),
                                      ((7, 9), 32)], ids=["340x256to256", "down", "up", "crop_only", "tiny_up"])
def test_decode_crop_resize_equals_jax(fmt, hw, size):
    """Decode, centre crop to the shorter side and PIL's LANCZOS (a copy
    when the crop has the size already): the port's equals JAX's PIL path
    on baseline, progressive and CMYK JPEG, PNG, BMP, and lossy and
    lossless WebP payloads, downscaled and enlarged."""
    h, w = hw
    data = _payload(_smooth(h, w, h * w + len(fmt)), fmt)
    got = datasets._decode_crop_resize(data, size)
    np.testing.assert_array_equal(got, jax_datasets._decode_crop_resize(data, size))
    assert got.shape == (size, size, 3)


def test_webp_payload_raises_naming_item_4c(tmp_path, jax_pil_path):
    """WebP payloads decode now (item 4c; the name predates that): an LSUN
    database of lossy, lossless and alpha WebP, progressive and CMYK JPEG
    payloads gives `load_lsun` and batch indexing equal to the JAX
    package's PIL path, the WebPs and JPEGs of a batch each on their
    decoder's pool. A payload of a coding that neither the port nor PIL
    decodes (a hierarchical JPEG) raises NotImplementedError naming the
    item and the feature (the test's name is from when such errors named
    item 4c)."""
    items = {}
    for i in range(10):
        h, w = 30 + 7 * i, 64 - 3 * i
        fmt = ["WEBP", "WEBP_LOSSLESS", "JPEG_PROGRESSIVE", "JPEG_CMYK", "JPEG"][i % 5]
        items[f"{i:03d}".encode()] = _payload(_smooth(h, w, i), fmt)
    alpha = np.dstack([_smooth(40, 36, 99), np.arange(40 * 36, dtype=np.uint8).reshape(40, 36)])
    items[b"alpha"] = _encode(alpha, "WEBP", quality=75)
    root = str(tmp_path)
    build_lmdb(os.path.join(root, "tower_val_lmdb"), items)
    want = jax_datasets.load_lsun(root, ["tower_val"], 32)
    os.remove(os.path.join(root, "tower_val_lmdb", "_keys_cache.pkl"))
    got = datasets.load_lsun(root, ["tower_val"], 32)
    assert got.shape == (11, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    idx = np.array([10, 3, 0, 7])
    np.testing.assert_array_equal(datasets.LSUNImages(root, ["tower_val"], 32)[idx], want[idx])
    hierarchical = _encode(_smooth(20, 20, 0), "JPEG").replace(b"\xff\xc0", b"\xff\xc5", 1)
    with pytest.raises(NotImplementedError, match=r"item.jpg.*hierarchical.*neither by the port nor by PIL"):
        datasets._decode_crop_resize(hierarchical, 16, "item.jpg")
    build_lmdb(str(tmp_path / "bridge_val_lmdb"), {b"a": hierarchical})
    with pytest.raises(NotImplementedError, match="hierarchical.*neither by the port nor by PIL"):
        datasets.load_lsun(str(tmp_path), ["bridge_val"], 16)


def test_arithmetic_and_lossless_payloads_equal_jax(tmp_path, jax_pil_path):
    """An LSUN database of arithmetic-coded JPEGs (sequential, progressive,
    and progressive cut short, which libjpeg smooths) and lossless JPEGs
    beside baseline ones: `load_lsun`, batch indexing and one item equal
    the JAX package's PIL path."""
    from damc_tpu_torch.tools.jpeg_writer import write_jpeg, write_lossless_jpeg

    items = {}
    for i in range(8):
        pix = _smooth(30 + 9 * i, 70 - 4 * i, 50 + i)
        if i % 4 == 0:
            items[f"{i:03d}".encode()] = write_jpeg(pix, [(2, 2), (1, 1), (1, 1)], 80, arithmetic=True, restart=i)
        elif i % 4 == 1:
            data = write_jpeg(pix, [(2, 1), (1, 1), (1, 1)], 85, arithmetic=True, progressive=True)
            items[f"{i:03d}".encode()] = data if i < 4 else data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"
        elif i % 4 == 2:
            items[f"{i:03d}".encode()] = write_lossless_jpeg(pix, predictor=i % 7 + 1, pt=i // 4)
        else:
            items[f"{i:03d}".encode()] = _payload(pix, "JPEG")
    root = str(tmp_path)
    build_lmdb(os.path.join(root, "church_outdoor_val_lmdb"), items)
    want = jax_datasets.load_lsun(root, ["church_outdoor_val"], 48)
    os.remove(os.path.join(root, "church_outdoor_val_lmdb", "_keys_cache.pkl"))
    got = datasets.load_lsun(root, ["church_outdoor_val"], 48)
    assert got.shape == (8, 48, 48, 3)
    np.testing.assert_array_equal(got, want)
    idx = np.array([6, 1, 2, 5])
    np.testing.assert_array_equal(datasets.LSUNImages(root, ["church_outdoor_val"], 48)[idx], want[idx])
    data = items[b"002"]
    np.testing.assert_array_equal(datasets._decode_crop_resize(data, 20, "item.jpg"),
                                  jax_datasets._decode_crop_resize(data, 20))


def test_png_and_bmp_payloads_equal_jax(tmp_path, jax_pil_path):
    """An LSUN database with a payload of every PNG and BMP kind of
    `tools/image_writer.py::KINDS` (1-, 2-, 4- and 16-bit and Adam7 PNG;
    1-, 4- and 16-bit, bit-field and RLE BMP) beside JPEGs: `load_lsun`,
    a batch of `LSUNClassImages` and one item equal the JAX package's PIL
    path."""
    from damc_tpu_torch.tools.image_writer import KINDS, write_kind

    items = {f"{k:03d}".encode(): write_kind(kind, _smooth(30 + 5 * k, 70 - 2 * k, 70 + k), k)
             for k, kind in enumerate(KINDS)}
    items[b"jpeg"] = _payload(_smooth(40, 52, 99), "JPEG")
    root = str(tmp_path)
    build_lmdb(os.path.join(root, "kitchen_val_lmdb"), items)
    want = jax_datasets.load_lsun(root, ["kitchen_val"], 40)
    os.remove(os.path.join(root, "kitchen_val_lmdb", "_keys_cache.pkl"))
    got = datasets.load_lsun(root, ["kitchen_val"], 40)
    assert got.shape == (len(KINDS) + 1, 40, 40, 3)
    np.testing.assert_array_equal(got, want)
    idx = np.array([19, 3, 10, 12, 17, 18, 0])
    np.testing.assert_array_equal(datasets.LSUNClassImages(os.path.join(root, "kitchen_val_lmdb"), 40)[idx], want[idx])
    data = items[b"011"]
    np.testing.assert_array_equal(datasets._decode_crop_resize(data, 20, "item.png"),
                                  jax_datasets._decode_crop_resize(data, 20))


@pytest.mark.parametrize("hw", [(64, 64), (80, 48), (37, 91), (32, 40)])
def test_port_within_the_libjpeg_batch_paths_bound(tmp_path, hw):
    """JAX's libjpeg batch path (its own Lanczos-3 in float) stands within
    max 3 and mean 0.5 of PIL's transform (tests/test_native_jpeg.py:52-56);
    the port, which equals PIL, stands within the same bound of it, for a
    whole LSUN batch."""
    if not jax_native_jpeg.native_jpeg_available():
        pytest.skip("the JAX package's libjpeg batch path does not build here (no jpeglib.h)")
    h, w = hw
    blobs = {f"{i}".encode(): _encode(_smooth(h, w, h + w + i), "JPEG", quality=95) for i in range(4)}
    build_lmdb(str(tmp_path / "tower_val_lmdb"), blobs)
    want = jax_datasets.LSUNImages(str(tmp_path), ["tower_val"], 32)[np.arange(4)]
    os.remove(str(tmp_path / "tower_val_lmdb" / "_keys_cache.pkl"))
    got = datasets.LSUNImages(str(tmp_path), ["tower_val"], 32)[np.arange(4)]
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 3 and diff.mean() <= 0.5, (diff.max(), diff.mean())


def test_lsun_batches_through_the_loader(tmp_path):
    """The training surface: a lazy `LSUNImages` through the port's `Loader`
    gives batches in [-1, 1] equal to the decoded items."""
    lsun_jpeg_db(str(tmp_path), "church_outdoor_train", 10, seed=4)
    view = datasets.LSUNImages(str(tmp_path), ["church_outdoor_train"], 24)
    x, idx = next(iter(datasets.Loader(view, batch_size=4, seed=1)))
    assert x.shape == (4, 24, 24, 3) and x.dtype == np.float32
    np.testing.assert_array_equal(x, view[idx].astype(np.float32) / 255.0 * 2.0 - 1.0)
