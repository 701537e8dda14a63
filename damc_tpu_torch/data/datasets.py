"""Dataset readers of the port (counterpart of
`damc_tpu/data/datasets.py`): CIFAR-10 from the python pickle batches and
SVHN from its .mat files, both as (N, 32, 32, 3) uint8; image folders
(CelebA-64, CelebA-HQ, FFHQ) through the port's own decoders and PIL's
bilinear resize, with the JAX package's `.npy` cache;
LSUN's lmdb databases (`LSUNClassImages`, `LSUNImages`, `load_lsun`)
through the port's LMDB reader, decoded, centre-cropped and resized by
PIL's Lanczos filter per item; the MNIST anomaly split from `mnist.npz`;
the NumPy batch `Loader`; and seeded writers of an MNIST-shaped
`mnist.npz` and of PNG trees for runs without the real files.

A file is decoded as PIL's `Image.open` picks its reader, whatever its
name: by walking PIL's open order (`formats.ORDER`), each format's accept
test and header probe, to the first format whose open succeeds. Every
decoder equals PIL's `Image.open(...).convert("RGB")` byte for byte
(`data/images.py`: PNG of every colour type and bit depth, Adam7 or not,
and BMP at 1, 4, 8, 16, 24 and 32 bits, BI_RGB, RLE8, RLE4 and
BI_BITFIELDS in PIL's layouts; `data/jpeg.py`: sequential and progressive JPEG,
Huffman- or arithmetic-coded, and lossless JPEG, grey, YCbCr, RGB, CMYK and
YCCK; `data/webp.py`: lossy, lossless and animated WebP, the LSUN tools'
export format; `data/gif.py`: a GIF's first frame; `data/tiff.py`: TIFF
under every coding PIL's libtiff decodes, in strips or tiles;
`data/pnm.py`: P1 to P6; `data/tga.py`, `data/qoi.py`, `data/ico.py` (ICO
and CUR), `data/icns.py`, `data/pcx.py` (PCX and DCX) and `data/sgi.py`);
the port itself never imports PIL. A JPEG coding PIL does not decode
either (hierarchical, lossless arithmetic, 12-bit) raises
NotImplementedError, as do the formats PIL reads that the port does not
yet (ROADMAP queue 3); a file that PIL refuses, opens but cannot load, or
cannot identify, or that is corrupt, raises ValueError naming the file.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from .formats import DECODE, ORDER, Source, identify
from .images import decode_bmp  # noqa: F401 (the BMP reader, as this module has always offered it)
from .images import decode_parsed, decode_png, parse_png, resize_bilinear, resize_lanczos
from .jpeg import decode_jpeg, decode_jpegs, jpeg_size
from .webp import decode_webp, decode_webps, webp_size

BATCH_BYTES = 64 << 20  # decoded bytes the folder reader decodes together (a PNG's work array is about 4x)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")  # the JAX reader's list
BATCHED = ("png", "jpeg", "webp")  # kinds the folder reader decodes in batches


def image_kind(data: Union[bytes, Source], name: str) -> str:
    """The kind of a file ("png", "jpeg", "bmp", "webp", "gif", "tiff",
    "pnm", "tga", "qoi", "ico", "cur", "icns", "pcx", "dcx", "sgi") as
    PIL's `Image.open` picks its reader (`formats.identify`), from the
    file's bytes or a `formats.Source` that reads only as far as PIL's
    probes do. A format PIL reads that the port does not yet raises
    NotImplementedError naming it; anything PIL cannot open and load
    raises ValueError naming the file."""
    return identify(data, name).kind


# kinds decoded one file at a time, in the order the folder reader meets them
SINGLE_DECODERS = {f.kind: f.decoder for f in ORDER if f.outcome == DECODE and f.kind not in BATCHED}


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """One image file's RGB pixels (H, W, 3) uint8, as PIL's
    `Image.open(...).convert("RGB")` gives them."""
    kind = image_kind(data, name)
    if kind == "png":
        return decode_png(data, name)
    if kind == "jpeg":
        return decode_jpeg(data, name)
    if kind == "webp":
        return decode_webp(data, name)
    return SINGLE_DECODERS[kind](data, name)


def adapt_labels(true_labels: np.ndarray, label: int) -> np.ndarray:
    """1 = anomalous (the held-out digit), 0 = normal."""
    out = np.zeros_like(true_labels)
    out[true_labels == label] = 1
    return out


def load_mnist_anomaly(root: str, heldout: int, split: str, cache: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, 28, 28, 1) float32 in [-1, 1], labels (N,) int32, 1 =
    anomalous) of the anomaly split of <root>/mnist.npz, as the reference
    makes it (`data/dataset.py:231-335`): all three splits together, the
    held-out digit out of train, a RandomState(42) permutation, 80% of the
    normal images for train, the other 20% and every held-out image, again
    permuted, for test. The split is cached in
    <root>/heldout_<digit>_<split>.npy (a pickled dict, read back only from
    this directory), written beside it and renamed into place, so another
    process (a rank of a run on the same host) finds it whole or not at
    all."""
    if split not in ("train", "test"):
        raise ValueError(f"split must be train or test, got {split!r}")
    cache_path = osp.join(root, f"heldout_{heldout}_{split}.npy")
    if cache and osp.exists(cache_path):
        dataset = np.load(cache_path, allow_pickle=True).item()
        imgs, lbls = dataset["img"], dataset["lbl"]
    else:
        with np.load(osp.join(root, "mnist.npz")) as f:
            data = dict(f)
        full_x = np.concatenate([data["x_train"], data["x_test"], data["x_valid"]], axis=0)
        full_y = np.concatenate([data["y_train"], data["y_test"], data["y_valid"]], axis=0)

        normal_x = full_x[full_y != heldout]
        normal_y = full_y[full_y != heldout]

        rng = np.random.RandomState(42)
        inds = rng.permutation(normal_x.shape[0])
        normal_x, normal_y = normal_x[inds], normal_y[inds]

        index = int(normal_x.shape[0] * 0.8)
        if split == "train":
            imgs, lbls = normal_x[:index], adapt_labels(normal_y[:index], heldout)
        else:
            test_x = np.concatenate([normal_x[index:], full_x[full_y == heldout]], axis=0)
            test_y = np.concatenate([normal_y[index:], full_y[full_y == heldout]], axis=0)
            inds = rng.permutation(test_x.shape[0])
            imgs, lbls = test_x[inds], adapt_labels(test_y[inds], heldout)
        if cache:
            tmp = f"{cache_path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, {"img": imgs, "lbl": lbls})
            os.replace(tmp, cache_path)

    imgs = np.asarray(imgs)
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    imgs = imgs.reshape(-1, 28, 28, 1).astype(np.float32)
    return imgs * 2.0 - 1.0, np.asarray(lbls).astype(np.int32)


def synthetic_mnist_npz(path: str, n_per_split=(600, 100, 100), seed: int = 0) -> None:
    """Write an MNIST-shaped mnist.npz made from `seed` (x_* float32 (n,
    784) in [0, 1], y_* digits): each digit a bright 7x7 block of its own on
    dim noise. The same file as the JAX package's writer
    (`damc_tpu/data/datasets.py:464-479`), drawn in one call per split: the
    RandomState gives the same numbers in one draw as image by image."""
    rng = np.random.RandomState(seed)
    out = {}
    for split, n in zip(("train", "test", "valid"), n_per_split):
        y = rng.randint(0, 10, size=n)
        img = rng.rand(n, 28, 28) * 0.2
        r, c = np.divmod(y, 4)
        rows = (r * 7)[:, None] + np.arange(7)  # (n, 7)
        cols = (c * 7)[:, None] + np.arange(7)
        img[np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :]] += 0.8
        out[f"x_{split}"] = img.reshape(n, 784).astype(np.float32).clip(0, 1)
        out[f"y_{split}"] = y
    np.savez(path, **out)


def load_cifar10(root: str, split: str = "train") -> np.ndarray:
    """(N, 32, 32, 3) uint8 from <root>/cifar-10-batches-py (data_batch_1..5
    for 'train', test_batch otherwise)."""
    base = osp.join(root, "cifar-10-batches-py")
    files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    chunks = []
    for f in files:
        with open(osp.join(base, f), "rb") as fh:
            entry = pickle.load(fh, encoding="latin1")
        chunks.append(np.asarray(entry["data"], np.uint8))
    data = np.concatenate(chunks, axis=0).reshape(-1, 3, 32, 32)
    return data.transpose(0, 2, 3, 1)


def load_svhn(root: str, split: str = "train") -> np.ndarray:
    """(N, 32, 32, 3) uint8 from <root>/{split}_32x32.mat."""
    from scipy import io as sio

    mat = sio.loadmat(osp.join(root, f"{split}_32x32.mat"))
    return np.transpose(mat["X"], (3, 0, 1, 2)).astype(np.uint8)


def _resize_crop(img: np.ndarray, size: int) -> np.ndarray:
    """The shorter side resized to `size` (torchvision `Resize(size)`), then
    the centre crop, as the JAX reader does it through PIL."""
    h, w = img.shape[:2]
    scale = size / min(w, h)
    img = resize_bilinear(img, (max(size, round(w * scale)), max(size, round(h * scale))))
    h, w = img.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    return img[top:top + size, left:left + size]


def load_image_folder(root: str, size: int, limit: Optional[int] = None) -> np.ndarray:
    """(N, size, size, 3) uint8 of the images under `root`, equal to the JAX
    package's PIL reader (`damc_tpu/data/datasets.py:122-148`): its walk
    order, extension list and `limit`; each image decoded as PIL opens it
    (`image_kind`), whatever its name, its shorter side resized to `size`
    by PIL's bilinear filter, then centre-cropped. Every file is probed
    first, through a `formats.Source` that reads only the bytes PIL's
    probes read, before anything is decoded: a file that is no image, or
    of a format the port does not read yet, raises first, and a JPEG of a
    kind the port does not decode raises from its header, before its batch
    is decoded. Files are decoded in batches of about `BATCH_BYTES`: PNGs
    together (each pass shape of a batch unfiltered once, over files and
    over Adam7's passes), JPEGs and WebPs on their decoders' thread pools,
    the other kinds one by one (all but BMP counted into the batch by
    their decoded size)."""
    paths = []
    for dirpath, _, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            if fn.lower().endswith(IMAGE_EXTENSIONS):
                paths.append(osp.join(dirpath, fn))
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    cache = root.rstrip("/") + f"_{size}.npy"
    kinds = []
    for p in paths:
        src = Source(path=p)
        try:
            kinds.append(image_kind(src, p))
        finally:
            src.close()
    out = np.empty((len(paths), size, size, 3), np.uint8)
    pngs, jpegs, webps, nbytes = [], [], [], 0

    def flush():
        for (i, _), img in zip(pngs, decode_parsed([png for _, png in pngs])):
            out[i] = _resize_crop(img, size)
        imgs = decode_jpegs([b for _, b, _ in jpegs], [p for _, _, p in jpegs])
        for (i, _, _), img in zip(jpegs, imgs):
            out[i] = _resize_crop(img, size)
        for (i, _, _), img in zip(webps, decode_webps([b for _, b, _ in webps], [p for _, _, p in webps])):
            out[i] = _resize_crop(img, size)
        pngs.clear()
        jpegs.clear()
        webps.clear()

    for i, (p, kind) in enumerate(zip(paths, kinds)):
        with open(p, "rb") as f:
            data = f.read()
        if kind == "png":
            pngs.append((i, parse_png(data, p)))
            nbytes += pngs[-1][1].nbytes
        elif kind == "jpeg":
            w, h = jpeg_size(data, p)
            jpegs.append((i, data, p))
            nbytes += w * h * 3
        elif kind == "webp":
            w, h = webp_size(data, p)
            webps.append((i, data, p))
            nbytes += w * h * 3
        else:
            img = SINGLE_DECODERS[kind](data, p)
            out[i] = _resize_crop(img, size)
            nbytes += img.nbytes if kind != "bmp" else 0
        if nbytes >= BATCH_BYTES:
            flush()
            nbytes = 0
    flush()
    return out


def load_image_folder_cached(root: str, size: int, cache_path: Optional[str] = None) -> np.ndarray:
    """`load_image_folder` through the JAX package's cache
    (`damc_tpu/data/datasets.py:151-167`): the first call decodes into
    `<root>_<size>.npy` (np.save), later calls map it read-only. A cache
    written by either package loads in the other."""
    cache_path = cache_path or (root.rstrip("/") + f"_{size}.npy")
    if not osp.exists(cache_path):
        data = load_image_folder(root, size)
        np.save(cache_path, data)
        del data
    return np.load(cache_path, mmap_mode="r")


# --------------------------------------------------------------------------
# LSUN (lmdb databases of encoded images)
# --------------------------------------------------------------------------

LSUN_CATEGORIES = (
    "bedroom", "bridge", "church_outdoor", "classroom", "conference_room",
    "dining_room", "kitchen", "living_room", "restaurant", "tower",
)


def _crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Centre crop to the shorter side, then PIL's LANCZOS resize to
    (size, size) (a copy when the crop already has that size)."""
    crop = min(img.shape[:2])
    top = (img.shape[0] - crop) // 2
    left = (img.shape[1] - crop) // 2
    return resize_lanczos(img[top:top + crop, left:left + crop], (size, size))


def _decode_crop_resize(imgbuf: bytes, size: int, name: str = "<lsun item>") -> np.ndarray:
    """Encoded image bytes -> uint8 (size, size, 3): the reference's LSUN
    transform (`data/dataset.py:47-64`; `Image.ANTIALIAS`, the alias of
    LANCZOS), bit for bit `damc_tpu/data/datasets.py::_decode_crop_resize`,
    which goes through PIL."""
    return _crop_resize(decode_image(bytes(imgbuf), name), size)


class LSUNClassImages:
    """One LSUN class database as a lazily decoded, batch-indexable array
    (counterpart of `damc_tpu/data/datasets.py::LSUNClassImages`): point
    reads by key through the port's LMDB reader, the key list cached in
    `<root>/_keys_cache.pkl` (the JAX package's file: a cache written by
    either package serves the other), and `_decode_crop_resize` per item.

    `len()` and indexing with an int (one (size, size, 3) image) or an
    index array (a uint8 (B, size, size, 3) batch, its JPEG payloads and
    its WebP payloads decoded together on their decoders' thread pools)
    are the surface the
    `Loader` needs. `env` is injectable: anything with `begin()` returning
    a context manager whose value has `.stat()["entries"]`, `.get(key)` and
    `.cursor().iternext(keys=True, values=False)`."""

    def __init__(self, root: str, size: int = 256, env=None, cache_keys: bool = True):
        from .native_lmdb import NativeLMDBEnv

        self.root = root
        self.size = size
        self.env = env if env is not None else NativeLMDBEnv(root)
        with self.env.begin() as txn:
            self.length = int(txn.stat()["entries"])
        cache_path = osp.join(root, "_keys_cache.pkl")
        if cache_keys and osp.isfile(cache_path):
            with open(cache_path, "rb") as fh:
                self.keys = pickle.load(fh)
        else:
            with self.env.begin() as txn:
                self.keys = list(txn.cursor().iternext(keys=True, values=False))
            if cache_keys and osp.isdir(root):
                # Atomic and best-effort: dataset mounts are often read-only,
                # and a failed cache write must not stop a reader whose reads
                # all work; the rename keeps other readers from a torn file.
                try:
                    tmp = cache_path + f".tmp.{os.getpid()}"
                    with open(tmp, "wb") as fh:
                        pickle.dump(self.keys, fh)
                    os.replace(tmp, cache_path)
                except OSError as e:
                    print(f"[damc] lsun key cache not written ({e}); continuing uncached")
        if len(self.keys) != self.length:
            raise ValueError(
                f"stale key cache for {root}: {len(self.keys)} keys vs {self.length} entries; "
                "delete _keys_cache.pkl"
            )

    def __len__(self) -> int:
        return self.length

    def _get_buf(self, index: int) -> bytes:
        with self.env.begin() as txn:
            imgbuf = txn.get(self.keys[int(index)])
        if imgbuf is None:
            raise KeyError(f"missing lmdb key at index {index} in {self.root}")
        return bytes(imgbuf)

    def _name(self, index: int) -> str:
        return f"{self.root}[{int(index)}]"

    def __getitem__(self, index):
        if np.isscalar(index) or isinstance(index, (int, np.integer)):
            return _decode_crop_resize(self._get_buf(int(index)), self.size, self._name(index))
        index = np.asarray(index)
        bufs = [self._get_buf(int(j)) for j in index]
        names = [self._name(j) for j in index]
        out = np.empty((len(index), self.size, self.size, 3), np.uint8)
        kinds = [image_kind(b, n) for b, n in zip(bufs, names)]
        jpegs = [i for i, k in enumerate(kinds) if k == "jpeg"]
        for i, img in zip(jpegs, decode_jpegs([bufs[i] for i in jpegs], [names[i] for i in jpegs])):
            out[i] = _crop_resize(img, self.size)
        webps = [i for i, k in enumerate(kinds) if k == "webp"]
        for i, img in zip(webps, decode_webps([bufs[i] for i in webps], [names[i] for i in webps])):
            out[i] = _crop_resize(img, self.size)
        for i in sorted(set(range(len(bufs))) - set(jpegs) - set(webps)):
            out[i] = _decode_crop_resize(bufs[i], self.size, names[i])
        return out


class LSUNImages:
    """Several LSUN class databases as one batch-indexable view with
    cumulative indexing (counterpart of
    `damc_tpu/data/datasets.py::LSUNImages`): class c lives at
    `<root>/<c>_lmdb`. `classes` is a list such as `['tower_val']` or one of
    'train' and 'val' (all ten categories) or 'test'."""

    def __init__(self, root: str, classes="train", size: int = 256, envs=None):
        self.classes = self._expand_classes(classes)
        self.dbs = [
            LSUNClassImages(osp.join(root, f"{c}_lmdb"), size=size, env=None if envs is None else envs[i])
            for i, c in enumerate(self.classes)
        ]
        self.cum = np.cumsum([len(db) for db in self.dbs])
        self.size = size

    @staticmethod
    def _expand_classes(classes):
        if isinstance(classes, str):
            if classes == "test":
                return ["test"]
            if classes in ("train", "val"):
                return [f"{c}_{classes}" for c in LSUN_CATEGORIES]
            classes = [classes]
        classes = list(classes)
        for c in classes:
            cat, _, split = c.rpartition("_")
            if c != "test" and (cat not in LSUN_CATEGORIES or split not in ("train", "val")):
                raise ValueError(
                    f"unknown LSUN class {c!r}; valid: <category>_<train|val> "
                    f"with category in {LSUN_CATEGORIES} or 'test'"
                )
        return classes

    def __len__(self) -> int:
        return int(self.cum[-1]) if len(self.dbs) else 0

    def __getitem__(self, index):
        if np.isscalar(index) or isinstance(index, (int, np.integer)):
            index = int(index)
            db_i = int(np.searchsorted(self.cum, index, side="right"))
            base = 0 if db_i == 0 else int(self.cum[db_i - 1])
            return self.dbs[db_i][index - base]
        # One batch call per class database, so that each decodes its JPEGs together.
        index = np.asarray(index)
        out = np.empty((len(index), self.size, self.size, 3), np.uint8)
        db_ids = np.searchsorted(self.cum, index, side="right")
        for db_i in np.unique(db_ids):
            sel = np.nonzero(db_ids == db_i)[0]
            base = 0 if db_i == 0 else int(self.cum[db_i - 1])
            out[sel] = self.dbs[int(db_i)][index[sel] - base]
        return out


def load_lsun(root: str, classes, size: int = 256, limit: Optional[int] = None) -> np.ndarray:
    """The first `limit` (default all) images of the LSUN `classes` under
    `root`, decoded into a uint8 (N, size, size, 3) array (for training, use
    `LSUNImages` with the `Loader`, which decodes batch by batch)."""
    view = LSUNImages(root, classes, size=size)
    n = len(view) if limit is None else min(limit, len(view))
    return view[np.arange(n)]


# --------------------------------------------------------------------------
# Batching
# --------------------------------------------------------------------------

class Loader:
    """Epoch-shuffled batch iterator with optional horizontal flips (the
    port's copy of `damc_tpu/data/datasets.py::Loader`, whose
    RandomState draws it repeats: the same seed gives the same batches).

    Yields (images float32 [-1, 1] NHWC, indices or labels). Takes uint8
    [0, 255] or float32 [-1, 1] stores, and any batch-indexable store with
    `len()` (a lazy `LSUNImages`); converts batch by batch, so the resident
    copy stays the store's. `stream()` cycles over epochs forever."""

    def __init__(
        self,
        images,
        labels: Optional[np.ndarray] = None,
        batch_size: int = 128,
        shuffle: bool = True,
        drop_last: bool = True,
        augment_flip: bool = False,
        seed: int = 0,
    ):
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.augment_flip = augment_flip
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.images)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _to_float(self, batch: np.ndarray) -> np.ndarray:
        if batch.dtype == np.uint8:
            batch = batch.astype(np.float32) / 255.0 * 2.0 - 1.0
        return np.ascontiguousarray(batch, np.float32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.images)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            batch = self._to_float(self.images[idx])
            if self.augment_flip:
                flip = self._rng.rand(len(idx)) < 0.5
                batch[flip] = batch[flip, :, ::-1]
            lbl = self.labels[idx] if self.labels is not None else idx
            yield batch, lbl

    def stream(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite epoch-cycling stream."""
        if len(self) == 0:
            raise ValueError(
                f"Loader yields no batches: {len(self.images)} images < batch_size {self.batch_size} "
                "with drop_last: an infinite stream would spin forever"
            )
        while True:
            yield from self


def synthetic_image_tree(root: str, n: int, size: Tuple[int, int], seed: int = 0, start: int = 0) -> None:
    """Write `n` RGB PNGs of `size` = (width, height) made from `seed` to
    `root`/{start + i:06d}.png: smooth images (seeded noise at 1/32 of the
    size, enlarged by the bilinear resize) plus a little pixel noise, so
    that they compress as photos do. The rows' filter types cycle through
    None, Sub, Up, Average and Paeth, so a reader meets all five."""
    from ..utils.logging import encode_png

    w, h = int(size[0]), int(size[1])
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    ftypes = np.arange(h) % 5
    for i in range(n):
        low = rng.integers(0, 256, (max(h // 32, 2), max(w // 32, 2), 3), dtype=np.uint8)
        img = resize_bilinear(low, (w, h)).astype(np.int16) + rng.integers(-2, 3, (h, w, 3), dtype=np.int16)
        with open(osp.join(root, f"{start + i:06d}.png"), "wb") as f:
            f.write(encode_png(np.clip(img, 0, 255).astype(np.uint8), filters=ftypes))
