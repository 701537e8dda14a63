"""Dataset readers of the port (counterpart of
`damc_tpu/data/datasets.py:40-167, 464-479`): CIFAR-10 from the python
pickle batches and SVHN from its .mat files, both as (N, 32, 32, 3) uint8;
image folders (CelebA-64, CelebA-HQ) through the port's PNG decoder and
PIL's bilinear resize (`data/images.py`), with the JAX package's `.npy`
cache; the MNIST anomaly split from `mnist.npz`; and seeded writers of an
MNIST-shaped `mnist.npz` and of PNG trees for runs without the real files.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Optional, Tuple

import numpy as np

from .images import decode_parsed, parse_png, resize_bilinear

BATCH_BYTES = 64 << 20  # filtered bytes the folder reader decodes together (its work array is about 4x)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")  # the JAX reader's list
# Formats the JAX reader opens through PIL and the port does not decode.
UNDECODED = {".jpg": "JPEG", ".jpeg": "JPEG", ".webp": "WebP", ".bmp": "BMP"}


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
    this directory)."""
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
            np.save(cache_path, {"img": imgs, "lbl": lbls})

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
    order, extension list and `limit`; each image's shorter side resized
    to `size` by PIL's bilinear filter, then centre-cropped. PNG only: a
    JPEG, WebP or BMP file raises NotImplementedError before anything is
    decoded."""
    paths = []
    for dirpath, _, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            if fn.lower().endswith(IMAGE_EXTENSIONS):
                paths.append(osp.join(dirpath, fn))
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    for p in paths:
        kind = UNDECODED.get(osp.splitext(p)[1].lower())
        if kind:
            raise NotImplementedError(
                f"{p}: the port decodes PNG files only and has no {kind} decoder (ROADMAP.md, "
                f"queue 1, item 4b). Convert the folder to PNG, or make its cache "
                f"{root.rstrip('/')}_{size}.npy with the JAX package's load_image_folder_cached "
                "on a machine with PIL: the port's load_image_folder_cached reads it as it is."
            )
    out = np.empty((len(paths), size, size, 3), np.uint8)
    batch, nbytes = [], 0

    def flush():
        for (i, _), img in zip(batch, decode_parsed([png for _, png in batch])):
            out[i] = _resize_crop(img, size)
        batch.clear()

    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            batch.append((i, parse_png(f.read(), p)))
        nbytes += batch[-1][1].filtered.size
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
