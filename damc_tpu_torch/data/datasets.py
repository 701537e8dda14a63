"""Dataset readers of the port (counterpart of
`damc_tpu/data/datasets.py:40-120, 464-479`): CIFAR-10 from the python
pickle batches and SVHN from its .mat files, both as (N, 32, 32, 3) uint8;
the MNIST anomaly split from `mnist.npz`, and a seeded MNIST-shaped
`mnist.npz` writer for runs without the real file. The image-folder and
LSUN readers are not ported (ROADMAP.md, queue 1, item 4).
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Tuple

import numpy as np


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
