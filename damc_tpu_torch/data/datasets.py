"""Dataset readers of the port (counterpart of
`damc_tpu/data/datasets.py:99-120`): CIFAR-10 from the python pickle
batches and SVHN from its .mat files, both as (N, 32, 32, 3) uint8. The
image-folder, LSUN and MNIST readers are not ported (ROADMAP.md, queue 1,
items 4 and 5).
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np


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
