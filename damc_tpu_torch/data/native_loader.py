"""ctypes binding of the C++ batch engine (counterpart of
`damc_tpu/data/native_loader.py`): `csrc/host/batch_loader.cpp`, a copy of
the JAX package's `native/batch_loader.cpp`, prepares training batches
(epoch shuffle, per-sample horizontal flip, uint8 -> float32 [-1, 1]) on a
pool of C++ threads with a prefetch ring. Its shuffle is libstdc++'s
mt19937, so with the same seed it gives the JAX package's host stream,
batch for batch.

`make_loader` picks the engine for a uint8 (N, H, W, C) array and the NumPy
`datasets.Loader` for anything else (float stores, lazy LSUN views). The
library is built on first use; a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Tuple

import numpy as np

from . import _native_build
from .datasets import Loader


def _configure(lib: ctypes.CDLL) -> None:
    lib.damc_loader_create.restype = ctypes.c_void_p
    lib.damc_loader_create.argtypes = [
        ctypes.c_void_p,  # images
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.damc_loader_next.restype = ctypes.c_int
    lib.damc_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.damc_loader_destroy.restype = None
    lib.damc_loader_destroy.argtypes = [ctypes.c_void_p]


class NativeLoader:
    """C++-backed infinite batch stream over a uint8 (N, H, W, C) store.

    Yields (float32 batch in [-1, 1], int64 indices). Epochs are shuffled
    (Fisher-Yates) with drop_last semantics; horizontal flips are per-sample
    Bernoulli(0.5) when `augment_flip`. The store is borrowed, not copied:
    it is kept referenced here for the engine's lifetime.
    """

    native_prefetch = True  # the worker pool already overlaps batch assembly

    def __init__(
        self,
        images: np.ndarray,
        batch_size: int = 128,
        shuffle: bool = True,
        drop_last: bool = True,
        augment_flip: bool = False,
        seed: int = 0,
        num_threads: int = 0,
        prefetch_depth: int = 4,
    ):
        if not isinstance(images, np.ndarray) or images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(
                f"NativeLoader wants a uint8 (N, H, W, C) store, got "
                f"{getattr(images, 'dtype', type(images))} ndim={getattr(images, 'ndim', '?')}"
            )
        if not drop_last:
            raise ValueError("the native engine implements drop_last epochs only")
        self._lib = _native_build.load("batch_loader", _configure)
        self.images = np.ascontiguousarray(images)
        self.batch_size = int(batch_size)
        n, h, w, c = self.images.shape
        self.sample_shape = (h, w, c)
        if num_threads <= 0:
            num_threads = min(8, os.cpu_count() or 4)
        self._handle = self._lib.damc_loader_create(
            self.images.ctypes.data_as(ctypes.c_void_p), n, h, w, c,
            self.batch_size, int(shuffle), int(augment_flip), int(drop_last),
            seed, num_threads, prefetch_depth,
        )
        if not self._handle:
            raise ValueError(f"damc_loader_create refused the store {self.images.shape} at batch {batch_size}")

    def __len__(self) -> int:
        return len(self.images) // self.batch_size

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._handle:
            raise StopIteration
        out = np.empty((self.batch_size, *self.sample_shape), np.float32)
        idx = np.empty((self.batch_size,), np.int64)
        ok = self._lib.damc_loader_next(
            self._handle, out.ctypes.data_as(ctypes.c_void_p), idx.ctypes.data_as(ctypes.c_void_p)
        )
        if not ok:
            raise StopIteration
        return out, idx

    def stream(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite stream; ends (without RuntimeError) once closed."""
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def __iter__(self):
        return self.stream()

    def close(self) -> None:
        """Stop and join the worker threads; later `next` calls raise
        StopIteration."""
        if getattr(self, "_handle", None):
            self._lib.damc_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def make_loader(
    images,
    batch_size: int = 128,
    shuffle: bool = True,
    drop_last: bool = True,
    augment_flip: bool = False,
    seed: int = 0,
):
    """The native engine for a uint8 (N, H, W, C) ndarray with drop_last,
    the NumPy `Loader` otherwise (float arrays, lazy batch-indexable
    datasets such as `LSUNImages`), as the JAX package's `make_loader`
    chooses. The engine is not optional: where it is chosen and fails to
    build, this raises."""
    if isinstance(images, np.ndarray) and images.dtype == np.uint8 and images.ndim == 4 and drop_last:
        return NativeLoader(images, batch_size, shuffle, drop_last, augment_flip, seed)
    return Loader(images, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                  augment_flip=augment_flip, seed=seed)
