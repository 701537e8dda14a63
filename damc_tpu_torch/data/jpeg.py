"""The port's JPEG decoder (ctypes binding of `csrc/host/jpeg_decode.cpp`),
equal byte for byte to PIL's `Image.open(path).convert("RGB")` (PIL bundles
libjpeg-turbo; the C++ decoder computes what its default decompression
computes: the islow IDCT, fancy upsampling, the table-driven YCbCr to RGB
and YCCK to CMYK conversions; then PIL's inverted-CMYK reading and its
CMYK to RGB conversion). Baseline and progressive Huffman files, with 1, 3
or 4 components (grey; YCbCr or RGB; CMYK or YCCK), decode.

`decode_jpegs` takes a batch of files as bytes and decodes them on a pool
of C++ threads; the interpreter lock is released for the whole batch.
Arithmetic-coded, lossless, hierarchical and 12-bit files raise
NotImplementedError; corrupt or truncated data raises ValueError (so does a
progressive file whose scans leave coefficients that libjpeg would smooth);
each error names the file.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import numpy as np

from . import _native_build

JPEG_MAGIC = b"\xff\xd8"
MSG_BYTES = 256  # room for each file's error message
OK, UNSUPPORTED, CORRUPT = 0, 1, 2


def unsupported_message(name: str, feature: str, cache: Optional[str] = None) -> str:
    """The error of a file whose kind the port does not decode: the file,
    the feature, the ROADMAP item that owes it, and the way round (for an
    image folder, its `.npy` cache `cache`)."""
    return (
        f"{name}: {feature} is not decoded by the port (ROADMAP.md, queue 1, item 4c). Convert the "
        "file to baseline or progressive JPEG, PNG or WebP, or make the `.npy` cache "
        f"{cache or '<folder>_<size>.npy'} with the JAX package's load_image_folder_cached on a machine "
        "with PIL: the port's load_image_folder_cached reads it as it is."
    )


def _configure(lib: ctypes.CDLL) -> None:
    lib.damc_jpeg_header.restype = ctypes.c_int
    lib.damc_jpeg_header.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.damc_jpeg_decode_batch.restype = None
    lib.damc_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t,
    ]


def _raise(status: int, name: str, msg: str, cache: Optional[str]) -> None:
    if status == UNSUPPORTED:
        raise NotImplementedError(unsupported_message(name, f"a JPEG with {msg}", cache))
    raise ValueError(f"{name}: corrupt or truncated JPEG: {msg}")


def jpeg_size(data: bytes, name: str = "<bytes>", cache: Optional[str] = None):
    """(width, height) of a JPEG, read from its frame header; raises
    as `decode_jpegs` does for a file it would refuse."""
    lib = _native_build.load("jpeg_decode", _configure)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(MSG_BYTES)
    st = lib.damc_jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), msg, MSG_BYTES)
    if st != OK:
        _raise(st, name, msg.value.decode(errors="replace"), cache)
    return w.value, h.value


def decode_jpegs(
    blobs: Sequence[bytes], names: Optional[Sequence[str]] = None, threads: int = 0, cache: Optional[str] = None
) -> List[np.ndarray]:
    """The RGB pixels (H, W, 3) uint8 of each JPEG file in `blobs`, as PIL's
    `Image.open(...).convert("RGB")` gives them. Every header is read
    before anything is decoded, so a file of an unsupported kind raises
    first. `threads` (default: the machine's cores, at most 16) decode the
    batch; the result does not depend on it. `names` label errors; `cache`
    is the image folder's `.npy` cache, the way round an error names."""
    names = list(names) if names is not None else [f"<bytes {i}>" for i in range(len(blobs))]
    n = len(blobs)
    if n == 0:
        return []
    blobs = [bytes(b) for b in blobs]
    outs = []
    for b, name in zip(blobs, names):
        w, h = jpeg_size(b, name, cache)
        outs.append(np.empty((h, w, 3), np.uint8))
    lib = _native_build.load("jpeg_decode", _configure)
    if threads <= 0:
        threads = min(16, os.cpu_count() or 4)
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    status = (ctypes.c_int * n)()
    msgs = ctypes.create_string_buffer(n * MSG_BYTES)
    lib.damc_jpeg_decode_batch(datas, lens, ptrs, n, threads, status, msgs, MSG_BYTES)
    for i in range(n):
        if status[i] != OK:
            raw = msgs.raw[i * MSG_BYTES:(i + 1) * MSG_BYTES]
            _raise(status[i], names[i], raw.split(b"\0", 1)[0].decode(errors="replace"), cache)
    return outs


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """One JPEG file's RGB pixels (H, W, 3) uint8."""
    return decode_jpegs([data], [name], threads=1)[0]
