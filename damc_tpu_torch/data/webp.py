"""The port's WebP decoder (ctypes binding of `csrc/host/webp_decode.cpp`),
equal byte for byte to PIL's `Image.open(path).convert("RGB")` (PIL decodes
WebP through libwebp's animation decoder; the C++ decoder computes what
libwebp computes there: lossy VP8 frames with libwebp's fancy upsampling and
YUV to RGB conversion, lossless VP8L frames, the first frame of an
animation on its canvas).

`decode_webps` takes a batch of files as bytes and decodes them on a pool
of C++ threads; the interpreter lock is released for the whole batch.
Corrupt or truncated data raises ValueError naming the file.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import numpy as np

from . import _native_build

MSG_BYTES = 256  # room for each file's error message
OK, CORRUPT = 0, 2


def is_webp(head: bytes) -> bool:
    """Whether a file's first 12 bytes are a RIFF/WEBP header."""
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP"


def _configure(lib: ctypes.CDLL) -> None:
    lib.damc_webp_header.restype = ctypes.c_int
    lib.damc_webp_header.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.damc_webp_decode_batch.restype = None
    lib.damc_webp_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t,
    ]


def _raise(name: str, msg: str) -> None:
    raise ValueError(f"{name}: corrupt or truncated WebP: {msg}")


def webp_size(data: bytes, name: str = "<bytes>"):
    """(width, height) of a WebP file (its canvas), read from its container
    and the first frame's header; raises as `decode_webps` does for a file
    whose headers it would refuse."""
    lib = _native_build.load("webp_decode", _configure)
    w, h = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(MSG_BYTES)
    if lib.damc_webp_header(data, len(data), ctypes.byref(w), ctypes.byref(h), msg, MSG_BYTES) != OK:
        _raise(name, msg.value.decode(errors="replace"))
    return w.value, h.value


def decode_webps(blobs: Sequence[bytes], names: Optional[Sequence[str]] = None, threads: int = 0) -> List[np.ndarray]:
    """The RGB pixels (H, W, 3) uint8 of each WebP file in `blobs`, as PIL's
    `Image.open(...).convert("RGB")` gives them. Every header is read
    before anything is decoded. `threads` (default: the machine's cores, at
    most 16) decode the batch; the result does not depend on it. `names`
    label errors."""
    names = list(names) if names is not None else [f"<bytes {i}>" for i in range(len(blobs))]
    n = len(blobs)
    if n == 0:
        return []
    blobs = [bytes(b) for b in blobs]
    outs = []
    for b, name in zip(blobs, names):
        w, h = webp_size(b, name)
        outs.append(np.zeros((h, w, 3), np.uint8))  # an animation's canvas starts as zeros
    lib = _native_build.load("webp_decode", _configure)
    if threads <= 0:
        threads = min(16, os.cpu_count() or 4)
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    status = (ctypes.c_int * n)()
    msgs = ctypes.create_string_buffer(n * MSG_BYTES)
    lib.damc_webp_decode_batch(datas, lens, ptrs, n, threads, status, msgs, MSG_BYTES)
    for i in range(n):
        if status[i] != OK:
            raw = msgs.raw[i * MSG_BYTES:(i + 1) * MSG_BYTES]
            _raise(names[i], raw.split(b"\0", 1)[0].decode(errors="replace"))
    return outs


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """One WebP file's RGB pixels (H, W, 3) uint8."""
    return decode_webps([data], [name], threads=1)[0]
