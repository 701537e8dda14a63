"""LZMA (.xz) strips as libtiff's tif_lzma.c LZMADecode reads them: one
liblzma stream decoder (no memory limit, no flags), `lzma_code` run until
the strip is full, the stream ends or liblzma reports a fault; the strip
fails only where it is not full by then. A fault liblzma meets in the call
that fills the strip (a chunk's range coder left unfinished, a check that
does not match) goes unnoticed, as it does in libtiff.

The system's liblzma (the library Python's `lzma` module is built on) is
called through ctypes. There is no fallback: the standard library's `lzma`
raises in that last call, and so fails strips that libtiff and PIL decode.
Where liblzma cannot be loaded, the first LZMA strip raises naming it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

LZMA_OK, LZMA_STREAM_END = 0, 1


class _Stream(ctypes.Structure):
    """liblzma's lzma_stream (its ABI is stable across 5.x)."""

    _fields_ = ([("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t), ("total_in", ctypes.c_uint64),
                 ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                 ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p)]
                + [(f"reserved_ptr{i}", ctypes.c_void_p) for i in range(4)]
                + [(f"reserved_int{i}", ctypes.c_uint64) for i in range(4)]
                + [(f"reserved_size{i}", ctypes.c_size_t) for i in range(2)]
                + [(f"reserved_enum{i}", ctypes.c_int) for i in range(2)])


_lib: list = []
_lock = threading.Lock()


def _liblzma() -> ctypes.CDLL:
    """liblzma, loaded once; raises OSError naming it where it is missing."""
    with _lock:
        if not _lib:
            name = ctypes.util.find_library("lzma") or "liblzma.so.5"
            try:
                lib = ctypes.CDLL(name)
            except OSError as e:
                raise OSError(f"{name} (liblzma) cannot be loaded: LZMA-compressed TIFF strips need it") from e
            lib.lzma_stream_decoder.restype = ctypes.c_int
            lib.lzma_stream_decoder.argtypes = [ctypes.POINTER(_Stream), ctypes.c_uint64, ctypes.c_uint32]
            lib.lzma_code.restype = ctypes.c_int
            lib.lzma_code.argtypes = [ctypes.POINTER(_Stream), ctypes.c_int]
            lib.lzma_end.restype = None
            lib.lzma_end.argtypes = [ctypes.POINTER(_Stream)]
            _lib.append(lib)
        return _lib[0]


def unxz(data: bytes, size: int, out: np.ndarray) -> bool:
    """Decode an .xz strip into out[:size] as libtiff does; True where the
    strip is full."""
    lib = _liblzma()
    stream = _Stream()
    if lib.lzma_stream_decoder(ctypes.byref(stream), ctypes.c_uint64(2 ** 64 - 1), 0) != LZMA_OK:
        return False
    source = ctypes.create_string_buffer(bytes(data), len(data))
    try:
        stream.next_in, stream.avail_in = ctypes.addressof(source), len(data)
        stream.next_out, stream.avail_out = out.ctypes.data, size
        while stream.avail_out > 0:
            if lib.lzma_code(ctypes.byref(stream), 0) != LZMA_OK:  # the stream's end, or a fault
                break
        return stream.avail_out == 0
    finally:
        lib.lzma_end(ctypes.byref(stream))
