"""ctypes binding of `csrc/host/zstd_decode.cpp`: Zstandard (RFC 8878) as
libtiff 4.7's tif_zstd.c decodes a TIFF strip or tile through libzstd (PIL
hands every compressed TIFF to libtiff; Python 3.12 has no zstd module).
ctypes releases the interpreter lock around each call."""

from __future__ import annotations

import ctypes

import numpy as np

from . import _native_build

OK, CORRUPT, SHORT = range(3)


def _configure(lib: ctypes.CDLL) -> None:
    lib.damc_zstd_decode.restype = ctypes.c_int
    lib.damc_zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]


def zstd_decode(data: bytes, size: int, out: np.ndarray) -> int:
    """Decode one Zstandard strip or tile into out[:size] (uint8,
    contiguous); returns OK, CORRUPT or SHORT. A corrupt strip leaves the
    bytes past its last whole block as they were."""
    lib = _native_build.load("zstd_decode", _configure)
    return lib.damc_zstd_decode(data, len(data), out.ctypes.data, size)
