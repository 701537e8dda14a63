"""ctypes binding of `csrc/host/fax_decode.cpp`: the CCITT Group 3 and
Group 4 fax codes of TIFF compressions 2, 3, 4 and 32771 as libtiff 4.7's
tif_fax3.c decodes a strip or tile (PIL hands every compressed TIFF to
libtiff). ctypes releases the interpreter lock around each call."""

from __future__ import annotations

import ctypes

import numpy as np

from . import _native_build

OK, FAIL, OVERFLOW = range(3)
RLE, RLE_WORD, G3, G3_2D, G4 = range(5)


def _configure(lib: ctypes.CDLL) -> None:
    lib.damc_fax_decode.restype = ctypes.c_int
    lib.damc_fax_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]


class State:
    """The codec state libtiff keeps from strip to strip of an image: its
    FAXMODE_NOEOL flag, which Group 3 data without an EOL's final 1 sets."""

    def __init__(self):
        self.noeol = ctypes.c_int(0)


def fax_decode(data: bytes, out: np.ndarray, mode: int, width: int, row_bytes: int, state: State) -> int:
    """Decode one strip or tile into `out` (rows of `row_bytes`, uint8,
    contiguous), as libtiff fills its buffer: bits the decode does not
    reach keep their value. Returns OK, FAIL or OVERFLOW."""
    lib = _native_build.load("fax_decode", _configure)
    return lib.damc_fax_decode(data, len(data), out.ctypes.data, out.size, mode, width, row_bytes,
                               ctypes.byref(state.noeol))
