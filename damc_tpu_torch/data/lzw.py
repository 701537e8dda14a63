"""ctypes binding of `csrc/host/lzw_decode.cpp`: GIF's LZW as Pillow's
GifDecode.c decodes a frame, and TIFF's LZW (the pre-5.0 codes too),
PackBits and ThunderScan as libtiff 4.7 decodes a strip or tile (PIL hands
every compressed TIFF to libtiff). ctypes releases the interpreter lock
around each call."""

from __future__ import annotations

import ctypes

import numpy as np

from . import _native_build

OK, TRUNCATED, BROKEN, CONFIG, OVERRUN, _, SHORT = range(7)
GIF_FAULTS = {TRUNCATED: "image file is truncated", BROKEN: "broken LZW data", CONFIG: "LZW code size past 12",
              OVERRUN: "LZW data past the frame"}


def _configure(lib: ctypes.CDLL) -> None:
    lib.damc_gif_decode.restype = ctypes.c_int
    lib.damc_gif_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for fn in (lib.damc_tiff_lzw, lib.damc_packbits):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.damc_thunderscan.restype = ctypes.c_int
    lib.damc_thunderscan.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]


def _lib() -> ctypes.CDLL:
    return _native_build.load("lzw_decode", _configure)


def gif_frame(data: bytes, bits: int, interlace: bool, image: np.ndarray, box) -> int:
    """Decode a GIF frame's LZW data (`data`: from its first sub-block to
    the end of the file) into `image` (H, W) uint8 over `box` (x0, y0, x1,
    y1), as PIL's decoder fills it; returns OK or the fault's code."""
    x0, y0, x1, y1 = box
    return _lib().damc_gif_decode(data, len(data), bits, int(interlace), image.ctypes.data, image.strides[0],
                                  x0, y0, x1 - x0, y1 - y0)


def tiff_lzw(data: bytes, size: int, out: np.ndarray) -> int:
    """Decode one TIFF LZW strip or tile into out[:size] (uint8,
    contiguous); returns OK or the fault's code. A corrupt strip leaves the
    bytes past what it decoded as they were."""
    return _lib().damc_tiff_lzw(data, len(data), out.ctypes.data, size)


def packbits(data: bytes, size: int, out: np.ndarray) -> int:
    """Decode one TIFF PackBits strip or tile into out[:size]; returns OK
    or SHORT."""
    return _lib().damc_packbits(data, len(data), out.ctypes.data, size)


def thunderscan(data: bytes, size: int, width: int, out: np.ndarray) -> int:
    """Decode one ThunderScan strip or tile of rows `width` 4-bit pixels
    wide into out[:size]; returns OK or the fault's code."""
    return _lib().damc_thunderscan(data, len(data), out.ctypes.data, size, width)
