"""ctypes binding of `csrc/host/rle_decode.cpp`: the byte-serial loops of
TGA's, PCX's and SGI's run lengths, ICNS's packed channels and QOI's op
stream, each as PIL's reader runs it. ctypes releases the interpreter lock
around each call."""

from __future__ import annotations

import ctypes

import numpy as np

from . import _native_build

OK, TRUNCATED, OVERRUN, BROKEN = range(4)
FAULTS = {TRUNCATED: "image file is truncated", OVERRUN: "buffer overrun when reading image file",
          BROKEN: "broken run-length data"}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _configure(lib: ctypes.CDLL) -> None:
    signatures = {
        "damc_tga_rle": [ctypes.c_char_p, _I64, ctypes.c_int, _I64, _I64, _P],
        "damc_pcx_rle": [ctypes.c_char_p, _I64, _I64, _I64, ctypes.c_int, _I64, _P],
        "damc_sgi_rle": [ctypes.c_char_p, _I64, ctypes.c_int, _I64, _I64, ctypes.c_int, _P, ctypes.POINTER(_I64)],
        "damc_icns_rle": [ctypes.c_char_p, _I64, _I64, _P],
        "damc_qoi_decode": [ctypes.c_char_p, _I64, _I64, _P],
    }
    for fn, argtypes in signatures.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes


def _lib() -> ctypes.CDLL:
    return _native_build.load("rle_decode", _configure)


def tga_rle(data: bytes, depth: int, row_bytes: int, rows: int) -> tuple:
    """(status, rows x row_bytes uint8 in file order) of TGA run-length
    data; `depth` is the bytes a pixel."""
    out = np.zeros((rows, row_bytes), np.uint8)
    return _lib().damc_tga_rle(data, len(data), depth, row_bytes, rows, out.ctypes.data), out


def pcx_rle(data: bytes, row_bytes: int, width: int, bits: int, rows: int) -> tuple:
    """(status, rows x row_bytes uint8) of PCX run-length data, each row's
    planes moved as PcxDecode.c moves them (`bits`: the raw mode's bits a
    pixel)."""
    out = np.zeros((rows, row_bytes), np.uint8)
    return _lib().damc_pcx_rle(data, len(data), row_bytes, width, bits, rows, out.ctypes.data), out


def sgi_rle(body: bytes, bpc: int, width: int, height: int, bands: int) -> tuple:
    """(status, rows stored, height x (width * bands * bpc) uint8 in file
    order) of SGI run-length data; `body` is the file after its header."""
    out = np.zeros((height, width * bands * bpc), np.uint8)
    done = _I64(0)
    status = _lib().damc_sgi_rle(body, len(body), bpc, width, height, bands, out.ctypes.data, ctypes.byref(done))
    return status, done.value, out


def icns_rle(data: bytes, sizesq: int) -> tuple:
    """(status, 3 x sizesq uint8) of an ICNS entry's packed channels."""
    out = np.zeros((3, sizesq), np.uint8)
    return _lib().damc_icns_rle(data, len(data), sizesq, out.ctypes.data), out


def qoi(data: bytes, pixels: int) -> tuple:
    """(status, pixels x 3 uint8) of a QOI op stream."""
    out = np.zeros((pixels, 3), np.uint8)
    return _lib().damc_qoi_decode(data, len(data), pixels, out.ctypes.data), out
