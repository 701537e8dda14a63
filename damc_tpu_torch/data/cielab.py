"""PIL's conversion of mode LAB to RGB, byte for byte.

PIL converts LAB through LittleCMS (`ImageCms`): a transform from
`createProfile("LAB")` (CIELab, D50, ICC v2) to `createProfile("sRGB")`,
perceptual intent, no flags, on 8-bit samples. LittleCMS 2.17 optimizes it
into a 33x33x33 grid of 16-bit RGB values, each the unoptimized pipeline's
value at its node, and evaluates each pixel by its 16-bit tetrahedral
interpolation. This module does the same integer arithmetic over that grid,
which `tools/cielab_clut.py` samples from LittleCMS once and stores in
`cielab_clut.zlib` (the differences of consecutive values, zlib-coded):

  * a pixel's a* and b* are stored signed, as a TIFF's are; PIL hands
    LittleCMS each byte XOR 128, in its 8-bit v2 Lab encoding;
  * cmsFormatters' UnrollLabV2_8: x = v * 257, then v2 to v4 as
    ((x << 8) | x) >> 8, at most 0xFFFF;
  * cmsintrp.c TetrahedralInterp16 over the grid;
  * 16 to 8 bits as (v * 65281 + 2^23) >> 24.

`tests/test_torch_port_tiff_codings.py` holds the result to PIL's on 2^20
random inputs.
"""

from __future__ import annotations

import functools
import zlib
from pathlib import Path

import numpy as np

CLUT_FILE = Path(__file__).with_name("cielab_clut.zlib")
GRID = 33


@functools.lru_cache(maxsize=1)
def clut() -> np.ndarray:
    """The grid, (33 * 33 * 33 * 3,) int64, L outermost, RGB innermost."""
    delta = np.frombuffer(zlib.decompress(CLUT_FILE.read_bytes()), "<i2").astype(np.int64).reshape(-1, 3)
    return np.cumsum(delta, axis=0).reshape(-1) & 0xFFFF


def _v4(v: np.ndarray) -> np.ndarray:
    x = v.astype(np.int64) * 257
    return np.minimum(((x << 8) | x) >> 8, 0xFFFF)


def _tetrahedral(i0: np.ndarray, i1: np.ndarray, i2: np.ndarray) -> np.ndarray:
    t = clut()
    o2, o1, o0 = 3 * GRID * GRID, 3 * GRID, 3

    def fixed(a):  # _cmsToFixedDomain(a * Domain)
        a = a * (GRID - 1)
        return a + (a + 0x7FFF) // 0xFFFF

    fx, fy, fz = fixed(i0), fixed(i1), fixed(i2)
    rx, ry, rz = fx & 0xFFFF, fy & 0xFFFF, fz & 0xFFFF
    x1 = np.where(i0 == 0xFFFF, 0, o2)
    y1 = np.where(i1 == 0xFFFF, 0, o1)
    z1 = np.where(i2 == 0xFFFF, 0, o0)
    base = o2 * (fx >> 16) + o1 * (fy >> 16) + o0 * (fz >> 16)
    out = np.empty(i0.shape + (3,), np.int64)
    for ch in range(3):
        at = base + ch
        c0 = t[at]
        cx, cy, cz = t[at + x1], t[at + y1], t[at + z1]
        cxy, cxz, cyz, cxyz = t[at + x1 + y1], t[at + x1 + z1], t[at + y1 + z1], t[at + x1 + y1 + z1]
        rest = np.where(
            rx >= ry,
            np.where(ry >= rz, (cx - c0) * rx + (cxy - cx) * ry + (cxyz - cxy) * rz,
                     np.where(rz >= rx, (cxz - cz) * rx + (cxyz - cxz) * ry + (cz - c0) * rz,
                              (cx - c0) * rx + (cxyz - cxz) * ry + (cxz - cx) * rz)),
            np.where(rx >= rz, (cxy - cy) * rx + (cy - c0) * ry + (cxyz - cxy) * rz,
                     np.where(ry >= rz, (cxyz - cyz) * rx + (cy - c0) * ry + (cyz - cy) * rz,
                              (cxyz - cyz) * rx + (cyz - cz) * ry + (cz - c0) * rz))) + 0x8001
        out[..., ch] = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB of PIL's LAB samples (L, then a* and b* signed)."""
    lab = np.asarray(lab, np.uint8)
    out16 = _tetrahedral(_v4(lab[..., 0]), _v4(lab[..., 1] ^ 128), _v4(lab[..., 2] ^ 128))
    return (((out16 * 65281 + 8388608) >> 24) & 0xFF).astype(np.uint8)
