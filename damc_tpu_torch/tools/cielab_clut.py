"""Write `damc_tpu_torch/data/cielab_clut.zlib`: the 33x33x33 grid of 16-bit
sRGB values into which LittleCMS optimizes PIL's LAB to RGB transform, each
node the unoptimized transform's value at the node (CIELab v2 profile, D50,
to sRGB, perceptual intent, 16-bit v4 Lab in, 16-bit RGB out, no
optimization). Run it where a LittleCMS 2 library is at hand, such as the
one Pillow's wheel bundles:

    python -m damc_tpu_torch.tools.cielab_clut [path/to/liblcms2.so]

It prints the library's version and the file's size. `data/cielab.py`
reads the file; the port calls no colour library at run time.
"""

from __future__ import annotations

import ctypes
import glob
import os
import sys
import zlib

import numpy as np

from ..data.cielab import CLUT_FILE, GRID


def _find_lcms() -> str:
    for entry in sys.path:
        hits = glob.glob(os.path.join(entry, "pillow.libs", "liblcms2*")) if entry else []
        if hits:
            return hits[0]
    raise SystemExit("no liblcms2 found: give its path")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    lib = ctypes.CDLL(argv[0] if argv else _find_lcms())
    vp = ctypes.c_void_p
    lib.cmsCreateLab2Profile.restype = vp
    lib.cmsCreateLab2Profile.argtypes = [vp]
    lib.cmsCreate_sRGBProfile.restype = vp
    lib.cmsCreateTransform.restype = vp
    lib.cmsCreateTransform.argtypes = [vp, ctypes.c_uint32, vp, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lib.cmsDoTransform.argtypes = [vp, vp, vp, ctypes.c_uint32]
    lab16 = (10 << 16) | (3 << 3) | 2  # TYPE_Lab_16
    rgb16 = (4 << 16) | (3 << 3) | 2  # TYPE_RGB_16
    no_optimize = 0x0100
    xf = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), lab16, lib.cmsCreate_sRGBProfile(), rgb16, 0,
                                no_optimize)
    g = np.floor(np.arange(GRID) * 65535 / (GRID - 1) + 0.5).astype(np.uint16)  # _cmsQuantizeVal
    nodes = np.ascontiguousarray(np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3))
    out = np.zeros_like(nodes)
    lib.cmsDoTransform(xf, nodes.ctypes.data, out.ctypes.data, len(nodes))
    delta = np.diff(out.astype(np.int32), axis=0, prepend=0).astype("<i2")
    CLUT_FILE.write_bytes(zlib.compress(delta.tobytes(), 9))
    lib.cmsGetEncodedCMMversion.restype = ctypes.c_int
    print(f"LittleCMS {lib.cmsGetEncodedCMMversion()}: {CLUT_FILE} ({CLUT_FILE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
