"""A JPEG writer, numpy only, for the files the port's decoder is held to
PIL on and that no library at hand writes: PIL writes baseline and
progressive Huffman files, but no arithmetic-coded or lossless ones.

* `write_jpeg`: DCT files from pixels. Forward DCT, one quantisation table
  scaled by quality as libjpeg scales it, any sampling factors, Adobe APP14
  or component-ID colour spaces, single-component scans, restart
  intervals. Huffman coding (baseline, the standard tables of Annex K) or
  arithmetic coding (T.81 Annex D, F.1.4, G.1.3: the QM coder as libjpeg's
  jcarith.c runs it), sequential or progressive with libjpeg's
  `jpeg_simple_progression` script, with optional DAC conditioning.
* `write_lossless_jpeg`: lossless files (SOF3, Annex H) from samples:
  predictors 1 to 7, a point transform, restart intervals, sampling
  factors, interleaved or single-component scans, markers and IDs.
  `lossless_expected` gives the pixels a decoder must return for one.

    from damc_tpu_torch.tools.jpeg_writer import write_jpeg, write_lossless_jpeg
    data = write_jpeg(rgb, [(2, 2), (1, 1), (1, 1)], quality=80, arithmetic=True, progressive=True)
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_VALS = list(range(12))
AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435"
    "363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798"
    "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
    "f5f6f7f8f9fa")
LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                   14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])


def _codes(bits, vals):
    code, k, table = 0, 0, {}
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


DC_CODES, AC_CODES = _codes(DC_BITS, DC_VALS), _codes(AC_BITS, list(AC_VALS))
_n = np.arange(8)
DCT = np.sqrt(2 / 8) * np.cos((2 * _n[None, :] + 1) * _n[:, None] * np.pi / 16)
DCT[0] /= np.sqrt(2)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


# ---------------------------------------------------------------------------
# Huffman coding
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out += b"\xff\x00" if self.acc == 0xFF else bytes([self.acc])
                self.acc, self.n = 0, 0

    def flush(self):  # pad with one bits
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _put_block(bits, blk, pred):
    s, val = _magnitude(blk[0] - pred)
    bits.put(*DC_CODES[s])
    if s:
        bits.put(val, s)
    last = max([k for k in range(1, 64) if blk[k]], default=0)
    run = 0
    for k in range(1, last + 1):
        if blk[k] == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*AC_CODES[0xF0])
            run -= 16
        s, val = _magnitude(blk[k])
        bits.put(*AC_CODES[(run << 4) | s])
        bits.put(val, s)
        run = 0
    if last < 63:
        bits.put(*AC_CODES[0x00])


# ---------------------------------------------------------------------------
# Arithmetic coding: the QM coder (T.81 Annex D) as jcarith.c runs it
# ---------------------------------------------------------------------------

# Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); entry 113 is
# the fixed probability 0.5 that sign and DC refinement bits use.
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0),
    (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0), (0x001a, 33, 10, 0),
    (0x000d, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0),
    (0x002c, 33, 9, 0), (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0),
    (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1),
    (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0), (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0), (0x34ee, 91, 85, 0),
    (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0),
    (0x56a8, 95, 96, 1), (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504f, 111, 107, 0),
    (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
# (Qe, Next_Index_MPS, Switch_MPS << 7 | Next_Index_LPS), as jaricom.c packs them
_ARITAB = [(qe, nm, (sw << 7) | nl) for qe, nl, nm, sw in _QE]
FIXED = 113


class _QMEncoder:
    """One entropy-coded segment of the QM coder (jcarith.c arith_encode
    and finish_pass): statistics bins are bytearrays of states, the MPS
    sense in bit 7."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        if self.zc:
            self.out += b"\x00" * self.zc
            self.zc = 0

    def _carry(self):  # an overflow carries into the buffered byte and turns stacked 0xFF bytes to 0x00
        if self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def _settle(self):  # no carry can reach the buffered byte or the stacked 0xFF bytes any more
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nm, nl = _ARITAB[sv & 0x7F]
        a = self.a - qe
        if val != (sv >> 7):
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nm
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:  # final bytes only where they are not 0x00
            self._zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if not self.c & mask:
                    break
                b = (self.c >> shift) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


class _ArithScan:
    """The statistics and predictions of one arithmetic-coded scan
    (jcarith.c encode_mcu, encode_mcu_DC_first, _AC_first, _DC_refine,
    _AC_refine); `restart()` ends a restart interval and starts them anew."""

    def __init__(self, ncomp: int, tables: Sequence[int], dac_l, dac_u, dac_k):
        self.ncomp, self.tables = ncomp, tables
        self.L, self.U, self.K = dac_l, dac_u, dac_k
        self.segments: List[bytes] = []
        self._start()

    def _start(self) -> None:
        self.enc = _QMEncoder()
        self.dc_stats = {t: bytearray(64) for t in set(self.tables)}
        self.ac_stats = {t: bytearray(256) for t in set(self.tables)}
        self.fixed = bytearray([FIXED])
        self.last_dc = [0] * self.ncomp
        self.dc_context = [0] * self.ncomp

    def restart(self) -> None:
        self.segments.append(self.enc.finish())
        self._start()

    def data(self) -> bytes:
        """The scan's entropy-coded segments with RST0, RST1, ... between them."""
        parts = self.segments + [self.enc.finish()]
        out = bytearray(parts[0])
        for i, part in enumerate(parts[1:]):
            out += bytes([0xFF, 0xD0 + i % 8]) + part
        return bytes(out)

    def _value(self, stats: bytearray, st: int, v: int, x: int, ac: bool) -> None:
        """Figures F.8 and F.9: v > 0 coded as v - 1, its category from bin
        st on (AC: the second decision in the same bin) then from bin x,
        its bits below the top one 14 bins further."""
        enc = self.enc
        v -= 1
        m = 0
        if v:
            enc.encode(stats, st, 1)
            m = 1
            v2 = v >> 1
            if ac and v2:
                enc.encode(stats, st, 1)
                m <<= 1
                v2 >>= 1
            if not ac or m > 1:
                st = x
                while v2:
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
        enc.encode(stats, st, 0)
        st += 14
        while m > 1:
            m >>= 1
            enc.encode(stats, st, 1 if m & v else 0)

    def dc(self, ci: int, value: int) -> None:
        t = self.tables[ci]
        stats = self.dc_stats[t]
        s0 = self.dc_context[ci]
        v = value - self.last_dc[ci]
        enc = self.enc
        if v == 0:
            enc.encode(stats, s0, 0)
            self.dc_context[ci] = 0
            return
        self.last_dc[ci] = value
        enc.encode(stats, s0, 1)
        enc.encode(stats, s0 + 1, 1 if v < 0 else 0)
        st, ctx = (s0 + 3, 8) if v < 0 else (s0 + 2, 4)
        v = abs(v)
        # the category of v - 1 decides the next context (F.1.4.4.1.2)
        cat = 0 if v == 1 else 1 << ((v - 1).bit_length() - 1)
        if cat < (1 << self.L[t]) >> 1:
            ctx = 0
        elif cat > (1 << self.U[t]) >> 1:
            ctx += 8
        self.dc_context[ci] = ctx
        self._value(stats, st, v, 20, ac=False)

    def ac(self, ci: int, zz: Sequence[int], ss: int, se: int) -> None:
        """AC coefficients ss..se of a block, zz in zigzag order, already
        shifted by Al (sequential: ss=1, se=63)."""
        t = self.tables[ci]
        stats = self.ac_stats[t]
        enc = self.enc
        ke = se
        while ke >= ss and zz[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(stats, st, 0)  # not EOB
            while zz[k] == 0:
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            enc.encode(stats, st + 1, 1)
            v = zz[k]
            enc.encode(self.fixed, 0, 1 if v < 0 else 0)
            self._value(stats, st + 2, abs(v), 189 if k <= self.K[t] else 217, ac=True)
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)  # EOB

    def dc_refine(self, bit: int) -> None:
        self.enc.encode(self.fixed, 0, bit)

    def ac_refine(self, ci: int, block: Sequence[int], ss: int, se: int, ah: int, al: int) -> None:
        """Figure G.10: block in zigzag order, unshifted."""
        stats = self.ac_stats[self.tables[ci]]
        enc = self.enc

        def shifted(k, by):
            v = block[k]
            return -((-v) >> by) if v < 0 else v >> by

        ke = se
        while ke > 0 and shifted(ke, al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and shifted(kex, ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, st, 0)
            while True:
                v = shifted(k, al)
                if v:
                    if abs(v) >> 1:  # nonzero before this scan: its next bit
                        enc.encode(stats, st + 2, abs(v) & 1)
                    else:  # newly nonzero: its sign
                        enc.encode(stats, st + 1, 1)
                        enc.encode(self.fixed, 0, 1 if v < 0 else 0)
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)


def _simple_progression(ncomp: int, ycc: bool) -> List[Tuple[Tuple[int, ...], int, int, int, int]]:
    """libjpeg's jpeg_simple_progression (jcparam.c): (components, Ss, Se,
    Ah, Al) of each scan; the YCbCr script for 3 YCbCr components, the
    all-purpose one otherwise. DC scans hold every component."""
    every = tuple(range(ncomp))
    if ncomp == 3 and ycc:
        return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), (every, 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    scans = [(every, 0, 0, 0, 1)]
    for ss, se, ah, al in ((1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1)):
        scans += [((c,), ss, se, ah, al) for c in every]
    scans.append((every, 0, 0, 1, 0))
    scans += [((c,), 1, 63, 1, 0) for c in every]
    return scans


# ---------------------------------------------------------------------------
# DCT files
# ---------------------------------------------------------------------------


def _planes(img, marker, ids):
    img = np.asarray(img, np.float64)
    rgb_samples = marker == "adobe-rgb" or ids == (82, 71, 66)
    if img.ndim == 2:
        return [img]
    if img.shape[2] == 4:
        return [img[..., c] for c in range(4)]
    if rgb_samples:
        return [img[..., 0], img[..., 1], img[..., 2]]
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return [0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b]


def _units(comps, sampling, height, width, hmax, vmax, mcux, mcuy):
    """The blocks (component, block row, block column) of each MCU of a
    scan over `comps`: one block an MCU over the component's own size for
    a single component, else the interleaved MCUs of the frame."""
    if len(comps) == 1:
        c = comps[0]
        h, v = sampling[c]
        rows, cols = -(-(-(-height * v // vmax)) // 8), -(-(-(-width * h // hmax)) // 8)
        return [[(c, by, bx)] for by in range(rows) for bx in range(cols)]
    return [[(c, my * sampling[c][1] + y, mx * sampling[c][0] + x) for c in comps
             for y in range(sampling[c][1]) for x in range(sampling[c][0])]
            for my in range(mcuy) for mx in range(mcux)]


def _marker_segment(marker: str) -> bytes:
    if marker == "jfif":
        return _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if marker.startswith("adobe"):
        transform = {"adobe-rgb": 0, "adobe-ycc": 1, "adobe-cmyk": 0, "adobe-ycck": 2}[marker]
        return _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([transform]))
    if marker != "none":
        raise ValueError(f"unknown marker {marker!r}")
    return b""


def write_jpeg(img, sampling, quality=75, restart=0, interleaved=True, marker="jfif", ids=None,
               arithmetic=False, progressive=False, dac: Optional[Dict[Tuple[int, int], int]] = None) -> bytes:
    """JPEG bytes of `img`, (H, W) grey, (H, W, 3) RGB or (H, W, 4) samples
    written as they are (CMYK, or YCCK's Y, Cb, Cr, K), with `sampling` =
    [(h, v)] per component. `marker` is "jfif", "adobe-rgb" (Adobe APP14,
    transform 0: the samples are RGB), "adobe-ycc" (transform 1),
    "adobe-cmyk" (transform 0), "adobe-ycck" (transform 2) or "none"; `ids`
    the component IDs ((82, 71, 66) is 'R', 'G', 'B': RGB samples).
    `restart` is the restart interval in MCUs (0: none); `interleaved`
    False writes one scan a component (sequential files).

    Baseline Huffman by default (the standard tables). `arithmetic` codes
    the same coefficients arithmetically (SOF9), or with `progressive` in
    libjpeg's simple progression (SOF10); luma uses conditioning tables 0,
    the other components 1. `dac` {(class, table): value} writes a DAC
    segment: class 0 value (U << 4) | L for a DC table, class 1 value K
    for an AC table (defaults L=0, U=1, K=5)."""
    if progressive and not arithmetic:
        raise ValueError("progressive Huffman files: PIL writes them (save(..., progressive=True))")
    planes = _planes(img, marker, ids)
    height, width = np.asarray(img).shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    scale = (5000 / quality if quality < 50 else 200 - 2 * quality) / 100  # libjpeg's quality scaling
    q = np.clip(np.floor(LUMA_Q * scale + 0.5), 1, 255).astype(np.int64)
    ids = ids or tuple(range(1, len(planes) + 1))
    blocks = []
    for p, (h, v) in zip(planes, sampling):
        fy, fx = vmax // v, hmax // h
        ph, pw = -(-height // fy) * fy, -(-width // fx) * fx
        p = np.pad(p, ((0, ph - height), (0, pw - width)), mode="edge")
        p = p.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        bh, bw = mcuy * v * 8, mcux * h * 8
        p = np.pad(p, ((0, bh - p.shape[0]), (0, bw - p.shape[1])), mode="edge") - 128
        tiles = p.reshape(bh // 8, 8, bw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", DCT, tiles, DCT).reshape(bh // 8, bw // 8, 64)
        blocks.append(np.round(coef / q).astype(np.int64)[..., NATURAL].tolist())
    tables = [0] + [1] * (len(planes) - 1) if arithmetic else [0] * len(planes)
    out = bytearray(b"\xff\xd8") + _marker_segment(marker)
    out += _segment(0xDB, b"\0" + bytes(q[NATURAL].tolist()))
    sof = struct.pack(">BHHB", 8, height, width, len(planes))
    for cid, (h, v) in zip(ids, sampling):
        sof += bytes([cid, (h << 4) | v, 0])
    out += _segment(0xCA if progressive else 0xC9 if arithmetic else 0xC0, sof)
    if not arithmetic:
        out += _segment(0xC4, b"\x00" + bytes(DC_BITS) + bytes(DC_VALS) + b"\x10" + bytes(AC_BITS) + AC_VALS)
    dac_l, dac_u, dac_k = [0] * 16, [1] * 16, [5] * 16
    if dac:
        body = b""
        for (cls, t), value in sorted(dac.items()):
            body += bytes([(cls << 4) | t, value])
            if cls:
                dac_k[t] = value
            else:
                dac_l[t], dac_u[t] = value & 15, value >> 4
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if progressive:
        ycc = len(planes) == 3 and not (marker == "adobe-rgb" or ids == (82, 71, 66))
        scans = _simple_progression(len(planes), ycc)
    else:
        every = tuple(range(len(planes)))
        scans = [(every, 0, 63, 0, 0)] if interleaved or len(planes) == 1 else [((c,), 0, 63, 0, 0) for c in every]
    for comps, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], (tables[c] << 4) | tables[c]])
                                                             for c in comps) + bytes([ss, se, (ah << 4) | al]))
        units = _units(comps, sampling, height, width, hmax, vmax, mcux, mcuy)
        if not arithmetic:
            bits, pred, rst = _BitWriter(), [0] * len(planes), 0
            for m, unit in enumerate(units):
                if restart and m and m % restart == 0:
                    bits.flush()
                    bits.out += bytes([0xFF, 0xD0 + rst])
                    rst, pred = (rst + 1) % 8, [0] * len(planes)
                for c, by, bx in unit:
                    _put_block(bits, blocks[c][by][bx], pred[c])
                    pred[c] = blocks[c][by][bx][0]
            bits.flush()
            out += bits.out
            continue
        coder = _ArithScan(len(planes), tables, dac_l, dac_u, dac_k)
        for m, unit in enumerate(units):
            if restart and m and m % restart == 0:
                coder.restart()
            for c, by, bx in unit:
                zz = blocks[c][by][bx]
                if ss == 0 and ah == 0:  # DC first (sequential: with every AC coefficient)
                    coder.dc(c, zz[0] >> al)
                    if se:
                        coder.ac(c, zz, 1, 63)
                elif ss == 0:
                    coder.dc_refine((zz[0] >> al) & 1)
                elif ah == 0:
                    coder.ac(c, [-((-x) >> al) if x < 0 else x >> al for x in zz], ss, se)
                else:
                    coder.ac_refine(c, zz, ss, se, ah, al)
        out += coder.data()
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------------------
# Lossless files (Annex H)
# ---------------------------------------------------------------------------


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    return [0, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv]


def _lossless_planes(samples, sampling, pt=0):
    """The component planes a lossless file of `samples` holds: each
    component's top-left sample of every (hmax / h, vmax / v) cell, shifted
    right by the point transform `pt`."""
    s = np.asarray(samples, np.int64)
    s = s[..., None] if s.ndim == 2 else s
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    return [s[::vmax // v, ::hmax // h, c] >> pt for c, (h, v) in enumerate(sampling)]


def lossless_expected(samples, sampling, pt=0) -> np.ndarray:
    """The (H, W, components) uint8 samples a decoder returns for
    `write_lossless_jpeg(samples, sampling, pt=pt)`: each plane shifted
    back by pt and replicated to full size (libjpeg upsamples a lossless
    file without its triangle filters)."""
    s = np.asarray(samples)
    height, width = s.shape[:2]
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    out = [np.repeat(np.repeat(p << pt, vmax // v, 0), hmax // h, 1)[:height, :width]
           for p, (h, v) in zip(_lossless_planes(samples, sampling, pt), sampling)]
    return np.stack(out, axis=2).astype(np.uint8)


def write_lossless_jpeg(samples, sampling=None, predictor=1, pt=0, restart_rows=0, interleaved=True,
                        marker="none", ids=None) -> bytes:
    """Lossless JPEG bytes (SOF3, 8-bit, the standard DC Huffman table) of
    `samples`, (H, W) or (H, W, components) uint8 written as they are (no
    colour transform), `sampling` [(h, v)] per component (default 1x1
    each), predictor 1 to 7, point transform `pt`. `restart_rows` > 0 puts
    a restart marker every that many MCU rows (in a single-component scan
    of a component with v > 1, a multiple of v: libjpeg-turbo undifferences
    a component's v rows together). `marker` as `write_jpeg`'s; with
    "none" and IDs 1, 2, 3 a 3-component file is RGB, as libjpeg-turbo
    reads a lossless file."""
    s = np.asarray(samples)
    ncomp = 1 if s.ndim == 2 else s.shape[2]
    sampling = sampling or [(1, 1)] * ncomp
    height, width = s.shape[:2]
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    planes = [p.tolist() for p in _lossless_planes(s, sampling, pt)]
    ids = ids or tuple(range(1, ncomp + 1))
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    out = bytearray(b"\xff\xd8") + _marker_segment(marker)
    sof = struct.pack(">BHHB", 8, height, width, ncomp)
    for cid, (h, v) in zip(ids, sampling):
        sof += bytes([cid, (h << 4) | v, 0])
    out += _segment(0xC3, sof)
    out += _segment(0xC4, b"\x00" + bytes(DC_BITS) + bytes(DC_VALS))
    scans = [tuple(range(ncomp))] if interleaved or ncomp == 1 else [(c,) for c in range(ncomp)]
    per_row = [mcux if len(comps) > 1 else len(planes[comps[0]][0]) for comps in scans]
    restarts = {restart_rows * n for n in per_row} if restart_rows else set()
    if len(restarts) > 1:
        raise ValueError("one restart interval for every scan: give the scans equal MCU rows")
    if restarts:
        out += _segment(0xDD, struct.pack(">H", restarts.pop()))
    for comps in scans:
        if len(comps) == 1 and restart_rows % sampling[comps[0]][1]:
            raise ValueError("restart_rows must be a multiple of the component's v in its own scan")
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[c], 0]) for c in comps)
                        + bytes([predictor, 0, pt]))
        # The difference of every sample of each plane (H.1.2): the first
        # row of the scan and of each restart interval from the row alone.
        diffs = {}
        for c in comps:
            p = planes[c]
            rows_per_mcu_row = sampling[c][1] if len(comps) > 1 else 1
            d = []
            for y, row in enumerate(p):
                mcu_row = y // rows_per_mcu_row
                first = y == 0 or (restart_rows and mcu_row % restart_rows == 0 and y % rows_per_mcu_row == 0)
                out_row = []
                for x, value in enumerate(row):
                    if first:
                        pred = (1 << (8 - pt - 1)) if x == 0 else row[x - 1]
                    elif x == 0:
                        pred = p[y - 1][0]
                    else:
                        pred = _predict(predictor, row[x - 1], p[y - 1][x], p[y - 1][x - 1])
                    out_row.append((value - pred) & 0xFFFF)
                d.append(out_row)
            diffs[c] = d

        def sample_diff(c, y, x):
            d = diffs[c]
            y, x = min(y, len(d) - 1), min(x, len(d[0]) - 1)  # dummy samples: the edge's
            return d[y][x]

        if len(comps) == 1:
            c = comps[0]
            units = [[(c, y, x)] for y in range(len(planes[c])) for x in range(len(planes[c][0]))]
            mcus_per_row = len(planes[c][0])
        else:
            units = [[(c, my * sampling[c][1] + y, mx * sampling[c][0] + x) for c in comps
                      for y in range(sampling[c][1]) for x in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
            mcus_per_row = mcux
        bits, rst = _BitWriter(), 0
        for m, unit in enumerate(units):
            if restart_rows and m and m % (restart_rows * mcus_per_row) == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
            for c, y, x in unit:
                diff = sample_diff(c, y, x)
                diff = diff - 0x10000 if diff > 0x8000 else diff
                size, val = _magnitude(diff)
                bits.put(*DC_CODES[size])
                if size:
                    bits.put(val, size)
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")
