"""PNM decoding (P1 to P6) as PIL's `Image.open(...).convert("RGB")` gives
it (`PpmImagePlugin.py`). PIL's other Pbmplus variants (PFM and its
P0CMYK, PyP, PyRGBA and PyCMYK test formats) are not read yet
(`formats.ORDER`).

The header is read as PIL reads it: the magic number up to whitespace (at
most 6 bytes), then tokens of at most 10 bytes between whitespace, a `#`
skipping to the end of its line without ending the token it interrupts.
P1 and P4 are bits, 1 black. Samples at maxval 255 are read as they are;
at another maxval each is scaled by round(v / maxval * 255), clamped,
except grey past maxval 255, which PIL opens as 32-bit integers scaled to
65535 and `convert` clamps to 255 (at maxval 65535 the samples are read
unscaled and clamped). P1 to P3 are decimal text with comments anywhere;
their tokens are checked as PIL checks them. What PIL refuses (a bad
header, a sample past maxval, a file too short for its pixels) raises
ValueError naming the file.
"""

from __future__ import annotations

import numpy as np

from .images import PIL_MAX_PIXELS

WHITESPACE = b" \t\n\x0b\x0c\r"
# magic number -> PIL's mode
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}
BANDS = {"1": 1, "L": 1, "I": 1, "RGB": 3}
SAFEBLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK: the plain decoder's read size


def is_pnm(head: bytes) -> bool:
    """Whether a file's first bytes start P1 to P6."""
    return len(head) >= 2 and head[:1] == b"P" and head[1] in b"123456"


class _Reader:
    """PIL's reads of the header, byte by byte."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def read1(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.read1()
            if not c or c in WHITESPACE:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self.read1()
            if not c:
                break
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise ValueError(f"{self.name}: the PNM header ends early")
        if len(token) > 10:
            raise ValueError(f"{self.name}: a PNM header token longer than 10 bytes")
        return token

    def number(self) -> int:
        token = self.token()
        try:
            return int(token)
        except ValueError:
            raise ValueError(f"{self.name}: PNM header token {token!r} is not a number") from None


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(v / maxval * out_max), as PIL's decoders compute it in float64."""
    return np.round(v.astype(np.float64) / maxval * out_max).astype(np.int64)


class _Plain:
    """PpmPlainDecoder's reads: SAFEBLOCK bytes at a time from `start`,
    comments (to CR or LF, across blocks) taken out."""

    def __init__(self, data: bytes, start: int, name: str):
        self.data, self.pos, self.name, self.spans = data, start, name, False

    def read(self) -> bytes:
        block = self.data[self.pos:self.pos + SAFEBLOCK]
        self.pos += len(block)
        return block

    @staticmethod
    def _comment_end(block: bytes, at: int = 0) -> int:
        a, b = block.find(b"\n", at), block.find(b"\r", at)
        return min(a, b) if a * b > 0 else max(a, b)

    def uncomment(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.read()
        self.spans = False
        while True:
            at = block.find(b"#")
            if at == -1:
                break
            end = self._comment_end(block, at)
            if end != -1:
                block = block[:at] + block[end + 1:]
            else:
                block = block[:at]
                self.spans = True
                break
        return block

    def bits(self, total: int) -> np.ndarray:
        """P1's `total` samples (0 or 1), as _decode_bitonal reads them."""
        out = b""
        while len(out) != total:
            block = self.read()
            if not block:
                break
            tokens = b"".join(self.uncomment(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise ValueError(f"{self.name}: P1 token {bad[:1]!r} is not 0 or 1")
            out = (out + tokens)[:total]
        if len(out) < total:
            raise ValueError(f"{self.name}: not enough image data")
        return np.frombuffer(out, np.uint8) - 48

    def values(self, total: int, maxval: int, out_max: int) -> np.ndarray:
        """P2's and P3's `total` samples scaled to `out_max`, as
        _decode_blocks reads them."""
        values, half = [], b""
        while len(values) != total:
            block = self.read()
            if not block:
                if not half:
                    break
                block = b" "
            block = self.uncomment(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError(f"{self.name}: a PNM data token longer than 10 bytes")
            for token in tokens:
                if len(token) > 10:
                    raise ValueError(f"{self.name}: a PNM data token longer than 10 bytes")
                try:
                    value = int(token)
                except ValueError:
                    raise ValueError(f"{self.name}: PNM data token {token!r} is not a number") from None
                if value < 0 or value > maxval:
                    raise ValueError(f"{self.name}: PNM sample {value} outside 0 to {maxval}")
                values.append(value)
                if len(values) == total:
                    break
        if len(values) < total:
            raise ValueError(f"{self.name}: not enough image data")
        return _scale(np.asarray(values, np.int64), maxval, out_max)


def _to_rgb(mode: str, s: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 from PIL's mode's samples (H, W, bands), each in
    0 to 255 but for PIL's 32-bit grey mode I, clamped to 255."""
    if mode == "RGB":
        return s.astype(np.uint8)
    return np.repeat(np.minimum(s, 255).astype(np.uint8), 3, axis=2)


def decode_pnm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The RGB pixels (H, W, 3) uint8 of the PNM file `data`, as PIL's
    `Image.open(...).convert("RGB")` gives them."""
    r = _Reader(data, name)
    magic = r.magic()
    if magic not in MODES:
        raise ValueError(f"{name}: not a PNM file (magic number {magic!r})")
    mode = MODES[magic]
    width, height = r.number(), r.number()
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = 255
    if mode != "1":
        maxval = r.number()
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0 or width * height > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: a PNM of size {width}x{height} (PIL reads 1 to {PIL_MAX_PIXELS} pixels)")
    start, bands = r.pos, BANDS[mode]
    total = width * height * bands
    if plain:
        plain_reader = _Plain(data, start, name)
        if mode == "1":
            s = np.where(plain_reader.bits(total) == 1, 0, 255)
        else:
            s = plain_reader.values(total, maxval, 65535 if mode == "I" else 255)
    elif mode == "1":  # P4: rows of bits, 1 black
        stride = (width + 7) // 8
        need = stride * height
        if len(data) - start < need:
            raise ValueError(f"{name}: image file is truncated")
        bits = np.unpackbits(np.frombuffer(data, np.uint8, need, start).reshape(height, stride), axis=1)
        s = (bits[:, :width] ^ 1) * np.uint8(255)
    elif maxval == 255 or (maxval == 65535 and mode == "I"):  # PIL's raw decoder
        unit = 1 if maxval == 255 else 2
        need = total * unit
        if len(data) - start < need:
            raise ValueError(f"{name}: image file is truncated")
        s = np.frombuffer(data, np.uint8 if unit == 1 else ">u2", total, start)
    else:  # PIL's PpmDecoder: whole pixels only, scaled and clamped
        unit = 1 if maxval < 256 else 2
        have = (len(data) - start) // (unit * bands) * bands
        if have < total:
            raise ValueError(f"{name}: not enough image data")
        v = np.frombuffer(data, np.uint8 if unit == 1 else ">u2", total, start)
        out_max = 65535 if mode == "I" else 255
        s = np.minimum(_scale(v, maxval, out_max), out_max)
    return _to_rgb(mode, np.asarray(s).reshape(height, width, bands))
