"""PIL's open order as the port's format table.

`Image.open` does not go by a file's name: it tries its formats in the
order of `Image.ID` (`ORDER` here, Pillow 12.2.0's, with neither olefile
nor Ghostscript installed), and takes the first whose accept test passes
on the file's first 16 bytes (some formats have none) and whose `_open`
does not raise SyntaxError, IndexError, TypeError, KeyError, EOFError or
struct.error (or leave the image without a mode or a size): those fall
through to the next format; any other error stops the open. So a file is
decoded here by walking the same table:

  * each entry holds PIL's format name, its accept test and a header
    probe that raises `NotThisFormat` exactly where PIL's `_open` falls
    through and ValueError where it refuses the file;
  * then one of three outcomes: the port's decoder; NotImplementedError
    naming the file and PIL's format, for a format still to port (ROADMAP
    queue 3); ValueError naming the file, for a format PIL opens but cannot
    load on the card's machine (the BUFR, GRIB, HDF5, MPEG and WMF stubs,
    and EPS without Ghostscript).

A file no format takes raises ValueError naming the file, as PIL raises
UnidentifiedImageError. The probes of the decoded formats are their
readers' own header parsers (`tga_header`, `cur_bitmap`, ...). Those of
PNG, JPEG, BMP, GIF, PPM, TIFF and WebP are their accept tests: where
PIL's open of such a file falls through, no later format takes its first
bytes, so their decoders' ValueError is PIL's answer too. The probes of
the formats still to port follow their `_open`s read by read (IM, IMT,
IPTC, PCD and SPIDER have no accept test and so run on every file that
reaches them), except AVIF's, its accept test (PIL asks libavif), and
EPS's, its two required comments (a stub either way: a file PIL's EPS
reader refuses raises ValueError here too, as no later format takes it).

Pillow 12.2.0 first imports the plugin of the file's extension, so the
format of that extension is tried first; the JAX reader's extensions
(.png, .jpg, .jpeg, .webp, .bmp) name formats whose accept tests no other
format's first bytes pass, so the order stays the table's.

A `Source` reads a file only as far as the probes ask (a folder's first
pass reads a few hundred bytes a file: TGA's 18-byte header, SPIDER's 27
floats, PCD's bytes at 2048, ICO's directory).
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np

from .gif import GIF_MAGIC, decode_gif
from .icns import ICNS_MAGIC, decode_icns, icns_directory
from .ico import CUR_MAGIC, ICO_MAGIC, cur_bitmap, decode_cur, decode_ico, ico_directory
from .images import PNG_SIGNATURE, NotThisFormat, decode_bmp, decode_png, parse_dib
from .jpeg import decode_jpeg
from .pcx import dcx_first_page, decode_dcx, decode_pcx, is_dcx, is_pcx, pcx_header
from .pnm import decode_pnm
from .qoi import QOI_MAGIC, decode_qoi, qoi_header
from .sgi import decode_sgi, is_sgi, sgi_header
from .tga import decode_tga, tga_header
from .tiff import decode_tiff, is_tiff
from .webp import decode_webp

PREFIX = 16  # the bytes `Image.open` hands each accept test
HEAD = 4096  # the bytes a `Source` reads at once


class Source:
    """A file's bytes as the probes read them: `src[a:b]` and `len(src)`,
    read from `data` or from the file at `path`, only as far as asked."""

    def __init__(self, data: Optional[bytes] = None, path: Optional[str] = None):
        self._file = None
        if data is not None:
            self.head, self.size = data, len(data)
        else:
            self._file = open(path, "rb")
            self.size = os.fstat(self._file.fileno()).st_size
            self.head = self._file.read(HEAD)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, key: slice) -> bytes:
        start, stop, _ = key.indices(self.size)
        if stop <= len(self.head) or self._file is None:
            return self.head[start:stop]
        self._file.seek(start)
        return self._file.read(max(0, stop - start))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class _Reader:
    """A file object's read, seek and tell over a `Source`, for the probes
    that follow an `_open` read by read."""

    def __init__(self, src: Source, pos: int = 0):
        self.src, self.pos = src, pos

    def read(self, n: int = -1) -> bytes:
        b = self.src[self.pos:len(self.src) if n < 0 else self.pos + n]
        self.pos += len(b)
        return b

    def seek(self, pos: int) -> None:
        if pos < 0:
            raise ValueError("negative seek")
        self.pos = pos


DECODE, TODO, STUB = "decode", "todo", "stub"


@dataclass(frozen=True)
class Format:
    """One entry of PIL's order: its name, accept test, probe and
    outcome (the decoder, or TODO / STUB)."""

    name: str
    accept: Optional[Callable[[bytes], bool]]
    probe: Callable[[Source, str], None]
    outcome: str
    decoder: Optional[Callable[[bytes, str], np.ndarray]] = None
    label: str = ""  # the name errors give, if not PIL's

    @property
    def kind(self) -> str:
        """The port's name of the format (PIL's PPM is "pnm")."""
        return "pnm" if self.name == "PPM" else self.name.lower()


def _u16(b: bytes, o: int, e: str = "<") -> int:
    if len(b) < o + 2:
        raise NotThisFormat("cut short")
    return struct.unpack_from(e + "H", b, o)[0]


def _u32(b: bytes, o: int, e: str = "<") -> int:
    if len(b) < o + 4:
        raise NotThisFormat("cut short")
    return struct.unpack_from(e + "I", b, o)[0]


def _starts(*magic: bytes) -> Callable[[bytes], bool]:
    return lambda prefix: prefix.startswith(magic)


def _accepted(src: Source, name: str) -> None:
    """A probe for formats whose accept test is all the port checks."""


def _size(w: int, h: int, name: str) -> None:
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: empty size")


# ---------------------------------------------------------------------------
# Probes of the formats PIL opens that the port decodes
# ---------------------------------------------------------------------------

PPM_MODES = {b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P0CMYK", b"Pf", b"PyP", b"PyRGBA", b"PyCMYK"}


def _ppm_probe(src: Source, name: str) -> None:
    """PpmImageFile._read_magic: up to 6 bytes before whitespace; P1 to P6
    the port reads, PFM and PIL's test modes it does not yet."""
    magic = b""
    for c in src[:6]:
        if c in b" \t\n\x0b\x0c\r":
            break
        magic += bytes((c,))
    if magic not in PPM_MODES:
        raise NotThisFormat(f"{name}: not a PPM file")
    if magic == b"Pf":
        raise NotImplementedError(f"{name}: PIL reads this PFM file; the port does not yet")
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise NotImplementedError(f"{name}: PIL reads this PPM extension file; the port does not yet")


def _dib_probe(src: Source, name: str) -> None:
    parse_dib(src, 0, 0, name, "DIB")


# ---------------------------------------------------------------------------
# Probes of the formats still to port, and of PIL's stubs
# ---------------------------------------------------------------------------

def _avif_accept(prefix: bytes) -> bool:
    return prefix[4:8] == b"ftyp" and prefix[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


def _blp_probe(src: Source, name: str) -> None:
    s = src[:24]
    _size(_u32(s, 12), _u32(s, 16), name)
    if s[:4] == b"BLP1":
        _u32(s, 20)  # the encoding


def _jp2_boxes(r: _Reader, length: int, name: str):
    """Jpeg2KImagePlugin.BoxReader over r: yields (type, start, length) of
    each box until `length` (-1: none, when PIL reads on until a box header
    cannot be read, which raises), seeking past each box after its turn."""
    while length < 0 or r.pos < length:
        for need in (8, 16):
            if length >= 0 and r.pos + 8 > length:
                raise NotThisFormat(f"{name}: JPEG 2000 box header past its box")
            head = r.read(8)
            if len(head) < 8:
                raise ValueError(f"{name}: JPEG 2000 box header cut short")
            if need == 8:
                lbox, tbox = struct.unpack(">I4s", head)
                hlen = 8
                if lbox != 1:
                    break
            else:
                lbox, hlen = struct.unpack(">Q", head)[0], 16
        if lbox < hlen or (length >= 0 and r.pos + lbox - hlen > length):
            raise NotThisFormat(f"{name}: invalid JPEG 2000 box length")
        start = r.pos
        yield tbox, start, lbox - hlen
        r.seek(start + lbox - hlen)


def _j2k_comments(r: _Reader, name: str) -> None:
    """Jpeg2KImageFile._parse_comment: marker segments up to a tile, the
    end of the codestream or a comment."""
    while True:
        marker = r.read(2)
        if not marker:
            return
        if len(marker) < 2:
            raise NotThisFormat(f"{name}: JPEG 2000 marker cut short")
        if marker[1] in (0x90, 0xD9):
            return
        length = _u16(r.read(2), 0, ">")
        if marker[1] == 0x64:
            return
        r.seek(r.pos + length - 2)


def _jpeg2000_probe(src: Source, name: str) -> None:
    """Jpeg2KImagePlugin._open: a codestream's SIZ segment whole, of 1 to 4
    components and a size; a JP2 file's header box (jp2h) with an image
    header (ihdr) of a size and a mode, its colour (colr), palette (pclr)
    and resolution (res) boxes read as PIL reads them; then the marker
    segments before the first tile."""
    if src[:4] == b"\xff\x4f\xff\x51":
        lsiz = _u16(src[4:6], 0, ">")
        if lsiz == 0:  # PIL's read(lsiz - 2) of a file: a count below -1 raises
            raise ValueError(f"{name}: JPEG 2000 SIZ segment of length 0")
        siz = src[4:4 + lsiz] if lsiz >= 2 else src[4:len(src)]  # read(-1) reads on
        if len(siz) < 38:
            raise NotThisFormat(f"{name}: JPEG 2000 SIZ segment cut short")
        _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
        if csiz not in (1, 2, 3, 4) or (csiz == 1 and len(siz) < 39):
            raise NotThisFormat(f"{name}: JPEG 2000 components PIL cannot tell a mode from")
        _j2k_comments(_Reader(src, 4 + len(siz)), name)
        _size(xsiz - xosiz, ysiz - yosiz, name)
        return
    r = _Reader(src, 12)
    for tbox, start, n in _jp2_boxes(r, -1, name):
        if tbox == b"jp2h":
            break
        if tbox == b"ftyp" and n < 4:
            raise NotThisFormat(f"{name}: JPEG 2000 ftyp box cut short")
    if n > len(src) - start:
        raise ValueError(f"{name}: JPEG 2000 header box cut short")
    h = _Reader(Source(src[start:start + n]))
    size = mode = nc = colr = None
    for tbox, at, m in _jp2_boxes(h, n, name):
        if tbox == b"ihdr":
            if m < 11:
                raise NotThisFormat(f"{name}: JPEG 2000 ihdr box cut short")
            height, width, nc, bpc = struct.unpack(">IIHB", h.read(11))
            size = (width, height)
            mode = {1: "I;16" if bpc & 0x7F > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr":
            if m < 7:
                raise NotThisFormat(f"{name}: JPEG 2000 colr box cut short")
            meth, _, _, enumcs = struct.unpack(">BBBI", h.read(7))
            if meth == 1:
                colr = {0: "1", 15: "1", 12: "CMYK", 17: "L"}.get(enumcs, colr)
                mode = "CMYK" if enumcs == 12 and nc == 4 else mode
        elif tbox == b"pclr" and mode in ("L", "LA") and colr not in ("1", "L"):
            if m < 3:
                raise NotThisFormat(f"{name}: JPEG 2000 pclr box cut short")
            ne, npc = struct.unpack(">HB", h.read(3))
            depths = h.read(npc)
            if len(depths) < npc or m < 3 + npc + ne * npc:
                raise NotThisFormat(f"{name}: JPEG 2000 pclr box cut short")
            if max(depths, default=0) <= 8:
                body = h.read(ne * npc)
                if len({body[i:i + npc] for i in range(0, ne * npc, npc)}) > 256:
                    raise ValueError(f"{name}: JPEG 2000 palette of more than 256 colours")
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = _Reader(Source(h.read(m)))
            for tres, _, k in _jp2_boxes(res, m, name):
                if tres == b"resc":
                    if k < 10:
                        raise NotThisFormat(f"{name}: JPEG 2000 resc box cut short")
                    break
    if size is None or mode is None:
        raise NotThisFormat(f"{name}: malformed JP2 header")
    tail = _Reader(src, start + n)
    if tail.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
        length = _u16(tail.read(2), 0, ">")
        tail.seek(tail.pos + length - 2)
        _j2k_comments(tail, name)
    _size(*size, name)


def _dds_probe(src: Source, name: str) -> None:
    """DdsImageFile._open's header: 124 bytes whole (PIL refuses another
    size or a header cut short), a size; its pixel formats are left to the
    port's reader of DDS (PIL raises NotImplementedError for those it does
    not know, as the port does for the format)."""
    s = src[:128]
    header = _u32(s, 4)
    if header != 124 or len(s) < 128:
        raise ValueError(f"{name}: DDS header of {header} bytes ({len(s)} read)")
    _size(_u32(s, 16), _u32(s, 12), name)


def _eps_probe(src: Source, name: str) -> None:
    """EpsImageFile._open requires the %!PS-Adobe and %%BoundingBox
    comments (where they end it falls through)."""
    data = src[:len(src)]
    if b"%!PS-Adobe" not in data or b"%%BoundingBox" not in data:
        raise NotThisFormat(f"{name}: not an EPS file")


def _fits_probe(src: Source, name: str) -> None:
    """FitsImageFile._open: 80-byte cards, the first SIMPLE = T, each
    header up to its END (the next card at the next 2880 bytes), until a
    card outside a header follows the header that gives an image; that
    header's size (NAXIS, NAXIS1, NAXIS2) and BITPIX mode. Raises where PIL
    raises (a file cut inside its cards, no image data, a value that is no
    number)."""
    r, headers, in_progress, image = _Reader(src), {}, False, None
    while True:
        card = r.read(80)
        if not card:
            raise ValueError(f"{name}: truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            r.seek(-(-r.pos // 2880) * 2880)
            if image is None:
                try:
                    image = _fits_image(headers, name)
                except KeyError as e:
                    raise NotThisFormat(f"{name}: FITS header without {e}") from None
            in_progress = False
            continue
        if image:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise NotThisFormat(f"{name}: not a FITS file")
        headers[keyword] = value
    if not image:
        raise ValueError(f"{name}: FITS file of no image data")
    w, h, bits = image
    if bits not in (8, 16, 32, -32, -64):
        raise NotThisFormat(f"{name}: FITS BITPIX {bits} PIL has no mode for")
    _size(w, h, name)


def _fits_image(headers: dict, name: str):
    """FitsImageFile._parse_headers: (width, height, BITPIX) of the
    header's image, or None for a header of none (NAXIS 0)."""

    def size(prefix):
        naxis = int(headers[prefix + b"NAXIS"])
        if naxis == 0:
            return None
        return (1, int(headers[prefix + b"NAXIS1"])) if naxis == 1 else (int(headers[prefix + b"NAXIS1"]),
                                                                        int(headers[prefix + b"NAXIS2"]))

    try:
        prefix = b""
        if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
                and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
            size(prefix)
            int(headers[b"BITPIX"])
            prefix = b"Z"
        wh = size(prefix)
        return None if wh is None else (*wh, int(headers[prefix + b"BITPIX"]))
    except ValueError:
        raise ValueError(f"{name}: FITS header value that is no number") from None


def _fli_accept(prefix: bytes) -> bool:
    return len(prefix) >= 16 and _u16(prefix, 4) in (0xAF11, 0xAF12) and _u16(prefix, 14) in (0, 3)


def _fli_probe(src: Source, name: str) -> None:
    """FliImageFile._open: the 128-byte header's reserved zeros, the
    first chunk's prefix and frame (0xF100, 0xF1FA) headers and palette
    chunks read as PIL reads them, then the seek to frame 0 (a file of no
    frames, or cut before the first frame's size, falls through)."""
    s = src[:128]
    if s[20:22] != b"\x00" * 2 or s[42:80] != b"\x00" * 38 or s[88:] != b"\x00" * 40:
        raise NotThisFormat(f"{name}: not an FLI file")
    frames, width, height = _u16(s, 6), _u16(s, 8), _u16(s, 10)
    r = _Reader(src, 128)
    c = r.read(16)
    if _u16(c, 4) == 0xF100:
        r.seek(128 + _u32(c, 0))
        c = r.read(16)
    if _u16(c, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_u16(c, 6)):
            if chunk_size is not None:
                r.seek(r.pos + chunk_size - 6)
            h = r.read(6)
            kind = _u16(h, 4)
            if kind in (4, 11):
                i = 0
                for _ in range(_u16(r.read(2), 0)):
                    e = r.read(2)
                    if len(e) < 2:
                        raise NotThisFormat(f"{name}: FLI palette cut short")
                    i, n = i + e[0], e[1] or 256
                    rgb = r.read(n * 3)
                    if len(rgb) % 3 or i + len(rgb) // 3 > 256:
                        raise NotThisFormat(f"{name}: FLI palette past its entries")
                    i += len(rgb) // 3
                break
            chunk_size = _u32(h, 0)
            if not chunk_size:
                break
    if frames == 0:
        raise NotThisFormat(f"{name}: FLI file of no frames")
    _u32(src[128:132], 0)  # the first frame's size
    _size(width, height, name)


def _ftex_probe(src: Source, name: str) -> None:
    """FtexImagePlugin._open: the header's structs whole (its one format
    asserted), the mipmap's size at the offset it gives, format 0 or 1."""
    s = src[:32]
    if len(s) < 32:
        raise NotThisFormat(f"{name}: FTEX header cut short")
    _, w, h, _, count, fmt, where = struct.unpack("<7i", s[4:32])
    if count != 1:
        raise ValueError(f"{name}: FTEX of {count} formats")
    if where < 0:
        raise ValueError(f"{name}: FTEX mipmap at a negative offset")
    size = src[where:where + 4]
    if len(size) < 4:
        raise NotThisFormat(f"{name}: FTEX mipmap size cut short")
    if struct.unpack("<i", size)[0] < -1:  # PIL reads that many bytes of the file: a count below -1 raises
        raise ValueError(f"{name}: FTEX mipmap of a negative size")
    if fmt not in (0, 1):
        raise ValueError(f"{name}: FTEX texture compression {fmt}")
    if w <= 0 or h <= 0:  # PIL's FTEX open has closed the file by now: the formats after it fail to seek
        raise ValueError(f"{name}: FTEX of size {w}x{h}")


def _gbr_accept(prefix: bytes) -> bool:
    return len(prefix) >= 8 and _u32(prefix, 0, ">") >= 20 and _u32(prefix, 4, ">") in (1, 2)


def _gbr_probe(src: Source, name: str) -> None:
    s = src[:28]
    width, height, depth = _u32(s, 8, ">"), _u32(s, 12, ">"), _u32(s, 16, ">")
    if width == 0 or height == 0 or depth not in (1, 4):
        raise NotThisFormat(f"{name}: not a GIMP brush")
    if _u32(s, 4, ">") == 2:
        if s[20:24] != b"GIMP":
            raise NotThisFormat(f"{name}: not a GIMP brush")
        _u32(s, 24, ">")  # the spacing


IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name", "Scale (x,y)",
           "Image size (x*y)", "Image type")


def _im_number(v: str) -> float:
    try:
        return int(v)
    except ValueError:
        return float(v)


def _im_probe(src: Source, name: str) -> None:
    """ImImageFile._open: "key: value" lines of at most 100 bytes up to a
    NUL, ^Z or the end, at least one of IM's keys; the size and mode they
    give; the ^Z before the image data. A value PIL cannot convert raises
    as PIL raises."""
    if b"\n" not in src[:100]:
        raise NotThisFormat(f"{name}: not an IM file")
    pos, n = 0, 0
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    s = b""
    while True:
        s = src[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        rest = src[pos:pos + 101]  # a longer line is no IM header line
        end = rest.find(b"\n")
        rest = rest if end < 0 else rest[:end + 1]
        s, pos = s + rest, pos + len(rest)
        if len(s) > 100:
            raise NotThisFormat(f"{name}: not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = IM_SPLIT.match(s)
        if not m:
            raise NotThisFormat(f"{name}: syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            except ValueError:
                raise ValueError(f"{name}: IM header value {v!r} that PIL cannot read") from None
            v = v[0] if len(v) == 1 else v
        info[k] = v
        n += k in IM_TAGS
    if not n:
        raise NotThisFormat(f"{name}: not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    if s != b"\x1a":  # PIL reads on to the ^Z that ends the header
        while True:
            chunk = src[pos:pos + HEAD]
            at = chunk.find(b"\x1a")
            if not chunk:
                raise NotThisFormat(f"{name}: IM file truncated")
            if at >= 0:
                pos += at + 1
                break
            pos += len(chunk)
    if "Lut" in info and len(src) - pos < 768:
        raise NotThisFormat(f"{name}: IM palette cut short")
    try:
        if not mode or size[0] <= 0 or size[1] <= 0:
            raise NotThisFormat(f"{name}: IM file of no mode or size")
    except (TypeError, IndexError):
        raise NotThisFormat(f"{name}: IM size {size!r}") from None


IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_probe(src: Source, name: str) -> None:
    """ImtImageFile._open: "key value" lines up to a form feed; the width,
    height and "pixel n8" (its only mode) they give."""
    buffer = src[:100]
    if b"\n" not in buffer:
        raise NotThisFormat(f"{name}: not an IM Tools file")
    pos, xsize, ysize, mode = 100, 0, 0, False
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = src[pos:pos + 1]
            pos += len(s)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            more = src[pos:pos + 100]
            buffer += more
            pos += len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
            elif k == b"height":
                ysize = int(v)
        except ValueError:
            raise ValueError(f"{name}: IM Tools {k.decode()} {v!r} that PIL cannot read") from None
        if k == b"pixel" and v == b"n8":
            mode = True
    if not mode:
        raise NotThisFormat(f"{name}: not an IM Tools file")
    _size(xsize, ysize, name)


def _iptc_probe(src: Source, name: str) -> None:
    """IptcImageFile._open: its tagged fields up to (8, 10); the layers,
    size and compression they give."""
    info, pos, tag = {}, 0, None

    def field():
        nonlocal pos
        s = src[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\x00"):
            return None, 0
        if len(s) < 3:
            raise NotThisFormat(f"{name}: IPTC field cut short")
        t = s[1], s[2]
        if s[0] != 0x1C or t[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise NotThisFormat(f"{name}: not an IPTC/NAA file")
        if len(s) < 4:
            raise NotThisFormat(f"{name}: IPTC field cut short")
        size = s[3]
        if size > 132:
            raise ValueError(f"{name}: illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            b = src[pos:pos + size - 128]
            pos += len(b)
            size = int.from_bytes(b[-4:], "big")
        else:
            size = _u16(s, 3, ">")
        return t, size

    while True:
        tag, size = field()
        if not tag or tag == (8, 10):
            break
        value = None
        if size:
            value = src[pos:pos + size]
            pos += len(value)
        if tag in info:
            info[tag] = info[tag] + [value] if isinstance(info[tag], list) else [info[tag], value]
        else:
            info[tag] = value

    def getint(key):
        c = info[key]
        return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")

    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = (layers == 1 and not component) or (layers == 3 and component) or (layers == 4 and component)
        if not (layers == 1 and not component) and (3, 65) in info:
            info[(3, 65)][0] - 1
        size = getint((3, 20)), getint((3, 30))
    except (KeyError, IndexError, TypeError) as e:
        raise NotThisFormat(f"{name}: not an IPTC/NAA file ({e!r})") from None
    try:
        compression = getint((3, 120))
    except TypeError as e:
        raise NotThisFormat(f"{name}: not an IPTC/NAA file ({e!r})") from None
    except KeyError:
        compression = None
    if compression not in (1, 5):
        raise ValueError(f"{name}: unknown IPTC image compression")
    if not mode:
        raise NotThisFormat(f"{name}: IPTC file of no mode")
    _size(*size, name)


def _mcidas_probe(src: Source, name: str) -> None:
    s = src[:256]
    if len(s) != 256:
        raise NotThisFormat(f"{name}: not a McIdas area file")
    w = (0,) + struct.unpack("!64i", s)
    if w[11] not in (1, 2, 4):
        raise NotThisFormat(f"{name}: unsupported McIdas format")
    _size(w[10], w[9], name)


def _mpeg_probe(src: Source, name: str) -> None:
    s = src[4:7]
    if len(s) < 3:
        raise NotThisFormat(f"{name}: MPEG header cut short")
    bits = int.from_bytes(s, "big")
    _size(bits >> 12, bits & 0xFFF, name)


def _msp_probe(src: Source, name: str) -> None:
    s = src[:32]
    if len(s) < 32:
        raise NotThisFormat(f"{name}: MSP header cut short")
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _u16(s, i)
    if checksum:
        raise NotThisFormat(f"{name}: bad MSP checksum")
    _size(_u16(s, 4), _u16(s, 6), name)


def _pcd_probe(src: Source, name: str) -> None:
    s = src[2048:2048 + 1539]
    if not s.startswith(b"PCD_") or len(s) < 1539:  # PIL reads the orientation from the last of these
        raise NotThisFormat(f"{name}: not a PCD file")


def _pixar_probe(src: Source, name: str) -> None:
    s = src[:512]
    _size(_u16(s, 418), _u16(s, 416), name)
    if (_u16(s, 424), _u16(s, 426)) != (14, 2):
        raise NotThisFormat(f"{name}: PIXAR file of no mode PIL reads")


PSD_MODES = {(0, 1): 1, (0, 8): 1, (1, 8): 1, (2, 8): 1, (3, 8): 3, (4, 8): 4, (7, 8): 1, (8, 8): 1, (9, 8): 3}


def _psd_probe(src: Source, name: str) -> None:
    """PsdImageFile._open: the header, then the colour mode data, image
    resources and layer sections read through (each length whole), then
    the image data's compression and, packed, its row byte counts."""
    s = src[:26]
    if _u16(s, 4, ">") != 1:
        raise NotThisFormat(f"{name}: not a PSD file")
    channels = PSD_MODES.get((_u16(s, 24, ">"), _u16(s, 22, ">")))
    if channels is None:
        raise NotThisFormat(f"{name}: PSD mode PIL has no reader for")
    psd_channels = _u16(s, 12, ">")
    if channels > psd_channels:
        raise ValueError(f"{name}: PSD file of not enough channels")
    if channels == 3 and psd_channels == 4 and _u16(s, 24, ">") == 3:
        channels = 4
    width, height = _u32(s, 18, ">"), _u32(s, 14, ">")
    r = _Reader(src, 26)
    r.read(_u32(r.read(4), 0, ">"))  # colour mode data
    size = _u32(r.read(4), 0, ">")  # image resources
    end = r.pos + size
    while size and r.pos < end:
        r.read(4)
        _u16(r.read(2), 0, ">")
        n = r.read(1)
        if not n:
            raise NotThisFormat(f"{name}: PSD resource cut short")
        if not len(r.read(n[0])) & 1:
            r.read(1)
        if len(r.read(_u32(r.read(4), 0, ">"))) & 1:
            r.read(1)
    size = _u32(r.read(4), 0, ">")  # layer and mask information
    if size:
        end = r.pos + size
        _u32(r.read(4), 0, ">")
        r.seek(end)
    counts = channels * height * 2
    if _u16(r.read(2), 0, ">") == 1 and len(r.read(counts)) < counts:  # packed: each row's byte count
        raise NotThisFormat(f"{name}: PSD row byte counts cut short")
    _size(width, height, name)


def _spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader: the header's length, or 0."""
    h = (99,) + t

    def is_int(f):
        try:
            return f - int(f) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)) or int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider_probe(src: Source, name: str) -> None:
    """SpiderImageFile._open: 27 big- or little-endian floats that make a
    SPIDER header of a 2D image and a consistent stack."""
    f = src[:108]
    if len(f) < 108:
        raise NotThisFormat(f"{name}: not a SPIDER file")
    for e in (">", "<"):
        t = struct.unpack(e + "27f", f)
        if _spider_header(t):
            break
    else:
        raise NotThisFormat(f"{name}: not a SPIDER file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat(f"{name}: not a SPIDER 2D image")
    try:
        istack, imgnumber = int(h[24]), int(h[27])
    except (ValueError, OverflowError):
        raise ValueError(f"{name}: SPIDER stack values PIL cannot read") from None
    if not ((istack == 0 and imgnumber == 0) or (istack > 0 and imgnumber == 0) or (istack == 0 and imgnumber > 0)):
        raise NotThisFormat(f"{name}: inconsistent SPIDER stack header")
    _size(int(h[12]), int(h[2]), name)


def _sun_probe(src: Source, name: str) -> None:
    s = src[:32]
    depth, file_type = _u32(s, 12, ">"), _u32(s, 20, ">")
    palette_type, palette_length = _u32(s, 24, ">"), _u32(s, 28, ">")
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat(f"{name}: SUN depth PIL has no reader for")
    if palette_length and (palette_length > 1024 or palette_type != 1):
        raise NotThisFormat(f"{name}: SUN palette PIL has no reader for")
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat(f"{name}: SUN file type PIL has no reader for")
    _size(_u32(s, 4, ">"), _u32(s, 8, ">"), name)


def _wmf_accept(prefix: bytes) -> bool:
    return prefix.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"))


def _wmf_probe(src: Source, name: str) -> None:
    s = src[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if len(s) < 16:
            raise NotThisFormat(f"{name}: WMF header cut short")
        x0, y0, x1, y1, inch = struct.unpack_from("<4hH", s, 6)
        if inch == 0:
            raise ValueError(f"{name}: WMF of no inch")
        if s[22:26] != b"\x01\x00\t\x00":
            raise NotThisFormat(f"{name}: unsupported WMF file format")
        _size((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch, name)
    elif s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        if f2 == f0 or f3 == f1:
            raise ValueError(f"{name}: EMF frame of no size")
        _size(x1 - x0, y1 - y0, name)
    else:
        raise NotThisFormat(f"{name}: unsupported WMF file format")


XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def _xbm_probe(src: Source, name: str) -> None:
    m = XBM_HEAD.match(src[:512])
    if not m:
        raise NotThisFormat(f"{name}: not an XBM file")
    _size(int(m.group("width")), int(m.group("height")), name)


XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _xpm_probe(src: Source, name: str) -> None:
    """XpmImageFile._open: the first line matching the values' pattern,
    then one palette line a colour, each needing a "c" key (a missing
    value falls through, a line without one raises)."""
    lines = src[9:len(src)].splitlines(keepends=True)
    for at, line in enumerate(lines):
        m = XPM_HEAD.match(line)
        if m:
            break
    else:
        raise NotThisFormat(f"{name}: broken XPM file")
    try:
        w, h, colours, bpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{name}: XPM header PIL cannot read") from None
    palette = lines[at + 1:at + 1 + colours] + [b""] * max(0, colours - len(lines) + at + 1)
    for line in palette:
        words = line.rstrip()[bpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise NotThisFormat(f"{name}: XPM colour without a value")
                rgb = words[i + 1]
                if rgb != b"None" and not rgb.startswith(b"#"):
                    raise ValueError(f"{name}: XPM colour {rgb!r} PIL cannot read")
                if rgb.startswith(b"#"):
                    try:
                        int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError(f"{name}: XPM colour {rgb!r} PIL cannot read") from None
                break
        else:
            raise ValueError(f"{name}: XPM palette line PIL cannot read")
    _size(w, h, name)


def _xvthumb_probe(src: Source, name: str) -> None:
    lines = src[:len(src)].splitlines(keepends=True)[1:]
    for s in lines:
        if s[0] != 35:
            try:
                w, h = s.strip().split(maxsplit=2)[:2]
                w, h = int(w), int(h)
            except ValueError:
                raise ValueError(f"{name}: XV thumbnail header PIL cannot read") from None
            _size(w, h, name)
            return
    raise NotThisFormat(f"{name}: unexpected end of the XV thumbnail file")


# PIL's Image.ID after `Image.open` (Pillow 12.2.0; FPX and MIC come only with olefile)
ORDER = (
    Format("BMP", _starts(b"BM"), _accepted, DECODE, decode_bmp),
    Format("DIB", lambda p: len(p) >= 4 and _u32(p, 0) in (12, 40, 52, 56, 64, 108, 124), _dib_probe, TODO),
    Format("GIF", _starts(*GIF_MAGIC), _accepted, DECODE, decode_gif),
    Format("JPEG", _starts(b"\xff\xd8\xff"), _accepted, DECODE, decode_jpeg),
    Format("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy", _ppm_probe, DECODE, decode_pnm),
    Format("PNG", _starts(PNG_SIGNATURE), _accepted, DECODE, decode_png),
    Format("AVIF", _avif_accept, _accepted, TODO),
    Format("BLP", _starts(b"BLP1", b"BLP2"), _blp_probe, TODO),
    Format("BUFR", _starts(b"BUFR", b"ZCZC"), _accepted, STUB),
    Format("CUR", _starts(CUR_MAGIC), cur_bitmap, DECODE, decode_cur),
    Format("PCX", is_pcx, lambda src, name: pcx_header(src, 0, name), DECODE, decode_pcx),
    Format("DCX", is_dcx, lambda src, name: pcx_header(src, dcx_first_page(src, name), name), DECODE, decode_dcx),
    Format("DDS", _starts(b"DDS "), _dds_probe, TODO),
    Format("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and _u32(p, 0) == 0xC6D3D0C5), _eps_probe, STUB),
    Format("FITS", _starts(b"SIMPLE"), _fits_probe, TODO),
    Format("FLI", _fli_accept, _fli_probe, TODO),
    Format("FTEX", _starts(b"FTEX"), _ftex_probe, TODO),
    Format("GBR", _gbr_accept, _gbr_probe, TODO),
    Format("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, _accepted, STUB),
    Format("HDF5", _starts(b"\x89HDF\r\n\x1a\n"), _accepted, STUB),
    Format("JPEG2000", _starts(b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"), _jpeg2000_probe, TODO,
           label="JPEG 2000"),
    Format("ICNS", _starts(ICNS_MAGIC), icns_directory, DECODE, decode_icns),
    Format("ICO", _starts(ICO_MAGIC), ico_directory, DECODE, decode_ico),
    Format("IM", None, _im_probe, TODO),
    Format("IMT", None, _imt_probe, TODO),
    Format("IPTC", None, _iptc_probe, TODO),
    Format("MCIDAS", _starts(b"\x00\x00\x00\x00\x00\x00\x00\x04"), _mcidas_probe, TODO),
    Format("MPEG", _starts(b"\x00\x00\x01\xb3"), _mpeg_probe, STUB),
    Format("TIFF", is_tiff, _accepted, DECODE, decode_tiff),
    Format("MSP", _starts(b"DanM", b"LinS"), _msp_probe, TODO),
    Format("PCD", None, _pcd_probe, TODO),
    Format("PIXAR", _starts(b"\200\350\000\000"), _pixar_probe, TODO),
    Format("PSD", _starts(b"8BPS"), _psd_probe, TODO),
    Format("QOI", _starts(QOI_MAGIC), qoi_header, DECODE, decode_qoi),
    Format("SGI", is_sgi, sgi_header, DECODE, decode_sgi),
    Format("SPIDER", None, _spider_probe, TODO),
    Format("SUN", lambda p: len(p) >= 4 and _u32(p, 0, ">") == 0x59A66A95, _sun_probe, TODO),
    Format("TGA", None, tga_header, DECODE, decode_tga),
    Format("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP" and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"),
           _accepted, DECODE, decode_webp),
    Format("WMF", _wmf_accept, _wmf_probe, STUB),
    Format("XBM", lambda p: p.lstrip().startswith(b"#define"), _xbm_probe, TODO),
    Format("XPM", _starts(b"/* XPM */"), _xpm_probe, TODO),
    Format("XVTHUMB", _starts(b"P7 332"), _xvthumb_probe, TODO, label="XVThumb"),
)
STUB_WHY = {"EPS": "Ghostscript, which the card's machine lacks"}


def identify(data: Union[bytes, Source], name: str) -> Format:
    """The format PIL opens the file as, walking `ORDER` as `Image.open`
    does. Raises NotImplementedError naming the file and PIL's format for
    a format the port does not read yet, and ValueError naming the file
    for one PIL opens but cannot load, for what PIL refuses while it opens
    the file and for a file no format takes."""
    src = data if isinstance(data, Source) else Source(data)
    prefix = src[:PREFIX]
    for fmt in ORDER:
        try:
            if fmt.accept is not None and not fmt.accept(prefix):
                continue
            fmt.probe(src, name)
        except NotThisFormat:
            continue
        except ValueError as e:  # a probe's read of the file refused, as PIL's reads of it refuse
            if str(e).startswith(f"{name}: "):
                raise
            raise ValueError(f"{name}: {fmt.name}: {e}") from None
        label = fmt.label or fmt.name
        if fmt.outcome == TODO:
            raise NotImplementedError(f"{name}: PIL reads this {label} file; the port does not yet")
        if fmt.outcome == STUB:
            why = STUB_WHY.get(fmt.name, "a loader of its own, which PIL does not ship")
            raise ValueError(f"{name}: PIL opens this {label} file but cannot load it (it needs {why})")
        return fmt
    raise ValueError(f"{name}: no format of PIL's takes this file (PIL cannot identify it)")

