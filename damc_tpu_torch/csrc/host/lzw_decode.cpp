// The sequential codes of GIF and TIFF, decoded as PIL's readers decode
// them, so that the port's GIF and TIFF readers (damc_tpu_torch/data/gif.py,
// damc_tpu_torch/data/tiff.py) give PIL's pixels on whole files and PIL's
// refusals on corrupt ones:
//
//   * GIF's LZW (LSB-first codes, variable width from the minimum code size,
//     clear and end codes, sub-blocks) as Pillow's libImaging/GifDecode.c
//     decodes a frame, rows de-interlaced as it places them. Pillow feeds its
//     decoder the file in reads of 65,536 bytes, begins a sub-block only when
//     all of it has been read, and treats an end code as a pause: the decode
//     goes on with the next read, and fails ("image file is truncated") only
//     when the file has no more to read. The decoder here takes the frame's
//     data to the end of the file and replays those reads.
//   * TIFF's LZW (MSB-first codes of 9 to 12 bits with the early change, the
//     table growing to libtiff's 5,119 entries) as libtiff 4.7's
//     tif_lzw.c LZWDecode decodes a strip or tile: PIL's reader hands every
//     compressed TIFF to libtiff.
//   * TIFF's pre-5.0 LZW (LSB-first codes whose width changes one code
//     later) as libtiff's LZWDecodeCompat.
//   * TIFF's PackBits as libtiff's tif_packbits.c PackBitsDecode.
//   * TIFF's ThunderScan 4-bit coding as libtiff's tif_thunder.c
//     ThunderDecodeRow.
//
// C interface (ctypes, damc_tpu_torch/data/lzw.py):
//   damc_gif_decode(data, len, bits, interlace, image, stride, xoff, yoff, xsize, ysize)
//   damc_tiff_lzw(in, in_len, out, out_len)
//   damc_packbits(in, in_len, out, out_len)
//   damc_thunderscan(in, in_len, out, out_len, width)
// Each returns 0, or one of the failure codes below; the output is written
// as far as the decode got. ctypes releases the interpreter lock around each
// call.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o liblzw_decode.so lzw_decode.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { OK = 0, TRUNCATED = 1, BROKEN = 2, CONFIG = 3, OVERRUN = 4, OLD_STYLE = 5, SHORT = 6 };

// ---------------------------------------------------------------------------
// GIF (libImaging/GifDecode.c, Gif.h)
// ---------------------------------------------------------------------------

const int kGifBits = 12;
const int kGifTable = 1 << kGifBits;
const int64_t kPilRead = 65536;  // ImageFile.load's read size (decodermaxblock)

struct GifState {
  // ImagingCodecState
  int x = 0, y = 0, xsize, ysize;
  // GIFDECODERSTATE
  int bits, interlace, step = 1, repeat = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0, codesize = 0, codemask = 0, clear = 0, end = 0;
  int lastcode = 0;
  uint8_t lastdata = 0;
  int bufferindex = kGifTable;
  uint8_t buffer[kGifTable];
  uint16_t link[kGifTable];
  uint8_t data[kGifTable];
  int next = 0;
  int phase = 0;  // GifDecode.c's state->state
};

// Where the decode stopped: DONE (the frame is whole), PAUSE (it wants the
// next read: a sub-block not read whole, or an end code), or a failure.
enum GifStep { DONE, PAUSE, FAIL_BROKEN, FAIL_OVERRUN };

// GifDecode.c's NEWLINE: the next row, through the interlace passes; false
// once every row is written.
bool gif_newline(GifState& s) {
  s.x = 0;
  s.y += s.step;
  while (s.y >= s.ysize) {
    switch (s.interlace) {
      case 1: s.repeat = s.y = 4; s.interlace = 2; break;
      case 2: s.step = 4; s.repeat = s.y = 2; s.interlace = 3; break;
      case 3: s.step = 2; s.repeat = s.y = 1; s.interlace = 0; break;
      default: return false;
    }
  }
  return true;
}

// One call of ImagingGifDecode over buf[pos, avail): advances pos past what
// it consumed.
GifStep gif_decode(GifState& s, const uint8_t* buf, int64_t& pos, int64_t avail, uint8_t* image, int64_t stride,
                   int xoff, int yoff) {
  const uint8_t* ptr = buf + pos;
  int64_t bytes = avail - pos;
  auto row = [&]() { return image + (int64_t)(s.y + yoff) * stride + xoff; };
  uint8_t* out = row() + s.x;
  for (;;) {
    const uint8_t* p;
    int i;
    if (s.phase == 1) {
      s.next = s.clear + 2;
      s.codesize = s.bits + 1;
      s.codemask = (1 << s.codesize) - 1;
      s.bufferindex = kGifTable;
      s.phase = 2;
    }
    if (s.bufferindex < kGifTable) {
      i = kGifTable - s.bufferindex;
      p = &s.buffer[s.bufferindex];
      s.bufferindex = kGifTable;
    } else {
      while (s.bitcount < s.codesize) {
        if (s.blocksize > 0) {
          int c = *ptr++;
          bytes--;
          s.blocksize--;
          s.bitbuffer |= (uint32_t)c << s.bitcount;
          s.bitcount += 8;
        } else {
          if (bytes < 1) { pos = ptr - buf; return PAUSE; }
          int c = *ptr;
          if (bytes < c + 1) { pos = ptr - buf; return PAUSE; }
          s.blocksize = c;
          ptr++;
          bytes--;
        }
      }
      int c = (int)(s.bitbuffer & (uint32_t)s.codemask);
      s.bitbuffer >>= s.codesize;
      s.bitcount -= s.codesize;
      if (c == s.clear) {
        if (s.phase != 2) s.phase = 1;
        continue;
      }
      if (c == s.end) { pos = ptr - buf; return PAUSE; }
      i = 1;
      p = &s.lastdata;
      if (s.phase == 2) {
        if (c > s.clear) return FAIL_BROKEN;
        s.lastdata = (uint8_t)c;
        s.lastcode = c;
        s.phase = 3;
      } else {
        int thiscode = c;
        if (c > s.next) return FAIL_BROKEN;
        if (c == s.next) {
          if (s.bufferindex <= 0) return FAIL_BROKEN;
          s.buffer[--s.bufferindex] = s.lastdata;
          c = s.lastcode;
        }
        while (c >= s.clear) {
          if (s.bufferindex <= 0 || c >= kGifTable) return FAIL_BROKEN;
          s.buffer[--s.bufferindex] = s.data[c];
          c = s.link[c];
        }
        s.lastdata = (uint8_t)c;
        if (s.next < kGifTable) {
          s.data[s.next] = (uint8_t)c;
          s.link[s.next] = (uint16_t)s.lastcode;
          if (s.next == s.codemask && s.codesize < kGifBits) {
            s.codesize++;
            s.codemask = (1 << s.codesize) - 1;
          }
          s.next++;
        }
        s.lastcode = thiscode;
      }
    }
    if (s.y >= s.ysize) return FAIL_OVERRUN;
    for (int k = 0; k < i; k++) {
      *out++ = p[k];
      if (++s.x >= s.xsize) {
        if (!gif_newline(s)) { pos = ptr - buf; return DONE; }
        out = row();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// TIFF LZW (libtiff 4.7 tif_lzw.c LZWDecode)
// ---------------------------------------------------------------------------

const int kBitsMin = 9, kBitsMax = 12;
const int kClear = 256, kEoi = 257, kFirst = 258;
const int kCsize = ((1 << kBitsMax) - 1) + 1024;  // libtiff's CSIZE

struct Code {
  int next;  // the code before this one in its string, -1 at a string's start
  uint16_t length;
  uint8_t value, firstchar;
};

int tiff_lzw_compat(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t occ);

int tiff_lzw(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t occ) {
  if (in_len >= 2 && in[0] == 0 && (in[1] & 1)) return tiff_lzw_compat(in, in_len, out, occ);
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; ++c) tab[c] = Code{-1, 1, (uint8_t)c, (uint8_t)c};
  // LZWPreDecode: no entry may be used before a clear code sets the table up.
  int free_ent = -1, maxcode = (1 << kBitsMin) - 2, nbits = kBitsMin, oldcode = 0;
  uint64_t bitpos = 0, bitsleft = (uint64_t)in_len * 8;
  uint8_t* op = out;
  auto next_code = [&]() -> int {
    if (bitsleft < (uint64_t)nbits) return kEoi;  // libtiff: "not terminated with EOI code", then short
    uint32_t v = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos) v = (v << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    bitsleft -= nbits;
    return (int)v;
  };
  auto grow = [&]() {
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 2;
      if (free_ent >= kCsize) free_ent = -1;  // only a clear or the end may follow
    }
  };
  auto emit = [&](int code) -> bool {  // the string of `code`; false once the output is full
    int len = tab[code].length;
    int64_t take = len < occ ? len : occ;
    int c = code;
    for (int k = len - 1; k >= 0; --k, c = tab[c].next)
      if (k < take) op[k] = tab[c].value;
    op += take;
    occ -= take;
    return occ > 0;
  };
  if (occ == 0) return OK;
  for (;;) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      maxcode = (1 << kBitsMin) - 2;
      do code = next_code(); while (code == kClear);
      if (code == kEoi) break;
      if (code > kEoi) return BROKEN;
      *op++ = (uint8_t)code;
      occ--;
      oldcode = code;
      if (occ == 0) break;
      continue;
    }
    if (code < 256) {
      if (free_ent < 0 || code > free_ent) return BROKEN;
      Code& e = tab[free_ent];
      e = Code{oldcode, (uint16_t)(tab[oldcode].length + 1), (uint8_t)code, tab[oldcode].firstchar};
      grow();
      oldcode = code;
      *op++ = (uint8_t)code;
      if (--occ == 0) break;
      continue;
    }
    // code >= 258
    if (free_ent < 0 || code > free_ent) return BROKEN;
    uint8_t value = code == free_ent ? tab[oldcode].firstchar : tab[code].firstchar;
    tab[free_ent] = Code{oldcode, (uint16_t)(tab[oldcode].length + 1), value, tab[oldcode].firstchar};
    grow();
    oldcode = code;
    if (!emit(code)) break;
  }
  if (occ > 0) {
    memset(op, 0, (size_t)occ);
    return SHORT;
  }
  return OK;
}

// The pre-5.0 codes (libtiff 4.7 LZWDecodeCompat): LSB first, the width
// growing once the next entry passes 2^width - 1. Every entry past the
// first 258 is cleared at a clear code; a code naming an empty one is
// refused, as is a first code that is not a clear code.
int tiff_lzw_compat(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t occ) {
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; ++c) tab[c] = Code{-1, 1, (uint8_t)c, (uint8_t)c};
  for (int c = 256; c < kCsize; ++c) tab[c] = Code{-1, 0, 0, 0};
  int free_ent = -1, maxcode = (1 << kBitsMin) - 2, nbits = kBitsMin, oldcode = -1;
  uint64_t nextdata = 0, bitsleft = (uint64_t)in_len * 8;
  int nextbits = 0;
  int64_t bp = 0;
  uint8_t* op = out;
  auto byte = [&]() -> uint64_t { return bp < in_len ? in[bp++] : (bp++, 0); };
  auto next_code = [&]() -> int {
    if (bitsleft < (uint64_t)nbits) return kEoi;
    nextdata |= byte() << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= byte() << nextbits;
      nextbits += 8;
    }
    int code = (int)(nextdata & ((1u << nbits) - 1));
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int c = kFirst; c < kCsize; ++c) tab[c] = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        maxcode = (1 << kBitsMin) - 1;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return BROKEN;
      *op++ = (uint8_t)code;
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize || oldcode < 0) return BROKEN;
    Code& e = tab[free_ent];
    e.next = oldcode;
    e.firstchar = tab[oldcode].firstchar;
    e.length = (uint16_t)(tab[oldcode].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 1;
    }
    oldcode = code;
    if (code >= 256) {
      const Code& c = tab[code];
      if (c.length == 0) return BROKEN;
      int start = code;
      if (c.length > occ) {  // the part that fits: the string's first occ values
        while (tab[start].length > occ) start = tab[start].next;
        for (int64_t k = occ - 1, x = start; k >= 0; --k, x = tab[x].next) op[k] = tab[x].value;
        op += occ;
        occ = 0;
        break;
      }
      int len = c.length;
      int64_t k = len;
      for (int x = code; x >= 0 && k > 0; x = tab[x].next) op[--k] = tab[x].value;
      op += len;
      occ -= len;
    } else {
      *op++ = (uint8_t)code;
      occ--;
    }
  }
  if (occ > 0) {
    memset(op, 0, (size_t)occ);
    return SHORT;
  }
  return OK;
}

// ---------------------------------------------------------------------------
// TIFF ThunderScan (libtiff tif_thunder.c ThunderDecodeRow)
// ---------------------------------------------------------------------------

// Rows of `width` 4-bit pixels, two a byte, each row decoded from where the
// last one stopped: runs of the last pixel, 2- and 3-bit deltas from it,
// and raw values. A row that ends short or runs past its width is refused.
int thunderscan(const uint8_t* in, int64_t cc, uint8_t* out, int64_t occ, int64_t width) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const int64_t row_bytes = (width * 4 + 7) / 8;
  if (row_bytes <= 0 || occ % row_bytes) return BROKEN;
  const uint8_t* bp = in;
  for (uint8_t* row = out; occ > 0; row += row_bytes, occ -= row_bytes) {
    uint8_t* op = row;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto set = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < width) {
        if (npixels++ & 1) *op++ |= (uint8_t)lastpixel;
        else op[0] = (uint8_t)(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < width) {
      int n = *bp++, delta;
      cc--;
      switch (n & 0xc0) {
        case 0x00:
          if (npixels & 1) {
            op[0] |= (uint8_t)lastpixel;
            lastpixel = *op++;
            npixels++;
            n--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += n;
          if (npixels <= width)
            for (; n > 0; n -= 2) *op++ = (uint8_t)lastpixel;
          if (n == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        case 0x40:
          if ((delta = (n >> 4) & 3) != 2) set((unsigned)((int)lastpixel + kTwo[delta]));
          if ((delta = (n >> 2) & 3) != 2) set((unsigned)((int)lastpixel + kTwo[delta]));
          if ((delta = n & 3) != 2) set((unsigned)((int)lastpixel + kTwo[delta]));
          break;
        case 0x80:
          if ((delta = (n >> 3) & 7) != 4) set((unsigned)((int)lastpixel + kThree[delta]));
          if ((delta = n & 7) != 4) set((unsigned)((int)lastpixel + kThree[delta]));
          break;
        default:
          set((unsigned)n);
          break;
      }
    }
    if (npixels != width) return npixels < width ? SHORT : OVERRUN;
  }
  return OK;
}

// ---------------------------------------------------------------------------
// TIFF PackBits (libtiff tif_packbits.c PackBitsDecode)
// ---------------------------------------------------------------------------

int packbits(const uint8_t* in, int64_t cc, uint8_t* op, int64_t occ) {
  const uint8_t* bp = in;
  while (cc > 0 && occ > 0) {
    long n = (long)(int8_t)*bp++;
    cc--;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < n) n = (long)occ;
      if (cc == 0) break;
      occ -= n;
      uint8_t b = *bp++;
      cc--;
      memset(op, b, (size_t)n);
      op += n;
    } else {
      if (occ < n + 1) n = (long)occ - 1;
      if (cc < n + 1) break;
      ++n;
      memcpy(op, bp, (size_t)n);
      op += n;
      occ -= n;
      bp += n;
      cc -= n;
    }
  }
  if (occ > 0) {
    memset(op, 0, (size_t)occ);
    return SHORT;
  }
  return OK;
}

}  // namespace

extern "C" {

// Frame 0 of a GIF: `data[0, len)` runs from the first sub-block of the
// frame's image data to the end of the file; `bits` is its minimum code
// size. Pixels go to image + (yoff + row) * stride + xoff + column for the
// frame's xsize x ysize. Returns OK, TRUNCATED (the file ends first),
// BROKEN (a code PIL's decoder refuses), CONFIG (bits past 12) or OVERRUN.
int damc_gif_decode(const uint8_t* data, int64_t len, int bits, int interlace, uint8_t* image, int64_t stride,
                    int xoff, int yoff, int xsize, int ysize) {
  if (bits < 0 || bits > 12) return CONFIG;
  GifState* s = new GifState();
  s->xsize = xsize;
  s->ysize = ysize;
  s->bits = bits;
  s->clear = 1 << bits;
  s->end = s->clear + 1;
  if (interlace) {
    s->interlace = 1;
    s->step = s->repeat = 8;
  } else {
    s->interlace = 0;
    s->step = 1;
  }
  s->phase = 1;
  int64_t pos = 0, fed = 0;
  int status = TRUNCATED;
  for (;;) {
    if (fed == len) break;  // ImageFile.load: nothing more to read
    fed = len - fed < kPilRead ? len : fed + kPilRead;
    GifStep step = gif_decode(*s, data, pos, fed, image, stride, xoff, yoff);
    if (step == DONE) { status = OK; break; }
    if (step == FAIL_BROKEN) { status = BROKEN; break; }
    if (step == FAIL_OVERRUN) { status = OVERRUN; break; }
  }
  delete s;
  return status;
}

// One TIFF LZW strip or tile into out[0, out_len): OK, BROKEN (a code not
// yet in the table) or SHORT (the data ends first). Data that begins as the
// pre-TIFF 5.0 codes do (0x00, then an odd byte) is read by their decoder,
// as libtiff reads it.
int damc_tiff_lzw(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  return tiff_lzw(in, in_len, out, out_len);
}

// One ThunderScan strip or tile of rows `width` pixels wide into
// out[0, out_len): OK, SHORT or OVERRUN (a row ends short or runs past its
// width) or BROKEN (out_len not whole rows).
int damc_thunderscan(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len, int64_t width) {
  return thunderscan(in, in_len, out, out_len, width);
}

// One TIFF PackBits strip or tile into out[0, out_len): OK or SHORT.
int damc_packbits(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  return packbits(in, in_len, out, out_len);
}

}  // extern "C"
