// JPEG decoder whose output equals, byte for byte, what PIL's
// `Image.open(path).convert("RGB")` returns: libjpeg-turbo's default
// decompression (the islow integer IDCT of jidctint.c, fancy upsampling of
// jdsample.c, the table-driven YCbCr to RGB conversion and the YCCK to CMYK
// conversion of jdcolor.c), then, for 4-component files, PIL's own steps:
// the samples read as inverted CMYK ("CMYK;I") and its cmyk2rgb.
//
// Scope: sequential Huffman (SOF0, SOF1) and progressive Huffman (SOF2),
// 8-bit samples, 1, 3 or 4 components (grey; YCbCr or RGB; CMYK or YCCK),
// any integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), restart
// markers, interleaved or single-component scans, partial MCUs at the right
// and bottom edges. A progressive file keeps a whole-image coefficient
// buffer and decodes the four scan kinds of jdphuff.c (DC first, DC refine,
// AC first with EOB runs, AC refine with correction bits). libjpeg smooths
// the blocks of a progressive file whose low-frequency coefficients are not
// all complete (jdcoefct.c do_block_smoothing); such a file is refused as
// corrupt rather than decoded differently. EXIF orientation and ICC
// profiles are ignored, as convert("RGB") ignores them. Arithmetic-coded,
// lossless, hierarchical and 12-bit files are refused with status 1
// (unsupported); corrupt or truncated data with status 2. Every read is
// bounds-checked against the buffer.
//
// C interface (ctypes, damc_tpu_torch/data/jpeg.py):
//   damc_jpeg_header(data, len, &width, &height, &components, msg, msglen)
//   damc_jpeg_decode_batch(datas, lens, outs, n, threads, status, msgs, msglen)
// `outs[i]` is a caller-owned (height, width, 3) uint8 buffer sized from the
// header; each image of the batch is decoded by one thread of a pool.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o libjpeg_decode.so jpeg_decode.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status { OK = 0, UNSUPPORTED = 1, CORRUPT = 2 };

struct Failure {
  Status status;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw Failure{CORRUPT, msg}; }
[[noreturn]] void unsupported(const std::string& msg) { throw Failure{UNSUPPORTED, msg}; }

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jutils.c jpeg_natural_order with its 16 extra entries: a progressive AC
// scan's run may step past its band, and libjpeg then stores at 63.
inline int natural(int k) { return k < 64 ? kZigzag[k] : 63; }

// CMYK to RGB as PIL converts it (libImaging/Convert.c cmyk2rgb), after it
// reads the decoder's samples as inverted CMYK.
inline uint8_t muldiv255(int a, int b) {
  int t = a * b + 128;
  return (uint8_t)(((t >> 8) + t) >> 8);
}

// ---------------------------------------------------------------------------
// Output range limiting after the IDCT (jdmaster.c prepare_range_limit_table):
// the descaled value is taken modulo 1024 (& RANGE_MASK) and mapped to
// x + 128 for x in [-128, 127], 255 for [128, 511], 0 for [512, 895] (the
// values -512 to -129), so a wild value wraps as libjpeg's table makes it.
// ---------------------------------------------------------------------------
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;
const int kRangeMask = 1023;

// YCbCr -> RGB tables (jdcolor.c build_ycc_rgb_table), 16 fraction bits.
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int kScale = 16;
    const int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + kHalf;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------------------
// islow inverse DCT (jidctint.c), CONST_BITS 13, PASS1_BITS 2, with its
// shortcuts for columns and rows whose AC terms are all zero.
//
// libjpeg-turbo runs it in SIMD (jidctint-sse2/avx2): the dequantised
// coefficients, the sums in0 +- in4, in7 + in3 and in5 + in1 of each pass
// and pass 1's outputs in 16-bit lanes, and its last step saturates where
// the C table above wraps. The two agree on every block an encoder writes;
// a corrupt block can leave that range, and then the function returns
// false and the file is refused rather than decoded otherwise than PIL.
// ---------------------------------------------------------------------------
const int kConstBits = 13;
const int kPass1Bits = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

inline bool fits16(int64_t v) { return v >= -32768 && v <= 32767; }

bool idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int ws[64];
  for (int k = 0; k < 64; ++k)
    if (!fits16((int64_t)coef[k] * quant[k])) return false;
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 &&
        in[56] == 0) {
      int64_t dc = ((int64_t)in[0] * q[0]) * (1 << kPass1Bits);
      if (!fits16(dc)) return false;
      for (int r = 0; r < 8; ++r) w[8 * r] = (int)dc;
      continue;
    }
    {
      const int64_t i0 = (int64_t)in[0] * q[0], i4 = (int64_t)in[32] * q[32];
      if (!fits16(i0 + i4) || !fits16(i0 - i4) || !fits16((int64_t)in[56] * q[56] + (int64_t)in[24] * q[24]) ||
          !fits16((int64_t)in[40] * q[40] + (int64_t)in[8] * q[8]))
        return false;
    }
    int64_t z2 = (int64_t)in[16] * q[16], z3 = (int64_t)in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * q[0];
    z3 = (int64_t)in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * q[56];
    tmp1 = (int64_t)in[40] * q[40];
    tmp2 = (int64_t)in[24] * q[24];
    tmp3 = (int64_t)in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, s);
    w[56] = (int)descale(tmp10 - tmp3, s);
    w[8] = (int)descale(tmp11 + tmp2, s);
    w[48] = (int)descale(tmp11 - tmp2, s);
    w[16] = (int)descale(tmp12 + tmp1, s);
    w[40] = (int)descale(tmp12 - tmp1, s);
    w[24] = (int)descale(tmp13 + tmp0, s);
    w[32] = (int)descale(tmp13 - tmp0, s);
    for (int r = 0; r < 8; ++r)
      if (!fits16(w[8 * r])) return false;
  }
  const int s = kConstBits + kPass1Bits + 3;
  auto limit = [](int64_t x, bool& ok) {  // the C table and SIMD's saturation agree on [-512, 511]
    if (x < -512 || x > 511) ok = false;
    return kRange.t[(int)x & kRangeMask];
  };
  bool ok = true;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (!fits16((int64_t)w[0] + w[4]) || !fits16((int64_t)w[0] - w[4]) || !fits16((int64_t)w[7] + w[3]) ||
        !fits16((int64_t)w[5] + w[1]))
      return false;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = limit(descale((int64_t)w[0], kPass1Bits + 3), ok);
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit(descale(tmp10 + tmp3, s), ok);
    o[7] = limit(descale(tmp10 - tmp3, s), ok);
    o[1] = limit(descale(tmp11 + tmp2, s), ok);
    o[6] = limit(descale(tmp11 - tmp2, s), ok);
    o[2] = limit(descale(tmp12 + tmp1, s), ok);
    o[5] = limit(descale(tmp12 - tmp1, s), ok);
    o[3] = limit(descale(tmp13 + tmp0, s), ok);
    o[4] = limit(descale(tmp13 - tmp0, s), ok);
  }
  return ok;
}

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------
const int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};  // largest code of each length, -1 if none; [17] sentinel
  int32_t valoff[17] = {};   // index into vals of the first code of each length, minus that code
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value for codes of <= kLookBits bits; 0 = longer
  int max_val = -1;  // the largest symbol

  void build(const uint8_t counts[17], const uint8_t* symbols, int nsym) {
    memcpy(vals, symbols, nsym);
    max_val = nsym ? *std::max_element(symbols, symbols + nsym) : -1;
    int code = 0, k = 0;
    memset(look, 0, sizeof(look));
    for (int len = 1; len <= 16; ++len) {
      valoff[len] = k - code;
      for (int i = 0; i < counts[len]; ++i, ++k, ++code) {
        // jdhuff.c: the codes of a length fit in it, and none is all ones.
        if (code >= (1 << len) - 1) corrupt("bad Huffman table (more codes than a length holds)");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); ++j) look[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
        }
      }
      maxcode[len] = counts[len] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader: 0xFF00 stuffing removed; a marker or the end
// of the buffer supplies zero bits, and consuming one of them is an error.
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t p;
  uint64_t acc = 0;
  int nbits = 0;
  int fake = 0;  // zero bits at the tail of acc that stand past a marker or the end
  bool at_marker = false;
  bool overrun = false;

  BitReader(const uint8_t* data, size_t len, size_t pos) : d(data), n(len), p(pos) {}

  void fill() {
    while (nbits <= 56) {
      uint64_t b = 0;
      if (!at_marker) {
        if (p >= n) {
          at_marker = true;
        } else if (d[p] != 0xFF) {
          b = d[p++];
        } else if (p + 1 < n && d[p + 1] == 0x00) {
          b = 0xFF;
          p += 2;
        } else {
          at_marker = true;  // p stays on the marker's 0xFF
        }
      }
      if (at_marker) fake += 8;
      acc |= b << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t peek16() {
    if (nbits < 16) fill();
    return (uint32_t)(acc >> 48);
  }
  inline void skip(int k) {
    acc <<= k;
    nbits -= k;
    if (nbits < fake) {
      overrun = true;
      fake = nbits;
    }
  }
  inline int get(int k) {  // 1 <= k <= 16
    if (nbits < k) fill();
    int v = (int)(acc >> (64 - k));
    skip(k);
    return v;
  }
  int decode(const Huffman& h) {
    uint32_t look = peek16();
    uint16_t e = h.look[look >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      int32_t code = (int32_t)(look >> (16 - len));
      if (code <= h.maxcode[len]) {
        skip(len);
        int idx = h.valoff[len] + code;
        if (idx < 0 || idx > 255) corrupt("bad Huffman code");
        return h.vals[idx];
      }
    }
    corrupt("bad Huffman code");
  }
  // Position of the next marker: the bits left in the buffer are the
  // segment's padding; bytes that stand between them and the marker are
  // skipped, as libjpeg discards them.
  size_t next_marker() {
    size_t q = p;
    for (;;) {
      if (q + 1 >= n) return n;
      if (d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF) return q;
      ++q;
    }
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks a row and rows of blocks, padded to whole MCUs
  int dw = 0, dh = 0;  // samples a row and rows of the component (downsampled size)
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  // The quantization table as libjpeg latches it at the component's first
  // scan (jdinput.c latch_quant_tables); all zero until then.
  bool latched = false;
  uint16_t q[64] = {};
  int coef_bits[64];  // progressive: the Al of each coefficient's last scan, -1 before any
  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool have_frame = false, have_scan = false, jfif = false, adobe = false, progressive = false;
  bool multi_scan = false;  // jdinput.c initial_setup: progressive, or a first scan without every component
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[4];

  Jpeg(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) corrupt("truncated file (inside a marker segment)");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
  // The next marker code. Bytes before its 0xFF are skipped, as libjpeg's
  // next_marker discards them (with a warning), and so are fill bytes 0xFF.
  // A stuffed FF 00 outside a scan is skipped too, as both skip it.
  int marker() {
    for (;;) {
      while (u8() != 0xFF) {
      }
      int m;
      do m = u8();
      while (m == 0xFF);
      if (m != 0) return m;
    }
  }

  void read_sof(int m, size_t end) {
    if (have_frame) corrupt("two frame headers");
    if (!icc.empty()) {  // PIL's SOF handler reads byte 13 of the first ICC_PROFILE segment, sorted
      std::sort(icc.begin(), icc.end());
      if (icc[0].size() < 14) corrupt("an ICC_PROFILE segment too short for PIL");
      icc.clear();
    }
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (end - pos != 3 * (size_t)ncomp) corrupt("bad frame header length");  // jdmarker.c JERR_BAD_LENGTH
    if (precision != 8) unsupported(std::to_string(precision) + "-bit samples (8 bits only)");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) unsupported(std::to_string(ncomp) + " components (1, 3 or 4 only)");
    progressive = m == 0xC2;
    if (width == 0 || height == 0) corrupt("zero width or height (a DNL marker is not supported)");
    if (pos + 3 * (size_t)ncomp > end) corrupt("truncated frame header");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) corrupt("bad sampling factors");
      if (c.tq > 3) corrupt("bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (ncomp > 1 && (hmax % c.h || vmax % c.v))
        unsupported("fractional sampling factors");
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    have_frame = true;
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3) corrupt("bad quantization table");  // any precision but 0 is 16-bit, in libjpeg as in PIL
      for (int k = 0; k < 64; ++k) qt[t][kZigzag[k]] = (uint16_t)(prec ? u16() : u8());
      if (pos > end) corrupt("bad quantization table length");
      qt_defined[t] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) corrupt("bad Huffman table index");
      uint8_t counts[17] = {};
      int total = 0;
      for (int i = 1; i <= 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256) corrupt("bad Huffman table (more than 256 symbols)");
      if (pos + total > end) corrupt("truncated Huffman table");
      uint8_t sym[256];
      for (int i = 0; i < total; ++i) sym[i] = (uint8_t)u8();
      (cls ? ac[t] : dc[t]).build(counts, sym, total);
    }
  }

  void read_app(int m, size_t end) {
    size_t len = end - pos;
    const uint8_t* p = d + pos;
    // jdmarker.c examine_app0 / examine_app14: the first 14 / 12 bytes.
    if (m == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
      adobe = true;
      adobe_transform = p[11];
    }
    if (!have_scan) pil_app(m, p, len);
    pos = end;
  }

  // PIL reads the segments before the first scan itself
  // (JpegImagePlugin.APP), and a few short ones that libjpeg ignores make
  // its Image.open fail: a JFIF or Adobe segment without its version, a
  // Photoshop resource block cut after its code, and (checked at SOF) an
  // ICC_PROFILE segment without its marker count.
  std::vector<std::string> icc;
  void pil_app(int m, const uint8_t* p, size_t len) {
    auto starts = [&](const char* tag, size_t k) { return len >= k && !memcmp(p, tag, k); };
    if ((m == 0xE0 && starts("JFIF", 4)) || (m == 0xEE && starts("Adobe", 5))) {
      if (len < 7) corrupt("a JFIF or Adobe segment too short for PIL");
    } else if (m == 0xE2 && starts("ICC_PROFILE", 12)) {
      icc.emplace_back((const char*)p, len);
    } else if (m == 0xED && starts("Photoshop 3.0", 14)) {
      // PIL's loop over the resource blocks stops at a struct.error (a
      // short code, size or ResolutionInfo) but fails at an IndexError.
      uint64_t off = 14;
      while (off + 4 <= len && !memcmp(p + off, "8BIM", 4)) {
        off += 4;
        if (off + 2 > len) break;
        const int code = (p[off] << 8) | p[off + 1];
        off += 2;
        if (off >= len) corrupt("a Photoshop segment too short for PIL");
        off += 1 + p[off];
        off += off & 1;
        if (off + 4 > len) break;
        const uint64_t size = ((uint64_t)p[off] << 24) | (p[off + 1] << 16) | (p[off + 2] << 8) | p[off + 3];
        off += 4;
        if (code == 0x03ED && std::min<uint64_t>(size, off < len ? len - off : 0) < 14) break;
        off += size;
        off += off & 1;
      }
    }
  }

  static int add_dc(int pred, int diff) {
    int64_t v = (int64_t)pred + diff;  // jdhuff.c refuses a DC value that leaves int (JERR_BAD_DCT_COEF)
    if (v > INT32_MAX || v < INT32_MIN) corrupt("DC coefficient out of range");
    return (int)v;
  }

  void decode_block(BitReader& br, int16_t* blk, const Huffman& hdc, const Huffman& hac, int& pred) {
    int s = br.decode(hdc);
    if (s > 15) corrupt("bad DC magnitude category");
    int diff = s ? extend(br.get(s), s) : 0;
    pred = add_dc(pred, diff);
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64;) {
      int rs = br.decode(hac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) corrupt("AC coefficient index past 63");
        blk[kZigzag[k]] = (int16_t)extend(br.get(sz), sz);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // The four progressive scan kinds (jdphuff.c decode_mcu_DC_first,
  // decode_mcu_DC_refine, decode_mcu_AC_first, decode_mcu_AC_refine).
  void dc_first(BitReader& br, int16_t* blk, const Huffman& hdc, int& pred, int al) {
    int s = br.decode(hdc);
    if (s > 15) corrupt("bad DC magnitude category");
    int diff = s ? extend(br.get(s), s) : 0;
    pred = add_dc(pred, diff);
    blk[0] = (int16_t)(int)((unsigned)pred << al);
  }

  void ac_first(BitReader& br, int16_t* blk, const Huffman& hac, int ss, int se, int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(hac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (s > 15) corrupt("bad AC magnitude category");
        blk[natural(k)] = (int16_t)(int)((unsigned)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  void ac_refine(BitReader& br, int16_t* blk, const Huffman& hac, int ss, int se, int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto correct = [&](int16_t& c) {
      if (br.get(1) && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c + m1);
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(hac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // A new coefficient has size 1 (libjpeg warns otherwise and reads on).
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& c = blk[natural(k)];
          if (c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[natural(k)] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& c = blk[natural(k)];
        if (c != 0) correct(c);
      }
      --eobrun;
    }
  }

  void read_scan(size_t end) {
    if (!have_frame) corrupt("a scan before the frame header");
    int ns = u8();
    if (ns < 1 || ns > ncomp) corrupt("bad scan component count");
    if (!have_scan) multi_scan = progressive || ns < ncomp;
    else if (!multi_scan) corrupt("a second scan in a single-scan file (EOI expected)");
    int idx[4], td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int cid = u8(), t = u8();
      // jdmarker.c get_sos: scan slot i takes the first component with that
      // ID whose index has no slot filled yet, that is, an index >= i.
      idx[i] = -1;
      for (int j = i; j < ncomp && idx[i] < 0; ++j)
        if (comp[j].id == cid) idx[i] = j;
      if (idx[i] < 0) corrupt("a scan names an unknown component");
      for (int j = 0; j < i; ++j)  // which libjpeg refuses too, if later
        if (idx[j] == idx[i]) corrupt("a scan names a component twice");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) corrupt("bad Huffman table index");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (pos != end) corrupt("bad scan header length");
    // jdhuff.c jpeg_make_d_derived_tbl refuses a DC table with a symbol above
    // 15 when a scan first uses it, whether or not the symbol is ever decoded.
    auto dc_table = [&](int t) {
      if (!dc[t].defined) corrupt("a scan uses an undefined Huffman table");
      if (dc[t].max_val > 15) corrupt("bad Huffman table (a DC symbol above 15)");
    };
    if (!progressive) {
      if (ss != 0 || se != 63 || a != 0) corrupt("not a sequential scan (spectral selection or approximation set)");
      for (int i = 0; i < ns; ++i) {
        dc_table(td[i]);
        if (!ac[ta[i]].defined) corrupt("a scan uses an undefined Huffman table");
      }
    } else {
      // jdphuff.c start_pass_phuff_decoder: the checks that are errors.
      bool dc_band = ss == 0;
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) corrupt("bad progressive scan parameters");
      for (int i = 0; i < ns; ++i) {
        if (dc_band && ah == 0) dc_table(td[i]);
        if (!dc_band && !ac[ta[i]].defined) corrupt("a scan uses an undefined Huffman table");
        for (int k = ss; k <= se; ++k) comp[idx[i]].coef_bits[k] = al;
      }
    }
    int units = 0;
    for (int i = 0; i < ns; ++i) units += ns == 1 ? 1 : comp[idx[i]].h * comp[idx[i]].v;
    if (units > 10) corrupt("more than 10 blocks in an MCU");
    for (int i = 0; i < ns; ++i) {
      Component& c = comp[idx[i]];
      if (!c.latched) {
        if (!qt_defined[c.tq]) corrupt("a component uses an undefined quantization table");
        memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    int mx, my;  // MCUs a row and rows of MCUs
    if (ns == 1) {
      mx = (comp[idx[0]].dw + 7) / 8;
      my = (comp[idx[0]].dh + 7) / 8;
    } else {
      mx = mcux;
      my = mcuy;
    }
    BitReader br(d, n, pos);
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int64_t total = (int64_t)mx * my;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        size_t q = br.next_marker();
        if (q + 1 >= n || d[q + 1] != 0xD0 + next_rst) corrupt("missing or wrong restart marker");
        next_rst = (next_rst + 1) & 7;
        br = BitReader(d, n, q + 2);
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      int mcol = (int)(m % mx), mrow = (int)(m / mx);
      for (int i = 0; i < ns; ++i) {
        Component& c = comp[idx[i]];
        int hb = ns == 1 ? 1 : c.h, vb = ns == 1 ? 1 : c.v;
        for (int by = 0; by < vb; ++by)
          for (int bx = 0; bx < hb; ++bx) {
            size_t row = (size_t)mrow * vb + by, col = (size_t)mcol * hb + bx;
            int16_t* blk = &c.coef[(row * c.bw + col) * 64];
            if (!progressive) {
              decode_block(br, blk, dc[td[i]], ac[ta[i]], pred[i]);
            } else if (ss == 0) {
              if (ah == 0) dc_first(br, blk, dc[td[i]], pred[i], al);
              else if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
            } else if (ah == 0) {
              ac_first(br, blk, ac[ta[i]], ss, se, al, eobrun);
            } else {
              ac_refine(br, blk, ac[ta[i]], ss, se, al, eobrun);
            }
          }
      }
      if (br.overrun) corrupt("truncated or corrupt entropy-coded data");
    }
    pos = br.next_marker();
    have_scan = true;
  }

  // jdcoefct.c smoothing_ok: would libjpeg smooth the blocks of this
  // (progressive) file? It does when the DC and the first nine AC
  // coefficients of every component have quantizers and some of those AC
  // coefficients still miss bits (or were never sent) after the last scan.
  bool would_smooth() const {
    bool useful = false;
    static const int kSaved = 10;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < kSaved; ++k)
        if (c.q[kZigzag[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSaved; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // Markers up to the first SOF (header) or up to EOI (whole file).
  void parse(bool header_only) {
    // PIL opens a file only when a marker follows SOI at once (its _accept),
    // and decodes it only to its EOI marker.
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) corrupt("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      if (pos >= n) corrupt(have_scan ? "truncated file (no EOI marker)" : "truncated file (no image data)");
      int m = marker();
      // jdmarker.c refuses markers it does not know (JERR_UNKNOWN_MARKER);
      // PIL's own header parser also refuses TEM before the first scan.
      if (m < 0xC0 || m == 0xC8 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD)) {
        if (m != 0x01 || !have_scan) corrupt("an unknown marker");
      }
      if (m == 0xD9) {  // EOI
        if (!have_scan) corrupt("no scan before the end of the image");
        return;
      }
      if (m == 0xD8) corrupt("a second SOI marker");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // a stray RSTn, TEM
      int len = u16();
      if (len < 2 || pos + len - 2 > n) corrupt("truncated marker segment");
      size_t end = pos + len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m, end);
          if (header_only) return;
          break;
        case 0xC3: case 0xC7: case 0xCB: case 0xCF: unsupported("lossless coding");
        case 0xC5: case 0xC6: case 0xCE: unsupported("hierarchical (differential) coding");
        case 0xC9: case 0xCA: case 0xCD: case 0xCC: unsupported("arithmetic coding");
        case 0xC4: read_dht(end); break;
        case 0xDB: read_dqt(end); break;
        case 0xDD:
          if (len != 4) corrupt("bad DRI length");
          restart_interval = u16();
          break;
        case 0xDA:
          read_scan(end);
          continue;  // pos is at the next marker
        case 0xDC: unsupported("a DNL marker");
        default:
          if (m >= 0xE0 && m <= 0xEF) read_app(m, end);
          break;
      }
      pos = end;
    }
  }

  // jdapimin.c default_decompress_parms: is a 3-component file YCbCr?
  bool is_ycc() const {
    if (jfif) return true;
    if (adobe) return adobe_transform != 0;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return false;  // 'R' 'G' 'B'
    return true;
  }

  // Sample planes (bw * 8 wide) of one component from its coefficients.
  std::vector<uint8_t> idct_plane(const Component& c) const {
    size_t stride = (size_t)c.bw * 8;
    std::vector<uint8_t> plane(stride * c.bh * 8);
    const uint16_t* q = c.q;  // a component no scan named has no coefficients and an all-zero table
    // Only the blocks that hold samples of the image are needed.
    int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
    std::vector<int16_t> zero(64, 0);
    for (int by = 0; by < rows; ++by)
      for (int bx = 0; bx < cols; ++bx) {
        const int16_t* blk = c.coef.empty() ? zero.data() : &c.coef[((size_t)by * c.bw + bx) * 64];
        if (!idct_islow(blk, q, &plane[(size_t)by * 8 * stride + (size_t)bx * 8], (int)stride))
          corrupt("coefficients out of the range that libjpeg-turbo's SIMD inverse DCT computes as its C version");
      }
    return plane;
  }

  // The component at full size (width x height), as jdsample.c upsamples
  // it with fancy upsampling on: h2v1 and h2v2 triangle filters when the
  // component is wider than 2 samples, h1v2 always, plain replication for
  // every other integral factor. Rows above the first and below the last
  // repeat the edge row (jdmainct.c's context pointers).
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane) const {
    const int W = width, H = height;
    const size_t stride = (size_t)c.bw * 8;
    const int hr = hmax / c.h, vr = vmax / c.v;
    std::vector<uint8_t> out((size_t)W * H);
    auto in = [&](int y) { return &plane[(size_t)y * stride]; };
    const int dw = c.dw, dh = c.dh;
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; ++y) memcpy(&out[(size_t)y * W], in(y), W);
    } else if (hr == 2 && vr == 1 && dw > 2) {
      std::vector<uint8_t> row(2 * (size_t)dw);
      for (int y = 0; y < H; ++y) {
        const uint8_t* s = in(y);
        row[0] = s[0];
        row[1] = (uint8_t)((s[0] * 3 + s[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v = s[x] * 3;
          row[2 * x] = (uint8_t)((v + s[x - 1] + 1) >> 2);
          row[2 * x + 1] = (uint8_t)((v + s[x + 1] + 2) >> 2);
        }
        row[2 * (dw - 1)] = (uint8_t)((s[dw - 1] * 3 + s[dw - 2] + 1) >> 2);
        row[2 * (dw - 1) + 1] = s[dw - 1];
        memcpy(&out[(size_t)y * W], row.data(), W);
      }
    } else if (hr == 1 && vr == 2) {
      for (int y = 0; y < H; ++y) {
        int r = y >> 1;
        const uint8_t* s0 = in(r);
        const uint8_t* s1 = in((y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0));
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = &out[(size_t)y * W];
        for (int x = 0; x < W; ++x) o[x] = (uint8_t)((s0[x] * 3 + s1[x] + bias) >> 2);
      }
    } else if (hr == 2 && vr == 2 && dw > 2) {
      std::vector<int> sum(dw);
      std::vector<uint8_t> row(2 * (size_t)dw);
      for (int y = 0; y < H; ++y) {
        int r = y >> 1;
        const uint8_t* s0 = in(r);
        const uint8_t* s1 = in((y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0));
        for (int x = 0; x < dw; ++x) sum[x] = s0[x] * 3 + s1[x];
        row[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
        row[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; ++x) {
          row[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 8) >> 4);
          row[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 7) >> 4);
        }
        row[2 * (dw - 1)] = (uint8_t)((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
        row[2 * (dw - 1) + 1] = (uint8_t)((sum[dw - 1] * 4 + 7) >> 4);
        memcpy(&out[(size_t)y * W], row.data(), W);
      }
    } else {
      for (int y = 0; y < H; ++y) {
        const uint8_t* s = in(y / vr);
        uint8_t* o = &out[(size_t)y * W];
        for (int x = 0; x < W; ++x) o[x] = s[x / hr];
      }
    }
    return out;
  }

  void decode(uint8_t* rgb) {
    parse(false);
    if (progressive && would_smooth())
      corrupt("a progressive file whose scans leave low-frequency coefficients incomplete (libjpeg's block "
              "smoothing is not reproduced)");
    const size_t npix = (size_t)width * height;
    if (ncomp == 1) {
      std::vector<uint8_t> plane = idct_plane(comp[0]);
      size_t stride = (size_t)comp[0].bw * 8;
      for (int y = 0; y < height; ++y) {
        const uint8_t* s = &plane[(size_t)y * stride];
        uint8_t* o = rgb + (size_t)y * width * 3;
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
      }
      return;
    }
    std::vector<uint8_t> full[4];
    for (int i = 0; i < ncomp; ++i) full[i] = upsample(comp[i], idct_plane(comp[i]));
    const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
    if (ncomp == 4) {
      // jdapimin.c: Adobe transform 0 or no Adobe marker is CMYK, any other
      // transform YCCK, which jdcolor.c ycck_cmyk_convert turns into CMYK.
      // PIL reads the CMYK samples inverted and converts them by cmyk2rgb.
      const bool ycck = adobe && adobe_transform != 0;
      const uint8_t* c3 = full[3].data();
      for (size_t i = 0; i < npix; ++i) {
        int c = c0[i], m = c1[i], y = c2[i];
        if (ycck) {
          int luma = c0[i], cb = c1[i], cr = c2[i];
          c = clamp8(255 - (luma + kColor.cr_r[cr]));
          m = clamp8(255 - (luma + (int)((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16)));
          y = clamp8(255 - (luma + kColor.cb_b[cb]));
        }
        int nk = c3[i];  // 255 - (255 - k): the inverted K
        rgb[3 * i] = clamp8(nk - muldiv255(255 - c, nk));
        rgb[3 * i + 1] = clamp8(nk - muldiv255(255 - m, nk));
        rgb[3 * i + 2] = clamp8(nk - muldiv255(255 - y, nk));
      }
      return;
    }
    if (!is_ycc()) {
      for (size_t i = 0; i < npix; ++i) {
        rgb[3 * i] = c0[i];
        rgb[3 * i + 1] = c1[i];
        rgb[3 * i + 2] = c2[i];
      }
      return;
    }
    for (size_t i = 0; i < npix; ++i) {
      int y = c0[i], cb = c1[i], cr = c2[i];
      rgb[3 * i] = clamp8(y + kColor.cr_r[cr]);
      rgb[3 * i + 1] = clamp8(y + (int)((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
      rgb[3 * i + 2] = clamp8(y + kColor.cb_b[cb]);
    }
  }
};

void put_message(char* buf, size_t len, const std::string& msg) {
  if (!buf || !len) return;
  size_t k = std::min(len - 1, msg.size());
  memcpy(buf, msg.data(), k);
  buf[k] = 0;
}

}  // namespace

extern "C" {

// Parses markers up to the frame header. Returns 0 and the size, or 1
// (unsupported) / 2 (corrupt) with a message.
int damc_jpeg_header(const uint8_t* data, size_t len, int* width, int* height, int* components, char* msg,
                     size_t msglen) {
  try {
    Jpeg j(data, len);
    j.parse(true);
    if (!j.have_frame) corrupt("no frame header");
    *width = j.width;
    *height = j.height;
    *components = j.ncomp;
    return OK;
  } catch (const Failure& f) {
    put_message(msg, msglen, f.msg);
    return f.status;
  } catch (const std::bad_alloc&) {
    put_message(msg, msglen, "out of memory");
    return CORRUPT;
  }
}

// Decodes n files, outs[i] (height, width, 3) uint8 each, over `threads`
// threads; status[i] and the message at msgs + i * msglen report each file.
void damc_jpeg_decode_batch(const uint8_t* const* datas, const size_t* lens, uint8_t* const* outs, int n,
                            int threads, int* status, char* msgs, size_t msglen) {
  std::atomic<int> next{0};
  auto work = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) {
      try {
        Jpeg j(datas[i], lens[i]);
        j.decode(outs[i]);
        status[i] = OK;
      } catch (const Failure& f) {
        status[i] = f.status;
        put_message(msgs + (size_t)i * msglen, msglen, f.msg);
      } catch (const std::bad_alloc&) {
        status[i] = CORRUPT;
        put_message(msgs + (size_t)i * msglen, msglen, "out of memory");
      }
    }
  };
  threads = std::max(1, std::min(threads, n));
  if (threads == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
}

}  // extern "C"
