// Zstandard (RFC 8878) as libtiff 4.7's tif_zstd.c ZSTDDecode reads a TIFF
// strip or tile through libzstd, so that the port's TIFF reader
// (damc_tpu_torch/data/tiff.py) gives PIL's pixels for compression 50000;
// PIL hands every compressed TIFF to libtiff.
//
// The decoder follows the RFC: frames (a skippable one ends the strip), raw, RLE
// and compressed blocks, literals raw, RLE, Huffman-coded in one or four
// streams or with the previous block's table, sequences whose literal
// length, match length and offset codes are FSE-coded under predefined,
// RLE, transmitted or repeated tables, and the repeat offsets. It refuses
// what libzstd refuses: reserved bits and block types, a dictionary ID, a
// window past 2^27 bytes, blocks past their maximum size, tables that do
// not sum or are too deep, bit streams not consumed exactly, offsets
// before the frame's start, literals overrun, a frame whose content size
// or checksum (XXH64) disagrees. libtiff stops at the end of the first
// frame or when the strip is full; libzstd decodes one block (or the
// checksum) past the one that fills it, and a fault there is a fault.
//
// C interface (ctypes, damc_tpu_torch/data/zstd.py):
//   damc_zstd_decode(in, in_len, out, out_len) -> 0 (the strip is full),
//   1 (corrupt data) or 2 (the data ends first)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o libzstd_decode.so zstd_decode.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kShort = 2 };
struct Corrupt {};
[[noreturn]] void corrupt() { throw Corrupt(); }

const size_t kBlockMax = 128 * 1024;

// ---------------------------------------------------------------------------
// XXH64 (seed 0): the content checksum
// ---------------------------------------------------------------------------

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
               P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t round64(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t merge64(uint64_t acc, uint64_t v) { return (acc ^ round64(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round64(v1, rd64(p));
      v2 = round64(v2, rd64(p + 8));
      v3 = round64(v3, rd64(p + 16));
      v4 = round64(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= round64(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Bit streams
// ---------------------------------------------------------------------------

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// A backward bit stream (FSE and Huffman): read from the last byte, whose
// highest set bit marks the start, toward the first; bits past the start
// read as zero and count as consumed.
struct BackBits {
  const uint8_t* d;
  int64_t total;  // bits in the stream
  int64_t used = 0;
  BackBits(const uint8_t* data, size_t len) : d(data) {
    if (len == 0 || data[len - 1] == 0) corrupt();
    total = (int64_t)len * 8 - (8 - highbit(data[len - 1]));
  }
  inline int bit_at(int64_t k) const {  // k-th bit read, 0 first
    int64_t pos = total - 1 - k;
    if (pos < 0) return 0;
    return (d[pos >> 3] >> (pos & 7)) & 1;
  }
  uint32_t peek(int n) const {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | (uint32_t)bit_at(used + i);
    return v;
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    used += n;
    return v;
  }
  bool overflow() const { return used > total; }
  bool done() const { return used == total; }
};

// ---------------------------------------------------------------------------
// FSE tables
// ---------------------------------------------------------------------------

struct FseCell {
  uint16_t symbol = 0;
  uint8_t bits = 0;
  uint16_t base = 0;
};
struct Fse {
  int log = 0;
  std::vector<FseCell> cells;
};

void build_fse(Fse& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.cells.assign(size, FseCell());
  std::vector<uint16_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.cells[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].symbol = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) corrupt();
  for (int u = 0; u < size; ++u) {
    FseCell& c = t.cells[u];
    const uint32_t ns = next[c.symbol]++;
    c.bits = (uint8_t)(log - highbit(ns));
    c.base = (uint16_t)((ns << c.bits) - size);
  }
}

// libzstd's FSE_readNCount: the normalized counts at the head of `p`;
// returns the bytes read.
size_t read_ncount(int16_t* norm, int& nsym, int& log, int max_symbol, int max_log, const uint8_t* p, size_t n) {
  std::vector<uint8_t> buf(p, p + n);
  buf.resize(n + 16, 0);
  uint64_t bitpos = 0;
  auto peek32 = [&]() {
    uint64_t byte = bitpos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) v |= (uint64_t)(byte + i < buf.size() ? buf[byte + i] : 0) << (8 * i);
    return (uint32_t)(v >> (bitpos & 7));
  };
  if (n == 0) corrupt();
  uint32_t bits = peek32();
  int nb = (int)(bits & 0xF) + 5;
  if (nb > max_log) corrupt();
  log = nb;
  bitpos += 4;
  int remaining = (1 << nb) + 1, threshold = 1 << nb;
  nb++;
  int charnum = 0;
  bool previous0 = false;
  for (int i = 0; i <= max_symbol; ++i) norm[i] = 0;
  for (;;) {
    if (previous0) {
      for (;;) {
        uint32_t b = peek32() & 3;
        bitpos += 2;
        charnum += (int)b;
        if (b != 3) break;
      }
      if (charnum > max_symbol) break;
    }
    uint32_t bs = peek32();
    const int maxv = (2 * threshold - 1) - remaining;
    int count;
    if ((int)(bs & (threshold - 1)) < maxv) {
      count = (int)(bs & (threshold - 1));
      bitpos += nb - 1;
    } else {
      count = (int)(bs & (2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      bitpos += nb;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[charnum++] = (int16_t)count;
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = highbit((uint32_t)remaining) + 1;
      threshold = 1 << (nb - 1);
    }
    if (charnum > max_symbol) break;
  }
  if (remaining != 1) corrupt();
  if (charnum > max_symbol + 1) corrupt();
  nsym = charnum;
  size_t used = (bitpos + 7) >> 3;
  if (used > n) corrupt();
  return used;
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct Huffman {
  int log = 0;
  std::vector<uint8_t> symbol, bits;  // indexed by the next `log` bits
};

size_t read_huffman(Huffman& h, const uint8_t* p, size_t n) {
  if (n < 1) corrupt();
  uint8_t w[256] = {};
  int nw = 0;
  size_t used;
  const int head = p[0];
  if (head >= 128) {
    nw = head - 127;
    used = 1 + (size_t)(nw + 1) / 2;
    if (used > n) corrupt();
    for (int i = 0; i < nw; ++i) w[i] = (uint8_t)(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
  } else {
    used = 1 + (size_t)head;
    if (used > n || head == 0) corrupt();
    int16_t norm[256];
    int nsym, log;
    size_t hdr = read_ncount(norm, nsym, log, 255, 6, p + 1, head);
    Fse t;
    build_fse(t, norm, nsym, log);
    BackBits bs(p + 1 + hdr, head - hdr);
    uint32_t s1 = bs.read(log), s2 = bs.read(log);
    for (;;) {
      if (nw > 253) corrupt();
      const FseCell& c1 = t.cells[s1];
      w[nw++] = (uint8_t)c1.symbol;
      s1 = c1.base + bs.read(c1.bits);
      if (bs.overflow()) {
        w[nw++] = (uint8_t)t.cells[s2].symbol;
        break;
      }
      if (nw > 253) corrupt();
      const FseCell& c2 = t.cells[s2];
      w[nw++] = (uint8_t)c2.symbol;
      s2 = c2.base + bs.read(c2.bits);
      if (bs.overflow()) {
        w[nw++] = (uint8_t)t.cells[s1].symbol;
        break;
      }
    }
  }
  uint32_t rank[13] = {}, total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 12) corrupt();
    rank[w[i]]++;
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) corrupt();
  const int log = highbit(total) + 1;
  if (log > 12) corrupt();
  const uint32_t rest = (1u << log) - total;
  if (rest != (1u << highbit(rest))) corrupt();
  const int last = highbit(rest) + 1;
  w[nw++] = (uint8_t)last;
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) corrupt();
  h.log = log;
  h.symbol.assign((size_t)1 << log, 0);
  h.bits.assign((size_t)1 << log, 0);
  uint32_t start[14] = {};
  for (int k = 1, next = 0; k <= log; ++k) {
    start[k] = (uint32_t)next;
    next += (int)(rank[k] << (k - 1));
  }
  for (int s = 0; s < nw; ++s) {
    if (!w[s]) continue;
    const uint32_t len = (1u << w[s]) >> 1;
    for (uint32_t u = start[w[s]]; u < start[w[s]] + len; ++u) {
      h.symbol[u] = (uint8_t)s;
      h.bits[u] = (uint8_t)(log + 1 - w[s]);
    }
    start[w[s]] += len;
  }
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits bs(p, n);
  for (size_t i = 0; i < count; ++i) {
    const uint32_t v = bs.peek(h.log);
    out[i] = h.symbol[v];
    bs.used += h.bits[v];
  }
  if (!bs.done()) corrupt();
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,   17,    18,    19,    20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,   33,   34,   35,    37,    39,    41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  const uint8_t* in;
  size_t len, pos = 0;
  std::vector<uint8_t> out;  // the frame's content so far
  size_t committed = 0;      // of which whole blocks (what libzstd has flushed)
  size_t want;               // bytes the strip takes
  size_t block_max = kBlockMax;
  Huffman huf;
  bool have_huf = false;
  Fse ll, of, ml;
  bool have_seq_tables = false;
  uint64_t rep[3] = {1, 4, 8};

  Frame(const uint8_t* data, size_t n, size_t want_) : in(data), len(n), want(want_) {}

  size_t literals(const uint8_t* p, size_t n, std::vector<uint8_t>& lit) {
    if (n < 1) corrupt();
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {
      size_t size, hs;
      if ((sf & 1) == 0) {
        size = p[0] >> 3;
        hs = 1;
      } else if (sf == 1) {
        if (n < 2) corrupt();
        size = (p[0] >> 4) + ((size_t)p[1] << 4);
        hs = 2;
      } else {
        if (n < 3) corrupt();
        size = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
        hs = 3;
      }
      if (size > block_max) corrupt();
      if (type == 0) {
        if (hs + size > n) corrupt();
        lit.assign(p + hs, p + hs + size);
        return hs + size;
      }
      if (hs + 1 > n) corrupt();
      lit.assign(size, p[hs]);
      return hs + 1;
    }
    size_t size, csize, hs;
    bool single = false;
    if (n < 3) corrupt();
    if (sf < 2) {
      single = sf == 0;
      hs = 3;
      const uint32_t v = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16);
      size = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      if (n < 4) corrupt();
      hs = 4;
      const uint32_t v = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
      size = (v >> 4) & 0x3FFF;
      csize = v >> 18;
    } else {
      if (n < 5) corrupt();
      hs = 5;
      const uint64_t v = p[0] | (p[1] << 8) | ((uint64_t)p[2] << 16) | ((uint64_t)p[3] << 24) | ((uint64_t)p[4] << 32);
      size = (v >> 4) & 0x3FFFF;
      csize = (size_t)(v >> 22);
    }
    if (size > block_max) corrupt();
    if (!single && size < 6) corrupt();
    if (csize + hs > n) corrupt();
    const uint8_t* q = p + hs;
    size_t qn = csize;
    if (type == 2) {
      size_t t = read_huffman(huf, q, qn);
      have_huf = true;
      q += t;
      qn -= t;
    } else if (!have_huf) {
      corrupt();
    }
    lit.assign(size, 0);
    if (single) {
      huffman_stream(huf, q, qn, lit.data(), size);
    } else {
      if (qn < 10) corrupt();
      const size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8), s3 = q[4] | (q[5] << 8);
      if (s1 + s2 + s3 + 6 > qn) corrupt();
      const size_t s4 = qn - 6 - s1 - s2 - s3;
      const size_t seg = (size + 3) / 4;
      if (3 * seg > size) corrupt();
      const uint8_t* d = q + 6;
      huffman_stream(huf, d, s1, lit.data(), seg);
      huffman_stream(huf, d + s1, s2, lit.data() + seg, seg);
      huffman_stream(huf, d + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huffman_stream(huf, d + s1 + s2 + s3, s4, lit.data() + 3 * seg, size - 3 * seg);
    }
    return hs + csize;
  }

  size_t seq_table(Fse& t, int mode, const int16_t* def, int def_log, int max_symbol, int max_log, const uint8_t* p,
                   size_t n) {
    if (mode == 0) {
      build_fse(t, def, max_symbol + 1, def_log);
      return 0;
    }
    if (mode == 1) {
      if (n < 1) corrupt();
      if (p[0] > max_symbol) corrupt();
      t.log = 0;
      t.cells.assign(1, FseCell{p[0], 0, 0});
      return 1;
    }
    if (mode == 2) {
      int16_t norm[64];
      int nsym, log;
      size_t used = read_ncount(norm, nsym, log, max_symbol, max_log, p, n);
      build_fse(t, norm, nsym, log);
      return used;
    }
    if (!have_seq_tables) corrupt();
    return 0;
  }

  void block(const uint8_t* p, size_t n) {
    std::vector<uint8_t> lit;
    size_t k = literals(p, n, lit);
    p += k;
    n -= k;
    if (n < 1) corrupt();
    size_t nseq = p[0];
    size_t h = 1;
    if (nseq == 0) {
      if (n != 1) corrupt();
      out.insert(out.end(), lit.begin(), lit.end());
      return;
    }
    if (nseq >= 128) {
      if (nseq == 255) {
        if (n < 3) corrupt();
        nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
        h = 3;
      } else {
        if (n < 2) corrupt();
        nseq = ((nseq - 128) << 8) + p[1];
        h = 2;
      }
    }
    if (h + 1 > n) corrupt();
    const int modes = p[h];
    if (modes & 3) corrupt();
    h++;
    h += seq_table(ll, modes >> 6, kLLDefault, 6, 35, 9, p + h, n - h);
    h += seq_table(of, (modes >> 4) & 3, kOFDefault, 5, 31, 8, p + h, n - h);
    h += seq_table(ml, (modes >> 2) & 3, kMLDefault, 6, 52, 9, p + h, n - h);
    if (h > n) corrupt();
    have_seq_tables = true;
    BackBits bs(p + h, n - h);
    uint32_t sll = bs.read(ll.log), sof = bs.read(of.log), sml = bs.read(ml.log);
    const size_t block_start = out.size();
    size_t litpos = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const FseCell &cl = ll.cells[sll], &co = of.cells[sof], &cm = ml.cells[sml];
      const int ofcode = co.symbol;
      if (cl.symbol > 35 || cm.symbol > 52) corrupt();
      uint64_t offset;
      if (ofcode > 1) {
        offset = ((uint64_t)1 << ofcode) - 3 + bs.read(ofcode);
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const int ll0 = cl.symbol == 0;
        if (ofcode == 0) {
          offset = rep[ll0];
          rep[1] = rep[!ll0];
          rep[0] = offset;
        } else {
          const int idx = 1 + ll0 + (int)bs.read(1);
          uint64_t t = idx == 3 ? rep[0] - 1 : rep[idx];
          if (t == 0) t = ~(uint64_t)0;
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset = t;
        }
      }
      const uint64_t mlen = kMLBase[cm.symbol] + bs.read(kMLBits[cm.symbol]);
      const uint64_t llen = kLLBase[cl.symbol] + bs.read(kLLBits[cl.symbol]);
      if (i + 1 < nseq) {
        sll = cl.base + bs.read(cl.bits);
        sml = cm.base + bs.read(cm.bits);
        sof = co.base + bs.read(co.bits);
      }
      if (llen > lit.size() - litpos) corrupt();
      if (out.size() - block_start + llen + mlen > block_max) corrupt();
      out.insert(out.end(), lit.begin() + (long)litpos, lit.begin() + (long)(litpos + llen));
      litpos += llen;
      if (offset > out.size()) corrupt();
      size_t from = out.size() - (size_t)offset;
      for (uint64_t m = 0; m < mlen; ++m) out.push_back(out[from + m]);
    }
    if (!bs.done()) corrupt();
    if (out.size() - block_start + lit.size() - litpos > block_max) corrupt();
    out.insert(out.end(), lit.begin() + (long)litpos, lit.end());
  }

  // The frame at in[pos]: returns kOk once the strip is full or the frame
  // is whole, having decoded what libzstd decodes before it stops.
  int decode() {
    bool full = false;  // past the strip's end: running out of data is no fault
    auto need = [&](size_t k) {
      if (pos + k > len) throw Status(full ? kOk : kShort);
    };
    need(5);
    const int fhd = in[pos + 4];
    pos += 5;
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
    if (fhd & 8) corrupt();
    uint64_t window = 0;
    if (!single) {
      const int wd = in[pos++];
      const int exponent = wd >> 3, mantissa = wd & 7;
      const uint64_t base = (uint64_t)1 << (10 + exponent);
      window = base + (base / 8) * mantissa;
    }
    const int dict_bytes = (int[]){0, 1, 2, 4}[dict_flag];
    const int fcs_bytes = (int[]){single ? 1 : 0, 2, 4, 8}[fcs_flag];
    need((size_t)dict_bytes + fcs_bytes);
    uint64_t dict = 0, fcs = ~(uint64_t)0;
    for (int i = 0; i < dict_bytes; ++i) dict |= (uint64_t)in[pos++] << (8 * i);
    if (fcs_bytes) {
      fcs = 0;
      for (int i = 0; i < fcs_bytes; ++i) fcs |= (uint64_t)in[pos++] << (8 * i);
      if (fcs_bytes == 2) fcs += 256;
    }
    if (dict) corrupt();
    if (single) window = fcs;
    if (window > ((uint64_t)1 << 27) + 1) corrupt();
    block_max = (size_t)(window < kBlockMax ? window : kBlockMax);
    for (;;) {
      need(3);
      const uint32_t bh = in[pos] | (in[pos + 1] << 8) | ((uint32_t)in[pos + 2] << 16);
      pos += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) corrupt();
      if (size > block_max) corrupt();
      const size_t csize = type == 1 ? 1 : size;
      if (type == 0 && pos + size > len) {  // libzstd streams a raw block out as its bytes arrive
        out.insert(out.end(), in + pos, in + len);
        committed = out.size();
        pos = len;
        throw Status(out.size() >= want ? kOk : kShort);
      }
      need(csize);
      if (type == 0) {
        out.insert(out.end(), in + pos, in + pos + size);
      } else if (type == 1) {
        out.insert(out.end(), size, in[pos]);
      } else {
        block(in + pos, size);
      }
      pos += csize;
      if (fcs != ~(uint64_t)0 && out.size() > fcs) corrupt();
      committed = out.size();
      if (last) {
        if (fcs != ~(uint64_t)0 && out.size() != fcs) corrupt();
        if (checksum) {
          if (pos + 4 > len) return kOk;  // libzstd waits for the checksum; the strip is what it is
          const uint32_t want32 = rd32(in + pos);
          if ((uint32_t)xxh64(out.data(), out.size()) != want32) corrupt();
          pos += 4;
        }
        return kOk;
      }
      if (full) return kOk;
      if (out.size() >= want) full = true;  // one more block is decoded past the full strip
    }
  }
};

}  // namespace

extern "C" {

// One TIFF Zstandard strip or tile into out[0, out_len): kOk, kCorrupt or
// kShort (the data or the first frame ends before the strip is full). The
// output is written as far as the decode got.
int damc_zstd_decode(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  const size_t len = (size_t)in_len, want = (size_t)out_len;
  if (len < 4) return kShort;
  const uint32_t magic = rd32(in);
  // A skippable frame: libzstd's ZSTD_decompressStream returns 0 at its
  // end, as at a frame's, and libtiff stops there with the strip empty.
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return kShort;
  if (magic != 0xFD2FB528u) return kCorrupt;
  Frame f(in, len, want);
  int st;
  try {
    st = f.decode();
  } catch (Status s) {
    st = s == kOk && f.out.size() < want ? kShort : s;
  } catch (const Corrupt&) {
    st = kCorrupt;
  } catch (const std::bad_alloc&) {
    return kCorrupt;
  }
  // What libzstd flushed: whole blocks where the frame failed, else all.
  const size_t have = st == kOk ? f.out.size() : f.committed;
  const size_t k = have < want ? have : want;
  if (k) memcpy(out, f.out.data(), k);
  if (st == kOk && k < want) return kShort;
  return st;
}

}  // extern "C"
