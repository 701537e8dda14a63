// CCITT Group 3 and Group 4 fax codes as libtiff 4.7's tif_fax3.c decodes a
// TIFF strip or tile, so that the port's TIFF reader
// (damc_tpu_torch/data/tiff.py) gives PIL's pixels for compressions 2
// (modified Huffman, rows byte-aligned), 3 (T.4: 1-D, or 2-D where
// T4Options bit 0 is set; each row after an EOL), 4 (T.6) and 32771
// (modified Huffman, rows word-aligned); PIL hands every compressed TIFF to
// libtiff.
//
// The decode replays libtiff's: the code tables that mkg3states.c builds
// (lookups of 7, 12 and 13 bits, the stream read LSB first after each byte's
// bits are reversed), the runs of each row with CLEANUP_RUNS's repair of a
// row of the wrong length, _TIFFFax3fillruns's clamping (which the next row
// sees as its reference), and its faults: a bad code word ends its row and
// the decode goes on; the data ending before the last row is refused, but
// for Group 4 once a row has been decoded, where the rows after it are left
// as they stood in the caller's buffer; Group 3 data that ends before an
// EOL's final 1 is read again from the strip's start as data without EOLs
// (libtiff 4.7's "Try to decode fax Group 3 data without EOL").
//
// C interface (ctypes, damc_tpu_torch/data/fax.py):
//   damc_fax_decode(in, in_len, out, out_len, mode, width, row_bytes, &noeol)
// `mode` is kRle, kRleWord, kG3, kG3TwoD or kG4; `out` holds out_len / row_bytes
// rows and keeps what the decode does not write; `noeol` carries libtiff's
// FAXMODE_NOEOL from strip to strip of an image (0 at its start). Returns
// kOk, kFail or kOverflow (a row of more runs than libtiff's run arrays
// hold).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o libfax_decode.so fax_decode.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { kOk = 0, kFail = 1, kOverflow = 2 };
enum Mode { kRle = 0, kRleWord = 1, kG3 = 2, kG3TwoD = 3, kG4 = 4 };
enum State { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp,
             S_EOL };

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

struct Proto {
  const char* bits;  // the code as it stands in the stream, first bit first
  uint32_t param;
};

const Proto kPass[] = {{"0001", 0}, {nullptr, 0}};
const Proto kHoriz[] = {{"001", 0}, {nullptr, 0}};
const Proto kV0[] = {{"1", 0}, {nullptr, 0}};
const Proto kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}, {nullptr, 0}};
const Proto kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}, {nullptr, 0}};
const Proto kExt[] = {{"0000001", 0}, {nullptr, 0}};
const Proto kEOLV[] = {{"0000000", 0}, {nullptr, 0}};
const Proto kEOLH[] = {{"00000000000", 0}, {nullptr, 0}};
const Proto kMakeUp[] = {{"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
                         {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
                         {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
                         {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
                         {"000000011111", 2560}, {nullptr, 0}};
const Proto kMakeUpW[] = {{"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320},
                          {"00110111", 384}, {"01100100", 448}, {"01100101", 512}, {"01101000", 576},
                          {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
                          {"011010011", 896}, {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
                          {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
                          {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
                          {"011000", 1664}, {"010011011", 1728}, {nullptr, 0}};
const Proto kMakeUpB[] = {{"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192},
                          {"000001011011", 256}, {"000000110011", 320}, {"000000110100", 384},
                          {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
                          {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
                          {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
                          {"0000001110100", 1024}, {"0000001110101", 1088}, {"0000001110110", 1152},
                          {"0000001110111", 1216}, {"0000001010010", 1280}, {"0000001010011", 1344},
                          {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
                          {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728},
                          {nullptr, 0}};
const char* const kTermW[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",     "1110",     "1111",
    "10011",    "10100",    "00111",    "01000",    "001000",   "000011",   "110100",   "110101",
    "101010",   "101011",   "0100111",  "0001100",  "0001000",  "0010111",  "0000011",  "0000100",
    "0101000",  "0101011",  "0010011",  "0100100",  "0011000",  "00000010", "00000011", "00011010",
    "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111", "00101000",
    "00101001", "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* const kTermB[64] = {
    "0000110111",   "010",          "11",           "10",           "011",          "0011",
    "0010",         "00011",        "000101",       "000100",       "0000100",      "0000101",
    "0000111",      "00000100",     "00000111",     "000011000",    "0000010111",   "0000011000",
    "0000001000",   "00001100111",  "00001101000",  "00001101100",  "00000110111",  "00000101000",
    "00000010111",  "00000011000",  "000011001010", "000011001011", "000011001100", "000011001101",
    "000001101000", "000001101001", "000001101010", "000001101011", "000011010010", "000011010011",
    "000011010100", "000011010101", "000011010110", "000011010111", "000001101100", "000001101101",
    "000011011010", "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100", "000000110111",
    "000000111000", "000000100111", "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};

// mkg3states.c FillTable: every `size`-bit lookup whose low bits (the
// stream's first bits) are the code takes the code's entry; later fills win.
void fill(std::vector<TabEnt>& t, int size, const char* bits, uint32_t param, int state) {
  const int width = (int)strlen(bits);
  uint32_t code = 0;
  for (int k = 0; k < width; ++k) code |= (uint32_t)(bits[k] - '0') << k;
  for (uint32_t v = code; v < (1u << size); v += 1u << width) t[v] = TabEnt{(uint8_t)state, (uint8_t)width, param};
}
void fill(std::vector<TabEnt>& t, int size, const Proto* p, int state) {
  for (; p->bits; ++p) fill(t, size, p->bits, p->param, state);
}

struct Tables {
  std::vector<TabEnt> main, white, black;
  uint8_t rev[256];
  Tables() : main(128), white(4096), black(8192) {
    fill(main, 7, kPass, S_Pass);
    fill(main, 7, kHoriz, S_Horiz);
    fill(main, 7, kV0, S_V0);
    fill(main, 7, kVR, S_VR);
    fill(main, 7, kVL, S_VL);
    fill(main, 7, kExt, S_Ext);
    fill(main, 7, kEOLV, S_EOL);
    fill(white, 12, kMakeUpW, S_MakeUpW);
    fill(white, 12, kMakeUp, S_MakeUp);
    for (int r = 0; r < 64; ++r) fill(white, 12, kTermW[r], (uint32_t)r, S_TermW);
    fill(white, 12, kEOLH, S_EOL);
    fill(black, 13, kMakeUpB, S_MakeUpB);
    fill(black, 13, kMakeUp, S_MakeUp);
    for (int r = 0; r < 64; ++r) fill(black, 13, kTermB[r], (uint32_t)r, S_TermB);
    fill(black, 13, kEOLH, S_EOL);
    for (int v = 0; v < 256; ++v) {
      int r = 0;
      for (int k = 0; k < 8; ++k) r |= ((v >> k) & 1) << (7 - k);
      rev[v] = (uint8_t)r;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run past
// the row is cut to it, in the run array too.
void fillruns(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (colour) *cp++ |= (uint8_t)(0xff >> bx);
          else *cp++ &= (uint8_t)(0xff << (8 - bx));
          run -= 8 - bx;
        }
        uint32_t n = run >> 3;
        if (n) {
          memset(cp, colour ? 0xff : 0x00, n);
          cp += n;
          run &= 7;
        }
        if (run) {
          if (colour) cp[0] = (uint8_t)((cp[0] | (0xff00 >> run)) & 0xff);
          else cp[0] &= (uint8_t)(0xff >> run);
        }
      } else {
        if (colour) cp[0] |= (uint8_t)(masks[run] >> bx);
        else cp[0] &= (uint8_t)~(masks[run] >> bx);
      }
      x += runs[colour];
    }
  }
}

struct Overflow {};

struct Decoder {
  const Tables& T = tables();
  const uint8_t* cp;
  const uint8_t* ep;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  int a0 = 0, RunLength = 0;
  int lastx;
  uint32_t nruns;
  std::vector<uint32_t> runs;
  uint32_t *curruns, *refruns = nullptr;
  uint32_t *pa = nullptr, *thisrun = nullptr, *pb = nullptr;
  int b1 = 0;
  const TabEnt* TabEnt_ = nullptr;

  Decoder(const uint8_t* in, int64_t len, int width, bool two_d) : cp(in), ep(in + len), lastx(width) {
    // Fax3SetupState: run arrays of rowpixels + 1 rounded up to 32, twice that with a reference line.
    nruns = (uint32_t)(((int64_t)width + 1 + 31) / 32 * 32);
    if (two_d) nruns *= 2;
    runs.assign((size_t)nruns * 2, 0);
    curruns = runs.data();
    if (two_d) {
      refruns = runs.data() + nruns;
      refruns[0] = (uint32_t)width;
      refruns[1] = 0;
    }
  }

  bool end() const { return cp >= ep; }
  // NeedBits8 / NeedBits16: false where the data has ended with no valid bits.
  bool need8(int n) {
    if (BitsAvail < n) {
      if (end()) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;
      } else {
        BitAcc |= (uint32_t)T.rev[*cp++] << BitsAvail;
        BitsAvail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (BitsAvail < n) {
      if (end()) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;
      } else {
        BitAcc |= (uint32_t)T.rev[*cp++] << BitsAvail;
        if ((BitsAvail += 8) < n) {
          if (end()) {
            BitsAvail = n;
          } else {
            BitAcc |= (uint32_t)T.rev[*cp++] << BitsAvail;
            BitsAvail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return BitAcc & ((1u << n) - 1); }
  void clr(int n) {
    BitsAvail -= n;
    BitAcc >>= n;
  }
  const TabEnt* lookup(const std::vector<TabEnt>& tab, int wid, bool sixteen, bool& eof) {
    if (!(sixteen ? need16(wid) : need8(wid))) {
      eof = true;
      return nullptr;
    }
    const TabEnt* e = &tab[get(wid)];
    clr(e->width);
    return e;
  }

  void setvalue(uint32_t x) {
    if (pa >= thisrun + nruns) throw Overflow();
    *pa++ = (uint32_t)RunLength + x;
    a0 += (int)x;
    RunLength = 0;
  }

  void cleanup_runs() {
    if (RunLength) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= (int)*--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue((uint32_t)(lastx - a0));
      } else if (a0 > lastx) {
        setvalue((uint32_t)lastx);
        setvalue(0);
      }
    }
  }

  // SYNC_EOL: find the EOL (11 zeros, unless one was just read), skip fill
  // bits, consume the 1. kSynced, kEof where the data ends in the search
  // for the zeros, kNoEol where it ends before the EOL's 1 (libtiff 4.7
  // then takes the data for Group 3 without EOLs).
  enum Sync { kSynced, kEof, kNoEol };
  Sync sync_eol() {
    if (EOLcnt == 0) {
      for (;;) {
        if (!need16(11)) return kEof;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return kNoEol;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    EOLcnt = 0;
    return kSynced;
  }

  // EXPAND1D: false at the end of the data (the row's runs cleaned up).
  bool expand1d() {
    bool eof = false;
    for (;;) {
      for (;;) {
        const TabEnt* e = lookup(T.white, 12, true, eof);
        if (eof) goto eof1d;
        switch (e->state) {
          case S_EOL: EOLcnt = 1; goto done1d;
          case S_TermW: setvalue(e->param); goto doneWhite;
          case S_MakeUpW: case S_MakeUp: a0 += (int)e->param; RunLength += (int)e->param; break;
          default: goto done1d;  // unexpected("WhiteTable")
        }
      }
    doneWhite:
      if (a0 >= lastx) goto done1d;
      for (;;) {
        const TabEnt* e = lookup(T.black, 13, true, eof);
        if (eof) goto eof1d;
        switch (e->state) {
          case S_EOL: EOLcnt = 1; goto done1d;
          case S_TermB: setvalue(e->param); goto doneBlack;
          case S_MakeUpB: case S_MakeUp: a0 += (int)e->param; RunLength += (int)e->param; break;
          default: goto done1d;  // unexpected("BlackTable")
        }
      }
    doneBlack:
      if (a0 >= lastx) goto done1d;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  eof1d:
    cleanup_runs();
    return false;
  done1d:
    cleanup_runs();
    return true;
  }

  void check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) throw Overflow();
        b1 += (int)(pb[0] + pb[1]);
        pb += 2;
      }
  }

  // One run of colour `black` in horizontal mode; false on a bad code
  // (-1) or the end of data (0 via eof).
  int horiz_run(bool black, bool& eof) {
    for (;;) {
      const TabEnt* e = black ? lookup(T.black, 13, true, eof) : lookup(T.white, 12, true, eof);
      if (eof) return 0;
      if (e->state == (black ? S_TermB : S_TermW)) {
        setvalue(e->param);
        return 1;
      }
      if (e->state == (black ? S_MakeUpB : S_MakeUpW) || e->state == S_MakeUp) {
        a0 += (int)e->param;
        RunLength += (int)e->param;
        continue;
      }
      return -1;
    }
  }

  // EXPAND2D: false at the end of the data (the row's runs cleaned up).
  bool expand2d() {
    bool eof = false;
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) throw Overflow();
      const TabEnt* e = lookup(T.main, 7, false, eof);
      if (eof) goto eof2d;
      switch (e->state) {
        case S_Pass:
          check_b1();
          if (pb >= refruns + nruns) throw Overflow();
          b1 += (int)*pb++;
          RunLength += b1 - a0;
          a0 = b1;
          b1 += (int)*pb++;
          break;
        case S_Horiz: {
          const bool black_first = (pa - thisrun) & 1;
          int r = horiz_run(black_first, eof);
          if (eof) goto eof2d;
          if (r < 0) goto eol2d;  // unexpected(black_first ? "BlackTable" : "WhiteTable")
          r = horiz_run(!black_first, eof);
          if (eof) goto eof2d;
          if (r < 0) goto eol2d;
          check_b1();
          break;
        }
        case S_V0:
          check_b1();
          setvalue((uint32_t)(b1 - a0));
          if (pb >= refruns + nruns) throw Overflow();
          b1 += (int)*pb++;
          break;
        case S_VR:
          check_b1();
          setvalue((uint32_t)(b1 - a0 + (int)e->param));
          if (pb >= refruns + nruns) throw Overflow();
          b1 += (int)*pb++;
          break;
        case S_VL:
          check_b1();
          if (b1 < (int)(a0 + (int)e->param)) goto eol2d;  // unexpected("VL")
          setvalue((uint32_t)(b1 - a0 - (int)e->param));
          b1 -= (int)*--pb;
          break;
        case S_Ext:
          *pa++ = (uint32_t)(lastx - a0);
          goto eol2d;
        case S_EOL:
          *pa++ = (uint32_t)(lastx - a0);
          if (!need8(4)) goto eof2d;
          clr(4);
          EOLcnt = 1;
          goto eol2d;
        default:
          goto eol2d;  // unexpected("MainTable")
      }
    }
    if (RunLength) {
      if (RunLength + a0 < lastx) {  // a final V0 is expected
        if (!need8(1)) goto eof2d;
        if (!get(1)) goto eol2d;  // badMain2d
        clr(1);
      }
      setvalue(0);
    }
  eol2d:
    cleanup_runs();
    return true;
  eof2d:
    cleanup_runs();
    return false;
  }

  // `noeol`: the codec's FAXMODE_NOEOL, which a Group 3 strip whose data ends
  // before an EOL's 1 sets for the rest of the image: the strip is then
  // decoded again from its start for the rows still to fill, without EOLs.
  int decode(uint8_t* buf, int64_t occ, int mode, int64_t rowbytes, bool& noeol) {
    if (rowbytes <= 0 || occ % rowbytes) return kFail;  // "Fractional scanlines cannot be read"
    const uint8_t* start = cp;
    int64_t line = 0;
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      if (mode == kRle || mode == kRleWord) {
        bool ok = expand1d();
        fillruns(buf, thisrun, pa, (uint32_t)lastx);
        if (!ok) return kFail;
        if (mode == kRle) {
          clr(BitsAvail - (BitsAvail & ~7));
        } else {
          clr(BitsAvail - (BitsAvail & ~15));
          if (BitsAvail == 0 && ((cp - start) & 1)) cp++;  // isAligned(cp, uint16_t), the strip read whole
        }
      } else if (mode == kG3) {
        const Sync sync = noeol ? kSynced : sync_eol();
        if (sync == kNoEol) {
          noeol = true;
          cp = start;
          BitAcc = 0;
          BitsAvail = 0;
          EOLcnt = 0;
          continue;
        }
        if (sync == kEof) {
          cleanup_runs();
          fillruns(buf, thisrun, pa, (uint32_t)lastx);
          return kFail;
        }
        bool ok = expand1d();
        fillruns(buf, thisrun, pa, (uint32_t)lastx);
        if (!ok) return kFail;
      } else if (mode == kG3TwoD) {
        const Sync sync = noeol ? kSynced : sync_eol();
        if (sync == kNoEol) {
          noeol = true;
          cp = start;
          BitAcc = 0;
          BitsAvail = 0;
          EOLcnt = 0;
          continue;
        }
        if (sync == kEof || !need8(1)) {
          cleanup_runs();
          fillruns(buf, thisrun, pa, (uint32_t)lastx);
          return kFail;
        }
        const bool is1d = get(1);
        clr(1);
        pb = refruns;
        b1 = (int)*pb++;
        bool ok = is1d ? expand1d() : expand2d();
        fillruns(buf, thisrun, pa, (uint32_t)lastx);
        if (!ok) return kFail;
        if (pa < thisrun + nruns) setvalue(0);  // an imaginary change for the reference
        std::swap(curruns, refruns);
      } else {  // kG4
        pb = refruns;
        b1 = (int)*pb++;
        bool ok = expand2d();
        if (!ok || EOLcnt) {  // EOFG4: skip the EOFB, keep this row, stop
          if (need16(13)) {
          }
          clr(13);
          if ((lastx + 7) >> 3 > occ) return kFail;
          fillruns(buf, thisrun, pa, (uint32_t)lastx);
          return line ? kOk : kFail;
        }
        if ((lastx + 7) >> 3 > occ) return kFail;
        fillruns(buf, thisrun, pa, (uint32_t)lastx);
        setvalue(0);
        std::swap(curruns, refruns);
      }
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
    }
    return kOk;
  }
};

}  // namespace

extern "C" {

// One strip or tile of CCITT data into out[0, out_len), rows of `width`
// pixels `row_bytes` apart. Returns kOk, kFail or kOverflow.
int damc_fax_decode(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len, int mode, int width,
                    int64_t row_bytes, int* noeol) {
  if (width <= 0 || row_bytes < ((int64_t)width + 7) / 8) return kFail;
  try {
    Decoder d(in, in_len, width, mode == kG3TwoD || mode == kG4);
    bool flag = *noeol != 0;
    const int status = d.decode(out, out_len, mode, row_bytes, flag);
    *noeol = flag;
    return status;
  } catch (const Overflow&) {
    return kOverflow;
  } catch (const std::bad_alloc&) {
    return kFail;
  }
}

}  // extern "C"
