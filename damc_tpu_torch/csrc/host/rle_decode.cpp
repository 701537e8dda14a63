// The byte-serial decoders of TGA, PCX, SGI, ICNS and QOI, decoded as PIL's
// readers decode them, so that the port's readers (damc_tpu_torch/data/
// tga.py, pcx.py, sgi.py, icns.py, qoi.py) give PIL's pixels on whole files
// and PIL's refusals on corrupt ones. Each loop carries a state from byte to
// byte that numpy cannot vectorise:
//
//   * TGA's run-length packets as Pillow's libImaging/TgaRleDecode.c reads
//     them: a run may not cross the end of a row (buffer overrun), a
//     literal may; a packet is taken only when all of it is in the file; a
//     pixel of under 8 bits takes no bytes, so such a file never ends.
//   * PCX's runs as libImaging/PcxDecode.c reads them: a run past the end of
//     a row is an overrun (the decode goes on, the error is reported at the
//     end); a full row's planes are moved together where PcxDecode.c's
//     memmove moves them (1-bit planes to (width + 7) / 8 bytes apart, 8-bit
//     planes to the width apart when the row's bytes over its whole planes
//     leave a wider stride).
//   * SGI's per-row, per-channel runs as libImaging/SgiRleDecode.c reads
//     them: offset and length tables after the 512-byte header, rows
//     expanded into one interleaved row buffer that is kept from row to row,
//     a row whose chunk count runs out on a non-zero chunk ending the image
//     early without an error.
//   * ICNS's packed 24-bit channels as IcnsImagePlugin.read_32 reads them
//     (runs of byte - 125, literals of byte + 1, one channel after another).
//   * QOI's op stream as QoiImagePlugin.QoiDecoder reads it.
//
// C interface (ctypes, damc_tpu_torch/data/rle.py):
//   damc_tga_rle(in, in_len, depth, row_bytes, rows, out)
//   damc_pcx_rle(in, in_len, row_bytes, xsize, bits, rows, out)
//   damc_sgi_rle(in, in_len, bpc, xsize, ysize, bands, out, rows_done)
//   damc_icns_rle(in, in_len, sizesq, out)
//   damc_qoi_decode(in, in_len, pixels, out)
// Each returns 0, or one of the failure codes below; the output is written
// as far as the decode got. ctypes releases the interpreter lock around each
// call.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o librle_decode.so rle_decode.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Status { OK = 0, TRUNCATED = 1, OVERRUN = 2, BROKEN = 3 };

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

extern "C" {

// TGA run-length data from in[0, in_len) into `rows` rows of `row_bytes`
// bytes, in the order the file holds them. `depth` is the bytes a pixel
// (PIL's depth // 8: 0 for 1-bit files, which never complete).
int damc_tga_rle(const uint8_t* in, int64_t in_len, int depth, int64_t row_bytes, int64_t rows, uint8_t* out) {
  int64_t pos = 0, x = 0, y = 0;
  if (rows <= 0) return OK;
  while (true) {
    if (in_len - pos < 1) return TRUNCATED;
    int64_t n = int64_t(depth) * ((in[pos] & 0x7f) + 1);
    int64_t extra = 0;
    const uint8_t* lit = nullptr;
    if (in[pos] & 0x80) {
      if (in_len - pos < 1 + depth) return TRUNCATED;
      if (x + n > row_bytes) return OVERRUN;
      uint8_t* dst = out + y * row_bytes + x;
      if (depth == 1) {
        std::memset(dst, in[pos + 1], size_t(n));
      } else {
        for (int64_t i = 0; i < n; i += depth) std::memcpy(dst + i, in + pos + 1, size_t(depth));
      }
      pos += 1 + depth;
    } else {
      if (in_len - pos < 1 + n) return TRUNCATED;
      lit = in + pos + 1;
      if (x + n > row_bytes) {
        extra = n - (row_bytes - x);
        n = row_bytes - x;
      }
      std::memcpy(out + y * row_bytes + x, lit, size_t(n));
      lit += n;
      pos += 1 + n + extra;
    }
    while (true) {
      x += n;
      if (x >= row_bytes) {
        x = 0;
        if (++y >= rows) return OK;
      }
      if (extra == 0) break;
      n = extra < row_bytes ? extra : row_bytes;
      std::memcpy(out + y * row_bytes + x, lit, size_t(n));
      lit += n;
      extra -= n;
    }
  }
}

// PCX run-length data into `rows` rows of `row_bytes` bytes (PIL's planes x
// stride), each row's planes moved as PcxDecode.c moves them; `xsize` is
// the width in pixels, `bits` the raw mode's bits a pixel (1, 2 and 4 for
// 1-bit images of 1, 2 and 4 planes, 8, 24).
int damc_pcx_rle(const uint8_t* in, int64_t in_len, int64_t row_bytes, int64_t xsize, int bits, int64_t rows,
                 uint8_t* out) {
  std::vector<uint8_t> buffer(size_t(row_bytes), 0);
  int64_t pos = 0, x = 0, y = 0;
  int status = OK;
  if (rows <= 0) return OK;
  while (true) {
    if (in_len - pos < 1) return TRUNCATED;
    if ((in[pos] & 0xC0) == 0xC0) {
      if (in_len - pos < 2) return TRUNCATED;
      int n = in[pos] & 0x3F;
      while (n > 0) {
        if (x >= row_bytes) {
          status = OVERRUN;
          break;
        }
        buffer[size_t(x++)] = in[pos + 1];
        n--;
      }
      pos += 2;
    } else {
      buffer[size_t(x++)] = in[pos++];
    }
    if (x >= row_bytes) {
      int64_t width = xsize, bands, stride = 0;
      if (bits == 2 || bits == 4) {
        width = (xsize + 7) / 8;
        bands = bits;
        stride = row_bytes / bits;
      } else {
        bands = row_bytes / xsize;
        if (bands != 0) stride = row_bytes / bands;
      }
      if (stride > width) {
        for (int64_t i = 1; i < bands; i++)
          std::memmove(buffer.data() + i * width, buffer.data() + i * stride, size_t(width));
      }
      std::memcpy(out + y * row_bytes, buffer.data(), size_t(row_bytes));
      x = 0;
      if (++y >= rows) return status;
    }
  }
}

}  // extern "C"

namespace {

// SgiRleDecode.c's expandrow (bpc 1) and expandrow2 (bpc 2): 0 at a
// row's end, n (1) when the chunk count runs out on a non-zero chunk, -1 on
// an overrun. `end` is the last byte of the file.
int expand_row(uint8_t* dest, const uint8_t* src, int64_t n, int z, int64_t xsize, const uint8_t* end) {
  int64_t x = 0;
  for (; n > 0; n--) {
    if (src > end) return -1;
    uint8_t pixel = *src++;
    if (n == 1 && pixel != 0) return int(n);
    uint8_t count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + count > end) return -1;
      while (count--) {
        *dest = *src++;
        dest += z;
      }
    } else {
      if (src > end) return -1;
      pixel = *src++;
      while (count--) {
        *dest = pixel;
        dest += z;
      }
    }
  }
  return 0;
}

int expand_row2(uint8_t* dest, const uint8_t* src, int64_t n, int z, int64_t xsize, const uint8_t* end) {
  int64_t x = 0;
  for (; n > 0; n--) {
    if (src + 1 > end) return -1;
    uint8_t pixel = src[1];
    src += 2;
    if (n == 1 && pixel != 0) return int(n);
    uint8_t count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + 2 * count > end) return -1;
      while (count--) {
        std::memcpy(dest, src, 2);
        src += 2;
        dest += z * 2;
      }
    } else {
      if (src + 2 > end) return -1;
      while (count--) {
        std::memcpy(dest, src, 2);
        dest += z * 2;
      }
      src += 2;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// SGI run-length data: in[0, in_len) is the file after its 512-byte header.
// Writes `ysize` rows of xsize * bands * bpc interleaved bytes in the order
// the decoder fills them (the file's first row first) and the number of
// rows it stored to rows_done (fewer when a row ends the image early).
int damc_sgi_rle(const uint8_t* in, int64_t in_len, int bpc, int64_t xsize, int64_t ysize, int bands, uint8_t* out,
                 int64_t* rows_done) {
  const int64_t kHeader = 512;
  *rows_done = 0;
  int64_t tablen = int64_t(bands) * ysize;
  if (in_len < 8 * tablen) return OVERRUN;
  if (in_len <= 0) return OVERRUN;
  int64_t row_bytes = xsize * bands * bpc;
  std::vector<uint8_t> buffer(size_t(row_bytes), 0);
  const uint8_t* end = in + in_len - 1;
  for (int64_t row = 0; row < ysize; row++) {
    for (int chan = 0; chan < bands; chan++) {
      int64_t k = row + chan * ysize;
      uint32_t offset = be32(in + 4 * k), length = be32(in + 4 * tablen + 4 * k);
      if (offset < kHeader) return OVERRUN;
      int64_t off = int64_t(offset) - kHeader;
      // The length counts chunks down as a C int (a length of 2^31 or more expands nothing) and is
      // not held to the file: a row ends at its zero chunk.
      int32_t n = int32_t(length);
      int status = 0;
      if (n > 0 && off >= in_len) {
        status = -1;  // expandrow's first test: the chunk lies past the file
      } else if (n > 0) {
        status = bpc == 1 ? expand_row(buffer.data() + chan, in + off, n, bands, xsize, end)
                          : expand_row2(buffer.data() + chan * 2, in + off, n, bands, xsize, end);
      }
      if (status == -1) return OVERRUN;
      if (status == 1) return OK;
    }
    std::memcpy(out + row * row_bytes, buffer.data(), size_t(row_bytes));
    *rows_done = row + 1;
  }
  return OK;
}

// The three packed channels of an ICNS is32/il32/ih32/it32 entry, read from
// in[0, in_len) (the entry's data to the end of the file) into out[0,
// 3 * sizesq), one channel after another. TRUNCATED: the file ended inside
// a channel's data; BROKEN: a channel's runs did not end on its last byte.
int damc_icns_rle(const uint8_t* in, int64_t in_len, int64_t sizesq, uint8_t* out) {
  int64_t pos = 0;
  int status = OK;
  for (int band = 0; band < 3; band++) {
    uint8_t* dst = out + band * sizesq;
    int64_t got = 0, left = sizesq;
    while (left > 0) {
      if (pos >= in_len) break;
      uint8_t b = in[pos++];
      int64_t block;
      if (b & 0x80) {
        block = int64_t(b) - 125;
        if (pos < in_len) {
          uint8_t v = in[pos++];
          int64_t k = block < left ? block : left;
          std::memset(dst + got, v, size_t(k));
          got += block;
        }
      } else {
        block = int64_t(b) + 1;
        int64_t avail = in_len - pos < block ? in_len - pos : block;
        int64_t k = avail < left ? avail : left;
        std::memcpy(dst + got, in + pos, size_t(k));
        pos += avail;
        got += avail;
      }
      left -= block;
    }
    if (left != 0) return BROKEN;
    if (got < sizesq) status = TRUNCATED;
  }
  return status;
}

// QOI's op stream in[0, in_len) (after the 14-byte header) into `pixels`
// RGB pixels (the alpha PIL keeps for a 4-channel file is dropped by its
// conversion to RGB, so it is tracked but not written).
int damc_qoi_decode(const uint8_t* in, int64_t in_len, int64_t pixels, uint8_t* out) {
  uint8_t index[64][4];
  bool seen[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t pos = 0, px = 0;
  while (px < pixels) {
    if (pos >= in_len) return TRUNCATED;
    uint8_t b = in[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (in_len - pos < 3) return TRUNCATED;
      v[0] = in[pos], v[1] = in[pos + 1], v[2] = in[pos + 2], v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (in_len - pos < 4) return TRUNCATED;
      std::memcpy(v, in + pos, 4);
      pos += 4;
    } else {
      int op = b >> 6;
      if (op == 0) {
        int i = b & 63;
        if (seen[i]) {
          std::memcpy(v, index[i], 4);
        } else {
          v[0] = v[1] = v[2] = v[3] = 0;
        }
      } else if (op == 1) {
        v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
        v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
        v[2] = uint8_t(prev[2] + (b & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (pos >= in_len) return TRUNCATED;
        uint8_t second = in[pos++];
        int dg = (b & 63) - 32, dr = ((second >> 4) & 15) - 8, db = (second & 15) - 8;
        v[0] = uint8_t(prev[0] + dg + dr);
        v[1] = uint8_t(prev[1] + dg);
        v[2] = uint8_t(prev[2] + dg + db);
        v[3] = prev[3];
      } else {
        int64_t run = (b & 63) + 1;
        for (; run > 0 && px < pixels; run--, px++) std::memcpy(out + 3 * px, prev, 3);
        continue;
      }
    }
    std::memcpy(prev, v, 4);
    int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(index[h], v, 4);
    seen[h] = true;
    std::memcpy(out + 3 * px, v, 3);
    px++;
  }
  return OK;
}

}  // extern "C"
