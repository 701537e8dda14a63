// WebP decoder whose output equals, byte for byte, what PIL's
// `Image.open(path).convert("RGB")` returns. PIL decodes every WebP file
// through libwebp's WebPAnimDecoder in RGBA mode with default options, so
// the output is libwebp's: for lossy (VP8, RFC 6386) frames its
// reconstruction and loop filters (src/dec, src/dsp/dec.c), its "fancy"
// chroma upsampling (src/dsp/upsampling.c) and its 14-bit fixed-point YUV to
// RGB conversion (src/dsp/yuv.h); for lossless (VP8L) frames the ARGB
// pixels; in both cases the colour samples do not depend on alpha (RGBA is
// not premultiplied), so an ALPH chunk's plane is decoded only as far as
// failing where libwebp fails. An animated file gives its first frame,
// drawn at its offset on a canvas of transparent zeros.
//
// Scope: the RIFF container with a simple `VP8 ` or `VP8L` chunk, or `VP8X`
// with `ICCP`, `ANIM`, `ANMF`, `ALPH`, `EXIF`, `XMP ` and unknown chunks.
// A file is refused (status 2, with a message) wherever PIL's path refuses
// it: libwebp's whole-file feature check, its demuxer (every chunk and
// frame), its decoder and its alpha decoder; so a corrupt file decodes to
// PIL's pixels or fails. Every read is bounds-checked, and the boolean
// decoder reads past a partition's end as libwebp does (zero bits, then an
// end-of-data error).
//
// C interface (ctypes, damc_tpu_torch/data/webp.py):
//   damc_webp_header(data, len, &width, &height, msg, msglen)
//   damc_webp_decode_batch(datas, lens, outs, n, threads, status, msgs, msglen)
// `outs[i]` is a caller-owned, zero-filled (height, width, 3) uint8 buffer
// sized from the header (the canvas); each image of the batch is decoded by
// one thread of a pool.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o libwebp_decode.so webp_decode.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status { OK = 0, CORRUPT = 2 };

struct Failure {
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw Failure{msg}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

// PIL refuses images above twice its MAX_IMAGE_PIXELS (DecompressionBombError).
const uint64_t kMaxPixels = 178956970;

// ===========================================================================
// Tables (RFC 6386 and the WebP lossless format, in libwebp's layout)
// ===========================================================================

// Dequantisation factors by quantiser index (RFC 6386 14.1).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// Default token probabilities [type][band][context][node] (RFC 6386 13.5).
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// The probability that the frame header updates each of them (RFC 6386 13.4).
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// Key-frame 4x4 mode probabilities [above][left][node], in libwebp's mode order.
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// VP8L distance codes 1 to 120 as (dy << 4) | (8 - dx) (the format's distance map).
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// libwebp's intra 4x4 mode numbering (src/dec/common_dec.h).
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED,
       B_HU_PRED, B_DC_PRED_NOTOP, B_DC_PRED_NOLEFT, B_DC_PRED_NOTOPLEFT };
// The intra 4x4 mode tree (RFC 6386 bmode_tree): node i's two children at
// [2i] and [2i + 1], a leaf as minus its mode.
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ===========================================================================
// VP8 (lossy)
// ===========================================================================

// The boolean decoder of src/utils/bit_reader_*: `range` holds the range
// minus one; bytes load one at a time (the same arithmetic as libwebp's
// wider loads). Past the end it shifts in one zero byte and sets `eof`,
// which fails the macroblock being decoded.
struct BoolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    p = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      bits += 8;
      value = (value << 8) | *p++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  inline int bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> bits);
    int b;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  uint32_t value_bits(int n) {  // VP8GetValue
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {  // VP8GetSignedValue
    const int v = (int)value_bits(n);
    return bit(0x80) ? -v : v;
  }
  int flag() { return bit(0x80); }
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode = 0;
  bool is_i4x4 = false;
  int segment = 0;
  bool skip = false;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

const int BPS = 32;  // the stride of libwebp's reconstruction buffer
const int Y_OFF = BPS * 1 + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;
const int YUV_SIZE = BPS * 17 + BPS * 9;

#define DST(x, y) dst[(x) + (y)*BPS]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void put(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

// 16x16 luma and 8x8 chroma prediction (src/dsp/dec.c).
void pred_block(uint8_t* dst, int mode, int size) {
  const int log2 = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      put(dst, dc >> (log2 + 1), size);
      break;
    }
    case B_DC_PRED_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      put(dst, dc >> log2, size);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      put(dst, dc >> log2, size);
      break;
    }
    case B_DC_PRED_NOTOPLEFT: put(dst, 0x80, size); break;
    case B_TM_PRED: true_motion(dst, size); break;
    case B_VE_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    default: corrupt("bad intra prediction mode");
  }
}

// 4x4 luma prediction (src/dsp/dec.c DC4 ... HU4).
void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, (int)(dc >> 3), 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    default: corrupt("bad intra 4x4 prediction mode");
  }
}
#undef DST

// The inverse DCT of one 4x4 block, added to the prediction (TransformOne_C);
// libwebp's DC-only and three-coefficient shortcuts compute the same.
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block into the DC terms of
// the 16 luma blocks (TransformWHT_C).
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// Loop filters (src/dsp/dec.c), on pixels p[-4 * step] .. p[3 * step].
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// One edge of `size` pixels: `hstride` crosses the edge, `vstride` runs along it.
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh, bool mb) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
    else if (mb) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

struct VP8Decoder {
  const uint8_t* data;
  size_t size;  // the padded payload, all of which the last partition may read
  size_t chunk_size = 0;  // the chunk's size field, which partition 0 must stay below
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header (ResetSegmentHeader's defaults)
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {}, filter_strength[4] = {};
  uint8_t segment_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
  BoolDecoder br;
  BoolDecoder parts[8];
  int num_parts_minus_one = 0;
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FilterInfo fstrengths[4][2];
  // Frame buffers, padded to whole macroblocks and left uninitialised: their
  // pages are touched only as rows decode, so a corrupt header that claims a
  // huge frame fails at its first missing row without writing them all.
  int ystride = 0, uvstride = 0;
  std::unique_ptr<uint8_t[]> Y, U, V;

  VP8Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  // The frame header (VP8GetInfo's checks); sets width and height.
  void read_size() {
    if (size < 10) corrupt("truncated VP8 frame header");
    const uint32_t bits = le24(data);
    const bool key_frame = !(bits & 1);
    if (!key_frame) corrupt("not a VP8 key frame");
    if (((bits >> 1) & 7) > 3) corrupt("unknown VP8 profile");
    if (!((bits >> 4) & 1)) corrupt("VP8 frame not displayable");
    if ((bits >> 5) >= chunk_size) corrupt("inconsistent VP8 partition size");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) corrupt("bad VP8 start code");
    width = le16(data + 6) & 0x3fff;
    height = le16(data + 8) & 0x3fff;
    if (width == 0 || height == 0) corrupt("zero VP8 width or height");
  }

  void parse_headers() {
    read_size();
    const uint32_t bits = le24(data);
    const size_t part0 = bits >> 5;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t left = size - 10;
    if (part0 > left) corrupt("bad VP8 partition length");
    br.init(buf, part0);
    buf += part0;
    left -= part0;
    br.flag();  // colour space
    br.flag();  // clamping type
    // segment header
    use_segment = br.flag();
    if (use_segment) {
      update_map = br.flag();
      if (br.flag()) {
        absolute_delta = br.flag();
        for (int s = 0; s < 4; ++s) quantizer[s] = br.flag() ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.flag() ? br.signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) segment_probs[s] = br.flag() ? (uint8_t)br.value_bits(8) : 255;
    }
    if (br.eof) corrupt("cannot parse the VP8 segment header");
    // filter header
    simple = br.flag();
    level = (int)br.value_bits(6);
    sharpness = (int)br.value_bits(3);
    use_lf_delta = br.flag();
    if (use_lf_delta && br.flag()) {
      for (int i = 0; i < 4; ++i)
        if (br.flag()) ref_lf_delta[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.flag()) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) corrupt("cannot parse the VP8 filter header");
    // token partitions
    num_parts_minus_one = (1 << br.value_bits(2)) - 1;
    const size_t last = num_parts_minus_one;
    if (left < 3 * last) corrupt("cannot parse the VP8 partitions");
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + last * 3;
    size_t size_left = left - last * 3;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = le24(sz);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last].init(part_start, size_left);
    if (part_start >= buf + left) corrupt("cannot parse the VP8 partitions (no data)");
    // quantizers
    const int base_q0 = (int)br.value_bits(7);
    const int dqy1_dc = br.flag() ? br.signed_value(4) : 0;
    const int dqy2_dc = br.flag() ? br.signed_value(4) : 0;
    const int dqy2_ac = br.flag() ? br.signed_value(4) : 0;
    const int dquv_dc = br.flag() ? br.signed_value(4) : 0;
    const int dquv_ac = br.flag() ? br.signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      QuantMatrix& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.flag();  // refresh entropy probabilities (ignored)
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br.value_bits(8)
                                                                       : kCoeffsProba0[t][b][c][p];
    use_skip_proba = br.flag();
    if (use_skip_proba) skip_p = (int)br.value_bits(8);
    // filter strengths (VP8EnterCritical)
    if (filter_type > 0) {
      for (int s = 0; s < 4; ++s) {
        int base_level;
        if (use_segment) {
          base_level = filter_strength[s];
          if (!absolute_delta) base_level += level;
        } else {
          base_level = level;
        }
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
          FilterInfo& info = fstrengths[s][i4x4];
          int lvl = base_level;
          if (use_lf_delta) {
            lvl += ref_lf_delta[0];
            if (i4x4) lvl += mode_lf_delta[0];
          }
          lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
          if (lvl > 0) {
            int ilevel = lvl;
            if (sharpness > 0) {
              ilevel >>= sharpness > 4 ? 2 : 1;
              if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
            }
            if (ilevel < 1) ilevel = 1;
            info.ilevel = ilevel;
            info.limit = 2 * lvl + ilevel;
            info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
          } else {
            info.limit = 0;
          }
          info.inner = i4x4;
        }
      }
    }
  }

  void parse_intra_mode(MBData& block, uint8_t* top, uint8_t* left) {
    if (update_map) {
      block.segment = !br.bit(segment_probs[0]) ? br.bit(segment_probs[1]) : br.bit(segment_probs[2]) + 2;
    } else {
      block.segment = 0;
    }
    block.skip = use_skip_proba ? br.bit(skip_p) : false;
    block.is_i4x4 = !br.bit(145);
    if (!block.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? B_TM_PRED : B_HE_PRED) : (br.bit(163) ? B_VE_PRED : B_DC_PRED);
      block.imodes[0] = (uint8_t)ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
          ymode = -i;
          top[x] = (uint8_t)ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    block.uvmode = !br.bit(142) ? B_DC_PRED : !br.bit(114) ? B_VE_PRED : br.bit(183) ? B_TM_PRED : B_HE_PRED;
  }

  // GetCoeffs: the tokens of one block from `n` on; returns the index after
  // the last non-zero coefficient (16 when the run reaches the end).
  static int get_large_value(BoolDecoder& tb, const uint8_t* p) {
    int v;
    if (!tb.bit(p[3])) {
      if (!tb.bit(p[4])) v = 2;
      else v = 3 + tb.bit(p[5]);
    } else {
      if (!tb.bit(p[6])) {
        if (!tb.bit(p[7])) {
          v = 5 + tb.bit(159);
        } else {
          v = 7 + 2 * tb.bit(165);
          v += tb.bit(145);
        }
      } else {
        const int bit1 = tb.bit(p[8]);
        const int bit0 = tb.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.bit(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  int get_coeffs(BoolDecoder& tb, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.bit(p[0])) return n;
      while (!tb.bit(p[1])) {
        ++n;
        if (n == 16) return 16;
        p = proba[type][kBands[n]][0];
      }
      int v;
      const int band = kBands[n + 1];
      if (!tb.bit(p[2])) {
        v = 1;
        p = proba[type][band][1];
      } else {
        v = get_large_value(tb, p);
        p = proba[type][band][2];
      }
      const int sv = tb.bit(0x80) ? -v : v;
      out[kZigzag[n]] = (int16_t)(sv * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals; returns true when the macroblock has no non-zero coefficient.
  bool parse_residuals(BoolDecoder& tb, MBData& block, uint8_t& mb_nz, uint8_t& mb_nz_dc, uint8_t& left_nz,
                       uint8_t& left_nz_dc) {
    const QuantMatrix& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    memset(dst, 0, 384 * sizeof(int16_t));
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc;
      const int nz = get_coeffs(tb, 1, ctx, q.y2, 0, dc);
      mb_nz_dc = left_nz_dc = (nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = mb_nz & 0x0f, lnz = left_nz & 0x0f;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tb, ac_type, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = mb_nz >> (4 + ch);
      lnz = left_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tb, 2, ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb_nz = (uint8_t)out_t_nz;
    left_nz = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
      return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
    }
    return mode;
  }

  // Decodes the frame into Y, U, V (ReconstructRow, then DoFilter in
  // raster order: the filters never read a later macroblock).
  void decode() {
    parse_headers();
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    Y.reset(new uint8_t[(size_t)ystride * mb_h * 16]);
    U.reset(new uint8_t[(size_t)uvstride * mb_h * 8]);
    V.reset(new uint8_t[(size_t)uvstride * mb_h * 8]);
    std::vector<uint8_t> intra_t(4 * (size_t)mb_w, B_DC_PRED);
    uint8_t intra_l[4];
    std::vector<uint8_t> nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
    std::vector<MBData> blocks(mb_w);
    std::vector<FilterInfo> finfo(mb_w);
    std::vector<uint8_t> top_y(16 * (size_t)mb_w), top_u(8 * (size_t)mb_w), top_v(8 * (size_t)mb_w);
    uint8_t yuv_b[YUV_SIZE];
    memset(yuv_b, 0, sizeof(yuv_b));
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    static const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
                                  8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                                  0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      BoolDecoder& tb = parts[mb_y & num_parts_minus_one];
      memset(intra_l, B_DC_PRED, 4);
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(blocks[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) corrupt("premature end of VP8 partition 0");
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& block = blocks[mb_x];
        bool skip = block.skip;
        if (!skip) {
          skip = parse_residuals(tb, block, nz_top[mb_x], nz_dc_top[mb_x], left_nz, left_nz_dc);
        } else {
          left_nz = nz_top[mb_x] = 0;
          if (!block.is_i4x4) left_nz_dc = nz_dc_top[mb_x] = 0;
          block.non_zero_y = 0;
          block.non_zero_uv = 0;
        }
        if (filter_type > 0) {
          finfo[mb_x] = fstrengths[block.segment][block.is_i4x4];
          finfo[mb_x].inner = finfo[mb_x].inner || !skip;
        }
        if (tb.eof) corrupt("premature end of VP8 data");
      }
      // Reconstruct the row.
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBData& block = blocks[mb_x];
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
          for (int j = -1; j < 8; ++j) {
            memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
            memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
          }
        }
        if (mb_y > 0) {
          memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
          memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
          memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
        }
        const int16_t* coeffs = block.coeffs;
        uint32_t bits = block.non_zero_y;
        if (block.is_i4x4) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
            else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
          }
          for (int k = 1; k <= 3; ++k) memcpy(top_right + k * 4 * BPS, top_right, 4);
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* dst = y_dst + kScan[n];
            pred4(dst, block.imodes[n]);
            if (bits >> 30) transform_add(coeffs + n * 16, dst);
          }
        } else {
          pred_block(y_dst, check_mode(mb_x, mb_y, block.imodes[0]), 16);
          for (int n = 0; n < 16; ++n, bits <<= 2)
            if (bits >> 30) transform_add(coeffs + n * 16, y_dst + kScan[n]);
        }
        const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
        pred_block(u_dst, uv_mode, 8);
        pred_block(v_dst, uv_mode, 8);
        for (int c = 0; c < 2; ++c) {
          const uint32_t bits_uv = block.non_zero_uv >> (8 * c);
          uint8_t* dst = c ? v_dst : u_dst;
          const int16_t* in = coeffs + (16 + 4 * c) * 16;
          if (bits_uv & 0xff)
            for (int k = 0; k < 4; ++k) transform_add(in + 16 * k, dst + (k & 1) * 4 + (k >> 1) * 4 * BPS);
        }
        memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
        memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
        memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
        uint8_t* yo = Y.get() + (size_t)mb_y * 16 * ystride + mb_x * 16;
        uint8_t* uo = U.get() + (size_t)mb_y * 8 * uvstride + mb_x * 8;
        uint8_t* vo = V.get() + (size_t)mb_y * 8 * uvstride + mb_x * 8;
        for (int j = 0; j < 16; ++j) memcpy(yo + (size_t)j * ystride, y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          memcpy(uo + (size_t)j * uvstride, u_dst + j * BPS, 8);
          memcpy(vo + (size_t)j * uvstride, v_dst + j * BPS, 8);
        }
      }
      if (filter_type > 0)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y, finfo[mb_x]);
    }
  }

  void filter_mb(int mb_x, int mb_y, const FilterInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = Y.get() + (size_t)mb_y * 16 * ystride + mb_x * 16;
    const int ys = ystride;
    if (filter_type == 1) {
      if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    const int uvs = uvstride;
    uint8_t* u = U.get() + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t* v = V.get() + (size_t)mb_y * 8 * uvs + mb_x * 8;
    const int il = f.ilevel, hv = f.hev_thresh;
    if (mb_x > 0) {
      complex_edge(y, 1, ys, 16, limit + 4, il, hv, true);
      complex_edge(u, 1, uvs, 8, limit + 4, il, hv, true);
      complex_edge(v, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) complex_edge(y + 4 * k, 1, ys, 16, limit, il, hv, false);
      complex_edge(u + 4, 1, uvs, 8, limit, il, hv, false);
      complex_edge(v + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
      complex_edge(y, ys, 1, 16, limit + 4, il, hv, true);
      complex_edge(u, uvs, 1, 8, limit + 4, il, hv, true);
      complex_edge(v, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) complex_edge(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      complex_edge(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      complex_edge(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }
};

// YUV to RGB (src/dsp/yuv.h), 14-bit fixed point.
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One output row of libwebp's fancy upsampler (UpsampleRgbaLinePair): the
// chroma of each pixel from the nearer chroma row `n` (weight 3) and the
// farther `f` (weight 1), then 3:1 across, as two rounded averages.
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu, const uint8_t* fv,
                  uint8_t* dst, int len) {
  auto chroma = [](const uint8_t* n, const uint8_t* f, int x, int* out) {
    // out[0]: pixel 2x - 1, out[1]: pixel 2x
    const int avg = n[x - 1] + n[x] + f[x - 1] + f[x] + 8;
    out[0] = (((avg + 2 * (n[x] + f[x - 1])) >> 3) + n[x - 1]) >> 1;
    out[1] = (((avg + 2 * (n[x - 1] + f[x])) >> 3) + n[x]) >> 1;
  };
  yuv_to_rgb(y[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2, dst);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    int u[2], v[2];
    chroma(nu, fu, x, u);
    chroma(nv, fv, x, v);
    yuv_to_rgb(y[2 * x - 1], u[0], v[0], dst + 3 * (2 * x - 1));
    yuv_to_rgb(y[2 * x], u[1], v[1], dst + 3 * (2 * x));
  }
  if (!(len & 1)) {
    const int x = last_pair;
    yuv_to_rgb(y[len - 1], (3 * nu[x] + fu[x] + 2) >> 2, (3 * nv[x] + fv[x] + 2) >> 2, dst + 3 * (len - 1));
  }
}

// The frame's RGB into `out` (stride `out_stride` bytes): EmitFancyRGB's
// row pairs, with output row 0 (and the last row of an even height) taking
// one chroma row for both.
void vp8_to_rgb(const VP8Decoder& dec, uint8_t* out, size_t out_stride) {
  const int W = dec.width, H = dec.height, uv_h = (H + 1) / 2;
  for (int y = 0; y < H; ++y) {
    int near, far;
    if (y == 0) {
      near = far = 0;
    } else if (y & 1) {
      near = (y - 1) >> 1;
      far = std::min((y + 1) >> 1, uv_h - 1);
    } else {
      near = y >> 1;
      far = near - 1;
    }
    const uint8_t* U = dec.U.get();
    const uint8_t* V = dec.V.get();
    upsample_row(dec.Y.get() + (size_t)y * dec.ystride, U + (size_t)near * dec.uvstride,
                 V + (size_t)near * dec.uvstride, U + (size_t)far * dec.uvstride, V + (size_t)far * dec.uvstride,
                 out + (size_t)y * out_stride, W);
  }
}

// ===========================================================================
// VP8L (lossless)
// ===========================================================================

// LSB-first bit reader (src/utils/bit_reader_utils.c VP8LBitReader): past
// the data it reads zeros, and it is at its end once more bits are consumed
// than the data holds (at least the 64 bits of its first load).
struct LBitReader {
  const uint8_t* d;
  size_t n;
  uint64_t pos = 0;  // in bits
  uint64_t limit;
  bool eos = false;

  LBitReader(const uint8_t* data, size_t len) : d(data), n(len), limit(8 * (uint64_t)std::max<size_t>(len, 8)) {}

  inline uint64_t window() const {  // the next 57 or more bits, first bit lowest
    const size_t i = (size_t)(pos >> 3);
    uint64_t v = 0;
    if (i + 8 <= n) {
      memcpy(&v, d + i, 8);
    } else {
      for (size_t k = 0; k < 8 && i + k < n; ++k) v |= (uint64_t)d[i + k] << (8 * k);
    }
    return v >> (pos & 7);
  }
  inline void skip(int k) {
    pos += k;
    if (pos > limit) eos = true;
  }
  uint32_t read(int k) {
    if (eos) return 0;
    const uint32_t v = k ? (uint32_t)(window() & ((1ull << k) - 1)) : 0;
    skip(k);
    return v;
  }
};

// A canonical prefix code: an 8-bit lookup for short codes, the canonical
// walk for longer ones; one symbol alone takes no bits.
struct PrefixCode {
  uint16_t look[256];  // (length << 12) | symbol; length 0 = longer than 8 bits
  uint16_t count[16];
  std::vector<uint16_t> sorted;
  int single = -1;

  // VP8LBuildHuffmanTable's checks; false for an invalid code.
  bool build(const int* lengths, int n) {
    int cnt[16] = {0};
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++cnt[lengths[s]];
    }
    if (cnt[0] == n) return false;
    for (int len = 1; len < 16; ++len)
      if (cnt[len] > (1 << len)) return false;
    const int coded = n - cnt[0];
    sorted.clear();
    for (int len = 1; len < 16; ++len)
      for (int s = 0; s < n; ++s)
        if (lengths[s] == len) sorted.push_back((uint16_t)s);
    if (coded == 1) {
      single = sorted[0];
      return true;
    }
    int open = 1;
    for (int len = 1; len < 16; ++len) {
      open <<= 1;
      open -= cnt[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    for (int len = 0; len < 16; ++len) count[len] = (uint16_t)cnt[len];
    memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int len = 1; len <= 8; ++len) {
      for (int i = 0; i < cnt[len]; ++i, ++code, ++k) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
        for (int j = rev; j < 256; j += 1 << len) look[j] = (uint16_t)((len << 12) | sorted[k]);
      }
      code <<= 1;
    }
    return true;
  }

  inline int read(LBitReader& br) const {
    if (single >= 0) return single;
    const uint64_t w = br.window();
    const uint16_t e = look[w & 255];
    if (e) {
      br.skip(e >> 12);
      return e & 0xfff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= (int)((w >> (len - 1)) & 1);
      const int c = count[len];
      if (code - first < c) {
        br.skip(len);
        return sorted[index + code - first];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    corrupt("bad VP8L prefix code");  // unreachable for a complete code
  }
};

struct HTreeGroup {
  PrefixCode codes[5];  // green (with lengths and cache), red, blue, alpha, distance
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a = top, b = left, c = top-left
  int s = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int ca = (a >> sh) & 0xff, cb = (b >> sh) & 0xff, cc = (c >> sh) & 0xff;
    s += std::abs(cb - cc) - std::abs(ca - cc);
  }
  return s <= 0 ? a : b;
}
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8)
    out |= (uint32_t)clip255((int)((c0 >> sh) & 0xff) + (int)((c1 >> sh) & 0xff) - (int)((c2 >> sh) & 0xff)) << sh;
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = (ave >> sh) & 0xff, b = (c2 >> sh) & 0xff;
    out |= (uint32_t)clip255(a + (a - b) / 2) << sh;
  }
  return out;
}

inline uint32_t predict(int mode, const uint32_t* out, int x, int width) {
  const uint32_t L = out[x - 1];
  const uint32_t* top = out + x - width;
  switch (mode) {
    case 0: return 0xff000000u;
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 14 and 15 (libwebp's sentinels)
  }
}

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

struct VP8LDecoder {
  LBitReader br;
  int width = 0, height = 0;
  std::vector<Transform> transforms;
  unsigned transforms_seen = 0;
  bool alpha_plane = false;  // an ALPH chunk's stream, which has no header

  VP8LDecoder(const uint8_t* d, size_t n) : br(d, n) {}

  void read_header() {
    if (br.n < 5 || br.d[0] != 0x2f || (br.d[4] >> 5) != 0) corrupt("bad VP8L signature");
    br.read(8);
    width = (int)br.read(14) + 1;
    height = (int)br.read(14) + 1;
    br.read(1);  // alpha hint
    if (br.read(3) != 0) corrupt("bad VP8L version");
    if (br.eos) corrupt("truncated VP8L header");
  }

  // One prefix code (ReadHuffmanCode) into `code`, or read and checked
  // only when `code` is null.
  void read_code(int alphabet_size, PrefixCode* code) {
    std::vector<int> lengths(std::max(alphabet_size, 256), 0);
    if (br.read(1)) {  // simple code
      const int num_symbols = (int)br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (num_symbols == 2) lengths[br.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = (int)br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = (int)br.read(3);
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) corrupt("bad VP8L code-length code");
      int max_symbol;
      if (br.read(1)) {
        const int length_nbits = 2 + 2 * (int)br.read(3);
        max_symbol = 2 + (int)br.read(length_nbits);
        if (max_symbol > alphabet_size) corrupt("bad VP8L code lengths");
      } else {
        max_symbol = alphabet_size;
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet_size) {
        if (max_symbol-- == 0) break;
        if (br.eos) break;
        const int len = cl.read(br);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len != 0) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int slot = len - 16;
          const int repeat = (int)br.read(kExtra[slot]) + kOffset[slot];
          if (symbol + repeat > alphabet_size) corrupt("bad VP8L code lengths");
          const int v = len == 16 ? prev : 0;
          for (int r = 0; r < repeat; ++r) lengths[symbol++] = v;
        }
      }
    }
    if (br.eos) corrupt("truncated VP8L data");
    PrefixCode tmp;
    if (!(code ? code : &tmp)->build(lengths.data(), alphabet_size)) corrupt("bad VP8L prefix code");
  }

  // One entropy-coded image (DecodeImageStream): level 0 reads the
  // transforms and may use meta prefix codes; its pixels come back in the
  // width of its last transform.
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    if (level0) {
      while (br.read(1)) {
        if (br.eos) corrupt("truncated VP8L data");
        const int type = (int)br.read(2);
        if (transforms_seen & (1u << type)) corrupt("a VP8L transform appears twice");
        transforms_seen |= 1u << type;
        Transform t;
        t.type = type;
        t.xsize = xsize;
        t.ysize = ysize;
        if (type == 0 || type == 1) {
          t.bits = 2 + (int)br.read(3);
          t.data = decode_stream(subsample(xsize, t.bits), subsample(ysize, t.bits), false);
        } else if (type == 3) {
          const int num_colors = (int)br.read(8) + 1;
          t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
          xsize = subsample(t.xsize, t.bits);
          std::vector<uint32_t> map = decode_stream(num_colors, 1, false);
          const int final_colors = 1 << (8 >> t.bits);
          t.data.assign(final_colors, 0);
          t.data[0] = map[0];
          for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(map[i], t.data[i - 1]);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > 11) corrupt("bad VP8L colour cache size");
    }
    // prefix codes, with the meta image that picks a group per tile
    int huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> huff_image;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      huff_bits = 2 + (int)br.read(3);
      huff_xsize = subsample(xsize, huff_bits);
      huff_image = decode_stream(huff_xsize, subsample(ysize, huff_bits), false);
      for (uint32_t& g : huff_image) {
        g = (g >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)g + 1);
      }
    }
    if (br.eos) corrupt("truncated VP8L data");
    // Only the groups the meta image names are kept; the others are read
    // and checked (ReadHuffmanCodesHelper's mapping).
    std::vector<int> mapping(num_groups, -1);
    int used = 0;
    if (huff_image.empty()) {
      mapping[0] = used++;
    } else {
      for (uint32_t& g : huff_image) {
        if (mapping[g] < 0) mapping[g] = used++;
        g = (uint32_t)mapping[g];
      }
    }
    std::vector<HTreeGroup> groups(used);
    for (int i = 0; i < num_groups; ++i)
      for (int j = 0; j < 5; ++j) {
        const int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits > 0 ? 1 << cache_bits : 0);
        read_code(alphabet, mapping[i] >= 0 ? &groups[mapping[i]].codes[j] : nullptr);
      }
    // the pixels (DecodeImageData)
    const uint64_t npix = (uint64_t)xsize * ysize;
    if (npix > kMaxPixels) corrupt("VP8L image too large");
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    std::unique_ptr<uint32_t[]> buf(new uint32_t[npix ? npix : 1]);  // uninitialised, as the VP8 planes
    uint32_t* const data = buf.get();
    const uint32_t mask = huff_bits ? (1u << huff_bits) - 1 : ~0u;
    const int len_code_limit = 256 + 24;
    const int cache_limit = len_code_limit + (int)cache.size();
    uint64_t src = 0, last_cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int c, int r) -> const HTreeGroup& {
      if (huff_image.empty()) return groups[0];
      return groups[huff_image[(size_t)(r >> huff_bits) * huff_xsize + (c >> huff_bits)]];
    };
    auto flush_cache = [&]() {
      for (; last_cached < src; ++last_cached) {
        const uint32_t argb = data[last_cached];
        cache[(argb * 0x1e35a7bdu) >> (32 - cache_bits)] = argb;
      }
    };
    // An alpha plane that only indexes colours, with no colour cache and
    // one-symbol red, blue and alpha codes, goes through libwebp's 8-bit path
    // (DecodeAlphaData): it finishes each symbol it starts and fails at the
    // end of the data only if pixels are still missing.
    bool eight_bit = level0 && alpha_plane && transforms.size() == 1 && transforms[0].type == 3 && cache_bits == 0;
    for (const HTreeGroup& grp : groups)
      for (int j = 1; j <= 3; ++j) eight_bit = eight_bit && grp.codes[j].single >= 0;
    const HTreeGroup* g = &group_at(0, 0);
    while (src < npix && !(eight_bit && br.eos)) {
      if ((col & mask) == 0) g = &group_at(col, row);
      const int code = g->codes[0].read(br);
      if (br.eos && !eight_bit) break;
      if (code < 256) {
        const int red = g->codes[1].read(br);
        const int blue = g->codes[2].read(br);
        const int alpha = g->codes[3].read(br);
        if (br.eos && !eight_bit) break;
        data[src] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | (uint32_t)blue;
      } else if (code < len_code_limit) {
        const int length = copy_value(code - 256);
        const int dist_symbol = g->codes[4].read(br);
        const int dist_code = copy_value(dist_symbol);
        const int dist = plane_to_distance(xsize, dist_code);
        if (br.eos && !eight_bit) break;
        if ((uint64_t)dist > src || npix - src < (uint64_t)length) corrupt("bad VP8L backward reference");
        for (int i = 0; i < length; ++i) data[src + i] = data[src + i - dist];
        src += length;
        col += length;
        while (col >= xsize) {
          col -= xsize;
          ++row;
        }
        if (col & mask) g = &group_at(col, row);
        if (cache_bits) flush_cache();
        continue;
      } else if (code < cache_limit) {
        flush_cache();
        data[src] = cache[code - len_code_limit];
      } else {
        corrupt("bad VP8L symbol");
      }
      ++src;
      if (++col >= xsize) {
        col = 0;
        ++row;
        if (cache_bits) flush_cache();
      }
    }
    if (br.eos && (!eight_bit || src < npix)) corrupt("truncated VP8L data");
    return std::vector<uint32_t>(data, data + npix);
  }

  int copy_value(int symbol) {  // GetCopyDistance / GetCopyLength
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }

  static int plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dist_code = kCodeToPlane[code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  // The ARGB pixels (width x height) of the frame.
  std::vector<uint32_t> decode() {
    read_header();
    std::vector<uint32_t> argb = decode_stream(width, height, true);
    for (int n = (int)transforms.size() - 1; n >= 0; --n) argb = inverse(transforms[n], argb);
    return argb;
  }

  static std::vector<uint32_t> inverse(const Transform& t, const std::vector<uint32_t>& in) {
    const int W = t.xsize, H = t.ysize;
    std::vector<uint32_t> out((size_t)W * H);
    if (t.type == 0) {  // predictor
      const int tiles_per_row = subsample(W, t.bits);
      for (int y = 0; y < H; ++y) {
        const uint32_t* src = &in[(size_t)y * W];
        uint32_t* o = &out[(size_t)y * W];
        if (y == 0) {
          o[0] = add_pixels(src[0], 0xff000000u);
          for (int x = 1; x < W; ++x) o[x] = add_pixels(src[x], o[x - 1]);
          continue;
        }
        o[0] = add_pixels(src[0], o[-W]);
        const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles_per_row];
        for (int x = 1; x < W; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          o[x] = add_pixels(src[x], predict(mode, o, x, W));
        }
      }
    } else if (t.type == 1) {  // cross colour
      const int tiles_per_row = subsample(W, t.bits);
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles_per_row + (x >> t.bits)];
          const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff), r2b = (int8_t)((m >> 16) & 0xff);
          const uint32_t argb = in[(size_t)y * W + x];
          const int8_t green = (int8_t)(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += color_delta(g2r, green);
          new_red &= 0xff;
          new_blue += color_delta(g2b, green);
          new_blue += color_delta(r2b, (int8_t)new_red);
          new_blue &= 0xff;
          out[(size_t)y * W + x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
        }
    } else if (t.type == 2) {  // subtract green
      for (size_t i = 0; i < out.size(); ++i) {
        const uint32_t argb = in[i];
        const uint32_t green = (argb >> 8) & 0xff;
        uint32_t rb = argb & 0x00ff00ffu;
        rb += (green << 16) | green;
        rb &= 0x00ff00ffu;
        out[i] = (argb & 0xff00ff00u) | rb;
      }
    } else {  // colour indexing
      const int in_w = subsample(W, t.bits);
      const int bits_per_pixel = 8 >> t.bits;
      const int count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      for (int y = 0; y < H; ++y) {
        const uint32_t* src = &in[(size_t)y * in_w];
        uint32_t packed = 0;
        for (int x = 0; x < W; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          out[(size_t)y * W + x] = t.data[packed & bit_mask];
          packed >>= bits_per_pixel;
        }
      }
    }
    return out;
  }
};

// ===========================================================================
// The RIFF container, as libwebp's demuxer (src/demux/demux.c) reads it for
// PIL's animation decoder: every chunk and every frame is checked, and a
// file the demuxer refuses is refused, though only the first frame is drawn.
// ===========================================================================

const uint64_t kMaxChunkPayload = 0xFFFFFFFFu - 8 - 1;

struct Chunk {
  size_t offset = 0, size = 0;  // the chunk header's offset; header and padded payload
};

struct Frame {
  int x = 0, y = 0, width = 0, height = 0;
  int num = 0;  // 0 until an ALPH or image chunk is stored
  bool complete = false, lossless = false;
  Chunk alpha, image;
};

// The dimensions of an image chunk's bitstream (WebPGetFeatures on the
// chunk): `data` its padded payload, `size` its size field.
void bitstream_size(const uint8_t* data, size_t padded, uint32_t size, bool lossless, int* w, int* h) {
  if (lossless) {
    VP8LDecoder l(data, padded);
    l.read_header();
    *w = l.width;
    *h = l.height;
  } else {
    VP8Decoder v(data, padded);
    v.chunk_size = size;
    v.read_size();
    *w = v.width;
    *h = v.height;
  }
}

// ALPHInit and ALPHDecode: libwebp decodes a lossy frame's alpha plane
// beside its pixels and fails the frame when the plane is corrupt. The RGB
// output never uses the plane, so it is decoded only as far as failing
// where libwebp fails.
void check_alpha(const uint8_t* data, size_t size, int width, int height) {
  if (size <= 1) corrupt("bad ALPH chunk");
  const int method = data[0] & 3, pre_processing = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre_processing > 1 || reserved) corrupt("bad ALPH header");
  if (method == 0) {
    if (size - 1 < (uint64_t)width * height) corrupt("truncated ALPH data");
    return;
  }
  VP8LDecoder l(data + 1, size - 1);
  l.alpha_plane = true;
  l.decode_stream(width, height, true);
}

struct WebP {
  const uint8_t* d;
  size_t n;
  size_t pos = 0, end = 0;  // the parse position and the end of the RIFF chunk
  int flags = 0, canvas_w = 0, canvas_h = 0;
  std::vector<Frame> frames;

  WebP(const uint8_t* data, size_t len) : d(data), n(len) {}

  size_t left() const { return end - pos; }
  bool is(size_t at, const char* fourcc) const { return !memcmp(d + at, fourcc, 4); }

  // StoreFrame: an ALPH chunk and an image chunk for frame `num`, stopping
  // at any other chunk.
  void store_frame(int num, uint64_t min_size, Frame& f) {
    if (left() < 8 || left() < min_size) corrupt("truncated chunk");
    int alpha_chunks = 0, image_chunks = 0;
    for (;;) {
      const size_t start = pos;
      const uint32_t size = le32(d + pos + 4);
      pos += 8;
      if (size > kMaxChunkPayload) corrupt("bad chunk size");
      const uint64_t padded = (uint64_t)size + (size & 1);
      if (padded > left()) corrupt("truncated chunk");
      const bool alph = is(start, "ALPH"), vp8l = is(start, "VP8L"), image = vp8l || is(start, "VP8 ");
      if (vp8l && alpha_chunks > 0) corrupt("an ALPH chunk before a VP8L chunk");
      if (alph && alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha = {start, 8 + (size_t)padded};
      } else if (image && image_chunks == 0) {
        ++image_chunks;
        f.image = {start, 8 + (size_t)padded};
        f.lossless = vp8l;
        bitstream_size(d + pos, (size_t)padded, size, vp8l, &f.width, &f.height);
        f.complete = true;
      } else {
        pos = start;  // left for the caller
        return;
      }
      f.num = num;
      pos += (size_t)padded;
      if (pos == end) return;
      if (left() < 8) corrupt("truncated chunk");
    }
  }

  // AddFrame: a frame follows only a complete one.
  void add_frame(const Frame& f) {
    if (!frames.empty() && !frames.back().complete) corrupt("a frame after an incomplete one");
    frames.push_back(f);
  }

  // ParseSingleImage.
  void single_image(bool ext) {
    if (!frames.empty()) corrupt("a second image");
    if (left() < 8) corrupt("truncated chunk");
    Frame f;
    store_frame(1, 0, f);
    if (!(flags & 0x10)) f.alpha = Chunk();  // the alpha flag is missing: the ALPH chunk is dropped
    if (!ext && f.width > 0 && f.height > 0) {
      canvas_w = f.width;
      canvas_h = f.height;
    }
    add_frame(f);
  }

  // ParseAnimationFrame.
  void animation_frame(uint64_t padded, bool animation) {
    if (padded < 16) corrupt("bad ANMF chunk");
    Frame f;
    const uint8_t* p = d + pos;
    f.x = 2 * (int)le24(p);
    f.y = 2 * (int)le24(p + 3);
    f.width = 1 + (int)le24(p + 6);
    f.height = 1 + (int)le24(p + 9);
    pos += 16;
    if ((uint64_t)f.width * f.height >= ((uint64_t)1 << 32)) corrupt("frame too large");
    const size_t start = pos;
    store_frame((int)frames.size() + 1, padded - 16, f);
    if (pos - start > padded - 16) corrupt("frame data beyond its ANMF chunk");
    if (animation && f.num > 0) add_frame(f);
  }

  // WebPGetFeatures on the whole file (src/dec/webp_dec.c
  // ParseHeadersInternal), which WebPAnimDecoderNew runs before the demuxer:
  // a stricter VP8X, the chunks before a still image's bitstream within the
  // RIFF size, and that bitstream's header valid and the size of the canvas.
  // Running out of data is no failure there once a VP8X chunk is seen.
  void check_features() const {
    const uint64_t riff = le32(d + 4);
    if (riff < 12) corrupt("bad RIFF size");
    size_t p = 12, rem = n - 12;
    bool vp8x = false;
    uint32_t vp8x_w = 0, vp8x_h = 0;
    if (rem < 8) corrupt("truncated file");
    if (!memcmp(d + p, "VP8X", 4)) {
      if (le32(d + p + 4) != 10 || rem < 18) corrupt("bad VP8X chunk");
      if (le32(d + p + 8) & 0x02) return;  // an animation: the header is all it reads
      vp8x = true;
      vp8x_w = le24(d + p + 12) + 1;
      vp8x_h = le24(d + p + 15) + 1;
      p += 18;
      rem -= 18;
      if (rem < 4) return;
      uint32_t total = 4 + 8 + 10;  // ParseOptionalChunks, in its uint32 arithmetic
      for (;;) {
        if (rem < 8) return;
        const uint32_t size = le32(d + p + 4);
        if (size > kMaxChunkPayload) corrupt("bad chunk size");
        const uint32_t disk = (8 + size + 1) & ~1u;
        total += disk;
        if (total > riff) corrupt("chunks beyond the RIFF size");
        if (!memcmp(d + p, "VP8 ", 4) || !memcmp(d + p, "VP8L", 4)) break;
        if (rem < disk) return;
        p += disk;
        rem -= disk;
      }
    }
    if (rem < 8) {
      if (vp8x) return;
      corrupt("truncated file");
    }
    bool lossless;
    uint64_t compressed;
    if (!memcmp(d + p, "VP8 ", 4) || !memcmp(d + p, "VP8L", 4)) {
      compressed = le32(d + p + 4);
      if (compressed > riff - 12) corrupt("bad image chunk size");
      lossless = d[p + 3] == 'L';
      p += 8;
      rem -= 8;
    } else {
      lossless = rem >= 5 && d[p] == 0x2f && (d[p + 4] >> 5) == 0;  // a raw bitstream
      compressed = rem;
    }
    if (rem < (lossless ? 5u : 10u)) {
      if (vp8x) return;
      corrupt("truncated file");
    }
    int w, h;
    if (lossless) {
      VP8LDecoder l(d + p, rem);
      l.read_header();
      w = l.width;
      h = l.height;
    } else {
      VP8Decoder v(d + p, rem);
      v.chunk_size = compressed;
      v.read_size();
      w = v.width;
      h = v.height;
    }
    if (vp8x && ((uint32_t)w != vp8x_w || (uint32_t)h != vp8x_h)) corrupt("image size differs from the canvas");
  }

  // ReadHeader, ParseVP8X or ParseSingleImage, and the validity checks.
  void parse() {
    if (n < 20) corrupt("truncated file");
    if (memcmp(d, "RIFF", 4) || memcmp(d + 8, "WEBP", 4)) corrupt("not a WebP file (no RIFF/WEBP header)");
    const uint64_t riff = le32(d + 4);
    if (riff < 8 || riff > kMaxChunkPayload) corrupt("bad RIFF size");
    if (riff + 8 > n) corrupt("truncated file (shorter than its RIFF size)");
    check_features();
    end = (size_t)riff + 8;
    pos = 12;
    if (left() < 4) corrupt("truncated file");
    if (is(pos, "VP8 ") || is(pos, "VP8L")) {
      single_image(false);
    } else if (is(pos, "VP8X")) {
      parse_vp8x();
    } else {
      corrupt("unknown first chunk (not VP8, VP8L or VP8X)");
    }
    if (canvas_w <= 0 || canvas_h <= 0 || frames.empty()) corrupt("no image");
    const bool animation = flags & 0x02;
    for (const Frame& f : frames) {
      if (!f.complete) corrupt("an incomplete frame");
      if (f.alpha.size && f.alpha.offset > f.image.offset) corrupt("ALPH after the image");
      if (f.width <= 0 || f.height <= 0) corrupt("an empty frame");
      const bool inside = animation ? (uint64_t)f.x + f.width <= (uint64_t)canvas_w &&
                                          (uint64_t)f.y + f.height <= (uint64_t)canvas_h
                                    : f.x == 0 && f.y == 0 && f.width == canvas_w && f.height == canvas_h;
      if (!inside) corrupt(animation ? "a frame outside the canvas" : "image size differs from the canvas");
      if (!animation && f.num > 1) corrupt("frames in a still image");
    }
  }

  void parse_vp8x() {
    if (left() < 8) corrupt("truncated VP8X chunk");
    const uint32_t size = le32(d + pos + 4);
    pos += 8;
    if (size > kMaxChunkPayload || size < 10) corrupt("bad VP8X chunk");
    const uint64_t padded = (uint64_t)size + (size & 1);
    if (padded > left()) corrupt("truncated VP8X chunk");
    flags = d[pos];
    canvas_w = (int)le24(d + pos + 4) + 1;
    canvas_h = (int)le24(d + pos + 7) + 1;
    if ((uint64_t)canvas_w * canvas_h >= ((uint64_t)1 << 32)) corrupt("canvas too large");
    pos += (size_t)padded;
    if (left() < 8) corrupt("truncated file");
    if (flags & ~0x3e) corrupt("bad VP8X flags");
    const bool animation = flags & 0x02;
    bool anim_chunk = false;
    for (;;) {
      const size_t start = pos;
      const uint32_t csize = le32(d + pos + 4);
      pos += 8;
      if (csize > kMaxChunkPayload) corrupt("bad chunk size");
      const uint64_t cpadded = (uint64_t)csize + (csize & 1);
      if (cpadded > left()) corrupt("truncated chunk");
      if (is(start, "VP8X")) corrupt("a second VP8X chunk");
      if (is(start, "ALPH") || is(start, "VP8 ") || is(start, "VP8L")) {
        if (anim_chunk || animation) corrupt("an image chunk outside ANMF in an animation");
        pos = start;
        single_image(true);
      } else if (is(start, "ANIM")) {
        if (cpadded < 6) corrupt("bad ANIM chunk");
        anim_chunk = true;
        pos += (size_t)cpadded;
      } else if (is(start, "ANMF")) {
        if (!anim_chunk) corrupt("an ANMF chunk before ANIM");
        animation_frame(cpadded, animation);
      } else {
        pos += (size_t)cpadded;  // ICCP, EXIF, XMP and unknown chunks
      }
      if (pos == end) return;
      if (left() < 8) corrupt("truncated file");
    }
  }

  // The RGB canvas into `rgb` (canvas_h, canvas_w, 3), which the caller
  // zero-fills: an animation's first frame lies on transparent black. The
  // frame's data is what the demuxer hands the decoder: the image chunk's
  // padded payload, and its ALPH chunk for a lossy frame.
  void decode(uint8_t* rgb) {
    parse();
    const Frame& f = frames[0];
    const size_t stride = (size_t)canvas_w * 3;
    uint8_t* out = rgb + (size_t)f.y * stride + (size_t)f.x * 3;
    const uint8_t* data = d + f.image.offset + 8;
    const size_t size = f.image.size - 8;
    if (f.lossless) {
      VP8LDecoder l(data, size);
      std::vector<uint32_t> argb = l.decode();
      for (int y = 0; y < l.height; ++y) {
        uint8_t* o = out + (size_t)y * stride;
        const uint32_t* s = &argb[(size_t)y * l.width];
        for (int x = 0; x < l.width; ++x) {
          o[3 * x] = (uint8_t)(s[x] >> 16);
          o[3 * x + 1] = (uint8_t)(s[x] >> 8);
          o[3 * x + 2] = (uint8_t)s[x];
        }
      }
    } else {
      VP8Decoder v(data, size);
      v.chunk_size = le32(d + f.image.offset + 4);
      v.decode();
      if (f.alpha.size) check_alpha(d + f.alpha.offset + 8, le32(d + f.alpha.offset + 4), v.width, v.height);
      vp8_to_rgb(v, out, stride);
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

// Parses the container and the first frame's bitstream header. Returns 0
// and the canvas size, or 2 (corrupt) with a message.
int damc_webp_header(const uint8_t* data, size_t len, int* width, int* height, char* msg, size_t msglen) {
  try {
    WebP w(data, len);
    w.parse();
    if ((uint64_t)w.canvas_w * w.canvas_h > kMaxPixels) corrupt("image larger than PIL's decompression-bomb limit");
    *width = w.canvas_w;
    *height = w.canvas_h;
    return OK;
  } catch (const Failure& f) {
    put_message(msg, msglen, f.msg);
    return CORRUPT;
  } catch (const std::bad_alloc&) {
    put_message(msg, msglen, "out of memory");
    return CORRUPT;
  }
}

// Decodes n files, outs[i] (height, width, 3) uint8 each and zero-filled,
// over `threads` threads; status[i] and the message at msgs + i * msglen
// report each file.
void damc_webp_decode_batch(const uint8_t* const* datas, const size_t* lens, uint8_t* const* outs, int n,
                            int threads, int* status, char* msgs, size_t msglen) {
  std::atomic<int> next{0};
  auto work = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) {
      try {
        WebP w(datas[i], lens[i]);
        w.decode(outs[i]);
        status[i] = OK;
      } catch (const Failure& f) {
        status[i] = CORRUPT;
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
