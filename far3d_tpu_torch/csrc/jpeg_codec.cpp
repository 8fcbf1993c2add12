// Baseline JPEG decoder and encoder, equal bit for bit to OpenCV's
// ``cv2.imread(path, IMREAD_COLOR)`` / ``cv2.imdecode`` and byte for byte to
// ``cv2.imwrite(path, img, [IMWRITE_JPEG_QUALITY, q])`` as OpenCV builds them
// on libjpeg-turbo with its defaults.
//
// Decode: baseline and extended sequential Huffman frames (SOF0 / SOF1) of
// 8-bit samples, 1 or 3 components, luma sampled 1x1, 2x1 or 2x2 against 1x1
// chroma, DRI / RSTn restart markers. The stages are libjpeg's: dequantize
// and the integer "islow" IDCT (jidctint.c, its descaling and its post-IDCT
// range table), fancy upsampling (jdsample.c's h2v1 and h2v2 triangle
// filters with their alternating biases, plain replication where the chroma
// plane is at most 2 samples wide), the fixed-point YCbCr -> BGR tables of
// jdcolor.c, the output cropped to the image. Progressive, arithmetic,
// lossless, hierarchical and 12-bit frames, CMYK and RGB-coded files, other
// sampling layouts and an EXIF orientation other than 1 raise by name.
//
// Encode, as jpeg_set_defaults + jpeg_set_quality(q, force_baseline) write:
// BGR -> YCbCr through jccolor.c's tables, 4:2:0 by jcsample.c's box filter
// with its 1,2 bias (edges replicated as jcprepct.c pads them), the islow
// FDCT (jfdctint.c), quantization by libjpeg-turbo's reciprocals
// (jcdctmgr.c), the Annex K tables scaled by jpeg_quality_scaling, the
// standard Huffman tables without optimization, dummy blocks at the right
// and bottom edges as jccoefct.c makes them, and the marker sequence SOI,
// JFIF APP0, DQT x2, SOF0, DHT x4, SOS, EOI. A 2-D input is written as a
// one-component (grayscale) file.
//
// The C entry points report failure by a negative return and a message that
// jpeg_last_error() returns (per thread).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// Zig-zag index -> natural (row-major) index, with 16 extra entries that
// keep a corrupt run inside the block, as libjpeg's jpeg_natural_order has.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- islow DCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jidctint.c's post-IDCT range table, indexed by (x & 1023): x + 128
// saturated to [0, 255] for x in [-512, 511], wrapping beyond as libjpeg's.
struct IdctRange {
  uint8_t t[1024];
  IdctRange() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      t[i] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
};
const IdctRange kIdctRange;

// jpeg_idct_islow: coef (natural order) times quant -> 8x8 samples.
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int(in[0]) * int(q[0])) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16], z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, n));
    w[56] = int(descale(tmp10 - tmp3, n));
    w[8] = int(descale(tmp11 + tmp2, n));
    w[48] = int(descale(tmp11 - tmp2, n));
    w[16] = int(descale(tmp12 + tmp1, n));
    w[40] = int(descale(tmp12 - tmp1, n));
    w[24] = int(descale(tmp13 + tmp0, n));
    w[32] = int(descale(tmp13 - tmp0, n));
  }
  const uint8_t* rl = kIdctRange.t;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = rl[int(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits + kPass1Bits + 3;
    o[0] = rl[int(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = rl[int(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = rl[int(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = rl[int(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = rl[int(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = rl[int(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = rl[int(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = rl[int(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// jpeg_fdct_islow on (sample - 128); results are 8x the true coefficients.
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int32_t((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int32_t((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int n = kConstBits - kPass1Bits;
    p[2] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[6] = int32_t(descale(z1 + tmp12 * (-FIX_1_847759065), n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int32_t(descale(tmp4 + z1 + z3, n));
    p[5] = int32_t(descale(tmp5 + z2 + z4, n));
    p[3] = int32_t(descale(tmp6 + z2 + z3, n));
    p[1] = int32_t(descale(tmp7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int32_t(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int32_t(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int n = kConstBits + kPass1Bits;
    p[16] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[48] = int32_t(descale(z1 + tmp12 * (-FIX_1_847759065), n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int32_t(descale(tmp4 + z1 + z3, n));
    p[40] = int32_t(descale(tmp5 + z2 + z4, n));
    p[24] = int32_t(descale(tmp6 + z2 + z3, n));
    p[8] = int32_t(descale(tmp7 + z1 + z4, n));
  }
}

// ------------------------------------------------------------ Huffman tables

struct HuffSpec {
  uint8_t bits[17];  // bits[l]: number of codes of length l (1..16)
  uint8_t vals[256];
  int nvals;
};

// Annex K.3 tables as jstdhuff.c gives them.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

HuffSpec make_spec(const uint8_t* bits, const uint8_t* vals, int n) {
  HuffSpec s{};
  std::memcpy(s.bits, bits, 17);
  std::memcpy(s.vals, vals, n);
  s.nvals = n;
  return s;
}

// Canonical codes of a table (Annex C): code and length of each symbol.
void canonical_codes(const HuffSpec& s, uint16_t* code, uint8_t* size) {
  int k = 0;
  uint32_t c = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < s.bits[l]; ++i, ++k) {
      code[s.vals[k]] = uint16_t(c);
      size[s.vals[k]] = uint8_t(l);
      ++c;
    }
    c <<= 1;
  }
}

// ----------------------------------------------------------------- decoding

constexpr int kLookBits = 9;

struct DecodeTable {
  bool defined = false;
  // lookup[peek of kLookBits]: (length << 8) | symbol, length 0 = longer code
  uint16_t lookup[1 << kLookBits];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valoffset[17];
  uint8_t vals[256];
};

void build_decode_table(const HuffSpec& s, DecodeTable* t) {
  std::memset(t->lookup, 0, sizeof(t->lookup));
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += s.bits[l];
  if (total > 256) fail("JPEG: bad Huffman table (more than 256 codes)");
  std::memcpy(t->vals, s.vals, total);
  int k = 0;
  int32_t code = 0;
  for (int l = 1; l <= 16; ++l) {
    if (code + s.bits[l] > (int32_t(1) << l))
      fail("JPEG: bad Huffman table (more codes than bits)");
    if (s.bits[l]) {
      t->valoffset[l] = k - code;
      for (int i = 0; i < s.bits[l]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j)
            t->lookup[(code << shift) | j] = uint16_t((l << 8) | s.vals[k]);
        }
      }
      t->maxcode[l] = code - 1;
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;  // stops the slow search on corrupt data
  t->defined = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes before a marker
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            at_marker = true;  // leave the marker; feed zeros as libjpeg does
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= uint64_t(byte) << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (bits < n) fill();
    return uint32_t(buf >> (64 - n));
  }
  inline void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  inline uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  inline int decode(const DecodeTable& t) {
    uint32_t look = peek(16);
    uint16_t e = t.lookup[look >> (16 - kLookBits)];
    if (e >> 8) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    while (l <= 16 && int32_t(look >> (16 - l)) > t.maxcode[l]) ++l;
    if (l > 16) {  // corrupt data: libjpeg warns and returns symbol 0
      skip(16);
      return 0;
    }
    skip(l);
    return t.vals[t.valoffset[l] + int32_t(look >> (16 - l))];
  }
  // Drop the bits left before a restart marker and step over the marker.
  void restart() {
    buf = 0;
    bits = 0;
    at_marker = false;
    while (p < end && *p != 0xFF) ++p;  // libjpeg skips stray bytes too
    while (p < end && *p == 0xFF) ++p;
    if (p < end && *p >= 0xD0 && *p <= 0xD7) ++p;
  }
};

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? int(v) - (1 << s) + 1 : int(v);
}

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;          // blocks of the allocated plane
  int dw = 0, dh = 0;          // samples that hold the image ("downsampled")
  bool seen = false;
  uint16_t quant[64];          // natural order, latched at its scan
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8)
};

struct Frame {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  DecodeTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool frame_seen = false;
  Frame f;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) fail("JPEG: truncated file");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // The end of a marker segment whose 2-byte length was just read: the
  // length counts itself, and the segment lies inside the file.
  size_t segment_end() {
    int len = u16();
    if (len < 2 || pos + size_t(len - 2) > size)
      fail("JPEG: bad marker segment length");
    return pos + size_t(len - 2);
  }

  int next_marker() {
    // skip to 0xFF, then any fill 0xFFs; FF 00 is data, not a marker
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return -1;
      int m = data[pos++];
      if (m != 0) return m;
    }
  }

  void read_dqt() {
    size_t stop = segment_end();
    while (pos < stop) {
      int pq = u8(), tq = pq & 15;
      pq >>= 4;
      if (tq > 3) fail("JPEG: bad DQT table index");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = uint16_t(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    pos = stop;
  }

  void read_dht() {
    size_t stop = segment_end();
    while (pos < stop) {
      int tc = u8(), th = tc & 15;
      tc >>= 4;
      if (th > 3 || tc > 1) fail("JPEG: bad DHT table index");
      HuffSpec s{};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += (s.bits[l] = uint8_t(u8()));
      if (total > 256) fail("JPEG: bad Huffman table (more than 256 codes)");
      for (int i = 0; i < total; ++i) s.vals[i] = uint8_t(u8());
      s.nvals = total;
      build_decode_table(s, tc ? &ac[th] : &dc[th]);
    }
    pos = stop;
  }

  void read_app(int m) {
    size_t stop = segment_end();
    size_t start = pos;
    int len = int(stop - start);
    const uint8_t* d = data + start;
    if (m == 0xE0 && len >= 5 && std::memcmp(d, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (m == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    if (m == 0xE1 && len >= 14 && std::memcmp(d, "Exif\0\0", 6) == 0)
      check_orientation(d + 6, len - 6);
    pos = stop;
  }

  // The EXIF orientation of IFD0; anything but 1 raises, since OpenCV would
  // rotate the image.
  void check_orientation(const uint8_t* t, int n) {
    if (n < 8) return;
    bool le = t[0] == 'I' && t[1] == 'I';
    if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
    auto rd16 = [&](int o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](int o) -> uint32_t {
      return le ? (uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                   (uint32_t(t[o + 2]) << 16) | (uint32_t(t[o + 3]) << 24))
                : ((uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                   (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]));
    };
    uint32_t ifd = rd32(4);
    if (ifd + 2 > uint32_t(n)) return;
    int count = rd16(int(ifd));
    for (int i = 0; i < count; ++i) {
      uint32_t e = ifd + 2 + 12 * i;
      if (e + 12 > uint32_t(n)) return;
      if (rd16(int(e)) == 0x0112) {
        int value = rd16(int(e) + 8);
        if (value != 1)
          fail("JPEG: EXIF orientation " + std::to_string(value) +
               " is not supported (OpenCV would rotate the image)");
        return;
      }
    }
  }

  void read_sof(int m) {
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
      fail("JPEG: progressive JPEG is not supported");
    if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
      fail("JPEG: lossless JPEG is not supported");
    if (m >= 0xC9)
      fail("JPEG: arithmetic-coded JPEG is not supported");
    if (m == 0xC5) fail("JPEG: hierarchical JPEG is not supported");
    if (frame_seen) fail("JPEG: more than one frame");
    frame_seen = true;
    u16();
    int precision = u8();
    if (precision != 8)
      fail("JPEG: " + std::to_string(precision) +
           "-bit samples are not supported (8-bit only)");
    f.height = u16();
    f.width = u16();
    f.ncomp = u8();
    if (f.height == 0 || f.width == 0) fail("JPEG: empty image");
    if (int64_t(f.height) * f.width > (int64_t(1) << 30))
      fail("JPEG: more than 2^30 pixels (OpenCV's default limit)");
    if (f.ncomp == 4) fail("JPEG: CMYK JPEG is not supported");
    if (f.ncomp != 1 && f.ncomp != 3)
      fail("JPEG: " + std::to_string(f.ncomp) +
           " components are not supported (1 or 3)");
    for (int i = 0; i < f.ncomp; ++i) {
      Component& c = f.comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("JPEG: bad component in SOF");
      f.hmax = std::max(f.hmax, c.h);
      f.vmax = std::max(f.vmax, c.v);
    }
    if (f.ncomp == 3) {
      const Component& y = f.comp[0];
      int ry = f.hmax / y.h, ryv = f.vmax / y.v;
      bool ok = ry == 1 && ryv == 1;
      for (int i = 1; i < 3 && ok; ++i) {
        const Component& c = f.comp[i];
        if (f.hmax % c.h || f.vmax % c.v) ok = false;
        int rh = f.hmax / c.h, rv = f.vmax / c.v;
        if (!((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
              (rh == 2 && rv == 2)))
          ok = false;
        if (rh != f.hmax / f.comp[1].h || rv != f.vmax / f.comp[1].v)
          ok = false;
      }
      if (!ok)
        fail("JPEG: sampling " + std::to_string(y.h) + "x" +
             std::to_string(y.v) + "," + std::to_string(f.comp[1].h) + "x" +
             std::to_string(f.comp[1].v) + "," + std::to_string(f.comp[2].h) +
             "x" + std::to_string(f.comp[2].v) +
             " is not supported (luma 1x1, 2x1 or 2x2 against 1x1 chroma)");
    }
    f.mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    f.mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    for (int i = 0; i < f.ncomp; ++i) {
      Component& c = f.comp[i];
      c.bw = f.mcux * c.h;
      c.bh = f.mcuy * c.v;
      c.dw = int((int64_t(f.width) * c.h + f.hmax - 1) / f.hmax);
      c.dh = int((int64_t(f.height) * c.v + f.vmax - 1) / f.vmax);
      c.plane.assign(size_t(c.bw) * 8 * size_t(c.bh) * 8, 0);
    }
  }

  void decode_block(BitReader& br, Component& c, int& pred, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const DecodeTable& dct = dc[c.dc_tbl];
    const DecodeTable& act = ac[c.ac_tbl];
    int s = br.decode(dct);
    if (s) {
      if (s > 15) s = 15;
      pred += extend(br.get(s), s);
    }
    coef[0] = int16_t(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, c.quant,
               c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
               stride);
  }

  void read_sos() {
    if (!frame_seen) fail("JPEG: scan before frame header");
    u16();
    int n = u8();
    if (n < 1 || n > 4) fail("JPEG: bad SOS");
    Component* sc[4];
    for (int i = 0; i < n; ++i) {
      int id = u8(), tables = u8();
      Component* c = nullptr;
      for (int j = 0; j < f.ncomp; ++j)
        if (f.comp[j].id == id) c = &f.comp[j];
      if (!c) fail("JPEG: scan names an unknown component");
      c->dc_tbl = tables >> 4;
      c->ac_tbl = tables & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail("JPEG: bad table index");
      if (!dc[c->dc_tbl].defined || !ac[c->ac_tbl].defined)
        fail("JPEG: scan uses an undefined Huffman table");
      if (!qt_defined[c->tq]) fail("JPEG: undefined quantization table");
      std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
      c->seen = true;
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("JPEG: progressive JPEG is not supported");

    BitReader br{data + pos, data + size};
    int preds[4] = {0, 0, 0, 0};
    int restarts_left = restart_interval;
    auto maybe_restart = [&]() {
      if (!restart_interval) return;
      if (restarts_left == 0) {
        br.restart();
        preds[0] = preds[1] = preds[2] = preds[3] = 0;
        restarts_left = restart_interval;
      }
      --restarts_left;
    };
    if (n == 1) {
      Component& c = *sc[0];
      int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          maybe_restart();
          decode_block(br, c, preds[0], bx, by);
        }
    } else {
      for (int my = 0; my < f.mcuy; ++my)
        for (int mx = 0; mx < f.mcux; ++mx) {
          maybe_restart();
          for (int i = 0; i < n; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                decode_block(br, c, preds[i], mx * c.h + h, my * c.v + v);
          }
        }
    }
    // continue after the entropy-coded data
    pos = size_t(br.p - data);
  }

  // Parse the markers; with header_only, stop after the frame header.
  void parse(bool header_only = false) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail("JPEG: not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0 || m == 0xD9) break;
      if (m == 0xDB) read_dqt();
      else if (m == 0xC4) read_dht();
      else if (m == 0xDD) { u16(); restart_interval = u16(); }
      else if (m == 0xCC) fail("JPEG: arithmetic-coded JPEG is not supported");
      else if (m >= 0xC0 && m <= 0xCF) {
        read_sof(m);
        if (header_only) return;
      }
      else if (m == 0xDA) read_sos();
      else if (m >= 0xD0 && m <= 0xD7) continue;
      else if (m == 0xD8 || m == 0x01) continue;
      else if (m >= 0xE0 && m <= 0xEF) read_app(m);
      else pos = segment_end();
    }
    if (!frame_seen) fail("JPEG: no frame header");
    for (int i = 0; i < f.ncomp; ++i)
      if (!f.comp[i].seen) fail("JPEG: a component has no scan");
  }
};

// jdcolor.c's tables.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = int32_t(-fix(0.71414) * x);
      cb_g[i] = int32_t(-fix(0.34414) * x + one_half);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One output row of a chroma plane upsampled by (rh, rv) as jdsample.c does.
void upsample_row(const Component& c, int rh, int rv, int y, int width,
                  uint8_t* out, std::vector<int>& colsum) {
  int stride = c.bw * 8;
  const uint8_t* plane = c.plane.data();
  int dw = c.dw;
  if (rh == 1 && rv == 1) {
    std::memcpy(out, plane + size_t(y) * stride, width);
    return;
  }
  if (rv == 1) {  // h2v1
    const uint8_t* in = plane + size_t(y) * stride;
    if (dw > 2) {
      out[0] = in[0];
      out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int j = 1; j < dw - 1; ++j) {
        int v = in[j] * 3;
        out[2 * j] = uint8_t((v + in[j - 1] + 1) >> 2);
        out[2 * j + 1] = uint8_t((v + in[j + 1] + 2) >> 2);
      }
      int j = dw - 1;
      out[2 * j] = uint8_t((in[j] * 3 + in[j - 1] + 1) >> 2);
      out[2 * j + 1] = in[j];
    } else {
      for (int j = 0; j < dw; ++j) out[2 * j] = out[2 * j + 1] = in[j];
    }
    return;
  }
  // h2v2
  int i = y >> 1;
  if (dw <= 2) {
    const uint8_t* in = plane + size_t(i) * stride;
    for (int j = 0; j < dw; ++j) out[2 * j] = out[2 * j + 1] = in[j];
    return;
  }
  int far = (y & 1) ? std::min(i + 1, c.dh - 1) : std::max(i - 1, 0);
  const uint8_t* in0 = plane + size_t(i) * stride;
  const uint8_t* in1 = plane + size_t(far) * stride;
  int* cs = colsum.data();
  for (int j = 0; j < dw; ++j) cs[j] = in0[j] * 3 + in1[j];
  out[0] = uint8_t((cs[0] * 4 + 8) >> 4);
  out[1] = uint8_t((cs[0] * 3 + cs[1] + 7) >> 4);
  for (int j = 1; j < dw - 1; ++j) {
    int v = cs[j] * 3;
    out[2 * j] = uint8_t((v + cs[j - 1] + 8) >> 4);
    out[2 * j + 1] = uint8_t((v + cs[j + 1] + 7) >> 4);
  }
  int j = dw - 1;
  out[2 * j] = uint8_t((cs[j] * 3 + cs[j - 1] + 8) >> 4);
  out[2 * j + 1] = uint8_t((cs[j] * 4 + 7) >> 4);
}

void color_out(const Frame& f, uint8_t* out) {
  int w = f.width, h = f.height;
  const Component& yc = f.comp[0];
  int ystride = yc.bw * 8;
  if (f.ncomp == 1) {
    for (int y = 0; y < h; ++y) {
      const uint8_t* yr = yc.plane.data() + size_t(y) * ystride;
      uint8_t* o = out + size_t(y) * w * 3;
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yr[x];
    }
    return;
  }
  const Component& cb = f.comp[1];
  const Component& cr = f.comp[2];
  int rh = f.hmax / cb.h, rv = f.vmax / cb.v;
  int wide = std::max(w, 2 * cb.dw) + 16;
  std::vector<uint8_t> cbrow(wide), crrow(wide);
  std::vector<int> colsum(cb.dw + 2);
  for (int y = 0; y < h; ++y) {
    const uint8_t* yr = yc.plane.data() + size_t(y) * ystride;
    upsample_row(cb, rh, rv, y, w, cbrow.data(), colsum);
    upsample_row(cr, rh, rv, y, w, crrow.data(), colsum);
    uint8_t* o = out + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      int yy = yr[x], b = cbrow[x], r = crrow[x];
      o[3 * x + 2] = clamp255(yy + kYcc.cr_r[r]);
      o[3 * x + 1] = clamp255(yy + int((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
      o[3 * x + 0] = clamp255(yy + kYcc.cb_b[b]);
    }
  }
}

// ----------------------------------------------------------------- encoding

const uint8_t kStdLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jpeg_quality_scaling + jpeg_add_quant_table(force_baseline = TRUE).
void scaled_quant(const uint8_t* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(basic[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;
    out[i] = uint16_t(t);
  }
}

// jcdctmgr.c's compute_reciprocal with 16-bit DCT elements (the SIMD build).
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor compute_reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{fq & 0xFFFF, c & 0xFFFF, r - 16};
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((uint32_t(1) << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      uint8_t byte = uint8_t(buf >> nbits);
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
    }
  }
  void flush() {  // pad the last byte with ones
    if (nbits) put(0x7F, 8 - nbits);
  }
};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
};

EncTable make_enc(const HuffSpec& s) {
  EncTable t{};
  canonical_codes(s, t.code, t.size);
  return t;
}

inline int nbits_of(int v) {
  return v ? 32 - __builtin_clz(uint32_t(v)) : 0;
}

void encode_block(BitWriter& bw, const int16_t* q, int& last_dc,
                  const EncTable& dct, const EncTable& act) {
  int t = q[0] - last_dc;
  last_dc = q[0];
  int t2 = t;
  if (t < 0) {
    t = -t;
    --t2;
  }
  int nb = nbits_of(t);
  bw.put(dct.code[nb], dct.size[nb]);
  if (nb) bw.put(uint32_t(t2), nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    int v = q[kNatural[k]];
    if (v == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      r -= 16;
    }
    int a = v, a2 = v;
    if (a < 0) {
      a = -a;
      --a2;
    }
    nb = nbits_of(a);
    int sym = (r << 4) + nb;
    bw.put(act.code[sym], act.size[sym]);
    bw.put(uint32_t(a2), nb);
    r = 0;
  }
  if (r > 0) bw.put(act.code[0], act.size[0]);
}

// FDCT and quantize one 8x8 block of samples (stride `stride`).
void fdct_quant_block(const uint8_t* src, int stride, const Divisor* div,
                      int16_t* out) {
  int32_t ws[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) ws[8 * r + c] = int(src[r * stride + c]) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int t = int16_t(ws[i]);
    const Divisor& d = div[i];
    bool neg = t < 0;
    if (neg) t = -t;
    uint32_t product = uint32_t(t + int(d.corr)) * d.recip;
    product >>= d.shift + 16;
    int16_t v = int16_t(product);
    out[i] = neg ? int16_t(-v) : v;
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

void emit_dqt(std::vector<uint8_t>& o, int index, const uint16_t* q) {
  o.push_back(0xFF);
  o.push_back(0xDB);
  put16(o, 67);
  o.push_back(uint8_t(index));
  for (int k = 0; k < 64; ++k) o.push_back(uint8_t(q[kNatural[k]]));
}

void emit_dht(std::vector<uint8_t>& o, int cls_index, const HuffSpec& s) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + s.nvals);
  o.push_back(uint8_t(cls_index));
  for (int l = 1; l <= 16; ++l) o.push_back(s.bits[l]);
  for (int i = 0; i < s.nvals; ++i) o.push_back(s.vals[i]);
}

// jccolor.c's rgb_ycc tables: Y from R, G, B at 0, 256, 512; Cb at 768,
// 1024, 1280; Cr at 1280 (= Cb's B table), 1536, 1792.
struct RgbYccTables {
  int32_t t[8 * 256];
  RgbYccTables() {
    auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
    const int32_t one_half = 1 << 15, cbcr_off = 128 << 16;
    for (int i = 0; i < 256; ++i) {
      t[i] = fix(0.29900) * i;
      t[i + 256] = fix(0.58700) * i;
      t[i + 512] = fix(0.11400) * i + one_half;
      t[i + 768] = -fix(0.16874) * i;
      t[i + 1024] = -fix(0.33126) * i;
      t[i + 1280] = fix(0.50000) * i + cbcr_off + one_half - 1;
      t[i + 1536] = -fix(0.41869) * i;
      t[i + 1792] = -fix(0.08131) * i;
    }
  }
};
const RgbYccTables kRgbYcc;

// A component plane padded as jcprepct.c / jcsample.c pad it.
struct Plane {
  int w, h;  // allocated: a whole number of blocks of the component's MCU
  std::vector<uint8_t> px;
};

std::vector<uint8_t> encode(const uint8_t* img, int height, int width,
                            int channels, int quality) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535)
    fail("JPEG: image size out of range");
  if (channels != 1 && channels != 3)
    fail("JPEG: encoder takes 1 or 3 channels");
  const bool color = channels == 3;
  const int hmax = color ? 2 : 1, vmax = color ? 2 : 1;
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);

  // Full-resolution planes: Y (or gray) and, in colour, Cb and Cr.
  int full_w = mcux * 8 * hmax, full_h = mcuy * 8 * vmax;
  std::vector<uint8_t> full[3];
  int ncomp = color ? 3 : 1;
  for (int c = 0; c < ncomp; ++c) full[c].assign(size_t(full_w) * full_h, 0);
  if (color) {
    const int32_t* tab = kRgbYcc.t;
    for (int y = 0; y < height; ++y) {
      const uint8_t* row = img + size_t(y) * width * 3;
      uint8_t* o0 = full[0].data() + size_t(y) * full_w;
      uint8_t* o1 = full[1].data() + size_t(y) * full_w;
      uint8_t* o2 = full[2].data() + size_t(y) * full_w;
      for (int x = 0; x < width; ++x) {
        int b = row[3 * x], g = row[3 * x + 1], r = row[3 * x + 2];
        o0[x] = uint8_t((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
        o1[x] = uint8_t((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
        o2[x] = uint8_t((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
      }
    }
  } else {
    for (int y = 0; y < height; ++y)
      std::memcpy(full[0].data() + size_t(y) * full_w, img + size_t(y) * width,
                  width);
  }
  // replicate the right column and the bottom row of the image
  for (int c = 0; c < ncomp; ++c) {
    uint8_t* p = full[c].data();
    for (int y = 0; y < height; ++y) {
      uint8_t* row = p + size_t(y) * full_w;
      std::memset(row + width, row[width - 1], full_w - width);
    }
    for (int y = height; y < full_h; ++y)
      std::memcpy(p + size_t(y) * full_w, p + size_t(height - 1) * full_w,
                  full_w);
  }

  // Luma keeps full resolution; chroma is box-downsampled 2x2 with the bias
  // 1, 2, 1, 2 along each row (jcsample.c h2v2_downsample). The padded
  // full-resolution rows replicate the last image row, so the downsampled
  // rows past the image equal what jcprepct.c's bottom padding gives.
  Plane planes[3];
  planes[0].w = full_w;
  planes[0].h = full_h;
  planes[0].px = std::move(full[0]);
  for (int c = 1; c < ncomp; ++c) {
    Plane& p = planes[c];
    p.w = full_w / 2;
    p.h = full_h / 2;
    p.px.assign(size_t(p.w) * p.h, 0);
    const uint8_t* s = full[c].data();
    for (int y = 0; y < p.h; ++y) {
      const uint8_t* r0 = s + size_t(2 * y) * full_w;
      const uint8_t* r1 = r0 + full_w;
      uint8_t* o = p.px.data() + size_t(y) * p.w;
      int bias = 1;
      for (int x = 0; x < p.w; ++x) {
        o[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] +
                        bias) >> 2);
        bias ^= 3;
      }
    }
  }
  // jcprepct.c pads the downsampled rows to the iMCU height by replicating
  // the last downsampled row: chroma row ceil(H/2)-1 for rows past it.
  if (color) {
    int dh = (height + 1) / 2;
    for (int c = 1; c < 3; ++c) {
      Plane& p = planes[c];
      for (int y = dh; y < p.h; ++y)
        std::memcpy(p.px.data() + size_t(y) * p.w,
                    p.px.data() + size_t(dh - 1) * p.w, p.w);
    }
    // the chroma columns past ceil(W/2) came from replicated full-res
    // columns: box sums of equal pairs, which is what expand_right_edge
    // before the downsample gives; nothing more to pad.
  }

  uint16_t qlum[64], qchrom[64];
  scaled_quant(kStdLumQuant, quality, qlum);
  scaled_quant(kStdChromQuant, quality, qchrom);
  Divisor dlum[64], dchrom[64];
  for (int i = 0; i < 64; ++i) {
    dlum[i] = compute_reciprocal(uint32_t(qlum[i]) << 3);
    dchrom[i] = compute_reciprocal(uint32_t(qchrom[i]) << 3);
  }

  HuffSpec dcl = make_spec(kDcLumBits, kDcVals, 12);
  HuffSpec acl = make_spec(kAcLumBits, kAcLumVals, 162);
  HuffSpec dcc = make_spec(kDcChromBits, kDcVals, 12);
  HuffSpec acc = make_spec(kAcChromBits, kAcChromVals, 162);
  EncTable edcl = make_enc(dcl), eacl = make_enc(acl);
  EncTable edcc = make_enc(dcc), eacc = make_enc(acc);

  std::vector<uint8_t> o;
  o.reserve(size_t(width) * height / 2 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I',
                          'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00,
                          0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof(head));
  emit_dqt(o, 0, qlum);
  if (color) emit_dqt(o, 1, qchrom);
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back(uint8_t(ncomp));
  o.push_back(1);
  o.push_back(color ? 0x22 : 0x11);
  o.push_back(0);
  if (color) {
    const uint8_t rest[] = {2, 0x11, 1, 3, 0x11, 1};
    o.insert(o.end(), rest, rest + 6);
  }
  emit_dht(o, 0x00, dcl);
  emit_dht(o, 0x10, acl);
  if (color) {
    emit_dht(o, 0x01, dcc);
    emit_dht(o, 0x11, acc);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * ncomp);
  o.push_back(uint8_t(ncomp));
  o.push_back(1);
  o.push_back(0x00);
  if (color) {
    const uint8_t rest[] = {2, 0x11, 3, 0x11};
    o.insert(o.end(), rest, rest + 4);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  int last[3] = {0, 0, 0};
  int16_t q[4][64];
  if (!color) {
    int bwid = (width + 7) / 8, bhgt = (height + 7) / 8;
    for (int by = 0; by < bhgt; ++by)
      for (int bx = 0; bx < bwid; ++bx) {
        fdct_quant_block(planes[0].px.data() + size_t(by) * 8 * planes[0].w +
                             bx * 8,
                         planes[0].w, dlum, q[0]);
        encode_block(bw, q[0], last[0], edcl, eacl);
      }
  } else {
    // luma blocks that hold image samples; the rest of an MCU are dummy
    // blocks: zero AC, the DC of the block before (jccoefct.c)
    int ybw = (width + 7) / 8, ybh = (height + 7) / 8;
    const Plane& yp = planes[0];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        int blk = 0;
        for (int v = 0; v < 2; ++v)
          for (int h = 0; h < 2; ++h, ++blk) {
            int bx = mx * 2 + h, by = my * 2 + v;
            if (by < ybh && bx < ybw) {
              fdct_quant_block(yp.px.data() + size_t(by) * 8 * yp.w + bx * 8,
                               yp.w, dlum, q[blk]);
            } else {
              std::memset(q[blk], 0, sizeof(q[blk]));
              q[blk][0] = q[blk - 1][0];
            }
          }
        for (int b = 0; b < 4; ++b) encode_block(bw, q[b], last[0], edcl, eacl);
        for (int c = 1; c < 3; ++c) {
          const Plane& p = planes[c];
          fdct_quant_block(p.px.data() + size_t(my) * 8 * p.w + mx * 8, p.w,
                           dchrom, q[0]);
          encode_block(bw, q[0], last[c], edcc, eacc);
        }
      }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace

extern "C" {

const char* jpeg_last_error() { return g_error.c_str(); }

// Size and components of a JPEG: 0, or -1 with jpeg_last_error().
int jpeg_info(const uint8_t* data, size_t size, int* height, int* width,
              int* components) {
  try {
    Decoder d(data, size);
    d.parse(true);
    *height = d.f.height;
    *width = d.f.width;
    *components = d.f.ncomp;
    return 0;
  } catch (const JpegError& e) {
    g_error = e.msg;
    return -1;
  } catch (const std::bad_alloc&) {
    g_error = "JPEG: out of memory";
    return -1;
  }
}

// Decode into out, an (height, width, 3) uint8 BGR buffer of the size that
// jpeg_info gave: 0, or -1 with jpeg_last_error().
int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int height,
                int width) {
  try {
    Decoder d(data, size);
    d.parse();
    if (d.f.height != height || d.f.width != width)
      fail("JPEG: output buffer does not match the image size");
    if (d.f.ncomp == 3) {
      if (d.saw_adobe && !d.saw_jfif && d.adobe_transform == 0)
        fail("JPEG: RGB-coded JPEG (Adobe transform 0) is not supported");
      if (!d.saw_jfif && !d.saw_adobe && d.f.comp[0].id == 82 &&
          d.f.comp[1].id == 71 && d.f.comp[2].id == 66)
        fail("JPEG: RGB-coded JPEG (component ids R, G, B) is not supported");
    }
    color_out(d.f, out);
    return 0;
  } catch (const JpegError& e) {
    g_error = e.msg;
    return -1;
  } catch (const std::bad_alloc&) {
    g_error = "JPEG: out of memory";
    return -1;
  }
}

// Encode an (height, width, channels) uint8 image (BGR, or gray for 1
// channel) at `quality`. Returns the byte count and sets *out to a buffer
// that jpeg_free releases, or -1 with jpeg_last_error().
long jpeg_encode(const uint8_t* img, int height, int width, int channels,
                 int quality, uint8_t** out) {
  try {
    std::vector<uint8_t> bytes = encode(img, height, width, channels, quality);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!buf) fail("JPEG: out of memory");
    std::memcpy(buf, bytes.data(), bytes.size());
    *out = buf;
    return long(bytes.size());
  } catch (const JpegError& e) {
    g_error = e.msg;
    return -1;
  } catch (const std::bad_alloc&) {
    g_error = "JPEG: out of memory";
    return -1;
  }
}

void jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
