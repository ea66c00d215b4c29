// Host-only JPEG codec of raft_tpu_torch: no libjpeg, only the JPEG
// specification (ITU-T T.81) and the arithmetic of libjpeg-turbo's default
// paths, which is what OpenCV's imdecode and imencode run.  Built with the
// host C++ compiler by raft_tpu_torch/_build.py and bound with ctypes in
// raft_tpu_torch/imageio.py.
//
// Decode returns what cv2.imdecode(data, IMREAD_COLOR) returns, bitwise:
// [H, W, 3] BGR, gray replicated, the EXIF orientation applied.  It reads
// baseline, extended (SOF1) and progressive (SOF2) Huffman files of 8-bit
// precision with 1 or 3 components (YCbCr, or RGB under Adobe's transform
// 0), any integral sampling factors, restart intervals, EOB runs and
// refinement scans.  Stage by stage it is libjpeg-turbo's default decode:
// the JDCT_ISLOW inverse DCT (jidctint.c) with its range limit, "fancy"
// triangle upsampling for h2v1, h1v2 and h2v2 (jdsample.c), replication for
// any other factor, and the fixed-point YCbCr->RGB tables of jdcolor.c.  A
// progressive file is decoded without block smoothing (libjpeg smooths only
// when low AC coefficients were never sent).  Arithmetic coding, 12-bit
// samples, lossless and hierarchical files and 4-component CMYK/YCCK are
// refused with an error naming the feature.
//
// Encode writes what cv2.imencode(".jpg", image, [IMWRITE_JPEG_QUALITY, q])
// writes, byte for byte: JFIF APP0, the DQTs scaled by jpeg_quality_scaling
// and clamped to [1, 255], SOF0 at 4:2:0 (gray: one component), the four
// standard Huffman tables, one interleaved scan, 1-bit padding.  Its
// arithmetic is jccolor.c's RGB->YCbCr, jcsample.c's h2v2 downsampling with
// its alternating bias, edge replication to whole MCUs, jfdctint.c's
// forward DCT and jcdctmgr.c's reciprocal quantisation.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void raise(const std::string& msg) { throw Error{msg}; }

int report(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
  return -1;
}

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ----------------------------------------------------------------- the DCTs

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

inline int32_t descale(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

// jidctint.c's post-IDCT range limit: the value wraps modulo 1024 as a
// signed 10-bit number, then is clamped to [0, 255] around 128.
inline uint8_t idct_limit(int32_t x) {
  int32_t t = x & 1023;
  t = (t ^ 512) - 512;
  t += 128;
  return uint8_t(t < 0 ? 0 : (t > 255 ? 255 : t));
}

// jpeg_idct_islow: coef (natural order) * quant -> 8x8 samples.
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int32_t dc = (int32_t(in[0]) * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = int32_t(in[16]) * q[16], z3 = int32_t(in[48]) * q[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(in[0]) * q[0];
    z3 = int32_t(in[32]) * q[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * q[56];
    tmp1 = int32_t(in[40]) * q[40];
    tmp2 = int32_t(in[24]) * q[24];
    tmp3 = int32_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + size_t(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// jpeg_fdct_islow on samples already centred on 0 (libjpeg-turbo's convsamp
// subtracts 128 first); the output is scaled up by 8.
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; r++) {
    int32_t* p = d + 8 * r;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits - kPass1Bits;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, n);
    p[6] = descale(z1 + tmp12 * (-FIX_1_847759065), n);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    p[7] = descale(tmp4 + z1 + z3, n);
    p[5] = descale(tmp5 + z2 + z4, n);
    p[3] = descale(tmp6 + z2 + z3, n);
    p[1] = descale(tmp7 + z1 + z4, n);
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, kPass1Bits);
    p[32] = descale(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits + kPass1Bits;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, n);
    p[48] = descale(z1 + tmp12 * (-FIX_1_847759065), n);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    p[56] = descale(tmp4 + z1 + z3, n);
    p[40] = descale(tmp5 + z2 + z4, n);
    p[24] = descale(tmp6 + z2 + z3, n);
    p[8] = descale(tmp7 + z1 + z4, n);
  }
}

// ------------------------------------------------------------ Huffman tables

struct HuffSpec {
  uint8_t bits[17];      // bits[k]: number of codes of length k (1..16)
  uint8_t vals[256];
  int nvals;
};

constexpr uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                     1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                     5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumaVals[162] = {
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
constexpr uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                       7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromaVals[162] = {
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

HuffSpec make_spec(const uint8_t* bits, const uint8_t* vals) {
  HuffSpec s{};
  std::memcpy(s.bits, bits, 17);
  s.nvals = 0;
  for (int k = 1; k <= 16; k++) s.nvals += bits[k];
  std::memcpy(s.vals, vals, size_t(s.nvals));
  return s;
}

HuffSpec dc_spec(bool chroma) {
  static const uint8_t v[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
  return make_spec(chroma ? kDcChromaBits : kDcLumaBits, v);
}

HuffSpec ac_spec(bool chroma) {
  return chroma ? make_spec(kAcChromaBits, kAcChromaVals)
                : make_spec(kAcLumaBits, kAcLumaVals);
}

// Canonical decoding table (T.81 Annex C and F.2.2.3).
struct HuffDec {
  static constexpr int kLook = 9;   // codes this long or shorter: one lookup
  bool defined = false;
  int32_t mincode[17], maxcode[18], valptr[17];
  uint8_t vals[256];
  uint16_t lookup[1 << kLook];      // (length << 8) | value, 0 for longer codes
  void build(const HuffSpec& s) {
    int code = 0, k = 0;
    std::memset(lookup, 0, sizeof(lookup));
    for (int len = 1; len <= 16; len++) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < s.bits[len]; i++, code++, k++)
        if (len <= kLook) {
          int lo = code << (kLook - len), hi = (code + 1) << (kLook - len);
          for (int c = lo; c < hi && c < (1 << kLook); c++)
            lookup[c] = uint16_t((len << 8) | s.vals[k]);
        }
      maxcode[len] = s.bits[len] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memcpy(vals, s.vals, 256);
    defined = true;
  }
};

// ------------------------------------------------------------------ decode

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;            // blocks allocated (whole MCUs)
  int bw_real = 0, bh_real = 0;  // blocks that cover the component
  int dw = 0, dh = 0;            // downsampled width and height
  bool latched = false;
  uint16_t quant[64] = {};
  std::vector<int16_t> coef;     // bw * bh blocks, natural order
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}
  size_t pos() const { return pos_; }
  // the next k (<= 24) bits, without consuming them
  uint32_t peek(int k) {
    if (cnt_ < k) fill();
    return uint32_t(buf_ >> (cnt_ - k)) & ((1u << k) - 1);
  }
  void skip(int k) { cnt_ -= k; }
  int bit() { return int(bits(1)); }
  int bits(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    cnt_ -= k;
    return int(v);
  }
  // Discards the bits left in the current byte and the restart marker
  // that must follow them.
  void restart() {
    cnt_ = 0;
    buf_ = 0;
    marker_ = false;
    while (pos_ + 1 < n_) {
      if (d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) {
        pos_ += 2;
        return;
      }
      pos_++;
    }
    raise("truncated data: a restart marker is missing");
  }

 private:
  // tops the buffer up to at least 25 bits; past a marker (or the end of
  // the data) it feeds zeros, as libjpeg does
  void fill() {
    while (cnt_ <= 24) {
      uint32_t b = 0;
      if (!marker_ && pos_ < n_) {
        b = d_[pos_];
        if (b == 0xFF) {
          uint8_t nb = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (nb == 0x00) {
            pos_ += 2;
          } else if (nb == 0xFF) {
            pos_++;          // a fill byte
            continue;
          } else {
            marker_ = true;
            b = 0;
          }
        } else {
          pos_++;
        }
      }
      buf_ = (buf_ << 8) | b;
      cnt_ += 8;
    }
  }
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  bool marker_ = false;
};

int decode_symbol(BitReader& br, const HuffDec& t) {
  if (!t.defined) raise("a scan uses an undefined Huffman table");
  uint32_t look = br.peek(HuffDec::kLook);
  uint16_t e = t.lookup[look];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  uint32_t code16 = br.peek(16);
  for (int len = HuffDec::kLook + 1; len <= 16; len++) {
    int32_t code = int32_t(code16 >> (16 - len));
    if (code <= t.maxcode[len]) {
      br.skip(len);
      return t.vals[t.valptr[len] + code - t.mincode[len]];
    }
  }
  raise("corrupt Huffman code");
}

inline int extend(int v, int s) {
  return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v);
}

struct Frame {
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
};

struct Decoder {
  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}
  const uint8_t* d;
  size_t n;
  Frame f;
  bool have_frame = false, jfif = false, adobe = false, exif_seen = false;
  int adobe_transform = -1, orientation = 1, restart_interval = 0;
  int eobrun = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];

  uint16_t be16(size_t p) const {
    if (p + 2 > n) raise("truncated file");
    return uint16_t((d[p] << 8) | d[p + 1]);
  }

  void parse_exif(size_t p, size_t len) {
    if (len < 14 || std::memcmp(d + p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = d + p + 6;
    size_t tn = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto u16 = [&](size_t o) -> uint32_t {
      return le ? uint32_t(t[o] | (t[o + 1] << 8))
                : uint32_t((t[o] << 8) | t[o + 1]);
    };
    auto u32 = [&](size_t o) -> uint32_t {
      return le ? uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                      (uint32_t(t[o + 2]) << 16) | (uint32_t(t[o + 3]) << 24)
                : (uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                      (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]);
    };
    if (u16(2) != 42) return;
    size_t ifd = u32(4);
    if (ifd + 2 > tn) return;
    size_t count = u16(ifd);
    for (size_t i = 0; i < count; i++) {
      size_t e = ifd + 2 + 12 * i;
      if (e + 12 > tn) return;
      if (u16(e) == 0x0112) {
        uint32_t value = u16(e + 8);
        if (value >= 1 && value <= 8) orientation = int(value);
        return;
      }
    }
  }

  void parse_sof(size_t p, size_t len, int marker) {
    if (have_frame) raise("more than one frame");
    if (len < 8) raise("corrupt SOF marker");
    int precision = d[p];
    f.height = be16(p + 1);
    f.width = be16(p + 3);
    f.ncomp = d[p + 5];
    f.progressive = marker == 0xC2;
    if (precision != 8)
      raise(std::to_string(precision) + "-bit samples are not supported "
            "(8-bit only)");
    if (f.ncomp == 4)
      raise("4-component (CMYK/YCCK) JPEG is not supported");
    if (f.ncomp != 1 && f.ncomp != 3)
      raise(std::to_string(f.ncomp) + "-component JPEG is not supported");
    if (f.width <= 0 || f.height <= 0)
      raise("zero-sized frame (a DNL marker is not supported)");
    if (len < size_t(6 + 3 * f.ncomp)) raise("corrupt SOF marker");
    for (int i = 0; i < f.ncomp; i++) {
      Component& c = f.comp[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        raise("corrupt SOF component");
      f.hmax = std::max(f.hmax, c.h);
      f.vmax = std::max(f.vmax, c.v);
    }
    f.mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    f.mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    for (int i = 0; i < f.ncomp; i++) {
      Component& c = f.comp[i];
      c.dw = int((int64_t(f.width) * c.h + f.hmax - 1) / f.hmax);
      c.dh = int((int64_t(f.height) * c.v + f.vmax - 1) / f.vmax);
      c.bw_real = (c.dw + 7) / 8;
      c.bh_real = (c.dh + 7) / 8;
      c.bw = f.mcux * c.h;
      c.bh = f.mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    have_frame = true;
  }

  void parse_dqt(size_t p, size_t len) {
    size_t end = p + len;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3) raise("corrupt DQT marker");
      p++;
      for (int k = 0; k < 64; k++) {
        uint16_t v;
        if (pq) {
          v = be16(p);
          p += 2;
        } else {
          if (p >= end) raise("corrupt DQT marker");
          v = d[p++];
        }
        qt[tq][kZigzag[k]] = v;
      }
      qt_defined[tq] = true;
    }
  }

  void parse_dht(size_t p, size_t len) {
    size_t end = p + len;
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3 || p + 17 > end) raise("corrupt DHT marker");
      HuffSpec s{};
      s.nvals = 0;
      for (int k = 1; k <= 16; k++) {
        s.bits[k] = d[p + k];
        s.nvals += s.bits[k];
      }
      p += 17;
      if (s.nvals > 256 || p + size_t(s.nvals) > end)
        raise("corrupt DHT marker");
      std::memcpy(s.vals, d + p, size_t(s.nvals));
      p += size_t(s.nvals);
      (tc ? ac[th] : dc[th]).build(s);
    }
  }

  // One scan; returns the position where marker parsing resumes.
  size_t scan(size_t p, size_t len) {
    if (!have_frame) raise("SOS before SOF");
    int ns = d[p];
    if (ns < 1 || ns > 4 || len < size_t(4 + 2 * ns)) raise("corrupt SOS");
    Component* cs[4];
    for (int i = 0; i < ns; i++) {
      int id = d[p + 1 + 2 * i], tables = d[p + 2 + 2 * i];
      Component* c = nullptr;
      for (int k = 0; k < f.ncomp; k++)
        if (f.comp[k].id == id) c = &f.comp[k];
      if (!c) raise("a scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3) raise("corrupt SOS");
      if (!c->latched) {
        if (!qt_defined[c->tq]) raise("a component's DQT is missing");
        std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->latched = true;
      }
      cs[i] = c;
    }
    size_t q = p + 1 + 2 * ns;
    int ss = d[q], se = d[q + 1], ah = d[q + 2] >> 4, al = d[q + 2] & 15;
    if (!f.progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss == 0 && se != 0) ||
               (ss > 0 && ns != 1) || al > 13) {
      raise("corrupt progressive scan parameters");
    }
    BitReader br(d, n, p + len);
    eobrun = 0;
    int pred[4] = {0, 0, 0, 0};
    int restarts_left = restart_interval;
    auto unit_done = [&]() {
      if (restart_interval == 0) return;
      if (--restarts_left == 0) {
        br.restart();
        restarts_left = restart_interval;
        eobrun = 0;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
    };
    auto block = [&](int i, int bx, int by) {
      Component& c = *cs[i];
      int16_t* b = &c.coef[(size_t(by) * c.bw + bx) * 64];
      if (!f.progressive) {
        decode_sequential(br, c, b, pred[i]);
      } else if (ss == 0) {
        if (ah == 0) {
          int s = decode_symbol(br, dc[c.td]);
          if (s > 15) raise("corrupt DC coefficient");
          int diff = extend(br.bits(s), s);
          pred[i] += diff;
          b[0] = int16_t(uint32_t(pred[i]) << al);
        } else if (br.bit()) {
          b[0] = int16_t(b[0] | (1 << al));
        }
      } else if (ah == 0) {
        decode_ac_first(br, c, b, ss, se, al);
      } else {
        decode_ac_refine(br, c, b, ss, se, al);
      }
    };
    if (ns == 1) {
      Component& c = *cs[0];
      int total = c.bw_real * c.bh_real, done = 0;
      for (int by = 0; by < c.bh_real; by++)
        for (int bx = 0; bx < c.bw_real; bx++) {
          block(0, bx, by);
          if (++done < total) unit_done();
        }
    } else {
      int total = f.mcux * f.mcuy, done = 0;
      for (int my = 0; my < f.mcuy; my++)
        for (int mx = 0; mx < f.mcux; mx++) {
          for (int i = 0; i < ns; i++) {
            Component& c = *cs[i];
            for (int yy = 0; yy < c.v; yy++)
              for (int xx = 0; xx < c.h; xx++)
                block(i, mx * c.h + xx, my * c.v + yy);
          }
          if (++done < total) unit_done();
        }
    }
    // resume at the next marker that is not a restart marker
    size_t r = br.pos();
    while (r + 1 < n) {
      if (d[r] == 0xFF && d[r + 1] != 0x00 && d[r + 1] != 0xFF &&
          !(d[r + 1] >= 0xD0 && d[r + 1] <= 0xD7))
        return r;
      r++;
    }
    return n;
  }

  void decode_sequential(BitReader& br, Component& c, int16_t* b, int& pred) {
    int s = decode_symbol(br, dc[c.td]);
    if (s > 15) raise("corrupt DC coefficient");
    pred += extend(br.bits(s), s);
    b[0] = int16_t(pred);
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(br, ac[c.ta]);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) raise("corrupt AC coefficients");
        b[kZigzag[k]] = int16_t(extend(br.bits(s), s));
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void decode_ac_first(BitReader& br, Component& c, int16_t* b, int ss,
                       int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = decode_symbol(br, ac[c.ta]);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) raise("corrupt AC coefficients");
        b[kZigzag[k]] = int16_t(uint32_t(extend(br.bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        eobrun--;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, Component& c, int16_t* b, int ss,
                        int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0)
        coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode_symbol(br, ac[c.ta]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t& coef = b[kZigzag[k]];
          if (coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) {
          if (k > 63) raise("corrupt AC refinement");
          b[kZigzag[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& coef = b[kZigzag[k]];
        if (coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) raise("not a JPEG file");
    size_t p = 2;
    bool scanned = false;
    while (true) {
      while (p < n && d[p] != 0xFF) p++;   // tolerate garbage between markers
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) {
        if (scanned) return;             // a missing EOI, as libjpeg allows
        raise("truncated file: no scan");
      }
      int m = d[p++];
      if (m == 0xD9) {
        if (!scanned) raise("no scan before EOI");
        return;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      size_t len = be16(p);
      if (len < 2 || p + len > n) raise("truncated marker segment");
      size_t body = p + 2, blen = len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          parse_sof(body, blen, m);
          break;
        case 0xC3:
          raise("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7:
          raise("hierarchical JPEG is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          raise("arithmetic-coded JPEG is not supported");
        case 0xCC:
          raise("arithmetic-coded JPEG (DAC marker) is not supported");
        case 0xC4:
          parse_dht(body, blen);
          break;
        case 0xDB:
          parse_dqt(body, blen);
          break;
        case 0xDD:
          if (blen < 2) raise("corrupt DRI marker");
          restart_interval = be16(body);
          break;
        case 0xDA:
          p = scan(body, blen);
          scanned = true;
          continue;
        case 0xE0:
          if (blen >= 5 && std::memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xE1:
          if (!exif_seen && blen >= 6 &&
              std::memcmp(d + body, "Exif\0\0", 6) == 0) {
            exif_seen = true;     // OpenCV reads the first Exif block only
            parse_exif(body, blen);
          }
          break;
        case 0xEE:
          if (blen >= 12 && std::memcmp(d + body, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[body + 11];
          }
          break;
        default:
          break;
      }
      p += len;
    }
  }

  // component plane after the inverse DCT: bw*8 x bh*8 samples
  std::vector<uint8_t> plane(const Component& c) const {
    size_t stride = size_t(c.bw) * 8;
    std::vector<uint8_t> out(stride * size_t(c.bh) * 8);
    for (int by = 0; by < c.bh_real; by++)
      for (int bx = 0; bx < c.bw_real; bx++)
        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                   &out[size_t(by) * 8 * stride + size_t(bx) * 8],
                   int(stride));
    return out;
  }

  // One component upsampled to the full frame (width x height).
  std::vector<uint8_t> upsample(const Component& c) const {
    const size_t stride = size_t(c.bw) * 8;
    std::vector<uint8_t> src = plane(c);
    const int W = f.width, H = f.height;
    std::vector<uint8_t> out(size_t(W) * H);
    if (f.hmax % c.h || f.vmax % c.v)
      raise("non-integral sampling factors are not supported");
    const int fh = f.hmax / c.h, fv = f.vmax / c.v;
    const int dw = c.dw, dh = c.dh;
    auto row = [&](int y) -> const uint8_t* {   // edge rows replicated
      y = std::min(std::max(y, 0), dh - 1);
      return &src[size_t(y) * stride];
    };
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < H; y++)
        std::memcpy(&out[size_t(y) * W], row(y), size_t(W));
    } else if (fh == 2 && fv == 1) {
      std::vector<uint8_t> line(size_t(2) * dw);
      for (int y = 0; y < H; y++) {
        const uint8_t* in = row(y);
        if (dw > 2) {
          line[0] = in[0];
          line[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; x++) {
            int v = in[x] * 3;
            line[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
            line[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
          }
          line[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          line[2 * dw - 1] = in[dw - 1];
        } else {
          for (int x = 0; x < 2 * dw; x++) line[x] = in[x / 2];
        }
        std::memcpy(&out[size_t(y) * W], line.data(), size_t(W));
      }
    } else if (fh == 1 && fv == 2) {
      for (int y = 0; y < H; y++) {
        int iy = y / 2;
        const uint8_t* near = row(iy);
        const uint8_t* far = row(y % 2 == 0 ? iy - 1 : iy + 1);
        int bias = y % 2 == 0 ? 1 : 2;
        uint8_t* o = &out[size_t(y) * W];
        for (int x = 0; x < W; x++)
          o[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
      }
    } else if (fh == 2 && fv == 2 && dw > 2) {
      std::vector<int> sum(static_cast<size_t>(dw));
      std::vector<uint8_t> line(size_t(2) * dw);
      for (int y = 0; y < H; y++) {
        int iy = y / 2;
        const uint8_t* near = row(iy);
        const uint8_t* far = row(y % 2 == 0 ? iy - 1 : iy + 1);
        for (int x = 0; x < dw; x++) sum[x] = near[x] * 3 + far[x];
        line[0] = uint8_t((sum[0] * 4 + 8) >> 4);
        line[1] = uint8_t((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; x++) {
          line[2 * x] = uint8_t((sum[x] * 3 + sum[x - 1] + 8) >> 4);
          line[2 * x + 1] = uint8_t((sum[x] * 3 + sum[x + 1] + 7) >> 4);
        }
        line[2 * dw - 2] = uint8_t((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
        line[2 * dw - 1] = uint8_t((sum[dw - 1] * 4 + 7) >> 4);
        std::memcpy(&out[size_t(y) * W], line.data(), size_t(W));
      }
    } else {
      // libjpeg's int_upsample (and h2v2_upsample): replication
      for (int y = 0; y < H; y++) {
        const uint8_t* in = row(y / fv);
        uint8_t* o = &out[size_t(y) * W];
        for (int x = 0; x < W; x++) o[x] = in[x / fh];
      }
    }
    return out;
  }

  // [H, W, 3] BGR
  void render(uint8_t* bgr) {
    const size_t npix = size_t(f.width) * f.height;
    if (f.ncomp == 1) {
      std::vector<uint8_t> y = upsample(f.comp[0]);
      for (size_t i = 0; i < npix; i++)
        bgr[3 * i] = bgr[3 * i + 1] = bgr[3 * i + 2] = y[i];
      return;
    }
    std::vector<uint8_t> c0 = upsample(f.comp[0]);
    std::vector<uint8_t> c1 = upsample(f.comp[1]);
    std::vector<uint8_t> c2 = upsample(f.comp[2]);
    bool rgb;
    if (jfif) {
      rgb = false;
    } else if (adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = f.comp[0].id == 82 && f.comp[1].id == 71 && f.comp[2].id == 66;
    }
    if (rgb) {
      for (size_t i = 0; i < npix; i++) {
        bgr[3 * i] = c2[i];
        bgr[3 * i + 1] = c1[i];
        bgr[3 * i + 2] = c0[i];
      }
      return;
    }
    // jdcolor.c: build_ycc_rgb_table
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < npix; i++) {
      int y = c0[i], cb = c1[i], cr = c2[i];
      bgr[3 * i + 2] = clamp(y + cr_r[cr]);
      bgr[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> kScale));
      bgr[3 * i] = clamp(y + cb_b[cb]);
    }
  }

  // output size after the EXIF orientation
  void out_size(int* h, int* w) const {
    bool swap = orientation >= 5;
    *h = swap ? f.width : f.height;
    *w = swap ? f.height : f.width;
  }
};

// cv::ApplyExifOrientation: flips and transposes of [H, W, 3].
void orient(const uint8_t* src, int h, int w, int orientation, uint8_t* dst) {
  const bool transpose = orientation >= 5;
  const int oh = transpose ? w : h, ow = transpose ? h : w;
  bool flip_x = false, flip_y = false;   // applied after the transpose
  switch (orientation) {
    case 2: flip_x = true; break;
    case 3: flip_x = flip_y = true; break;
    case 4: flip_y = true; break;
    case 5: break;
    case 6: flip_x = true; break;
    case 7: flip_x = flip_y = true; break;
    case 8: flip_y = true; break;
    default: break;
  }
  for (int y = 0; y < oh; y++)
    for (int x = 0; x < ow; x++) {
      int ty = flip_y ? oh - 1 - y : y, tx = flip_x ? ow - 1 - x : x;
      int sy = transpose ? tx : ty, sx = transpose ? ty : tx;
      std::memcpy(dst + (size_t(y) * ow + x) * 3,
                  src + (size_t(sy) * w + sx) * 3, 3);
    }
}

// ------------------------------------------------------------------ encode

constexpr uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffEnc {
  uint32_t code[256];
  int8_t size[256];
  explicit HuffEnc(const HuffSpec& s) {
    std::memset(size, 0, sizeof(size));
    int k = 0, c = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < s.bits[len]; i++, k++) {
        code[s.vals[k]] = uint32_t(c++);
        size[s.vals[k]] = int8_t(len);
      }
      c <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t bits, int n) {   // n <= 16
    acc_ = (acc_ << n) | (bits & ((1u << n) - 1));
    cnt_ += n;
    while (cnt_ >= 8) {
      cnt_ -= 8;
      uint8_t b = uint8_t(acc_ >> cnt_);
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);   // byte stuffing
    }
  }
  void flush() {   // pad the last byte with ones
    if (cnt_) put((1u << (8 - cnt_)) - 1, 8 - cnt_);
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int cnt_ = 0;
};

// jcdctmgr.c's compute_reciprocal (16-bit DCTELEM, as with SIMD) and its
// quantize().
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return {fq & 0xFFFF, c, r};
}

inline int16_t quantize(int32_t x, const Divisor& dv) {
  if (dv.recip == 1 && dv.corr == 0 && dv.shift == 0) return int16_t(x);
  int16_t t = int16_t(x);
  bool neg = t < 0;
  uint32_t a = uint32_t(neg ? -int32_t(t) : int32_t(t));
  uint32_t prod = ((a + dv.corr) & 0xFFFF) * dv.recip;
  int16_t q = int16_t(prod >> dv.shift);
  return neg ? int16_t(-q) : q;
}

void put_marker(std::vector<uint8_t>& o, uint8_t m) {
  o.push_back(0xFF);
  o.push_back(m);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const HuffSpec& s) {
  put_marker(o, 0xC4);
  put16(o, 2 + 1 + 16 + s.nvals);
  o.push_back(uint8_t(cls_id));
  for (int k = 1; k <= 16; k++) o.push_back(s.bits[k]);
  for (int i = 0; i < s.nvals; i++) o.push_back(s.vals[i]);
}

std::vector<uint8_t> encode(const uint8_t* img, int h, int w, int channels,
                            int quality) {
  if (h < 1 || w < 1 || h > 65500 || w > 65500)
    raise("JPEG encode: the image must be 1..65500 pixels on each side");
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qtab[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = (long((t ? kStdChroma : kStdLuma)[i]) * scale + 50L) / 100L;
      qtab[t][i] = uint16_t(std::min(std::max(v, 1L), 255L));
    }
  const int ncomp = channels == 1 ? 1 : 3;
  const int hs = ncomp == 3 ? 2 : 1;   // Y's sampling factors (4:2:0)
  const int mcu = 8 * hs;
  const int mcux = (w + mcu - 1) / mcu, mcuy = (h + mcu - 1) / mcu;

  // colour conversion (jccolor.c) on the whole frame
  std::vector<uint8_t> planes[3];
  const size_t npix = size_t(w) * h;
  if (ncomp == 1) {
    planes[0].assign(img, img + npix);
  } else {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t(1) << (kScale - 1);
    constexpr int32_t kCbCrOff = int32_t(128) << kScale;
    auto fix = [](double x) { return int32_t(x * (1 << kScale) + 0.5); };
    int32_t tab[8][256];
    for (int i = 0; i < 256; i++) {
      tab[0][i] = fix(0.29900) * i;
      tab[1][i] = fix(0.58700) * i;
      tab[2][i] = fix(0.11400) * i + kHalf;
      tab[3][i] = -fix(0.16874) * i;
      tab[4][i] = -fix(0.33126) * i;
      tab[5][i] = fix(0.50000) * i + kCbCrOff + kHalf - 1;
      tab[6][i] = -fix(0.41869) * i;
      tab[7][i] = -fix(0.08131) * i;
    }
    for (int c = 0; c < 3; c++) planes[c].resize(npix);
    for (size_t i = 0; i < npix; i++) {
      int b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
      planes[0][i] = uint8_t((tab[0][r] + tab[1][g] + tab[2][b]) >> kScale);
      planes[1][i] = uint8_t((tab[3][r] + tab[4][g] + tab[5][b]) >> kScale);
      planes[2][i] = uint8_t((tab[5][r] + tab[6][g] + tab[7][b]) >> kScale);
    }
  }

  // Each component's samples over whole blocks: the frame's right and bottom
  // edges replicated (jcprepct.c / jcsample.c), chroma h2v2-downsampled.
  struct Plane {
    std::vector<uint8_t> s;
    int bw, bh, bw_real, bh_real, hs, vs;
  } comp[3];
  for (int c = 0; c < ncomp; c++) {
    Plane& p = comp[c];
    p.hs = p.vs = c == 0 ? hs : 1;
    int dw = c == 0 ? w : (w + 1) / 2, dh = c == 0 ? h : (h + 1) / 2;
    if (ncomp == 1) {
      dw = w;
      dh = h;
    }
    p.bw_real = (dw + 7) / 8;
    p.bh_real = (dh + 7) / 8;
    p.bw = mcux * p.hs;
    p.bh = mcuy * p.vs;
    const int pw = p.bw_real * 8, ph = p.bh_real * 8;
    p.s.assign(size_t(pw) * ph, 0);
    if (c == 0 || ncomp == 1) {
      for (int y = 0; y < ph; y++) {
        const uint8_t* src = &planes[c][size_t(std::min(y, h - 1)) * w];
        uint8_t* dst = &p.s[size_t(y) * pw];
        for (int x = 0; x < pw; x++) dst[x] = src[std::min(x, w - 1)];
      }
    } else {
      // color rows padded to an even count, columns to 2 * pw
      auto at = [&](int y, int x) {
        return int(planes[c][size_t(std::min(y, h - 1)) * w + std::min(x, w - 1)]);
      };
      for (int y = 0; y < dh; y++) {
        uint8_t* dst = &p.s[size_t(y) * pw];
        int bias = 1;
        for (int x = 0; x < pw; x++) {
          int v = at(2 * y, 2 * x) + at(2 * y, 2 * x + 1) +
                  at(2 * y + 1, 2 * x) + at(2 * y + 1, 2 * x + 1) + bias;
          dst[x] = uint8_t(v >> 2);
          bias ^= 3;
        }
      }
      for (int y = dh; y < ph; y++)
        std::memcpy(&p.s[size_t(y) * pw], &p.s[size_t(dh - 1) * pw], size_t(pw));
    }
  }

  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(uint32_t(qtab[t][i]) << 3);

  std::vector<uint8_t> out;
  out.reserve(npix + 1024);
  put_marker(out, 0xD8);
  // JFIF APP0: version 1.01, no units, density 1:1, no thumbnail
  put_marker(out, 0xE0);
  put16(out, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), jfif, jfif + 14);
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); t++) {
    put_marker(out, 0xDB);
    put16(out, 67);
    out.push_back(uint8_t(t));
    for (int k = 0; k < 64; k++) out.push_back(uint8_t(qtab[t][kZigzag[k]]));
  }
  put_marker(out, 0xC0);
  put16(out, 8 + 3 * ncomp);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.push_back(uint8_t(ncomp));
  for (int c = 0; c < ncomp; c++) {
    out.push_back(uint8_t(c + 1));
    out.push_back(uint8_t((comp[c].hs << 4) | comp[c].vs));
    out.push_back(uint8_t(c == 0 ? 0 : 1));
  }
  HuffSpec dcs[2] = {dc_spec(false), dc_spec(true)};
  HuffSpec acs[2] = {ac_spec(false), ac_spec(true)};
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); t++) {
    put_dht(out, t, dcs[t]);
    put_dht(out, 0x10 | t, acs[t]);
  }
  put_marker(out, 0xDA);
  put16(out, 6 + 2 * ncomp);
  out.push_back(uint8_t(ncomp));
  for (int c = 0; c < ncomp; c++) {
    out.push_back(uint8_t(c + 1));
    out.push_back(uint8_t(c == 0 ? 0x00 : 0x11));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  HuffEnc dce[2] = {HuffEnc(dcs[0]), HuffEnc(dcs[1])};
  HuffEnc ace[2] = {HuffEnc(acs[0]), HuffEnc(acs[1])};
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  int32_t ws[64];
  auto emit_block = [&](int c, const int16_t* blk) {
    const int t = c == 0 ? 0 : 1;
    int diff = blk[0] - last_dc[c];
    last_dc[c] = blk[0];
    int a = diff < 0 ? -diff : diff, nbits = 0;
    while (a) {
      nbits++;
      a >>= 1;
    }
    bw.put(dce[t].code[nbits], dce[t].size[nbits]);
    if (nbits) bw.put(uint32_t(diff < 0 ? diff - 1 : diff) & ((1u << nbits) - 1), nbits);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      int v = blk[kZigzag[k]];
      if (v == 0) {
        run++;
        continue;
      }
      while (run > 15) {
        bw.put(ace[t].code[0xF0], ace[t].size[0xF0]);
        run -= 16;
      }
      int av = v < 0 ? -v : v;
      nbits = 0;
      while (av) {
        nbits++;
        av >>= 1;
      }
      int sym = (run << 4) | nbits;
      bw.put(ace[t].code[sym], ace[t].size[sym]);
      bw.put(uint32_t(v < 0 ? v - 1 : v) & ((1u << nbits) - 1), nbits);
      run = 0;
    }
    if (run > 0) bw.put(ace[t].code[0], ace[t].size[0]);
  };
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++)
      for (int c = 0; c < ncomp; c++) {
        Plane& p = comp[c];
        const int t = c == 0 ? 0 : 1;
        const int pw = p.bw_real * 8;
        int16_t blocks[4][64];
        for (int yy = 0; yy < p.vs; yy++)
          for (int xx = 0; xx < p.hs; xx++) {
            int bx = mx * p.hs + xx, by = my * p.vs + yy;
            int16_t* blk = blocks[yy * p.hs + xx];
            if (by >= p.bh_real) {
              // a dummy row at the bottom: zeros with the DC of the block
              // before this row in the MCU
              std::memset(blk, 0, 64 * sizeof(int16_t));
              blk[0] = blocks[yy * p.hs - 1][0];
            } else if (bx >= p.bw_real) {
              std::memset(blk, 0, 64 * sizeof(int16_t));
              blk[0] = blocks[yy * p.hs + xx - 1][0];
            } else {
              for (int r = 0; r < 8; r++)
                for (int k = 0; k < 8; k++)
                  ws[8 * r + k] =
                      int32_t(p.s[size_t(by * 8 + r) * pw + bx * 8 + k]) - 128;
              fdct_islow(ws);
              for (int i = 0; i < 64; i++) blk[i] = quantize(ws[i], div[t][i]);
            }
            emit_block(c, blk);
          }
      }
  bw.flush();
  put_marker(out, 0xD9);
  return out;
}

}  // namespace

extern "C" {

// Output [h, w] of a JPEG after its EXIF orientation; 0 or -1 with err.
int rt_jpeg_header(const uint8_t* data, size_t n, int32_t* hw, char* err,
                   int errlen) {
  try {
    Decoder dec(data, n);
    dec.parse();
    int h, w;
    dec.out_size(&h, &w);
    hw[0] = h;
    hw[1] = w;
    return 0;
  } catch (const Error& e) {
    return report(err, errlen, e.msg);
  } catch (const std::exception& e) {
    return report(err, errlen, e.what());
  }
}

// Decode into out ([h, w, 3] BGR, the sizes rt_jpeg_header gave).
int rt_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err,
                   int errlen) {
  try {
    Decoder dec(data, n);
    dec.parse();
    if (dec.orientation == 1) {
      dec.render(out);
    } else {
      std::vector<uint8_t> tmp(size_t(dec.f.width) * dec.f.height * 3);
      dec.render(tmp.data());
      orient(tmp.data(), dec.f.height, dec.f.width, dec.orientation, out);
    }
    return 0;
  } catch (const Error& e) {
    return report(err, errlen, e.msg);
  } catch (const std::exception& e) {
    return report(err, errlen, e.what());
  }
}

// A size no file rt_jpeg_encode writes for an h x w image exceeds: every
// block of three components (whole MCUs) at 4 bytes a coefficient.
size_t rt_jpeg_encode_bound(int32_t h, int32_t w) {
  size_t blocks = (size_t(w) + 16) * (size_t(h) + 16) / 64 * 3;
  return blocks * 64 * 4 + 4096;
}

// [h, w] gray or [h, w, 3] BGR uint8 -> JPEG bytes in out; the byte count,
// or -1 with err.
int64_t rt_jpeg_encode(const uint8_t* img, int32_t h, int32_t w,
                       int32_t channels, int32_t quality, uint8_t* out,
                       size_t cap, char* err, int errlen) {
  try {
    if (channels != 1 && channels != 3)
      raise("JPEG encode takes 1 or 3 channels");
    std::vector<uint8_t> bytes = encode(img, h, w, channels, quality);
    if (bytes.size() > cap) raise("JPEG encode: output buffer too small");
    std::memcpy(out, bytes.data(), bytes.size());
    return int64_t(bytes.size());
  } catch (const Error& e) {
    return report(err, errlen, e.msg);
  } catch (const std::exception& e) {
    return report(err, errlen, e.what());
  }
}

}  // extern "C"
