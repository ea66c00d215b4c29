// Host-only PNG codec of raft_tpu_torch: no libpng, only zlib and the PNG
// specification (ISO/IEC 15948).  Built with the host C++ compiler by
// raft_tpu_torch/_build.py and bound with ctypes in raft_tpu_torch/imageio.py.
//
// Decode returns what OpenCV's imdecode returns for a PNG: 3 channels in BGR
// order; gray replicated, a palette expanded, alpha dropped; 8-bit output
// takes a 16-bit sample's high byte (IMREAD_COLOR), native output keeps 16
// bits (IMREAD_ANYDEPTH | IMREAD_COLOR).  Every chunk's CRC and the zlib
// stream are checked: a corrupt file is an error, never a partial image.
// Encode writes one IDAT of filter-0 rows, 8- or 16-bit, gray or RGB
// (given as BGR, as OpenCV's imwrite takes it).

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

int fail(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
  return -1;
}

struct Header {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  int channels() const {
    switch (color) {
      case 0: return 1;    // gray
      case 2: return 3;    // RGB
      case 3: return 1;    // palette index
      case 4: return 2;    // gray + alpha
      case 6: return 4;    // RGBA
      default: return 0;
    }
  }
  size_t row_bytes() const {
    return (size_t(w) * channels() * depth + 7) / 8;
  }
};

bool valid_depth(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

// Walks the chunks: header, palette, concatenated IDAT.  Checks each CRC.
int parse(const uint8_t* data, size_t n, Header* hd, std::vector<uint8_t>* plte,
          std::vector<uint8_t>* idat, char* err, int errlen) {
  if (n < 8 || std::memcmp(data, kSig, 8) != 0)
    return fail(err, errlen, "not a PNG file (bad signature)");
  size_t pos = 8;
  bool seen_ihdr = false, seen_iend = false;
  while (pos + 12 <= n) {
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    if (len > n - pos - 12) return fail(err, errlen, "truncated PNG chunk");
    const uint8_t* body = data + pos + 8;
    uint32_t crc = uint32_t(crc32(0L, type, 4 + len));
    if (crc != be32(body + len))
      return fail(err, errlen, "PNG chunk CRC mismatch (corrupt file)");
    if (!seen_ihdr && std::memcmp(type, "IHDR", 4) != 0)
      return fail(err, errlen, "PNG does not start with IHDR");
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13 || seen_ihdr) return fail(err, errlen, "bad IHDR");
      hd->w = be32(body);
      hd->h = be32(body + 4);
      hd->depth = body[8];
      hd->color = body[9];
      hd->interlace = body[12];
      if (body[10] != 0 || body[11] != 0 || hd->interlace > 1)
        return fail(err, errlen, "bad IHDR compression/filter/interlace");
      if (hd->w == 0 || hd->h == 0 || hd->w > (1u << 24) || hd->h > (1u << 24))
        return fail(err, errlen, "bad PNG dimensions");
      if (!valid_depth(hd->color, hd->depth))
        return fail(err, errlen, "bad PNG color type / bit depth");
      seen_ihdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len == 0 || len > 768)
        return fail(err, errlen, "bad PLTE");
      plte->assign(body, body + len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      seen_iend = true;
      break;
    } else if (!(type[0] & 0x20)) {
      return fail(err, errlen, "unknown critical PNG chunk");
    }
    pos += 12 + size_t(len);
  }
  if (!seen_ihdr || !seen_iend) return fail(err, errlen, "truncated PNG");
  if (idat->empty()) return fail(err, errlen, "PNG has no IDAT");
  if (hd->color == 3 && plte->empty())
    return fail(err, errlen, "palette PNG without PLTE");
  if (hd->interlace)
    return fail(err, errlen, "interlaced (Adam7) PNG is not supported");
  return 0;
}

// Inflates exactly `want` bytes; anything else is an error.
int inflate_exact(const std::vector<uint8_t>& src, uint8_t* dst, size_t want,
                  char* err, int errlen) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return fail(err, errlen, "inflateInit failed");
  zs.next_in = const_cast<Bytef*>(src.data());
  zs.avail_in = uInt(src.size());
  zs.next_out = dst;
  zs.avail_out = uInt(want);
  int rc = inflate(&zs, Z_FINISH);
  size_t got = want - zs.avail_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || got != want)
    return fail(err, errlen, "corrupt PNG image data (zlib stream)");
  return 0;
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// In place: raw is h rows of (1 filter byte + row_bytes).
int unfilter(uint8_t* raw, const Header& hd, char* err, int errlen) {
  size_t rb = hd.row_bytes();
  size_t bpp = std::max<size_t>(1, size_t(hd.channels()) * hd.depth / 8);
  uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < hd.h; ++y) {
    uint8_t* row = raw + size_t(y) * (rb + 1);
    uint8_t f = row[0];
    uint8_t* cur = row + 1;
    switch (f) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < rb; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
        break;
      case 2:
        if (prev)
          for (size_t i = 0; i < rb; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < rb; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(cur[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rb; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = uint8_t(cur[i] + paeth(a, b, c));
        }
        break;
      default:
        return fail(err, errlen, "bad PNG filter type (corrupt file)");
    }
    prev = cur;
  }
  return 0;
}

// Sample k (0-based) of a row as an integer of the file's depth.
inline uint32_t sample(const uint8_t* row, size_t k, int depth) {
  switch (depth) {
    case 16: return (uint32_t(row[2 * k]) << 8) | row[2 * k + 1];
    case 8: return row[k];
    default: {
      size_t bit = k * size_t(depth);
      int shift = 8 - depth - int(bit % 8);
      return (row[bit / 8] >> shift) & ((1u << depth) - 1);
    }
  }
}

}  // namespace

extern "C" {

// hwdc: height, width, bit depth, color type.  0 on success.
int rt_png_header(const uint8_t* data, size_t n, int32_t* hwdc, char* err,
                  int errlen) {
  Header hd;
  std::vector<uint8_t> plte, idat;
  if (parse(data, n, &hd, &plte, &idat, err, errlen)) return -1;
  hwdc[0] = int32_t(hd.h);
  hwdc[1] = int32_t(hd.w);
  hwdc[2] = hd.depth;
  hwdc[3] = hd.color;
  return 0;
}

// out: h * w * 3 samples, BGR; uint8 when out16 == 0 (16-bit files give
// their high byte), uint16 when out16 != 0 (the file must be 16-bit).
int rt_png_decode(const uint8_t* data, size_t n, void* out, int out16,
                  char* err, int errlen) {
  Header hd;
  std::vector<uint8_t> plte, idat;
  if (parse(data, n, &hd, &plte, &idat, err, errlen)) return -1;
  if (out16 && hd.depth != 16)
    return fail(err, errlen, "16-bit output asked of a PNG that is not 16-bit");
  size_t rb = hd.row_bytes();
  std::vector<uint8_t> raw(size_t(hd.h) * (rb + 1));
  if (inflate_exact(idat, raw.data(), raw.size(), err, errlen)) return -1;
  if (unfilter(raw.data(), hd, err, errlen)) return -1;
  const int ch = hd.channels();
  const size_t npal = plte.size() / 3;
  uint8_t* o8 = static_cast<uint8_t*>(out);
  uint16_t* o16 = static_cast<uint16_t*>(out);
  for (uint32_t y = 0; y < hd.h; ++y) {
    const uint8_t* row = raw.data() + size_t(y) * (rb + 1) + 1;
    for (uint32_t x = 0; x < hd.w; ++x) {
      uint32_t rgb[3];
      if (hd.color == 3) {
        uint32_t idx = sample(row, x, hd.depth);
        if (idx >= npal) return fail(err, errlen, "PNG palette index out of range");
        for (int c = 0; c < 3; ++c) rgb[c] = plte[3 * idx + c];
      } else if (hd.color == 0 || hd.color == 4) {
        uint32_t g = sample(row, size_t(x) * ch, hd.depth);
        if (hd.depth < 8) g = g * (255u / ((1u << hd.depth) - 1));
        rgb[0] = rgb[1] = rgb[2] = g;
      } else {
        for (int c = 0; c < 3; ++c) rgb[c] = sample(row, size_t(x) * ch + c, hd.depth);
      }
      size_t o = (size_t(y) * hd.w + x) * 3;
      for (int c = 0; c < 3; ++c) {
        uint32_t v = rgb[2 - c];                  // RGB -> BGR
        if (out16) o16[o + c] = uint16_t(v);
        else o8[o + c] = uint8_t(hd.depth == 16 ? v >> 8 : v);
      }
    }
  }
  return 0;
}

// The most bytes rt_png_encode can write for this image.
size_t rt_png_encode_bound(int32_t h, int32_t w, int32_t channels,
                           int32_t depth) {
  size_t raw = size_t(h) * (1 + size_t(w) * channels * (depth / 8));
  return compressBound(uLong(raw)) + 8 + 25 + 12 + 12;
}

// px: h * w * channels samples (uint8 or uint16 by depth), BGR when
// channels == 3.  zlib's fastest level (OpenCV's default).  Returns the
// bytes written, or -1.
int64_t rt_png_encode(const void* px, int32_t h, int32_t w, int32_t channels,
                      int32_t depth, uint8_t* out, size_t cap, char* err,
                      int errlen) {
  if ((channels != 1 && channels != 3) || (depth != 8 && depth != 16) ||
      h <= 0 || w <= 0)
    return fail(err, errlen, "encode takes 1 or 3 channels of 8 or 16 bits");
  const size_t bps = size_t(depth / 8);
  const size_t rb = size_t(w) * channels * bps;
  std::vector<uint8_t> raw(size_t(h) * (rb + 1));
  const uint8_t* p8 = static_cast<const uint8_t*>(px);
  const uint16_t* p16 = static_cast<const uint16_t*>(px);
  for (int32_t y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + size_t(y) * (rb + 1);
    row[0] = 0;
    uint8_t* cur = row + 1;
    for (int32_t x = 0; x < w; ++x) {
      for (int32_t c = 0; c < channels; ++c) {
        int32_t src = channels == 3 ? 2 - c : c;  // BGR -> RGB
        size_t i = (size_t(y) * w + x) * channels + src;
        size_t o = (size_t(x) * channels + c) * bps;
        if (depth == 16) {
          cur[o] = uint8_t(p16[i] >> 8);
          cur[o + 1] = uint8_t(p16[i] & 0xff);
        } else {
          cur[o] = p8[i];
        }
      }
    }
  }
  uLongf zlen = compressBound(uLong(raw.size()));
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), uLong(raw.size()),
                Z_BEST_SPEED) != Z_OK)
    return fail(err, errlen, "zlib compress failed");
  std::vector<uint8_t> f(kSig, kSig + 8);
  auto chunk = [&f](const char* type, const uint8_t* body, size_t len) {
    put32(f, uint32_t(len));
    size_t start = f.size();
    f.insert(f.end(), type, type + 4);
    f.insert(f.end(), body, body + len);
    put32(f, uint32_t(crc32(0L, f.data() + start, uInt(4 + len))));
  };
  uint8_t ihdr[13];
  uint32_t dims[2] = {uint32_t(w), uint32_t(h)};
  for (int k = 0; k < 2; ++k)
    for (int b = 0; b < 4; ++b) ihdr[4 * k + b] = uint8_t(dims[k] >> (24 - 8 * b));
  ihdr[8] = uint8_t(depth);
  ihdr[9] = channels == 3 ? 2 : 0;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", z.data(), zlen);
  chunk("IEND", nullptr, 0);
  if (f.size() > cap) return fail(err, errlen, "encode buffer too small");
  std::memcpy(out, f.data(), f.size());
  return int64_t(f.size());
}

}  // extern "C"
