// fastimage: the data loader's host pass over one image, in C++ with a plain C
// interface for ctypes.
//
// png_unfilter undoes a PNG's row filters. preprocess_image does the steps of
// bbdm_tpu_torch/data/base.py:load_image after the decode: gray, gray+alpha or
// RGBA to RGB -> Pillow's triangle ("bilinear") resize -> optional horizontal
// flip -> uint8 to float32 in [0, 1] or [-1, 1]. The resize is Pillow's
// (Resample.c): 22-bit fixed-point weights, a horizontal pass then a vertical
// pass, each rounded to uint8, and an axis that keeps its size is not
// resampled. Every step computes bit for bit what the numpy plain version
// computes (utils/images.py:_unfilter, to_rgb, data/base.py:resize_bilinear,
// then the flip and the float32 arithmetic), which the CPU tests hold it
// against.
//
// gif_lzw is the GIF writer's (utils/gif.py) LZW coder for 8-bit indices.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

struct Coeffs {
  int ksize = 0;
  std::vector<int> lo, n;        // first input index and tap count per output
  std::vector<int64_t> weights;  // [out, ksize], fixed point
};

// data/base.py:_resample_coeffs, in the same double arithmetic and order
Coeffs resample_coeffs(int in_size, int out_size) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.lo.resize(out_size);
  c.n.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> w(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int64_t xmin = static_cast<int64_t>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int64_t xmax = static_cast<int64_t>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double total = 0.0;
    for (int k = 0; k < c.ksize; ++k) {
      double v = 1.0 - std::fabs((static_cast<double>(xmin + k) - center + 0.5) / filterscale);
      if (v < 0.0 || k >= xmax) v = 0.0;
      w[k] = v;
      total += v;
    }
    c.lo[xx] = static_cast<int>(xmin);
    c.n[xx] = static_cast<int>(std::max<int64_t>(xmax, 0));
    for (int k = 0; k < c.ksize; ++k) {
      double v = total != 0.0 ? w[k] / total : w[k];
      c.weights[static_cast<size_t>(xx) * c.ksize + k] = static_cast<int64_t>(
          v < 0 ? -0.5 + v * (1 << kPrecisionBits) : 0.5 + v * (1 << kPrecisionBits));
    }
  }
  return c;
}

inline uint8_t clip8(int64_t acc) {
  acc >>= kPrecisionBits;
  return static_cast<uint8_t>(acc < 0 ? 0 : (acc > 255 ? 255 : acc));
}

// uint8 [h, w, c] (c 1..4) -> RGB [h, w, 3]: gray repeated, alpha dropped
void to_rgb(const uint8_t* src, int h, int w, int c, uint8_t* dst) {
  const size_t n = static_cast<size_t>(h) * w;
  if (c == 3) {
    std::memcpy(dst, src, n * 3);
    return;
  }
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* s = src + i * c;
    uint8_t* d = dst + i * 3;
    if (c < 3) {
      d[0] = d[1] = d[2] = s[0];
    } else {
      d[0] = s[0];
      d[1] = s[1];
      d[2] = s[2];
    }
  }
}

// RGB [h, w, 3] -> [oh, ow, 3] as data/base.py:resize_bilinear
std::vector<uint8_t> resize(std::vector<uint8_t> img, int h, int w, int oh, int ow) {
  if (w != ow) {
    Coeffs c = resample_coeffs(w, ow);
    std::vector<uint8_t> out(static_cast<size_t>(h) * ow * 3);
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = img.data() + static_cast<size_t>(y) * w * 3;
      uint8_t* orow = out.data() + static_cast<size_t>(y) * ow * 3;
      for (int xx = 0; xx < ow; ++xx) {
        const int64_t* k = c.weights.data() + static_cast<size_t>(xx) * c.ksize;
        const uint8_t* s = row + static_cast<size_t>(c.lo[xx]) * 3;
        int64_t a0 = 1 << (kPrecisionBits - 1), a1 = a0, a2 = a0;
        for (int j = 0; j < c.n[xx]; ++j) {
          a0 += s[3 * j] * k[j];
          a1 += s[3 * j + 1] * k[j];
          a2 += s[3 * j + 2] * k[j];
        }
        orow[3 * xx] = clip8(a0);
        orow[3 * xx + 1] = clip8(a1);
        orow[3 * xx + 2] = clip8(a2);
      }
    }
    img.swap(out);
    w = ow;
  }
  if (h != oh) {
    Coeffs c = resample_coeffs(h, oh);
    const size_t row = static_cast<size_t>(w) * 3;
    std::vector<uint8_t> out(static_cast<size_t>(oh) * row);
    std::vector<int64_t> acc(row);
    for (int yy = 0; yy < oh; ++yy) {
      const int64_t* k = c.weights.data() + static_cast<size_t>(yy) * c.ksize;
      std::fill(acc.begin(), acc.end(), int64_t{1} << (kPrecisionBits - 1));
      for (int j = 0; j < c.n[yy]; ++j) {
        const uint8_t* s = img.data() + static_cast<size_t>(c.lo[yy] + j) * row;
        const int64_t kj = k[j];
        for (size_t i = 0; i < row; ++i) acc[i] += s[i] * kj;
      }
      uint8_t* o = out.data() + static_cast<size_t>(yy) * row;
      for (size_t i = 0; i < row; ++i) o[i] = clip8(acc[i]);
    }
    img.swap(out);
  }
  return img;
}

// RGB uint8 [oh, ow, 3] -> float32, flipped left-right if asked; the float32
// arithmetic of load_image: u / 255, then clip(v * 2 - 1, -1, 1)
void to_float(const uint8_t* img, int oh, int ow, float* dst, int flip, int to_normal) {
  for (int y = 0; y < oh; ++y) {
    const uint8_t* row = img + static_cast<size_t>(y) * ow * 3;
    float* d = dst + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const uint8_t* s = row + static_cast<size_t>(flip ? ow - 1 - x : x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        float v = static_cast<float>(s[ch]) / 255.0f;
        if (to_normal) v = std::min(1.0f, std::max(-1.0f, v * 2.0f - 1.0f));
        d[3 * x + ch] = v;
      }
    }
  }
}

// the Paeth predictor (a if pa <= pb and pa <= pc, else b if pb <= pc, else c)
// in stb_image's equivalent form, whose short dependency chain on a (the
// byte to the left, just decoded) compiles without branches
inline int paeth(int a, int b, int c) {
  const int thresh = c * 3 - (a + b);
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  const int t0 = hi <= thresh ? lo : c;
  return thresh <= lo ? hi : t0;
}

// Sub (F 1), Average (3) and Paeth (4) rows of BPP bytes per pixel: each byte
// adds a predictor of the decoded byte to its left, kept in a register per channel
template <int F, int BPP>
void unfilter_left(const uint8_t* raw, const uint8_t* prev, uint8_t* cur, int stride) {
  int a[BPP], c[BPP];
  for (int k = 0; k < BPP; ++k) {  // the first pixel: no left or upper-left neighbour
    const int p = F == 1 ? 0 : (F == 3 ? prev[k] >> 1 : prev[k]);
    a[k] = cur[k] = static_cast<uint8_t>(raw[k] + p);
    c[k] = prev[k];
  }
  for (int i = BPP; i + BPP <= stride; i += BPP) {
    for (int k = 0; k < BPP; ++k) {
      const int b = prev[i + k];
      const int p = F == 1 ? a[k] : (F == 3 ? (a[k] + b) >> 1 : paeth(a[k], b, c[k]));
      a[k] = cur[i + k] = static_cast<uint8_t>(raw[i + k] + p);
      c[k] = b;
    }
  }
}

template <int F>
void unfilter_left_bpp(const uint8_t* raw, const uint8_t* prev, uint8_t* cur, int stride,
                       int bpp) {
  if (stride % bpp == 0) {
    switch (bpp) {
      case 1: return unfilter_left<F, 1>(raw, prev, cur, stride);
      case 2: return unfilter_left<F, 2>(raw, prev, cur, stride);
      case 3: return unfilter_left<F, 3>(raw, prev, cur, stride);
      case 4: return unfilter_left<F, 4>(raw, prev, cur, stride);
      case 6: return unfilter_left<F, 6>(raw, prev, cur, stride);
      case 8: return unfilter_left<F, 8>(raw, prev, cur, stride);
      default: break;
    }
  }
  for (int i = 0; i < stride; ++i) {
    const int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
    const int p = F == 1 ? a : (F == 3 ? (a + b) >> 1 : paeth(a, b, c));
    cur[i] = static_cast<uint8_t>(raw[i] + p);
  }
}

// PNG rows [rows, 1 + stride] (filter byte first) -> [rows, stride]; returns 0,
// or 1 + the row whose filter type is not 0-4
int unfilter(const uint8_t* data, int rows, int stride, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (int r = 0; r < rows; ++r) {
    const uint8_t* raw = data + static_cast<size_t>(r) * (stride + 1);
    const int f = raw[0];
    ++raw;
    uint8_t* cur = out + static_cast<size_t>(r) * stride;
    if (f == 0) {
      std::memcpy(cur, raw, stride);
    } else if (f == 2) {
      for (int i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(raw[i] + prev[i]);
    } else if (f == 1) {
      unfilter_left_bpp<1>(raw, prev, cur, stride, bpp);
    } else if (f == 3) {
      unfilter_left_bpp<3>(raw, prev, cur, stride, bpp);
    } else if (f == 4) {
      unfilter_left_bpp<4>(raw, prev, cur, stride, bpp);
    } else {
      return 1 + r;
    }
    prev = cur;
  }
  return 0;
}

void preprocess(const uint8_t* src, int h, int w, int c, float* dst, int oh, int ow, int flip,
                int to_normal) {
  std::vector<uint8_t> rgb(static_cast<size_t>(h) * w * 3);
  to_rgb(src, h, w, c, rgb.data());
  std::vector<uint8_t> img = resize(std::move(rgb), h, w, oh, ow);
  to_float(img.data(), oh, ow, dst, flip, to_normal);
}

bool valid(int h, int w, int c, int oh, int ow) {
  return h > 0 && w > 0 && c >= 1 && c <= 4 && oh > 0 && ow > 0;
}

// LSB-first bit packer of the GIF LZW stream
struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool put(int code, int size) {
    acc |= static_cast<uint32_t>(code) << nbits;
    nbits += size;
    while (nbits >= 8) {
      if (n >= cap) return false;
      out[n++] = static_cast<uint8_t>(acc & 0xFF);
      acc >>= 8;
      nbits -= 8;
    }
    return true;
  }
  bool flush() {
    if (nbits > 0) {
      if (n >= cap) return false;
      out[n++] = static_cast<uint8_t>(acc & 0xFF);
      acc = 0;
      nbits = 0;
    }
    return true;
  }
};

}  // namespace

extern "C" {

// Returns 0; -1 if size is not rows * (stride + 1); 1 + r if row r has an
// unknown filter type.
int png_unfilter(const uint8_t* data, int64_t size, int rows, int stride, int bpp, uint8_t* out) {
  if (rows < 0 || stride < 0 || bpp < 1 || size != static_cast<int64_t>(rows) * (stride + 1))
    return -1;
  return unfilter(data, rows, stride, bpp, out);
}

int preprocess_image(const uint8_t* src, int h, int w, int c, float* dst, int oh, int ow,
                     int flip, int to_normal) {
  if (!valid(h, w, c, oh, ow)) return -1;
  preprocess(src, h, w, c, dst, oh, ow, flip, to_normal);
  return 0;
}

// GIF LZW with 8-bit minimum code size: indices [n] -> the code stream
// (without the sub-block framing). Returns its length, or -1 if cap is too small.
int64_t gif_lzw(const uint8_t* idx, int64_t n, uint8_t* out, int64_t cap) {
  constexpr int kClear = 256, kEnd = 257, kMax = 4096;
  std::vector<int16_t> table(static_cast<size_t>(kMax) * 256, -1);  // (prefix, byte) -> code
  std::vector<int32_t> used;
  BitWriter w{out, cap};
  int size = 9, next = kEnd + 1;
  if (!w.put(kClear, size)) return -1;
  if (n == 0) return w.put(kEnd, size) && w.flush() ? w.n : -1;
  int prefix = idx[0];
  for (int64_t i = 1; i < n; ++i) {
    const int k = idx[i];
    const int32_t slot = prefix * 256 + k;
    if (table[slot] >= 0) {
      prefix = table[slot];
      continue;
    }
    if (!w.put(prefix, size)) return -1;
    table[slot] = static_cast<int16_t>(next++);
    used.push_back(slot);
    if (next > (1 << size) && size < 12) ++size;
    if (next == kMax) {  // table full: start over
      if (!w.put(kClear, size)) return -1;
      for (int32_t u : used) table[u] = -1;
      used.clear();
      size = 9;
      next = kEnd + 1;
    }
    prefix = k;
  }
  if (!w.put(prefix, size) || !w.put(kEnd, size) || !w.flush()) return -1;
  return w.n;
}

}  // extern "C"
