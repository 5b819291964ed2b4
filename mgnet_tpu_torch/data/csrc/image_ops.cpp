// Host image operations of the port's data pipeline, with a plain C
// interface for ctypes (mgnet_tpu_torch/data/image_io.py).
//
// Counterpart of native/src/image_ops.cpp (libpng decode, cv2-style
// resize) for a machine with neither libpng nor Pillow: it needs no header
// beyond the C++ standard library and links nothing.
//
//  * mg_png_unfilter: undoes the PNG row filters (None, Sub, Up, Average,
//    Paeth) of an inflated IDAT stream. Python's zlib inflates; Sub,
//    Average and Paeth depend on the pixel just decoded, so they run here.
//  * mg_resample_bilinear_u8: Pillow's Image.resize(BILINEAR) bit for bit
//    (Pillow's libImaging/Resample.c): a triangle filter of support
//    max(scale, 1), double coefficients per output pixel normalised to
//    ints with PRECISION_BITS = 22 (round half away from zero), integer
//    accumulation from 1 << 21, >> 22 and a clamp to 0..255; the
//    horizontal pass first, over only the input rows the vertical pass
//    reads, then the vertical pass.
//  * mg_resample_nearest_u8: Pillow's Image.resize(NEAREST), which is an
//    affine scale (libImaging/Geometry.c ImagingScaleAffine): the source
//    coordinate starts at 0.5 * scale and grows by repeated addition of
//    the scale in double, truncated to an index.
//
// Both resamples compute a window [y0, y0 + wh) x [x0, x0 + ww) of the
// out_h x out_w result: each output pixel depends only on its own
// coefficients, so a window equals the same window cut from the whole
// result, and a resize followed by a crop does only the crop's work.
//
// Build: g++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC. No FMA
// contraction: the coefficient arithmetic must round as Pillow's (and the
// numpy versions in image_io.py) do, one rounding per operation.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

inline double triangle(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

inline uint8_t clip8(int32_t v) {
  int32_t s = v >> kPrecisionBits;  // arithmetic shift: floor
  return s < 0 ? 0 : (s > 255 ? 255 : static_cast<uint8_t>(s));
}

// Pillow's precompute_coeffs + normalize_coeffs_8bpc for the box
// [0, in_size): per output index its first input index, its tap count and
// ksize int32 coefficients. Returns ksize.
int coefficients(int in_size, int out_size, std::vector<int>& first,
                 std::vector<int>& count, std::vector<int32_t>& kk) {
  const double scale = static_cast<double>(static_cast<float>(in_size)) /
                       out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  first.assign(out_size, 0);
  count.assign(out_size, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = 0.0 + (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = triangle((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    int32_t* out = &kk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      const double v = k[x] * (1 << kPrecisionBits);
      out[x] = static_cast<int32_t>(k[x] < 0 ? -0.5 + v : 0.5 + v);
    }
    first[xx] = xmin;
    count[xx] = xmax;
  }
  return ksize;
}

// Pillow's affine-scale source indices for outputs [0, out_size), -1 where
// the index falls outside the input (that output stays 0, Pillow's fill).
std::vector<int> nearest_indices(int in_size, int out_size) {
  const double a = static_cast<double>(static_cast<float>(in_size)) /
                   out_size;
  std::vector<int> idx(out_size);
  double v = 0.0 + a * 0.5;
  for (int i = 0; i < out_size; ++i) {
    const int j = v < 0.0 ? -1 : static_cast<int>(v);
    idx[i] = (j >= 0 && j < in_size) ? j : -1;
    v += a;
  }
  return idx;
}

}  // namespace

extern "C" {

// filtered: h rows of (1 + stride) bytes, each led by its filter type;
// out: h * stride bytes; bpp: bytes per complete pixel (at least 1).
// Returns 0, or -(row + 1) for a row with an unknown filter type.
int mg_png_unfilter(const uint8_t* filtered, uint8_t* out, int h,
                    int64_t stride, int bpp) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = filtered + static_cast<int64_t>(y) * (stride + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* row = out + static_cast<int64_t>(y) * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(row, src, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          row[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          row[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

// src: h x w x c uint8 (c >= 1, C order); dst: wh x ww x c, the window at
// (y0, x0) of the out_h x out_w resize. Returns 0, or -1 on bad sizes.
int mg_resample_bilinear_u8(const uint8_t* src, int h, int w, int c,
                            uint8_t* dst, int out_h, int out_w, int y0,
                            int x0, int wh, int ww) {
  if (h <= 0 || w <= 0 || c <= 0 || out_h <= 0 || out_w <= 0 || wh <= 0 ||
      ww <= 0 || y0 < 0 || x0 < 0 || y0 + wh > out_h || x0 + ww > out_w)
    return -1;
  const bool need_h = out_w != w;
  const bool need_v = out_h != h;
  std::vector<int> yfirst, ycount, xfirst, xcount;
  std::vector<int32_t> ky, kx;
  const int ksize_v = coefficients(h, out_h, yfirst, ycount, ky);
  const int ksize_h = coefficients(w, out_w, xfirst, xcount, kx);
  // the input rows the window's vertical pass reads (Pillow's ybox,
  // restricted to the window's rows)
  int r0 = y0, r1 = y0 + wh;
  if (need_v) {
    r0 = yfirst[y0];
    r1 = yfirst[y0 + wh - 1] + ycount[y0 + wh - 1];
  }
  const int rows = r1 - r0;
  const int64_t row_len = static_cast<int64_t>(ww) * c;
  std::vector<uint8_t> tmp(static_cast<size_t>(rows) * row_len);
  const int64_t src_row = static_cast<int64_t>(w) * c;
  for (int r = 0; r < rows; ++r) {
    const uint8_t* in = src + static_cast<int64_t>(r0 + r) * src_row;
    uint8_t* o = tmp.data() + static_cast<int64_t>(r) * row_len;
    if (!need_h) {
      std::memcpy(o, in + static_cast<int64_t>(x0) * c, row_len);
      continue;
    }
    for (int xx = 0; xx < ww; ++xx) {
      const int ox = x0 + xx;
      const int xmin = xfirst[ox], n = xcount[ox];
      const int32_t* k = &kx[static_cast<size_t>(ox) * ksize_h];
      for (int ch = 0; ch < c; ++ch) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        const uint8_t* p = in + static_cast<int64_t>(xmin) * c + ch;
        for (int x = 0; x < n; ++x) ss += static_cast<int32_t>(p[x * c]) * k[x];
        o[static_cast<int64_t>(xx) * c + ch] = clip8(ss);
      }
    }
  }
  if (!need_v) {
    std::memcpy(dst, tmp.data(), static_cast<size_t>(wh) * row_len);
    return 0;
  }
  std::vector<int32_t> acc(row_len);
  for (int yy = 0; yy < wh; ++yy) {
    const int oy = y0 + yy;
    const int ymin = yfirst[oy] - r0, n = ycount[oy];
    const int32_t* k = &ky[static_cast<size_t>(oy) * ksize_v];
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int y = 0; y < n; ++y) {
      const uint8_t* in = tmp.data() + static_cast<int64_t>(ymin + y) * row_len;
      const int32_t ky_ = k[y];
      for (int64_t i = 0; i < row_len; ++i)
        acc[i] += static_cast<int32_t>(in[i]) * ky_;
    }
    uint8_t* o = dst + static_cast<int64_t>(yy) * row_len;
    for (int64_t i = 0; i < row_len; ++i) o[i] = clip8(acc[i]);
  }
  return 0;
}

// As mg_resample_bilinear_u8, for Pillow's NEAREST.
int mg_resample_nearest_u8(const uint8_t* src, int h, int w, int c,
                           uint8_t* dst, int out_h, int out_w, int y0,
                           int x0, int wh, int ww) {
  if (h <= 0 || w <= 0 || c <= 0 || out_h <= 0 || out_w <= 0 || wh <= 0 ||
      ww <= 0 || y0 < 0 || x0 < 0 || y0 + wh > out_h || x0 + ww > out_w)
    return -1;
  const std::vector<int> ys = nearest_indices(h, out_h);
  const std::vector<int> xs = nearest_indices(w, out_w);
  const int64_t row_len = static_cast<int64_t>(ww) * c;
  for (int yy = 0; yy < wh; ++yy) {
    uint8_t* o = dst + static_cast<int64_t>(yy) * row_len;
    const int sy = ys[y0 + yy];
    if (sy < 0) {
      std::memset(o, 0, row_len);
      continue;
    }
    const uint8_t* in = src + static_cast<int64_t>(sy) * w * c;
    for (int xx = 0; xx < ww; ++xx) {
      const int sx = xs[x0 + xx];
      for (int ch = 0; ch < c; ++ch)
        o[static_cast<int64_t>(xx) * c + ch] =
            sx < 0 ? 0 : in[static_cast<int64_t>(sx) * c + ch];
    }
  }
  return 0;
}

}  // extern "C"
