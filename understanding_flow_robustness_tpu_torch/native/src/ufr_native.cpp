// Host-side kernels of the PyTorch port's data pipeline (the port's own
// copy of understanding_flow_robustness_tpu/native/src/ufr_native.cpp,
// plus what the port reads PNG files and resizes frames with).
//
// Standard C++ only: no libpng, zlib or image library is assumed on the
// machine that runs the port.  native/__init__.py builds this file with
// g++ at first use into build/host_native/, keyed by a hash of source and
// flags, and binds it with ctypes (which releases the GIL for each call).
//
//   batch_u8_to_float01_pad, batch_f32_pad, resize_sparse_flow,
//   resize_bilinear_u8, decode_kitti_flow_u16: the JAX package's five.
//   png_unfilter:           PNG row filters 0-4 undone, any bytes per pixel.
//   resize_pil_bilinear_u8, resize_pil_box_u8, resize_pil_lanczos_u8:
//                           PIL's Image.resize(BILINEAR / BOX / LANCZOS) on
//                           u8.
//   resize_cv2_linear_f32:  cv2.resize(INTER_LINEAR) of a float32 image
//                           (read here from u8 samples).
//   resize_cv2_linear_u8, resize_cv2_linear_f{32,64}_by: cv2.resize(
//                           INTER_LINEAR) by factors fx, fy (the training
//                           augmentors').
//   pil_color_op, pil_hsv_convert: ImageEnhance's Brightness, Contrast and
//                           Color and the HSV hue roll of ColorJitter.
//
// The JPEG decoder is in ufr_jpeg.cpp, built into the same library.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// uint8 HWC image batch -> float32 in [0,1], with replicate padding to
// (out_h, out_w) (top/left offsets given).  in: (n, h, w, c), out: (n,
// out_h, out_w, c).
void batch_u8_to_float01_pad(const uint8_t* in, float* out, int64_t n,
                             int64_t h, int64_t w, int64_t c,
                             int64_t out_h, int64_t out_w, int64_t top,
                             int64_t left) {
  const float scale = 1.0f / 255.0f;
#pragma omp parallel for collapse(2)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t oy = 0; oy < out_h; ++oy) {
      int64_t sy = std::min(std::max(oy - top, int64_t(0)), h - 1);
      const uint8_t* src_row = in + ((i * h + sy) * w) * c;
      float* dst_row = out + ((i * out_h + oy) * out_w) * c;
      for (int64_t ox = 0; ox < out_w; ++ox) {
        int64_t sx = std::min(std::max(ox - left, int64_t(0)), w - 1);
        const uint8_t* px = src_row + sx * c;
        float* q = dst_row + ox * c;
        for (int64_t k = 0; k < c; ++k) q[k] = px[k] * scale;
      }
    }
  }
}

// float32 HWC -> float32 with replicate (zero_pad=0) or zero padding.
void batch_f32_pad(const float* in, float* out, int64_t n, int64_t h,
                   int64_t w, int64_t c, int64_t out_h, int64_t out_w,
                   int64_t top, int64_t left, int zero_pad) {
#pragma omp parallel for collapse(2)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t oy = 0; oy < out_h; ++oy) {
      int64_t sy = std::min(std::max(oy - top, int64_t(0)), h - 1);
      bool oob_y = (oy < top) || (oy >= top + h);
      const float* src_row = in + ((i * h + sy) * w) * c;
      float* dst_row = out + ((i * out_h + oy) * out_w) * c;
      for (int64_t ox = 0; ox < out_w; ++ox) {
        int64_t sx = std::min(std::max(ox - left, int64_t(0)), w - 1);
        bool oob = zero_pad && (oob_y || ox < left || ox >= left + w);
        const float* px = src_row + sx * c;
        float* q = dst_row + ox * c;
        for (int64_t k = 0; k < c; ++k) q[k] = oob ? 0.0f : px[k];
      }
    }
  }
}

// Sparse-aware flow resize (SparseFlowAugmentor.resize_sparse_flow_map):
// scatter the valid flow samples into the scaled grid, scaling vectors.
void resize_sparse_flow(const float* flow, const float* valid, int64_t h,
                        int64_t w, int64_t h1, int64_t w1, double fx,
                        double fy, float* flow_out, int32_t* valid_out) {
  std::memset(flow_out, 0, sizeof(float) * h1 * w1 * 2);
  std::memset(valid_out, 0, sizeof(int32_t) * h1 * w1);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      if (valid[y * w + x] < 1.0f) continue;
      // numpy's semantics: f64 products, round half to even
      int64_t xx = (int64_t)std::nearbyint((double)x * fx);
      int64_t yy = (int64_t)std::nearbyint((double)y * fy);
      if (xx <= 0 || xx >= w1 || yy <= 0 || yy >= h1) continue;
      flow_out[(yy * w1 + xx) * 2 + 0] =
          (float)((double)flow[(y * w + x) * 2 + 0] * fx);
      flow_out[(yy * w1 + xx) * 2 + 1] =
          (float)((double)flow[(y * w + x) * 2 + 1] * fy);
      valid_out[yy * w1 + xx] = 1;
    }
  }
}

// Bilinear uint8 HWC resize: half-pixel centres, edge clamping, f32
// weights, rounded to nearest (the JAX package's mask resize).
void resize_bilinear_u8(const uint8_t* in, uint8_t* out, int64_t h,
                        int64_t w, int64_t c, int64_t oh, int64_t ow) {
  const float sx = (float)w / ow;
  const float sy = (float)h / oh;
#pragma omp parallel for
  for (int64_t oy = 0; oy < oh; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int64_t y0 = (int64_t)std::floor(fy);
    float wy = fy - y0;
    int64_t y0c = std::min(std::max(y0, int64_t(0)), h - 1);
    int64_t y1c = std::min(std::max(y0 + 1, int64_t(0)), h - 1);
    for (int64_t ox = 0; ox < ow; ++ox) {
      float fxp = (ox + 0.5f) * sx - 0.5f;
      int64_t x0 = (int64_t)std::floor(fxp);
      float wx = fxp - x0;
      int64_t x0c = std::min(std::max(x0, int64_t(0)), w - 1);
      int64_t x1c = std::min(std::max(x0 + 1, int64_t(0)), w - 1);
      const uint8_t* p00 = in + (y0c * w + x0c) * c;
      const uint8_t* p01 = in + (y0c * w + x1c) * c;
      const uint8_t* p10 = in + (y1c * w + x0c) * c;
      const uint8_t* p11 = in + (y1c * w + x1c) * c;
      uint8_t* q = out + (oy * ow + ox) * c;
      for (int64_t k = 0; k < c; ++k) {
        float v = (1 - wy) * ((1 - wx) * p00[k] + wx * p01[k]) +
                  wy * ((1 - wx) * p10[k] + wx * p11[k]);
        q[k] = (uint8_t)std::lround(std::min(std::max(v, 0.0f), 255.0f));
      }
    }
  }
}

// KITTI uint16 flow PNG payload: (u16 - 2^15) / 64 and the valid channel.
void decode_kitti_flow_u16(const uint16_t* rgb16, int64_t h, int64_t w,
                           float* flow, float* valid) {
#pragma omp parallel for
  for (int64_t i = 0; i < h * w; ++i) {
    flow[i * 2 + 0] = ((float)rgb16[i * 3 + 0] - 32768.0f) / 64.0f;
    flow[i * 2 + 1] = ((float)rgb16[i * 3 + 1] - 32768.0f) / 64.0f;
    valid[i] = (float)rgb16[i * 3 + 2];
  }
}

// PNG scanline reconstruction (PNG spec, section 9).  in: h rows of one
// filter-type byte and row_bytes filtered bytes (the inflated IDAT
// stream); out: h rows of row_bytes.  bpp is the bytes of one pixel
// (rounded up to 1).  Average and Paeth depend on the previous byte of
// the same row, so each row is one sequential pass.  Returns 0, or 1 + the
// index of the first row whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t h,
                     int64_t row_bytes, int64_t bpp) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = in + y * (row_bytes + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* dst = out + y * row_bytes;
    const uint8_t* prev = y > 0 ? dst - row_bytes : nullptr;
    const int64_t lead = std::min(bpp, row_bytes);
    switch (type) {
      case 0:
        std::memcpy(dst, src, row_bytes);
        break;
      case 1:  // Sub
        std::memcpy(dst, src, lead);
        for (int64_t i = bpp; i < row_bytes; ++i)
          dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
        break;
      case 2:  // Up
        if (prev == nullptr) {
          std::memcpy(dst, src, row_bytes);
        } else {
          for (int64_t i = 0; i < row_bytes; ++i)
            dst[i] = (uint8_t)(src[i] + prev[i]);
        }
        break;
      case 3:  // Average
        for (int64_t i = 0; i < lead; ++i)
          dst[i] = (uint8_t)(src[i] + ((prev ? prev[i] : 0) >> 1));
        for (int64_t i = bpp; i < row_bytes; ++i)
          dst[i] = (uint8_t)(src[i] +
                             ((dst[i - bpp] + (prev ? prev[i] : 0)) >> 1));
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// PIL's two-pass separable resampling on 8-bit samples (Pillow,
// src/libImaging/Resample.c) with the BILINEAR (triangle, support 1), the
// BOX (support 1/2) or the LANCZOS (sinc(x) sinc(x/3), support 3) filter: the support widens by the scale on a
// downscale, coefficients are normalised in double and rounded to 22-bit
// fixed point, and each pass rounds its sums to u8.
namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double pil_triangle(double t) {
  if (t < 0.0) t = -t;
  return t < 1.0 ? 1.0 - t : 0.0;
}

double pil_box(double t) { return (t > -0.5 && t <= 0.5) ? 1.0 : 0.0; }

double pil_sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

// Resample.c lanczos_filter: the sinc truncated at 3 lobes
double pil_lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return pil_sinc(x) * pil_sinc(x / 3);
  return 0.0;
}

// Per output sample: the first source index, the count of taps, and
// ksize fixed-point coefficients.
int pil_coeffs(int64_t in_size, int64_t out_size, double support0,
               double (*filter)(double), std::vector<int>* bounds,
               std::vector<int32_t>* kk) {
  const double scale = (double)((float)in_size - 0.0f) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = support0 * filterscale;
  const int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> pre((size_t)out_size * ksize, 0.0);
  bounds->assign((size_t)out_size * 2, 0);
  for (int64_t xx = 0; xx < out_size; ++xx) {
    const double center = 0.0 + (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = (int)in_size;
    xmax -= xmin;
    double* k = &pre[(size_t)xx * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double wgt = filter((x + xmin - center + 0.5) * ss);
      k[x] = wgt;
      ww += wgt;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    (*bounds)[xx * 2 + 0] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->resize(pre.size());
  for (size_t i = 0; i < pre.size(); ++i) {
    (*kk)[i] = pre[i] < 0 ? (int32_t)(-0.5 + pre[i] * (1 << kPrecisionBits))
                          : (int32_t)(0.5 + pre[i] * (1 << kPrecisionBits));
  }
  return ksize;
}

inline uint8_t pil_clip8(int32_t ss) {
  const int32_t v = ss >> kPrecisionBits;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Image.resize((ow, oh), filter) of a u8 (h, w, c) image
void pil_resample(const uint8_t* in, uint8_t* out, int64_t h, int64_t w,
                  int64_t c, int64_t oh, int64_t ow, double support,
                  double (*filter)(double)) {
  if (h == oh && w == ow) {
    std::memcpy(out, in, (size_t)h * w * c);
    return;
  }
  std::vector<int> bx, by;
  std::vector<int32_t> kx, ky;
  const int ksx = pil_coeffs(w, ow, support, filter, &bx, &kx);
  const int ksy = pil_coeffs(h, oh, support, filter, &by, &ky);
  const bool horizontal = w != ow, vertical = h != oh;
  // the horizontal pass covers only the source rows the vertical pass reads
  const int64_t y_first = vertical ? by[0] : 0;
  const int64_t y_last = vertical ? by[(oh - 1) * 2] + by[(oh - 1) * 2 + 1]
                                   : h;
  const uint8_t* src = in;
  std::vector<uint8_t> tmp;
  if (horizontal) {
    const int64_t rows = y_last - y_first;
    tmp.resize((size_t)rows * ow * c);
#pragma omp parallel for
    for (int64_t y = 0; y < rows; ++y) {
      const uint8_t* row = in + (y + y_first) * w * c;
      for (int64_t xx = 0; xx < ow; ++xx) {
        const int xmin = bx[xx * 2], xmax = bx[xx * 2 + 1];
        const int32_t* k = &kx[(size_t)xx * ksx];
        for (int64_t ch = 0; ch < c; ++ch) {
          int32_t ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; ++x)
            ss += (int32_t)row[(x + xmin) * c + ch] * k[x];
          tmp[(y * ow + xx) * c + ch] = pil_clip8(ss);
        }
      }
    }
    src = tmp.data();
  }
  const int64_t sw = horizontal ? ow : w;
  if (!vertical) {
    std::memcpy(out, src, (size_t)oh * ow * c);
    return;
  }
  const int64_t shift = horizontal ? y_first : 0;
#pragma omp parallel for
  for (int64_t yy = 0; yy < oh; ++yy) {
    const int ymin = by[yy * 2] - (int)shift, ymax = by[yy * 2 + 1];
    const int32_t* k = &ky[(size_t)yy * ksy];
    for (int64_t xx = 0; xx < ow * c; ++xx) {
      int32_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y)
        ss += (int32_t)src[(y + ymin) * sw * c + xx] * k[y];
      out[yy * ow * c + xx] = pil_clip8(ss);
    }
  }
}

}  // namespace

// PIL Image.resize((ow, oh), BILINEAR) of a u8 (h, w, c) image, c = 1
// ("L") or 3 ("RGB").
void resize_pil_bilinear_u8(const uint8_t* in, uint8_t* out, int64_t h,
                            int64_t w, int64_t c, int64_t oh, int64_t ow) {
  pil_resample(in, out, h, w, c, oh, ow, 1.0, pil_triangle);
}

// PIL Image.resize((ow, oh), BOX), the same shapes
void resize_pil_box_u8(const uint8_t* in, uint8_t* out, int64_t h, int64_t w,
                       int64_t c, int64_t oh, int64_t ow) {
  pil_resample(in, out, h, w, c, oh, ow, 0.5, pil_box);
}

// PIL Image.resize((ow, oh), LANCZOS), the same shapes: the negative
// lobes make sums below 0 and above 255, which each pass clips
void resize_pil_lanczos_u8(const uint8_t* in, uint8_t* out, int64_t h,
                           int64_t w, int64_t c, int64_t oh, int64_t ow) {
  pil_resample(in, out, h, w, c, oh, ow, 3.0, pil_lanczos);
}

// cv2.resize(img_f32, (ow, oh), interpolation=INTER_LINEAR) of an image
// whose float32 samples are the u8 values of `in`: per output column the
// source index sx = floor(fx) and the weight f = fx - sx of fx = (dx + 0.5)
// * (w / ow) - 0.5, all in double, f rounded to float; left of the image
// the column is 0 and right of it w-1, with f = 0.  Rows take the same
// rule, reading clamped rows without moving the weight.  Each pass blends
// as fma(f, s1 - s0, s0) in float, which is how the OpenCV build the tests
// hold it against rounds, bit for bit (an exact 2x reduction included).
void resize_cv2_linear_f32(const uint8_t* in, float* out, int64_t h,
                           int64_t w, int64_t c, int64_t oh, int64_t ow) {
  auto coeffs = [](int64_t n, int64_t on, bool move, std::vector<int64_t>* s,
                   std::vector<float>* f) {
    const double scale = (double)n / on;
    s->resize(on);
    f->resize(on);
    for (int64_t d = 0; d < on; ++d) {
      const double fd = (d + 0.5) * scale - 0.5;
      int64_t i = (int64_t)std::floor(fd);
      float frac = (float)(fd - i);
      if (move && i < 0) i = 0, frac = 0.f;
      if (move && i >= n - 1) i = n - 1, frac = 0.f;
      (*s)[d] = i;
      (*f)[d] = frac;
    }
  };
  std::vector<int64_t> xofs, yofs;
  std::vector<float> ax, ay;
  coeffs(w, ow, true, &xofs, &ax);
  coeffs(h, oh, false, &yofs, &ay);
#pragma omp parallel
  {
    std::vector<float> row0(ow * c), row1(ow * c);
    auto hresize = [&](int64_t sy, float* dst) {
      const uint8_t* s = in + sy * w * c;
      for (int64_t dx = 0; dx < ow; ++dx) {
        const int64_t sx = xofs[dx];
        for (int64_t ch = 0; ch < c; ++ch) {
          const float s0 = (float)s[sx * c + ch];
          dst[dx * c + ch] =
              ax[dx] == 0.f
                  ? s0
                  : std::fma(ax[dx], (float)s[(sx + 1) * c + ch] - s0, s0);
        }
      }
    };
#pragma omp for
    for (int64_t dy = 0; dy < oh; ++dy) {
      const int64_t sy = yofs[dy];
      hresize(std::min(std::max(sy, int64_t(0)), h - 1), row0.data());
      hresize(std::min(std::max(sy + 1, int64_t(0)), h - 1), row1.data());
      float* d = out + dy * ow * c;
      for (int64_t i = 0; i < ow * c; ++i)
        d[i] = std::fma(ay[dy], row1[i] - row0[i], row0[i]);
    }
  }
}

// cv2.resize(img, None, fx=fx, fy=fy, interpolation=INTER_LINEAR) of a
// u8 (h, w, c) image into (oh, ow, c), oh = round(h fy) and ow = round(w
// fx) (the caller's).  OpenCV's coefficients: per output column the float
// f = (float)((dx + 0.5) / fx - 0.5), the source sx = floor(f), weights
// 1 - (f - sx) and f - sx rounded to 11-bit fixed point, clamped to the
// edge columns with weight 0; rows the same, reading clamped rows.  The
// horizontal pass sums exactly in int; the vertical one rounds as
// OpenCV's vector code (VResizeLinearVec_32s8u) does on every element,
// ((s0 >> 4) b0 >> 16) + ((s1 >> 4) b1 >> 16) + 2 >> 2.  An exact 2x
// reduction takes OpenCV's area path instead: each full 2x2 block's sum
// + 2 >> 2 (its vector code for 1, 3 and 4 channels; 2 channels round the
// quarter half to even) and a partial block's mean rounded half to even.
namespace {

void cv2_linear_coeffs(int64_t n, int64_t on, double inv_scale, bool clamp,
                       std::vector<int64_t>* s, std::vector<float>* f) {
  const double scale = 1.0 / inv_scale;
  s->resize(on);
  f->resize(on);
  for (int64_t d = 0; d < on; ++d) {
    float fd = (float)((d + 0.5) * scale - 0.5);
    int64_t i = (int64_t)std::floor(fd);
    fd -= (float)i;
    if (clamp && i < 0) i = 0, fd = 0.f;
    if (clamp && i >= n - 1) i = n - 1, fd = 0.f;
    (*s)[d] = i;
    (*f)[d] = fd;
  }
}

inline int32_t cv_round_coef(float v) {
  return (int32_t)std::nearbyint(v * 2048.0f);
}

}  // namespace

void resize_cv2_linear_u8(const uint8_t* in, uint8_t* out, int64_t h,
                          int64_t w, int64_t c, int64_t oh, int64_t ow,
                          double fx, double fy) {
  if (fx == 0.5 && fy == 0.5) {
    for (int64_t dy = 0; dy < oh; ++dy) {
      for (int64_t dx = 0; dx < ow; ++dx) {
        const int64_t y0 = 2 * dy, x0 = 2 * dx;
        const bool full = y0 + 1 < h && x0 + 1 < w;
        for (int64_t ch = 0; ch < c; ++ch) {
          int32_t sum = 0, count = 0;
          for (int64_t y = y0; y < std::min(y0 + 2, h); ++y)
            for (int64_t x = x0; x < std::min(x0 + 2, w); ++x)
              sum += in[(y * w + x) * c + ch], ++count;
          int32_t v;
          if (full && c != 2) v = (sum + 2) >> 2;
          else if (full) v = (int32_t)std::nearbyint((float)sum * 0.25f);
          else v = (int32_t)std::nearbyint((float)sum / (float)count);
          out[(dy * ow + dx) * c + ch] = (uint8_t)std::min(std::max(v, 0), 255);
        }
      }
    }
    return;
  }
  std::vector<int64_t> xofs, yofs;
  std::vector<float> ax, ay;
  cv2_linear_coeffs(w, ow, fx, true, &xofs, &ax);
  cv2_linear_coeffs(h, oh, fy, false, &yofs, &ay);
  std::vector<int32_t> a0(ow), a1(ow);
  for (int64_t d = 0; d < ow; ++d) {
    a0[d] = cv_round_coef(1.f - ax[d]);
    a1[d] = cv_round_coef(ax[d]);
  }
  std::vector<int32_t> row0(ow * c), row1(ow * c);
  auto hresize = [&](int64_t sy, int32_t* dst) {
    const uint8_t* s = in + sy * w * c;
    for (int64_t dx = 0; dx < ow; ++dx) {
      const int64_t sx = xofs[dx], sx1 = std::min(sx + 1, w - 1);
      for (int64_t ch = 0; ch < c; ++ch)
        dst[dx * c + ch] =
            s[sx * c + ch] * a0[dx] + s[sx1 * c + ch] * a1[dx];
    }
  };
  for (int64_t dy = 0; dy < oh; ++dy) {
    const int64_t sy = yofs[dy];
    hresize(std::min(std::max(sy, int64_t(0)), h - 1), row0.data());
    hresize(std::min(std::max(sy + 1, int64_t(0)), h - 1), row1.data());
    const int32_t b0 = cv_round_coef(1.f - ay[dy]), b1 = cv_round_coef(ay[dy]);
    uint8_t* d = out + dy * ow * c;
    for (int64_t i = 0; i < ow * c; ++i) {
      const int32_t v = (((row0[i] >> 4) * b0) >> 16) +
                        (((row1[i] >> 4) * b1) >> 16) + 2 >> 2;
      d[i] = (uint8_t)std::min(std::max(v, 0), 255);
    }
  }
}

// cv2.resize(flow, None, fx=fx, fy=fy, interpolation=INTER_LINEAR) of a
// float32 or float64 (h, w, c) array: the coefficients of
// resize_cv2_linear_u8 in float, each pass s0 (1 - f) + s1 f in the
// array's type (no FMA).  An exact 2x reduction of a float32 array is
// OpenCV's area path: a full 2x2 block's samples summed in row order times
// 0.25, a partial block's sum over its count.
extern "C++" {
namespace {

template <typename T>
void cv2_linear_float_by(const T* in, T* out, int64_t h, int64_t w,
                         int64_t c, int64_t oh, int64_t ow, double fx,
                         double fy) {
  std::vector<int64_t> xofs, yofs;
  std::vector<float> ax, ay;
  cv2_linear_coeffs(w, ow, fx, true, &xofs, &ax);
  cv2_linear_coeffs(h, oh, fy, false, &yofs, &ay);
  std::vector<T> row0(ow * c), row1(ow * c);
  auto hresize = [&](int64_t sy, T* dst) {
    const T* s = in + sy * w * c;
    for (int64_t dx = 0; dx < ow; ++dx) {
      const int64_t sx = xofs[dx], sx1 = std::min(sx + 1, w - 1);
      const float f1 = ax[dx], f0 = 1.f - f1;
      for (int64_t ch = 0; ch < c; ++ch)
        dst[dx * c + ch] = s[sx * c + ch] * f0 + s[sx1 * c + ch] * f1;
    }
  };
  for (int64_t dy = 0; dy < oh; ++dy) {
    const int64_t sy = yofs[dy];
    hresize(std::min(std::max(sy, int64_t(0)), h - 1), row0.data());
    hresize(std::min(std::max(sy + 1, int64_t(0)), h - 1), row1.data());
    const float f1 = ay[dy], f0 = 1.f - f1;
    T* d = out + dy * ow * c;
    for (int64_t i = 0; i < ow * c; ++i) d[i] = row0[i] * f0 + row1[i] * f1;
  }
}

}  // namespace
}  // extern "C++"

void resize_cv2_linear_f32_by(const float* in, float* out, int64_t h,
                              int64_t w, int64_t c, int64_t oh, int64_t ow,
                              double fx, double fy) {
  if (fx == 0.5 && fy == 0.5) {
    for (int64_t dy = 0; dy < oh; ++dy) {
      for (int64_t dx = 0; dx < ow; ++dx) {
        const int64_t y0 = 2 * dy, x0 = 2 * dx;
        const bool full = y0 + 1 < h && x0 + 1 < w;
        for (int64_t ch = 0; ch < c; ++ch) {
          float sum = 0.f;
          int count = 0;
          for (int64_t y = y0; y < std::min(y0 + 2, h); ++y)
            for (int64_t x = x0; x < std::min(x0 + 2, w); ++x)
              sum += in[(y * w + x) * c + ch], ++count;
          out[(dy * ow + dx) * c + ch] =
              full ? sum * 0.25f : sum / (float)count;
        }
      }
    }
    return;
  }
  cv2_linear_float_by(in, out, h, w, c, oh, ow, fx, fy);
}

void resize_cv2_linear_f64_by(const double* in, double* out, int64_t h,
                              int64_t w, int64_t c, int64_t oh, int64_t ow,
                              double fx, double fy) {
  cv2_linear_float_by(in, out, h, w, c, oh, ow, fx, fy);
}

// PIL's colour operations on an RGB u8 image of n pixels, in place, as
// Pillow computes them (libImaging/Blend.c, Convert.c): ImageEnhance's
// Brightness (op 0), Contrast (op 1) and Color (op 2) blend the image
// with a degenerate image by a float factor; hue (op 3) rolls the H of
// the RGB -> HSV -> RGB round trip by `shift` (mod 256).
namespace {

inline uint8_t pil_l(const uint8_t* p) {
  return (uint8_t)((p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
}

// Image.blend(im1, im2, alpha): im1 + alpha (im2 - im1) in float,
// truncated; clipped first when alpha lies outside [0, 1].
inline uint8_t pil_blend(int in1, int in2, float alpha) {
  if (alpha >= 0 && alpha <= 1.0) {
    return (uint8_t)(in1 + alpha * (in2 - in1));
  }
  const float t = (float)(in1 + alpha * (in2 - in1));
  if (t <= 0.0) return 0;
  if (t >= 255.0) return 255;
  return (uint8_t)t;
}

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// Convert.c rgb2hsv_row
inline void rgb2hsv(const uint8_t* in, uint8_t* out) {
  const uint8_t r = in[0], g = in[1], b = in[2];
  const uint8_t maxc = std::max(r, std::max(g, b));
  const uint8_t minc = std::min(r, std::min(g, b));
  uint8_t uh, us;
  if (minc == maxc) {
    uh = 0;
    us = 0;
  } else {
    float h;
    const float cr = (float)(maxc - minc);
    const float s = cr / (float)maxc;
    const float rc = ((float)(maxc - r)) / cr;
    const float gc = ((float)(maxc - g)) / cr;
    const float bc = ((float)(maxc - b)) / cr;
    if (r == maxc) {
      h = bc - gc;
    } else if (g == maxc) {
      h = 2.0 + rc - bc;
    } else {
      h = 4.0 + gc - rc;
    }
    h = std::fmod((h / 6.0 + 1.0), 1.0);
    uh = clip8((int)(h * 255.0));
    us = clip8((int)(s * 255.0));
  }
  out[0] = uh;
  out[1] = us;
  out[2] = maxc;
}

// Convert.c hsv2rgb
inline void hsv2rgb(const uint8_t* in, uint8_t* out) {
  const uint8_t h = in[0], s = in[1], v = in[2];
  if (s == 0) {
    out[0] = out[1] = out[2] = v;
    return;
  }
  const int i = (int)std::floor((float)h * 6.0 / 255.0);
  const float f = (float)h * 6.0 / 255.0 - (float)i;
  const float fs = ((float)s) / 255.0;
  const int p = (int)std::round((float)v * (1.0 - fs));
  const int q = (int)std::round((float)v * (1.0 - fs * f));
  const int t = (int)std::round((float)v * (1.0 - fs * (1.0 - f)));
  const uint8_t up = clip8(p), uq = clip8(q), ut = clip8(t);
  switch (i % 6) {
    case 0: out[0] = v; out[1] = ut; out[2] = up; break;
    case 1: out[0] = uq; out[1] = v; out[2] = up; break;
    case 2: out[0] = up; out[1] = v; out[2] = ut; break;
    case 3: out[0] = up; out[1] = uq; out[2] = v; break;
    case 4: out[0] = ut; out[1] = up; out[2] = v; break;
    case 5: out[0] = v; out[1] = up; out[2] = uq; break;
  }
}

}  // namespace

void pil_color_op(uint8_t* img, int64_t n, int op, double factor,
                  int shift) {
  const float alpha = (float)factor;
  if (op == 0) {
    for (int64_t i = 0; i < 3 * n; ++i) img[i] = pil_blend(0, img[i], alpha);
  } else if (op == 1) {
    // ImageStat's mean of the L image, rounded as int(mean + 0.5)
    int64_t sum = 0;
    for (int64_t i = 0; i < n; ++i) sum += pil_l(img + 3 * i);
    const int mean = (int)((double)sum / (double)n + 0.5);
    for (int64_t i = 0; i < 3 * n; ++i) img[i] = pil_blend(mean, img[i], alpha);
  } else if (op == 2) {
    for (int64_t i = 0; i < n; ++i) {
      uint8_t* p = img + 3 * i;
      const int l = pil_l(p);
      for (int k = 0; k < 3; ++k) p[k] = pil_blend(l, p[k], alpha);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      uint8_t* p = img + 3 * i;
      uint8_t hsv[3];
      rgb2hsv(p, hsv);
      hsv[0] = (uint8_t)(((hsv[0] + shift) % 256 + 256) % 256);
      hsv2rgb(hsv, p);
    }
  }
}

// The two conversions alone, for the tests: RGB -> HSV (to_hsv = 1) or
// HSV -> RGB (0) of n pixels.
void pil_hsv_convert(const uint8_t* in, uint8_t* out, int64_t n, int to_hsv) {
  for (int64_t i = 0; i < n; ++i) {
    if (to_hsv) rgb2hsv(in + 3 * i, out + 3 * i);
    else hsv2rgb(in + 3 * i, out + 3 * i);
  }
}

int ufr_native_version() { return 3; }

}  // extern "C"
