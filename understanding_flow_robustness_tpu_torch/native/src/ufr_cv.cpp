// The OpenCV and Pillow operations that the PyTorch port's corruptions,
// self-correlated patches and image writers call, in standard C++, so
// that the machine with the card runs them with neither cv2 nor PIL.
// Each function reproduces the arithmetic of the library call it replaces
// (OpenCV 5.0 and Pillow 12.1, the versions the CPU tests hold it against)
// in the same order of operations, so that the results are the same bits;
// where OpenCV's SIMD body and its scalar tail round differently, both
// are reproduced, keyed by the column as OpenCV's loops split it.
//
//   cv_rgb2hsv_f32, cv_hsv2rgb_f32: cvtColor COLOR_RGB2HSV / HSV2RGB, f32.
//   cv_sep_filter_f32:   sepFilter2D / GaussianBlur with a symmetric 3- or
//                        5-tap float kernel, BORDER_REFLECT_101, 1 channel.
//   cv_filter2d_f64:     filter2D of an f64 plane with an f32 kernel.
//   cv_affine_transform: getAffineTransform (6x6 LU, partial pivoting).
//   cv_warp_affine_f64:  warpAffine INTER_LINEAR, BORDER_REFLECT_101: the
//                        coordinates in 1/32 pixel, the weights from the
//                        bilinear table.
//   cv_resize_cubic_f64, cv_resize_cubic_u8: resize INTER_CUBIC.
//   cv_canny_u8, cv_distance_l2_5, cv_box3_f32, cv_box3_u8,
//   cv_equalize_hist, cv_filter2d_u8_3x3: spatter's water branch.
//   cv_circle_mask:      circle(..., thickness, LINE_8) as a pixel mask.
//   pil_resize_nearest_u8: Image.resize NEAREST (BOX is in ufr_native.cpp,
//                        beside BILINEAR).
//   gif_lzw, gif_unlzw:  GIF's variable-length LZW of 8-bit indices, and
//                        its inverse.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// borderInterpolate(BORDER_REFLECT_101)
inline int64_t reflect101(int64_t p, int64_t n) {
  if (n == 1) return 0;
  while (p < 0 || p >= n) p = p < 0 ? -p : 2 * n - 2 - p;
  return p;
}

// OpenCV's SIMD loops run 8 float lanes (the AVX2 build) over a row; the
// scalar remainder starts here.
inline int64_t vec_end(int64_t n) { return n - n % 8; }

// cv::SinTable (drawing.cpp): sin of 0..450 degrees to 7 decimals
const float kSinTable[451] = {
    0.0f, 0.0174524002f, 0.0348994993f, 0.0523359999f, 0.0697565004f, 0.0871556997f,
    0.104528502f, 0.121869303f, 0.139173105f, 0.156434506f, 0.173648193f, 0.190808997f,
    0.2079117f, 0.224951103f, 0.241921902f, 0.258819014f, 0.275637388f, 0.29237169f,
    0.309017003f, 0.325568199f, 0.342020094f, 0.35836789f, 0.374606609f, 0.390731096f,
    0.406736612f, 0.4226183f, 0.438371092f, 0.453990489f, 0.469471604f, 0.484809607f,
    0.5f, 0.515038073f, 0.529919326f, 0.544638991f, 0.559192896f, 0.573576391f,
    0.587785304f, 0.601814985f, 0.615661502f, 0.629320383f, 0.642787576f, 0.656059027f,
    0.669130623f, 0.681998372f, 0.694658399f, 0.707106829f, 0.719339788f, 0.7313537f,
    0.74314481f, 0.754709601f, 0.766044378f, 0.777145982f, 0.788010776f, 0.798635483f,
    0.809017003f, 0.819151998f, 0.829037607f, 0.838670611f, 0.848048091f, 0.857167304f,
    0.866025388f, 0.874619722f, 0.882947624f, 0.891006529f, 0.898793995f, 0.906307817f,
    0.913545489f, 0.920504928f, 0.927183926f, 0.933580399f, 0.939692616f, 0.945518613f,
    0.95105648f, 0.956304789f, 0.96126169f, 0.965925813f, 0.970295727f, 0.974370122f,
    0.978147626f, 0.981627226f, 0.984807789f, 0.987688303f, 0.990268111f, 0.992546201f,
    0.994521916f, 0.99619472f, 0.997564077f, 0.99862951f, 0.999390781f, 0.99984771f,
    1.0f, 0.99984771f, 0.999390781f, 0.99862951f, 0.997564077f, 0.99619472f,
    0.994521916f, 0.992546201f, 0.990268111f, 0.987688303f, 0.984807789f, 0.981627226f,
    0.978147626f, 0.974370122f, 0.970295727f, 0.965925813f, 0.96126169f, 0.956304789f,
    0.95105648f, 0.945518613f, 0.939692616f, 0.933580399f, 0.927183926f, 0.920504928f,
    0.913545489f, 0.906307817f, 0.898793995f, 0.891006529f, 0.882947624f, 0.874619722f,
    0.866025388f, 0.857167304f, 0.848048091f, 0.838670611f, 0.829037607f, 0.819151998f,
    0.809017003f, 0.798635483f, 0.788010776f, 0.777145982f, 0.766044378f, 0.754709601f,
    0.74314481f, 0.7313537f, 0.719339788f, 0.707106829f, 0.694658399f, 0.681998372f,
    0.669130623f, 0.656059027f, 0.642787576f, 0.629320383f, 0.615661502f, 0.601814985f,
    0.587785304f, 0.573576391f, 0.559192896f, 0.544638991f, 0.529919326f, 0.515038073f,
    0.5f, 0.484809607f, 0.469471604f, 0.453990489f, 0.438371092f, 0.4226183f,
    0.406736612f, 0.390731096f, 0.374606609f, 0.35836789f, 0.342020094f, 0.325568199f,
    0.309017003f, 0.29237169f, 0.275637388f, 0.258819014f, 0.241921902f, 0.224951103f,
    0.2079117f, 0.190808997f, 0.173648193f, 0.156434506f, 0.139173105f, 0.121869303f,
    0.104528502f, 0.0871556997f, 0.0697565004f, 0.0523359999f, 0.0348994993f, 0.0174524002f,
    0.0f, -0.0174524002f, -0.0348994993f, -0.0523359999f, -0.0697565004f, -0.0871556997f,
    -0.104528502f, -0.121869303f, -0.139173105f, -0.156434506f, -0.173648193f, -0.190808997f,
    -0.2079117f, -0.224951103f, -0.241921902f, -0.258819014f, -0.275637388f, -0.29237169f,
    -0.309017003f, -0.325568199f, -0.342020094f, -0.35836789f, -0.374606609f, -0.390731096f,
    -0.406736612f, -0.4226183f, -0.438371092f, -0.453990489f, -0.469471604f, -0.484809607f,
    -0.5f, -0.515038073f, -0.529919326f, -0.544638991f, -0.559192896f, -0.573576391f,
    -0.587785304f, -0.601814985f, -0.615661502f, -0.629320383f, -0.642787576f, -0.656059027f,
    -0.669130623f, -0.681998372f, -0.694658399f, -0.707106829f, -0.719339788f, -0.7313537f,
    -0.74314481f, -0.754709601f, -0.766044378f, -0.777145982f, -0.788010776f, -0.798635483f,
    -0.809017003f, -0.819151998f, -0.829037607f, -0.838670611f, -0.848048091f, -0.857167304f,
    -0.866025388f, -0.874619722f, -0.882947624f, -0.891006529f, -0.898793995f, -0.906307817f,
    -0.913545489f, -0.920504928f, -0.927183926f, -0.933580399f, -0.939692616f, -0.945518613f,
    -0.95105648f, -0.956304789f, -0.96126169f, -0.965925813f, -0.970295727f, -0.974370122f,
    -0.978147626f, -0.981627226f, -0.984807789f, -0.987688303f, -0.990268111f, -0.992546201f,
    -0.994521916f, -0.99619472f, -0.997564077f, -0.99862951f, -0.999390781f, -0.99984771f,
    -1.0f, -0.99984771f, -0.999390781f, -0.99862951f, -0.997564077f, -0.99619472f,
    -0.994521916f, -0.992546201f, -0.990268111f, -0.987688303f, -0.984807789f, -0.981627226f,
    -0.978147626f, -0.974370122f, -0.970295727f, -0.965925813f, -0.96126169f, -0.956304789f,
    -0.95105648f, -0.945518613f, -0.939692616f, -0.933580399f, -0.927183926f, -0.920504928f,
    -0.913545489f, -0.906307817f, -0.898793995f, -0.891006529f, -0.882947624f, -0.874619722f,
    -0.866025388f, -0.857167304f, -0.848048091f, -0.838670611f, -0.829037607f, -0.819151998f,
    -0.809017003f, -0.798635483f, -0.788010776f, -0.777145982f, -0.766044378f, -0.754709601f,
    -0.74314481f, -0.7313537f, -0.719339788f, -0.707106829f, -0.694658399f, -0.681998372f,
    -0.669130623f, -0.656059027f, -0.642787576f, -0.629320383f, -0.615661502f, -0.601814985f,
    -0.587785304f, -0.573576391f, -0.559192896f, -0.544638991f, -0.529919326f, -0.515038073f,
    -0.5f, -0.484809607f, -0.469471604f, -0.453990489f, -0.438371092f, -0.4226183f,
    -0.406736612f, -0.390731096f, -0.374606609f, -0.35836789f, -0.342020094f, -0.325568199f,
    -0.309017003f, -0.29237169f, -0.275637388f, -0.258819014f, -0.241921902f, -0.224951103f,
    -0.2079117f, -0.190808997f, -0.173648193f, -0.156434506f, -0.139173105f, -0.121869303f,
    -0.104528502f, -0.0871556997f, -0.0697565004f, -0.0523359999f, -0.0348994993f, -0.0174524002f,
    -0.0f, 0.0174524002f, 0.0348994993f, 0.0523359999f, 0.0697565004f, 0.0871556997f,
    0.104528502f, 0.121869303f, 0.139173105f, 0.156434506f, 0.173648193f, 0.190808997f,
    0.2079117f, 0.224951103f, 0.241921902f, 0.258819014f, 0.275637388f, 0.29237169f,
    0.309017003f, 0.325568199f, 0.342020094f, 0.35836789f, 0.374606609f, 0.390731096f,
    0.406736612f, 0.4226183f, 0.438371092f, 0.453990489f, 0.469471604f, 0.484809607f,
    0.5f, 0.515038073f, 0.529919326f, 0.544638991f, 0.559192896f, 0.573576391f,
    0.587785304f, 0.601814985f, 0.615661502f, 0.629320383f, 0.642787576f, 0.656059027f,
    0.669130623f, 0.681998372f, 0.694658399f, 0.707106829f, 0.719339788f, 0.7313537f,
    0.74314481f, 0.754709601f, 0.766044378f, 0.777145982f, 0.788010776f, 0.798635483f,
    0.809017003f, 0.819151998f, 0.829037607f, 0.838670611f, 0.848048091f, 0.857167304f,
    0.866025388f, 0.874619722f, 0.882947624f, 0.891006529f, 0.898793995f, 0.906307817f,
    0.913545489f, 0.920504928f, 0.927183926f, 0.933580399f, 0.939692616f, 0.945518613f,
    0.95105648f, 0.956304789f, 0.96126169f, 0.965925813f, 0.970295727f, 0.974370122f,
    0.978147626f, 0.981627226f, 0.984807789f, 0.987688303f, 0.990268111f, 0.992546201f,
    0.994521916f, 0.99619472f, 0.997564077f, 0.99862951f, 0.999390781f, 0.99984771f,
    1.0f,
};

// --------------------------------------------------------------------------
// drawing.cpp: integer circles, fixed-point lines and convex polygons
// --------------------------------------------------------------------------

constexpr int kXYShift = 16;
constexpr int64_t kXYOne = (int64_t)1 << kXYShift;

struct Mask {
  uint8_t* m;
  int64_t w, h;
  void put(int64_t x, int64_t y) const {
    if (x >= 0 && x < w && y >= 0 && y < h) m[y * w + x] = 1;
  }
  void hline(int64_t y, int64_t x1, int64_t x2) const {
    if (y < 0 || y >= h) return;
    x1 = std::max<int64_t>(x1, 0);
    x2 = std::min<int64_t>(x2, w - 1);
    for (int64_t x = x1; x <= x2; ++x) m[y * w + x] = 1;
  }
};

// Circle(): the midpoint circle, outline or filled (ThickLine's joints)
void circle_int(const Mask& img, int64_t cx, int64_t cy, int64_t radius,
                bool fill) {
  int64_t err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  while (dx >= dy) {
    const int64_t y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    const int64_t x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (x11 < img.w && x12 >= 0 && y21 < img.h && y22 >= 0) {
      if (fill) {
        img.hline(y11, x11, x12);
        img.hline(y12, x11, x12);
        if (x21 < img.w && x22 >= 0) {
          img.hline(y21, x21, x22);
          img.hline(y22, x21, x22);
        }
      } else {
        img.put(x11, y11);
        img.put(x12, y11);
        img.put(x11, y12);
        img.put(x12, y12);
        img.put(x21, y21);
        img.put(x22, y21);
        img.put(x21, y22);
        img.put(x22, y22);
      }
    }
    ++dy;
    err += plus;
    plus += 2;
    const int64_t mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// clipLine on the XY_SHIFT-scaled image size
bool clip_line(int64_t W, int64_t H, int64_t& x1, int64_t& y1, int64_t& x2,
               int64_t& y2) {
  const int64_t right = W - 1, bottom = H - 1;
  if (W <= 0 || H <= 0) return false;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Line2(): an 8-connected line between XY_SHIFT fixed-point points
void line2(const Mask& img, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!clip_line(img.w << kXYShift, img.h << kXYShift, x1, y1, x2, y2))
    return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
  const int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
  int64_t x_step, y_step, ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    x1 ^= x2 & j;
    x2 ^= x1 & j;
    x1 ^= x2 & j;
    y1 ^= y2 & j;
    y2 ^= y1 & j;
    y1 ^= y2 & j;
    x_step = kXYOne;
    y_step = (dy * kXYOne) / (ax | 1);
    ecount = (x2 - x1) >> kXYShift;
  } else {
    dx = (dx ^ i) - i;
    x1 ^= x2 & i;
    x2 ^= x1 & i;
    x1 ^= x2 & i;
    y1 ^= y2 & i;
    y2 ^= y1 & i;
    y1 ^= y2 & i;
    x_step = (dx * kXYOne) / (ay | 1);
    y_step = kXYOne;
    ecount = (y2 - y1) >> kXYShift;
  }
  x1 += kXYOne >> 1;
  y1 += kXYOne >> 1;
  img.put((x2 + (kXYOne >> 1)) >> kXYShift, (y2 + (kXYOne >> 1)) >> kXYShift);
  if (ax > ay) {
    x1 >>= kXYShift;
    for (; ecount >= 0; --ecount) {
      img.put(x1, y1 >> kXYShift);
      ++x1;
      y1 += y_step;
    }
  } else {
    y1 >>= kXYShift;
    for (; ecount >= 0; --ecount) {
      img.put(x1 >> kXYShift, y1);
      x1 += x_step;
      ++y1;
    }
  }
}

struct Pt {
  int64_t x, y;
};

// FillConvexPoly() with line_type 8 and shift XY_SHIFT
void fill_convex_poly(const Mask& img, const Pt* v, int npts) {
  const int64_t delta = kXYOne >> 1;
  int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  int imin = 0;
  Pt p0 = v[npts - 1];
  for (int i = 0; i < npts; ++i) {
    const Pt p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    line2(img, p0.x, p0.y, p.x, p.y);
    p0 = p;
  }
  xmin = (xmin + delta) >> kXYShift;
  xmax = (xmax + delta) >> kXYShift;
  ymin = (ymin + delta) >> kXYShift;
  ymax = (ymax + delta) >> kXYShift;
  if (npts < 3 || xmax < 0 || ymax < 0 || xmin >= img.w || ymin >= img.h)
    return;
  ymax = std::min<int64_t>(ymax, img.h - 1);
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int64_t ye;
  } edge[2];
  edge[0].idx = edge[1].idx = imin;
  int64_t y = ymin;
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -kXYOne;
  edge[0].dx = edge[1].dx = 0;
  int edges = npts;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          const int64_t ty = (v[idx].y + delta) >> kXYShift;
          if (ty > y) {
            const int64_t xs = v[idx0].x, xe = v[idx].x;
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int64_t xx1 = (edge[left].x + delta) >> kXYShift;
      int64_t xx2 = (edge[right].x + delta) >> kXYShift;
      if (xx2 >= 0 && xx1 < img.w) img.hline(y, xx1, xx2);
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= ymax);
}

// ThickLine() for thickness > 1, LINE_8, both points in XY_SHIFT fixed
// point; `flags` bit 0 / 1 draw the round joint at p0 / p1
void thick_line(const Mask& img, Pt p0, Pt p1, int thickness, int flags) {
  const double inv = 1.0 / kXYOne;
  const double dx = (p0.x - p1.x) * inv, dy = (p1.y - p0.y) * inv;
  double r = dx * dx + dy * dy;
  const int odd = thickness & 1;
  const int64_t th = (int64_t)thickness << (kXYShift - 1);
  if (std::fabs(r) > DBL_EPSILON) {
    r = (th + odd * kXYOne * 0.5) / std::sqrt(r);
    const int64_t dpx = (int64_t)std::nearbyint(dy * r);
    const int64_t dpy = (int64_t)std::nearbyint(dx * r);
    const Pt pt[4] = {{p0.x + dpx, p0.y + dpy},
                      {p0.x - dpx, p0.y - dpy},
                      {p1.x - dpx, p1.y - dpy},
                      {p1.x + dpx, p1.y + dpy}};
    fill_convex_poly(img, pt, 4);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1)) {
      circle_int(img, (p0.x + (kXYOne >> 1)) >> kXYShift,
                 (p0.y + (kXYOne >> 1)) >> kXYShift,
                 (th + (kXYOne >> 1)) >> kXYShift, true);
    }
    p0 = p1;
  }
}

// EllipseEx() of a full circle: ellipse2Poly's polygon, rounded to
// XY_SHIFT fixed point, as an open thick polyline (its ends meet)
void circle_thick(const Mask& img, int64_t cx, int64_t cy, int64_t radius,
                  int thickness) {
  const int64_t ax = radius << kXYShift;
  const int64_t ccx = cx << kXYShift, ccy = cy << kXYShift;
  int delta = (int)((ax + (kXYOne >> 1)) >> kXYShift);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  // sincos(0): alpha = cos = SinTable[450], beta = sin = SinTable[0]
  const float alpha = kSinTable[450], beta = kSinTable[0];
  std::vector<Pt> v;
  Pt prev = {INT64_MIN, INT64_MIN};
  for (int i = 0; i < 360 + delta; i += delta) {
    const int angle = i > 360 ? 360 : i;
    const double x = (double)ax * kSinTable[450 - angle];
    const double y = (double)ax * kSinTable[angle];
    const double px = (double)ccx + x * alpha - y * beta;
    const double py = (double)ccy + x * beta + y * alpha;
    Pt p;
    p.x = (int64_t)std::nearbyint(px / kXYOne) << kXYShift;
    p.y = (int64_t)std::nearbyint(py / kXYOne) << kXYShift;
    p.x += (int64_t)std::nearbyint(px - (double)p.x);
    p.y += (int64_t)std::nearbyint(py - (double)p.y);
    if (p.x != prev.x || p.y != prev.y) {
      v.push_back(p);
      prev = p;
    }
  }
  if (v.size() == 1) v.assign(2, Pt{ccx, ccy});
  // PolyLine(is_closed = false): joints at both ends of the first segment,
  // then at the end of each
  int flags = 3;
  for (size_t k = 1; k < v.size(); ++k) {
    thick_line(img, v[k - 1], v[k], thickness, flags);
    flags = 2;
  }
}

// --------------------------------------------------------------------------
// resize INTER_CUBIC
// --------------------------------------------------------------------------

// interpolateCubic (resize.cpp), float
void cubic_coeffs(float x, float* c) {
  const float A = -0.75f;
  c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
  c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
  c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
  c[3] = 1.f - c[0] - c[1] - c[2];
}

// per output index: the first of the 4 source taps and the weights
void cubic_table(int64_t n, int64_t on, std::vector<int64_t>* ofs,
                 std::vector<float>* w) {
  const double scale = 1.0 / ((double)on / n);
  ofs->resize(on);
  w->resize(on * 4);
  for (int64_t d = 0; d < on; ++d) {
    float f = (float)((d + 0.5) * scale - 0.5);
    const int64_t s = (int64_t)std::floor(f);
    f -= (float)s;
    (*ofs)[d] = s - 1;
    cubic_coeffs(f, &(*w)[d * 4]);
  }
}

inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// IPP's cubic kernel at distance x (0 <= x <= 2), in double
inline double ipp_cubic(double x) {
  return x <= 1 ? (1.25 * x - 2.25) * x * x + 1
                : ((-0.75 * x + 3.75) * x - 6) * x + 3;
}

// IPP's taps and weights per output index (see cv_resize_cubic_u8)
void ipp_cubic_table(int64_t n, int64_t on, std::vector<int64_t>* ofs,
                     std::vector<float>* w) {
  const double scale = (double)n / (double)on;
  ofs->resize(on);
  w->resize(on * 4);
  for (int64_t d = 0; d < on; ++d) {
    const double p = (d + 0.5) * scale - 0.5;
    const double s = std::floor(p);
    const double x0 = (double)(1.f + (float)(p - s));
    const double dist[4] = {x0, x0 - 1, 2 - x0, 3 - x0};
    (*ofs)[d] = (int64_t)s - 1;
    for (int j = 0; j < 4; ++j) (*w)[d * 4 + j] = (float)ipp_cubic(dist[j]);
  }
}

void resize_cubic_u8_ipp(const uint8_t* in, uint8_t* out, int64_t h,
                         int64_t w, int64_t c, int64_t oh, int64_t ow) {
  std::vector<int64_t> xo, yo;
  std::vector<float> xw, yw;
  ipp_cubic_table(w, ow, &xo, &xw);
  ipp_cubic_table(h, oh, &yo, &yw);
  std::vector<float> tmp((size_t)(h * ow * c));
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = in + y * w * c;
    for (int64_t d = 0; d < ow; ++d) {
      const float* a = &xw[d * 4];
      const uint8_t* px[4];
      for (int j = 0; j < 4; ++j)
        px[j] = row + clampi(xo[d] + j, 0, w - 1) * c;
      for (int64_t k = 0; k < c; ++k) {
        float v = (float)px[0][k] * a[0];
        for (int j = 1; j < 4; ++j) v = std::fma((float)px[j][k], a[j], v);
        tmp[(y * ow + d) * c + k] = v;
      }
    }
  }
  const int64_t n = ow * c;
#pragma omp parallel for
  for (int64_t d = 0; d < oh; ++d) {
    const float* b = &yw[d * 4];
    const float* S[4];
    for (int j = 0; j < 4; ++j)
      S[j] = &tmp[clampi(yo[d] + j, 0, h - 1) * n];
    uint8_t* o = out + d * n;
    for (int64_t x = 0; x < n; ++x) {
      const float v = std::fma(S[0][x], b[0], S[1][x] * b[1]) +
                      std::fma(S[2][x], b[2], S[3][x] * b[3]);
      const float r = std::nearbyint(v);
      o[x] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
    }
  }
}

}  // namespace

extern "C" {

// ---- colour ---------------------------------------------------------------

// cvtColor(img_f32, COLOR_RGB2HSV): H in degrees, S and V in [0, 1].
// The SIMD body takes the hue as fma(num, 60/(diff+eps), base) with base
// 360 in the red sector when g < b; the scalar tail (the last w % 8
// columns of each row) adds 360 after an fma with base 0.
void cv_rgb2hsv_f32(const float* in, float* out, int64_t h, int64_t w) {
  const int64_t ve = vec_end(w);
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const float* p = in + (y * w + x) * 3;
      float* o = out + (y * w + x) * 3;
      const float r = p[0], g = p[1], b = p[2];
      const float v = std::max(std::max(r, g), b);
      const float vmin = std::min(std::min(r, g), b);
      const float diff = v - vmin;
      const float s = diff / (std::fabs(v) + FLT_EPSILON);
      const float rev = (float)(60.0 / (double)(diff + FLT_EPSILON));
      float num, base;
      if (v == r) {
        num = g - b;
        base = (x < ve && g < b) ? 360.f : 0.f;
      } else if (v == g) {
        num = b - r;
        base = 120.f;
      } else {
        num = r - g;
        base = 240.f;
      }
      float hh = std::fma(num, rev, base);
      if (hh < 0) hh += 360.f;
      o[0] = hh;
      o[1] = s;
      o[2] = v;
    }
  }
}

// cvtColor(hsv_f32, COLOR_HSV2RGB), hue in degrees
void cv_hsv2rgb_f32(const float* in, float* out, int64_t h, int64_t w) {
  const float hscale = 6.f / 360.f;
#pragma omp parallel for
  for (int64_t i = 0; i < h * w; ++i) {
    const float* p = in + i * 3;
    float* o = out + i * 3;
    const float s = p[1], v = p[2];
    float hh = p[0] * hscale;
    int sector;
    if (hh >= 0.f && hh < 6.f) {
      sector = (int)std::floor(hh);
    } else {
      hh = std::fmod(hh, 6.f);
      sector = (int)std::floor(hh);
      if ((unsigned)sector >= 6u) {
        sector = 0;
        hh = 0.f;
      }
    }
    const float f = hh - (float)sector;
    const float tab[4] = {v, v * (1.f - s), v * std::fma(-s, f, 1.f),
                          v * std::fma(-s, 1.f - f, 1.f)};
    static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                          {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
    o[2] = tab[sector_data[sector][0]];  // b
    o[1] = tab[sector_data[sector][1]];  // g
    o[0] = tab[sector_data[sector][2]];  // r
  }
}

// ---- linear filters -------------------------------------------------------

// sepFilter2D(CV_32F) of an (h, w) float plane with the symmetric kernel
// k (n = 3 or 5 taps) along both axes, BORDER_REFLECT_101: the row pass,
// then the column pass, each in the order of operations of OpenCV's
// vector body and of its scalar tail.
int cv_sep_filter_f32(const float* in, float* out, int64_t h, int64_t w,
                      const float* k, int n) {
  if (n != 3 && n != 5) return -1;
  const int r = n / 2;
  const float kc = k[r], k1 = k[r + 1], k2 = n == 5 ? k[r + 2] : 0.f;
  std::vector<float> rows((size_t)(h * w));
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    const float* src = in + y * w;
    for (int64_t x = 0; x < w; ++x) {
      const float c = src[x];
      const float s1 = src[reflect101(x - 1, w)] + src[reflect101(x + 1, w)];
      const bool last = (w & 1) && x == w - 1;
      float d;
      if (n == 3) {
        d = last ? std::fma(s1, k1, c * kc) : std::fma(c, kc, s1 * k1);
      } else {
        const float s2 =
            src[reflect101(x - 2, w)] + src[reflect101(x + 2, w)];
        d = last ? (c * kc + s1 * k1) + s2 * k2
                 : std::fma(s2, k2, std::fma(c, kc, s1 * k1));
      }
      rows[y * w + x] = d;
    }
  }
  const int64_t ve = vec_end(w);
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    const float* S0 = &rows[y * w];
    const float* Sm1 = &rows[reflect101(y - 1, h) * w];
    const float* Sp1 = &rows[reflect101(y + 1, h) * w];
    const float* Sm2 = n == 5 ? &rows[reflect101(y - 2, h) * w] : nullptr;
    const float* Sp2 = n == 5 ? &rows[reflect101(y + 2, h) * w] : nullptr;
    for (int64_t x = 0; x < w; ++x) {
      const float c = S0[x], s1 = Sm1[x] + Sp1[x];
      float d;
      if (n == 3) {
        d = std::fma(s1, k1, c * kc);
      } else {
        const float s2 = Sm2[x] + Sp2[x];
        d = x < ve ? std::fma(s2, k2, std::fma(s1, k1, c * kc))
                   : (c * kc + s1 * k1) + s2 * k2;
      }
      out[y * w + x] = d;
    }
  }
  return 0;
}

// filter2D(plane_f64, -1, kernel_f32): correlation with the kernel
// centred, BORDER_REFLECT_101, summed in double in the kernel's raster
// order (OpenCV takes its DFT path for kernels this large, which agrees
// to ~1e-15, not to the bit)
void cv_filter2d_f64(const double* in, double* out, int64_t h, int64_t w,
                     const float* k, int64_t kh, int64_t kw) {
  const int64_t ay = kh / 2, ax = kw / 2;
  std::vector<int64_t> xs((size_t)(w * kw));
  for (int64_t x = 0; x < w; ++x)
    for (int64_t j = 0; j < kw; ++j) xs[x * kw + j] = reflect101(x + j - ax, w);
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      double s = 0.0;
      for (int64_t i = 0; i < kh; ++i) {
        const double* row = in + reflect101(y + i - ay, h) * w;
        const int64_t* xi = &xs[x * kw];
        for (int64_t j = 0; j < kw; ++j)
          s += (double)k[i * kw + j] * row[xi[j]];
      }
      out[y * w + x] = s;
    }
  }
}

// ---- geometry -------------------------------------------------------------

// getAffineTransform(src, dst): the 6x6 system solved by LU with partial
// pivoting; src and dst hold 3 (x, y) float points, M 2x3 doubles
int cv_affine_transform(const float* src, const float* dst, double* M) {
  double a[36] = {0}, b[6];
  for (int i = 0; i < 3; ++i) {
    const int j = i * 12, k = i * 12 + 6;
    a[j] = a[k + 3] = src[2 * i];
    a[j + 1] = a[k + 4] = src[2 * i + 1];
    a[j + 2] = a[k + 5] = 1;
    b[i * 2] = dst[2 * i];
    b[i * 2 + 1] = dst[2 * i + 1];
  }
  const int m = 6;
  for (int i = 0; i < m; ++i) {
    int k = i;
    for (int j = i + 1; j < m; ++j)
      if (std::fabs(a[j * m + i]) > std::fabs(a[k * m + i])) k = j;
    if (std::fabs(a[k * m + i]) < DBL_EPSILON * 10) return -1;
    if (k != i) {
      for (int j = i; j < m; ++j) std::swap(a[i * m + j], a[k * m + j]);
      std::swap(b[i], b[k]);
    }
    const double d = -1.0 / a[i * m + i];
    for (int j = i + 1; j < m; ++j) {
      const double alpha = a[j * m + i] * d;
      for (int c = i + 1; c < m; ++c) a[j * m + c] += alpha * a[i * m + c];
      b[j] += alpha * b[i];
    }
    a[i * m + i] = -d;
  }
  for (int i = m - 1; i >= 0; --i) {
    double s = b[i];
    for (int c = i + 1; c < m; ++c) s -= a[i * m + c] * b[c];
    b[i] = s * a[i * m + i];
  }
  std::memcpy(M, b, sizeof b);
  return 0;
}

// warpAffine(img_f64 (h, w, c), M, (w, h), INTER_LINEAR,
// BORDER_REFLECT_101): M inverted, each destination pixel mapped to
// source coordinates in 1/32 pixel (through 1/1024 fixed point, as
// WarpAffineInvoker does), blended with the bilinear table's float
// weights in double
void cv_warp_affine_f64(const double* in, double* out, int64_t h, int64_t w,
                        int64_t c, const double* Mfwd) {
  double M[6];
  std::memcpy(M, Mfwd, sizeof M);
  double D = M[0] * M[4] - M[1] * M[3];
  D = D != 0 ? 1. / D : 0;
  const double A11 = M[4] * D, A22 = M[0] * D;
  M[0] = A11;
  M[1] *= -D;
  M[3] *= -D;
  M[4] = A22;
  const double b1 = -M[0] * M[2] - M[1] * M[5];
  const double b2 = -M[3] * M[2] - M[4] * M[5];
  M[2] = b1;
  M[5] = b2;
  const int AB_BITS = 10, AB_SCALE = 1 << AB_BITS, INTER_BITS = 5;
  const int TAB = 1 << INTER_BITS, round_delta = AB_SCALE / TAB / 2;
  std::vector<int> adelta((size_t)w), bdelta((size_t)w);
  for (int64_t x = 0; x < w; ++x) {
    adelta[x] = (int)std::nearbyint(M[0] * x * AB_SCALE);
    bdelta[x] = (int)std::nearbyint(M[3] * x * AB_SCALE);
  }
  float wtab[TAB * TAB][4];
  for (int i = 0; i < TAB; ++i)
    for (int j = 0; j < TAB; ++j) {
      const float fy = i * (1.f / TAB), fx = j * (1.f / TAB);
      wtab[i * TAB + j][0] = (1.f - fy) * (1.f - fx);
      wtab[i * TAB + j][1] = (1.f - fy) * fx;
      wtab[i * TAB + j][2] = fy * (1.f - fx);
      wtab[i * TAB + j][3] = fy * fx;
    }
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    const int X0 = (int)std::nearbyint((M[1] * y + M[2]) * AB_SCALE) + round_delta;
    const int Y0 = (int)std::nearbyint((M[4] * y + M[5]) * AB_SCALE) + round_delta;
    for (int64_t x = 0; x < w; ++x) {
      const int X = (X0 + adelta[x]) >> (AB_BITS - INTER_BITS);
      const int Y = (Y0 + bdelta[x]) >> (AB_BITS - INTER_BITS);
      const int64_t sx = X >> INTER_BITS, sy = Y >> INTER_BITS;
      const float* wt = wtab[(Y & (TAB - 1)) * TAB + (X & (TAB - 1))];
      const int64_t x0 = reflect101(sx, w), x1 = reflect101(sx + 1, w);
      const int64_t y0 = reflect101(sy, h), y1 = reflect101(sy + 1, h);
      const double* v0 = in + (y0 * w + x0) * c;
      const double* v1 = in + (y0 * w + x1) * c;
      const double* v2 = in + (y1 * w + x0) * c;
      const double* v3 = in + (y1 * w + x1) * c;
      double* o = out + (y * w + x) * c;
      for (int64_t k = 0; k < c; ++k)
        o[k] = v0[k] * wt[0] + v1[k] * wt[1] + v2[k] * wt[2] + v3[k] * wt[3];
    }
  }
}

// resize(img_f64 (h, w, c), (ow, oh), INTER_CUBIC): float coefficients,
// double sums, the horizontal pass then the vertical, edges replicated
void cv_resize_cubic_f64(const double* in, double* out, int64_t h, int64_t w,
                         int64_t c, int64_t oh, int64_t ow) {
  std::vector<int64_t> xo, yo;
  std::vector<float> xw, yw;
  cubic_table(w, ow, &xo, &xw);
  cubic_table(h, oh, &yo, &yw);
  std::vector<double> tmp((size_t)(h * ow * c));
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    const double* row = in + y * w * c;
    for (int64_t d = 0; d < ow; ++d) {
      const float* a = &xw[d * 4];
      for (int64_t k = 0; k < c; ++k) {
        double v = 0;
        for (int j = 0; j < 4; ++j)
          v += row[clampi(xo[d] + j, 0, w - 1) * c + k] * a[j];
        tmp[(y * ow + d) * c + k] = v;
      }
    }
  }
#pragma omp parallel for
  for (int64_t d = 0; d < oh; ++d) {
    const float* b = &yw[d * 4];
    const double* S[4];
    for (int j = 0; j < 4; ++j)
      S[j] = &tmp[clampi(yo[d] + j, 0, h - 1) * ow * c];
    double* o = out + d * ow * c;
    for (int64_t x = 0; x < ow * c; ++x)
      o[x] = S[0][x] * b[0] + S[1][x] * b[1] + S[2][x] * b[2] + S[3][x] * b[3];
  }
}

// resize(img_u8 (h, w, 3), (ow, oh), INTER_CUBIC) as the pip OpenCV
// computes it.  An image of 4 pixels or more a side goes to Intel IPP
// (ippiResizeCubic, B = 0, C = 0.75), whose float code was fitted to
// cv2's outputs: each output's fractional source position is rounded to
// float, then the distance 1 + f to its first tap to float (a multiple of
// 2^-23); the four weights k(1 + f), k(f), k(1 - f), k(2 - f) are
// evaluated in double and rounded to float; the horizontal pass sums
// x0 c0, then fmaf's x1 c1, x2 c2, x3 c3 into it; the vertical pass adds
// fmaf(t0, b0, t1 b1) and fmaf(t2, b2, t3 b3); rounded to nearest even,
// saturated.  A smaller image takes OpenCV's own code: the float
// coefficients rounded to 11-bit fixed point, integer horizontal sums;
// the vertical pass in OpenCV's SSE body (all but the last (ow * c) % 8
// samples of a row) converts to float, sums the products S_j *
// (beta_j / 2^22) from the last tap back and rounds to nearest even, the
// scalar tail takes (v + 2^21) >> 22; saturated.
void cv_resize_cubic_u8(const uint8_t* in, uint8_t* out, int64_t h, int64_t w,
                        int64_t c, int64_t oh, int64_t ow) {
  if (h >= 4 && w >= 4) {
    resize_cubic_u8_ipp(in, out, h, w, c, oh, ow);
    return;
  }
  std::vector<int64_t> xo, yo;
  std::vector<float> xw, yw;
  cubic_table(w, ow, &xo, &xw);
  cubic_table(h, oh, &yo, &yw);
  std::vector<int32_t> xa(xw.size()), ya(yw.size());
  for (size_t i = 0; i < xw.size(); ++i)
    xa[i] = (int32_t)std::nearbyint(xw[i] * 2048.f);
  for (size_t i = 0; i < yw.size(); ++i)
    ya[i] = (int32_t)std::nearbyint(yw[i] * 2048.f);
  std::vector<int32_t> tmp((size_t)(h * ow * c));
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = in + y * w * c;
    for (int64_t d = 0; d < ow; ++d) {
      const int32_t* a = &xa[d * 4];
      for (int64_t k = 0; k < c; ++k) {
        int32_t v = 0;
        for (int j = 0; j < 4; ++j)
          v += row[clampi(xo[d] + j, 0, w - 1) * c + k] * a[j];
        tmp[(y * ow + d) * c + k] = v;
      }
    }
  }
  const int64_t n = ow * c, ve = vec_end(n);
  const float scale = 1.f / (2048 * 2048);
#pragma omp parallel for
  for (int64_t d = 0; d < oh; ++d) {
    const int32_t* b = &ya[d * 4];
    float bf[4];
    for (int j = 0; j < 4; ++j) bf[j] = (float)b[j] * scale;
    const int32_t* S[4];
    for (int j = 0; j < 4; ++j)
      S[j] = &tmp[clampi(yo[d] + j, 0, h - 1) * n];
    uint8_t* o = out + d * n;
    for (int64_t x = 0; x < n; ++x) {
      int64_t r;
      if (x < ve) {
        const float v = (float)S[0][x] * bf[0] +
                        ((float)S[1][x] * bf[1] +
                         ((float)S[2][x] * bf[2] + (float)S[3][x] * bf[3]));
        r = (int64_t)std::nearbyint(v);
      } else {
        const int64_t v = (int64_t)S[0][x] * b[0] + (int64_t)S[1][x] * b[1] +
                          (int64_t)S[2][x] * b[2] + (int64_t)S[3][x] * b[3];
        r = (v + (1 << 21)) >> 22;
      }
      o[x] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
    }
  }
}

// ---- spatter's water branch -----------------------------------------------

// Canny(img_u8, low, high) with the 3x3 Sobel (replicated borders), the L1
// magnitude, the 22.5-degree fixed-point direction test and hysteresis
void cv_canny_u8(const uint8_t* in, uint8_t* out, int64_t h, int64_t w,
                 int low, int high) {
  std::vector<int32_t> dx((size_t)(h * w)), dy(dx.size());
  std::vector<int32_t> mag((size_t)((h + 2) * (w + 2)), 0);
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* r0 = in + clampi(y - 1, 0, h - 1) * w;
    const uint8_t* r1 = in + y * w;
    const uint8_t* r2 = in + clampi(y + 1, 0, h - 1) * w;
    for (int64_t x = 0; x < w; ++x) {
      const int64_t xl = clampi(x - 1, 0, w - 1), xr = clampi(x + 1, 0, w - 1);
      const int32_t gx = (r0[xr] + 2 * r1[xr] + r2[xr]) -
                         (r0[xl] + 2 * r1[xl] + r2[xl]);
      const int32_t gy = (r2[xl] + 2 * r2[x] + r2[xr]) -
                         (r0[xl] + 2 * r0[x] + r0[xr]);
      dx[y * w + x] = gx;
      dy[y * w + x] = gy;
      mag[(y + 1) * (w + 2) + x + 1] = std::abs(gx) + std::abs(gy);
    }
  }
  // 0: weak candidate, 1: not an edge, 2: edge
  const int64_t mw = w + 2;
  std::vector<uint8_t> map((size_t)((h + 2) * mw), 1);
  const int TG22 = 13573;  // tan(22.5 deg) << 15, rounded
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const int64_t i = (y + 1) * mw + x + 1;
      const int32_t m = mag[i];
      uint8_t res = 1;
      if (m > low) {
        const int32_t xs = dx[y * w + x], ys = dy[y * w + x];
        const int64_t ax = std::abs(xs);
        const int64_t ay = (int64_t)std::abs(ys) << 15;
        const int64_t tg22x = ax * TG22;
        bool keep;
        if (ay < tg22x) {
          keep = m > mag[i - 1] && m >= mag[i + 1];
        } else {
          const int64_t tg67x = tg22x + (ax << 16);
          if (ay > tg67x) {
            keep = m > mag[i - mw] && m >= mag[i + mw];
          } else {
            const int s = (xs ^ ys) < 0 ? -1 : 1;
            keep = m > mag[i - mw - s] && m > mag[i + mw + s];
          }
        }
        if (keep) res = m > high ? 2 : 0;
      }
      map[i] = res;
    }
  }
  std::vector<int64_t> stack;
  for (int64_t i = 0; i < (int64_t)map.size(); ++i)
    if (map[i] == 2) stack.push_back(i);
  while (!stack.empty()) {
    const int64_t i = stack.back();
    stack.pop_back();
    const int64_t nb[8] = {i - mw - 1, i - mw, i - mw + 1, i - 1,
                           i + 1,      i + mw - 1, i + mw, i + mw + 1};
    for (int64_t j : nb)
      if (map[j] == 0) {
        map[j] = 2;
        stack.push_back(j);
      }
  }
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x)
      out[y * w + x] = map[(y + 1) * mw + x + 1] == 2 ? 255 : 0;
}

// distanceTransform(img_u8, DIST_L2, 5) -> f32: the two-pass 5x5 chamfer
// with the metrics 1, 1.4 and 2.1969 summed in float
void cv_distance_l2_5(const uint8_t* in, float* out, int64_t h, int64_t w) {
  const float HV = 1.0f, DG = 1.4f, LG = 2.1969f, INF = FLT_MAX;
  const int64_t tw = w + 4;
  std::vector<float> t((size_t)((h + 4) * tw), INF);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      float* p = &t[(y + 2) * tw + x + 2];
      if (!in[y * w + x]) {
        *p = 0.f;
        continue;
      }
      float v = p[-2 * tw - 1] + LG;
      v = std::min(v, p[-2 * tw + 1] + LG);
      v = std::min(v, p[-tw - 2] + LG);
      v = std::min(v, p[-tw - 1] + DG);
      v = std::min(v, p[-tw] + HV);
      v = std::min(v, p[-tw + 1] + DG);
      v = std::min(v, p[-tw + 2] + LG);
      v = std::min(v, p[-1] + HV);
      *p = v;
    }
  }
  for (int64_t y = h - 1; y >= 0; --y) {
    for (int64_t x = w - 1; x >= 0; --x) {
      float* p = &t[(y + 2) * tw + x + 2];
      float v = *p;
      v = std::min(v, p[2 * tw + 1] + LG);
      v = std::min(v, p[2 * tw - 1] + LG);
      v = std::min(v, p[tw + 2] + LG);
      v = std::min(v, p[tw + 1] + DG);
      v = std::min(v, p[tw] + HV);
      v = std::min(v, p[tw - 1] + DG);
      v = std::min(v, p[tw - 2] + LG);
      v = std::min(v, p[1] + HV);
      *p = v;
      out[y * w + x] = v;
    }
  }
}

// blur(img_f32, (3, 3)): the 3x3 sum in double (BORDER_REFLECT_101) times
// 1/9, rounded to float
void cv_box3_f32(const float* in, float* out, int64_t h, int64_t w) {
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    double rs[3];
    for (int64_t x = 0; x < w; ++x) {
      for (int i = 0; i < 3; ++i) {
        const float* row = in + reflect101(y + i - 1, h) * w;
        rs[i] = (double)row[reflect101(x - 1, w)] + (double)row[x] +
                (double)row[reflect101(x + 1, w)];
      }
      out[y * w + x] = (float)(((rs[0] + rs[1]) + rs[2]) * (1.0 / 9));
    }
  }
}

// blur(img_u8, (3, 3)): ((sum + 4) * 7282) >> 16, OpenCV's division by 9
void cv_box3_u8(const uint8_t* in, uint8_t* out, int64_t h, int64_t w) {
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      int s = 0;
      for (int i = 0; i < 3; ++i) {
        const uint8_t* row = in + reflect101(y + i - 1, h) * w;
        s += row[reflect101(x - 1, w)] + row[x] + row[reflect101(x + 1, w)];
      }
      out[y * w + x] = (uint8_t)(((s + 4) * 7282) >> 16);
    }
  }
}

// equalizeHist(img_u8): the cumulative histogram from the first occupied
// bin, scaled by 255 / (n - count of that bin) in float, rounded to even
void cv_equalize_hist(const uint8_t* in, uint8_t* out, int64_t n) {
  int64_t hist[256] = {0};
  for (int64_t i = 0; i < n; ++i) ++hist[in[i]];
  int i = 0;
  while (i < 256 && !hist[i]) ++i;
  uint8_t lut[256] = {0};
  if (i == 256) return;
  if (hist[i] == n) {
    std::memset(out, i, (size_t)n);
    return;
  }
  const float scale = 255.f / (float)(n - hist[i]);
  int64_t sum = 0;
  for (lut[i++] = 0; i < 256; ++i) {
    sum += hist[i];
    const int v = (int)std::nearbyint((float)sum * scale);
    lut[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
  for (int64_t j = 0; j < n; ++j) out[j] = lut[in[j]];
}

// filter2D(img_u8, CV_8U, kernel_3x3_int): exact integer correlation,
// BORDER_REFLECT_101, saturated
void cv_filter2d_u8_3x3(const uint8_t* in, uint8_t* out, int64_t h,
                        int64_t w, const int32_t* k) {
#pragma omp parallel for
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      int64_t s = 0;
      for (int i = 0; i < 3; ++i) {
        const uint8_t* row = in + reflect101(y + i - 1, h) * w;
        for (int j = 0; j < 3; ++j)
          s += (int64_t)k[i * 3 + j] * row[reflect101(x + j - 1, w)];
      }
      out[y * w + x] = (uint8_t)(s < 0 ? 0 : (s > 255 ? 255 : s));
    }
  }
}

// ---- drawing --------------------------------------------------------------

// circle(img, (cx, cy), radius, color, thickness >= 1, LINE_8) on an
// (h, w) image: mask[y, x] = 1 wherever OpenCV paints
void cv_circle_mask(uint8_t* mask, int64_t h, int64_t w, int64_t cx,
                    int64_t cy, int64_t radius, int thickness) {
  const Mask img{mask, w, h};
  if (thickness > 1)
    circle_thick(img, cx, cy, radius, thickness);
  else
    circle_int(img, cx, cy, radius, false);
}

// ---- PIL ------------------------------------------------------------------

// Image.resize((ow, oh), NEAREST): ImagingScaleAffine's source index of
// each output column / row, the position accumulated in double from
// half a step
void pil_resize_nearest_u8(const uint8_t* in, uint8_t* out, int64_t h,
                           int64_t w, int64_t c, int64_t oh, int64_t ow) {
  std::vector<int64_t> xs((size_t)ow), ys((size_t)oh);
  const double a0 = (double)w / ow, a4 = (double)h / oh;
  double xo = a0 * 0.5;
  for (int64_t x = 0; x < ow; ++x, xo += a0)
    xs[x] = std::min<int64_t>(xo < 0 ? 0 : (int64_t)xo, w - 1);
  double yo = a4 * 0.5;
  for (int64_t y = 0; y < oh; ++y, yo += a4)
    ys[y] = std::min<int64_t>(yo < 0 ? 0 : (int64_t)yo, h - 1);
#pragma omp parallel for
  for (int64_t y = 0; y < oh; ++y)
    for (int64_t x = 0; x < ow; ++x)
      std::memcpy(out + (y * ow + x) * c, in + (ys[y] * w + xs[x]) * c,
                  (size_t)c);
}

// ---- GIF ------------------------------------------------------------------

// GIF's LZW of n 8-bit indices (minimum code size 8): clear code first,
// codes growing from 9 to 12 bits, a clear code when the table is full,
// the end code last, packed LSB first.  Returns the byte count; when it
// exceeds cap, call again with a larger buffer.
int64_t gif_lzw(const uint8_t* idx, int64_t n, uint8_t* out, int64_t cap) {
  const int kClear = 256, kEnd = 257;
  std::vector<int32_t> table((size_t)4096 * 256, -1);  // (prefix, byte) -> code
  int next = 258, size = 9;
  int64_t pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  auto emit = [&](int code) {
    acc |= (uint32_t)code << nbits;
    nbits += size;
    while (nbits >= 8) {
      if (pos < cap) out[pos] = (uint8_t)acc;
      ++pos;
      acc >>= 8;
      nbits -= 8;
    }
  };
  auto reset = [&]() {
    std::fill(table.begin(), table.end(), -1);
    next = 258;
    size = 9;
  };
  emit(kClear);
  if (n > 0) {
    int prefix = idx[0];
    for (int64_t i = 1; i < n; ++i) {
      const int b = idx[i];
      const int32_t code = table[(size_t)prefix * 256 + b];
      if (code >= 0) {
        prefix = code;
        continue;
      }
      emit(prefix);
      if (next < 4096) {
        table[(size_t)prefix * 256 + b] = next++;
        if (next > (1 << size) && size < 12) ++size;
      } else {
        emit(kClear);
        reset();
      }
      prefix = b;
    }
    emit(prefix);
  }
  emit(kEnd);
  if (nbits > 0) {
    if (pos < cap) out[pos] = (uint8_t)acc;
    ++pos;
  }
  return pos;
}

// The inverse of gif_lzw for any minimum code size 2-8: the indices of n
// bytes of concatenated image sub-block data.  Returns the count written
// (at most cap; decoding stops at the end code or when the output is
// full), or -1 for a code that refers past the table.
int64_t gif_unlzw(const uint8_t* data, int64_t n, int min_code, uint8_t* out,
                  int64_t cap) {
  if (min_code < 2 || min_code > 8) return -1;
  const int clear = 1 << min_code, end = clear + 1;
  std::vector<int> prefix(4096), suffix(4096), first(4096);
  for (int i = 0; i < clear; ++i) {
    prefix[i] = -1;
    suffix[i] = i;
    first[i] = i;
  }
  int next = end + 1, size = min_code + 1, prev = -1;
  uint32_t acc = 0;
  int nbits = 0;
  int64_t pos = 0, written = 0;
  std::vector<uint8_t> stack(4096);
  while (written < cap) {
    while (nbits < size && pos < n) {
      acc |= (uint32_t)data[pos++] << nbits;
      nbits += 8;
    }
    if (nbits < size) break;
    const int code = (int)(acc & ((1u << size) - 1));
    acc >>= size;
    nbits -= size;
    if (code == clear) {
      next = end + 1;
      size = min_code + 1;
      prev = -1;
      continue;
    }
    if (code == end) break;
    int cur = code, sp = 0;
    if (prev >= 0 && code == next) {  // KwKwK: prev's string + its first
      stack[sp++] = (uint8_t)first[prev];
      cur = prev;
    } else if (code > next || (prev < 0 && code >= clear)) {
      return -1;
    }
    while (cur >= 0 && sp < 4096) {
      stack[sp++] = (uint8_t)suffix[cur];
      cur = prefix[cur];
    }
    while (sp > 0 && written < cap) out[written++] = stack[--sp];
    if (prev >= 0 && next < 4096) {
      prefix[next] = prev;
      suffix[next] = first[code == next ? prev : code];
      first[next] = first[prev];
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    prev = code;
  }
  return written;
}

}  // extern "C"
