// Bilinear backward warp for Hopper (sm_90a).
//
// Replaces understanding_flow_robustness_tpu/ops/pallas/warp_tile.py::
// _warp_kernel together with the exact gather fallback that ops/interp.py::
// _make_sample_exact wraps around it: the TPU kernel behind
// ops/interp.py::warp_backward (SPyNet's and PWC-Net's per-level warps,
// FlowNet2's stage chaining).  It computes, per output pixel (b, y, x) and
// channel c,
//   out[b, c, y, x] = bilinear sample of img[b, c] at (x + u, y + v)
// with u, v = flow[b, 0|1, y, x], in one of three modes
// (ops/interp.py::warp_backward_reference, the plain version):
//   0 border:     the coordinate clamped to [0, size-1], the weights from
//                 the clamped coordinate, indices clamped (Resample2d);
//   1 zeros_mask: PWC-Net's warp: the grid normalised by 2/(size-1) - 1,
//                 sampled align_corners=False with zeros outside, times the
//                 analytic separable in-bounds mask (>= 1e-4 on f32);
//   2 spynet:     the normalised grid clamped to [-1, 1], then sampled
//                 align_corners=False with zeros outside.
//
// Numerics.  The per-mode coordinate mapping runs here, from the raw flow:
// the same f32 operations in the same order as the plain version, written
// with round-to-nearest intrinsics so that nvcc contracts none of them
// into an FMA; the sample coordinates and mask bits are bit-equal to the
// plain version's.  In zeros mode a coordinate beyond [-2, size+1] is
// clamped to that range before floorf and the int conversion (all its taps
// stay outside), so a flow of +-1e30 gives zeros in zeros mode and the
// border value in border mode.  The blend is one product and three FMAs
// on the pixel's four f32 weights, where the plain version rounds eight
// products and three sums one by one: the f32 output is within a few f32
// roundings of the plain version's (chip_smoke.py's bar: 1e-5 x max|img|),
// and a bf16 output, rounded once to nearest even, within one bf16 ulp of
// the plain version's f32 sample.  The TPU design -- tiles with
// tent-selector matmuls on a flow-following slab, a violation count and a
// correction pass -- existed because a TPU gather is slow; it is not
// carried over.
//
// Bound: memory.  The warp reads the image and the flow and writes the
// output once each, a few FLOPs per element: SPyNet's finest level (batch
// 8, 3x384x1280 f32) moves 47 + 31 + 47 = 126 MB, ~38 us at 3.35 TB/s;
// PWC-Net's level 2 (batch 8, 32x96x320 bf16, f32 flow) moves 16 + 2 + 16 =
// 33 MB, ~10 us.  What a pixel costs is instruction issue (its map holds
// two IEEE divides) and, for features, the latency of its gathers.
// Design: a grid of (x-tile, row block, batch), so no thread divides to
// place its pixels, with 32-bit offsets inside a plane and 64-bit ones
// only for the plane base; the mode is a template parameter.  Images
// (C = 3, SPyNet) have their own instantiation: a thread maps 4
// consecutive pixels, loads their u and v as one 16-byte vector each and
// stores each plane's 4 outputs as one vector (16 bytes f32, 8 bytes
// bf16); a row's ragged end, and every row when W is not a multiple of 4,
// goes scalar.  Features (any other C, PWC-Net) take one pixel a thread,
// so that the map is done once per pixel and a launch has as many threads
// as pixels, at most 64 registers each (8 blocks an SM) with 8 channels'
// gathers in flight: latency, not issue, bounds that case.  The 4 taps
// per channel are scalar gathers: for a smooth flow neighbouring threads
// read neighbouring addresses, which coalesce and hit in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;       // threads of a block along x
constexpr int kRows = 4;      // rows of a block
// blocks an SM keeps resident for a feature warp (C != 3): <= 64 registers
// a thread, so that enough gathers are in flight
constexpr int kFeatureBlocks = 8;
constexpr float kMaskThreshold = 1e-4f;
enum Mode { kBorder = 0, kZerosMask = 1, kSpynet = 2 };

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ __forceinline__ static float load(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
  // 4 consecutive values at a 16-byte aligned address
  __device__ __forceinline__ static void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // 4 consecutive values at an 8-byte aligned address
  __device__ __forceinline__ static void store4(__nv_bfloat16* p,
                                                const float (&v)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// 2 * c / denom - 1 (interp.py:514, 541)
__device__ __forceinline__ float normalise(float c, float denom) {
  return __fsub_rn(__fdiv_rn(__fmul_rn(2.f, c), denom), 1.f);
}

// ((g + 1) * size - 1) * 0.5: align_corners=False (interp.py:143)
__device__ __forceinline__ float unnormalise(float g, float size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), size), 1.f), 0.5f);
}

// the analytic in-bounds weight of one axis (interp.py:528-533)
__device__ __forceinline__ float axis_weight(float c, float size) {
  const float f0 = floorf(c);
  const float frac = __fsub_rn(c, f0);
  const float f1 = __fadd_rn(f0, 1.f);
  const float last = size - 1.f;
  const float w0 = (f0 >= 0.f && f0 <= last) ? __fsub_rn(1.f, frac) : 0.f;
  const float w1 = (f1 >= 0.f && f1 <= last) ? frac : 0.f;
  return __fadd_rn(w0, w1);
}

// One output pixel's 4 taps: offsets inside the plane, whether each tap
// reads the image (a zeros-mode tap outside reads 0), and their weights.
struct Taps {
  int o00, o01, o10, o11;
  bool in00, in01, in10, in11;
  float w00, w01, w10, w11;
};

template <int kMode>
__device__ __forceinline__ Taps map_pixel(int xi, int yi, float u, float v,
                                          int H, int W) {
  const float fw = (float)W;
  const float fh = (float)H;
  float x = __fadd_rn((float)xi, u);
  float y = __fadd_rn((float)yi, v);
  bool keep = true;
  if (kMode == kBorder) {
    x = clampf(x, 0.f, fw - 1.f);
    y = clampf(y, 0.f, fh - 1.f);
  } else {
    float gx = normalise(x, (float)max(W - 1, 1));
    float gy = normalise(y, (float)max(H - 1, 1));
    if (kMode == kSpynet) {
      gx = clampf(gx, -1.f, 1.f);
      gy = clampf(gy, -1.f, 1.f);
    }
    x = unnormalise(gx, fw);
    y = unnormalise(gy, fh);
    if (kMode == kZerosMask) {
      keep = __fmul_rn(axis_weight(x, fw), axis_weight(y, fh)) >=
             kMaskThreshold;
    }
    // clamp before any float->int conversion; every tap stays outside
    x = clampf(x, -2.f, fw + 1.f);
    y = clampf(y, -2.f, fh + 1.f);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Taps t;
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  const float ux = __fsub_rn(1.f, wx);
  const float uy = __fsub_rn(1.f, wy);
  t.w00 = uy * ux;
  t.w01 = uy * wx;
  t.w10 = wy * ux;
  t.w11 = wy * wx;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  // in zeros mode a tap outside the image reads 0 (and every tap of a
  // masked pixel does, which writes +0); in border mode its index is
  // clamped (only a weight-0 tap can leave)
  const bool zeros = kMode != kBorder;
  const bool y0in = y0 >= 0 && y0 < H, y1in = y0 + 1 >= 0 && y0 + 1 < H;
  const bool x0in = x0 >= 0 && x0 < W, x1in = x0 + 1 >= 0 && x0 + 1 < W;
  t.in00 = !zeros || (keep && y0in && x0in);
  t.in01 = !zeros || (keep && y0in && x1in);
  t.in10 = !zeros || (keep && y1in && x0in);
  t.in11 = !zeros || (keep && y1in && x1in);
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x0 + 1, 0), W - 1);
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y0 + 1, 0), H - 1);
  t.o00 = yc0 * W + xc0;
  t.o01 = yc0 * W + xc1;
  t.o10 = yc1 * W + xc0;
  t.o11 = yc1 * W + xc1;
  return t;
}

// v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx as one
// product and three FMAs on the pixel's weights: within a few f32
// roundings of the plain version's separately rounded products and sums
template <typename T>
__device__ __forceinline__ float blend(const T* plane, const Taps& t) {
  const float v00 = t.in00 ? Io<T>::load(plane + t.o00) : 0.f;
  const float v01 = t.in01 ? Io<T>::load(plane + t.o01) : 0.f;
  const float v10 = t.in10 ? Io<T>::load(plane + t.o10) : 0.f;
  const float v11 = t.in11 ? Io<T>::load(plane + t.o11) : 0.f;
  return fmaf(v11, t.w11, fmaf(v10, t.w10, fmaf(v01, t.w01, v00 * t.w00)));
}

// kPx consecutive pixels of one row per thread; kC > 0: exactly kC
// channels (unrolled), kC = 0: C at run time.  Block (kTx, kRows), grid
// (x-tiles of kTx * kPx pixels, row blocks, batch); the wrapper keeps
// H * W below 2^31, so offsets inside a plane are 32-bit.
template <typename T, int kMode, int kPx, int kC>
__global__ void __launch_bounds__(kTx * kRows, kC > 0 ? 1 : kFeatureBlocks)
warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                T* __restrict__ out, int C_, int H, int W) {
  const int C = kC > 0 ? kC : C_;
  const int yi = blockIdx.y * kRows + threadIdx.y;
  const int xb = (blockIdx.x * kTx + threadIdx.x) * kPx;
  if (yi >= H || xb >= W) return;
  const int b = blockIdx.z;
  const int hw = H * W;
  const int row = yi * W + xb;
  const int n = min(kPx, W - xb);
  // whole 16-byte flow vectors and whole output vectors: W a multiple of
  // kPx = 4 keeps every row start (and every plane start) aligned
  const bool vec = kPx == 4 && n == kPx && (W % kPx) == 0;
  const float* fu = flow + (long long)(2 * b) * hw + row;
  const float* fv = fu + hw;
  float u[kPx], v[kPx];
  bool loaded = false;
  if constexpr (kPx == 4) {
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(fu));
      const float4 c = __ldg(reinterpret_cast<const float4*>(fv));
      u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
      v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      u[k] = k < n ? __ldg(fu + k) : 0.f;
      v[k] = k < n ? __ldg(fv + k) : 0.f;
    }
  }
  Taps t[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    t[k] = map_pixel<kMode>(xb + k, yi, u[k], v[k], H, W);
  }

  const T* src = img + (long long)b * C * hw;
  T* dst = out + (long long)b * C * hw + row;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const T* plane = src + (long long)c * hw;
    T* o = dst + (long long)c * hw;
    float r[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) r[k] = k < n ? blend(plane, t[k]) : 0.f;
    if constexpr (kPx == 4) {
      if (vec) {
        Io<T>::store4(o, r);
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      if (k < n) Io<T>::store(o + k, r[k]);
    }
  }
}

template <typename T, int kMode, int kPx, int kC>
cudaError_t launch_shape(const void* img, const float* flow, void* out,
                         int B, int C, int H, int W, cudaStream_t stream) {
  const dim3 block(kTx, kRows);
  const dim3 grid((W + kTx * kPx - 1) / (kTx * kPx), (H + kRows - 1) / kRows,
                  B);
  warp_fwd_kernel<T, kMode, kPx, kC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(img), flow, static_cast<T*>(out), C, H, W);
  return cudaGetLastError();
}

// C = 3 (images): 4 pixels a thread, vector flow loads and stores; other C
// (features): 1 pixel a thread, so that the map is done once per pixel and
// enough threads are in flight to cover the gathers of C channels
template <typename T, int kMode>
cudaError_t launch_mode(const void* img, const float* flow, void* out, int B,
                        int C, int H, int W, cudaStream_t stream) {
  return C == 3
             ? launch_shape<T, kMode, 4, 3>(img, flow, out, B, C, H, W, stream)
             : launch_shape<T, kMode, 1, 0>(img, flow, out, B, C, H, W,
                                            stream);
}

template <typename T>
cudaError_t launch(const void* img, const float* flow, void* out, int B,
                   int C, int H, int W, int mode, cudaStream_t stream) {
  switch (mode) {
    case kBorder:
      return launch_mode<T, kBorder>(img, flow, out, B, C, H, W, stream);
    case kZerosMask:
      return launch_mode<T, kZerosMask>(img, flow, out, B, C, H, W, stream);
    default:
      return launch_mode<T, kSpynet>(img, flow, out, B, C, H, W, stream);
  }
}

}  // namespace

// C interface, bound with ctypes by ops/warp.py::_warp_fwd_cuda, which
// validates every argument first (dtypes, shapes, contiguity, one device).
// img, out: (B, C, H, W), f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// flow: (B, 2, H, W) f32, channel 0 = u; mode: 0 border, 1 zeros_mask,
// 2 spynet.  Needs H * W < 2^31, and B and H / 4 within the grid's
// limits (65535).  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_warp_fwd(const void* img, const void* flow, void* out,
                            int B, int C, int H, int W, int mode, int is_bf16,
                            void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || mode < kBorder || mode > kSpynet ||
      (long long)H * W > 0x7fffffffLL || B > 65535 ||
      (H + kRows - 1) / kRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const float* f = static_cast<const float*>(flow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(img, f, out, B, C, H, W, mode, s)
              : launch<float>(img, f, out, B, C, H, W, mode, s);
  return (int)err;
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
