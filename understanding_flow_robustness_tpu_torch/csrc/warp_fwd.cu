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
// The per-mode coordinate mapping runs here, in the kernel, from the raw
// flow: the same f32 operations in the same order as the plain version,
// written with round-to-nearest intrinsics so that nvcc contracts none of
// them into an FMA.  So the kernel's sample coordinates and mask bits are
// bit-equal to the plain version's.  In zeros mode a coordinate beyond
// [-2, size+1] is clamped to that range before floorf and the int
// conversion (all its taps stay outside), so a flow of +-1e30 gives zeros
// in zeros mode and the border value in border mode.
//
// Weights, products and sums are f32, rounded one by one in the plain
// version's order (no FMA), and the output is written in the input's dtype
// (f32 or bf16, round to nearest even): the kernel's output is bit-equal
// to the plain version's on the same inputs.  The TPU design -- tiles
// with tent-selector matmuls on a flow-following slab, a violation count
// and a correction pass -- existed because a TPU gather is slow; it is not
// carried over.
//
// Bound: memory.  The warp reads the image, the flow and writes the
// output once each, a few FLOPs per element: SPyNet's finest level (batch
// 8, 3x384x1280 f32) moves 47 + 31 + 47 = 126 MB, ~38 us at 3.35 TB/s;
// PWC-Net's level 2 (batch 8, 32x96x320 bf16, f32 flow) moves 16 + 2 + 16 =
// 33 MB, ~10 us.  Design: one thread per output pixel reads its flow
// (coalesced: neighbouring threads are neighbouring pixels), maps the
// coordinate once, and loops over the channels gathering its 4 taps per
// plane; for a smooth flow neighbouring threads gather neighbouring
// addresses, so the taps coalesce too, and the 2x2 taps of neighbours
// overlap in L1.  The output is written once, coalesced, per plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
};

template <>
struct Io<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                T* __restrict__ out, int B, int C, int H, int W, int mode) {
  const long long hw = (long long)H * W;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)B * hw) return;
  const long long b = p / hw;
  const long long rem = p - b * hw;  // y * W + x
  const int yi = (int)(rem / W);
  const int xi = (int)(rem - (long long)yi * W);
  const float fw = (float)W;
  const float fh = (float)H;

  float x = __fadd_rn((float)xi, __ldg(flow + 2 * b * hw + rem));
  float y = __fadd_rn((float)yi, __ldg(flow + (2 * b + 1) * hw + rem));
  bool keep = true;
  if (mode == kBorder) {
    x = clampf(x, 0.f, fw - 1.f);
    y = clampf(y, 0.f, fh - 1.f);
  } else {
    float gx = normalise(x, (float)max(W - 1, 1));
    float gy = normalise(y, (float)max(H - 1, 1));
    if (mode == kSpynet) {
      gx = clampf(gx, -1.f, 1.f);
      gy = clampf(gy, -1.f, 1.f);
    }
    x = unnormalise(gx, fw);
    y = unnormalise(gy, fh);
    if (mode == kZerosMask) {
      keep = __fmul_rn(axis_weight(x, fw), axis_weight(y, fh)) >=
             kMaskThreshold;
    }
    // clamp before any float->int conversion; every tap stays outside
    x = clampf(x, -2.f, fw + 1.f);
    y = clampf(y, -2.f, fh + 1.f);
  }

  T* dst = out + b * C * hw + rem;
  if (!keep) {
    for (int c = 0; c < C; ++c) Io<T>::store(dst + c * hw, 0.f);
    return;
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  const float ux = __fsub_rn(1.f, wx);
  const float uy = __fsub_rn(1.f, wy);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  // in zeros mode a tap outside the image reads 0; in border mode its
  // index is clamped (only a weight-0 tap can leave)
  const bool zeros = mode != kBorder;
  const bool in00 = !zeros || (y0 >= 0 && y0 < H && x0 >= 0 && x0 < W);
  const bool in01 = !zeros || (y0 >= 0 && y0 < H && x0 + 1 >= 0 && x0 + 1 < W);
  const bool in10 = !zeros || (y0 + 1 >= 0 && y0 + 1 < H && x0 >= 0 && x0 < W);
  const bool in11 = !zeros ||
                    (y0 + 1 >= 0 && y0 + 1 < H && x0 + 1 >= 0 && x0 + 1 < W);
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x0 + 1, 0), W - 1);
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y0 + 1, 0), H - 1);
  const long long o00 = (long long)yc0 * W + xc0;
  const long long o01 = (long long)yc0 * W + xc1;
  const long long o10 = (long long)yc1 * W + xc0;
  const long long o11 = (long long)yc1 * W + xc1;

  // v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx, each
  // product and sum rounded in this order as the plain version's separate
  // f32 ops do (no FMA), so both give the same bits
  const T* src = img + b * C * hw;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const T* plane = src + c * hw;
    const float v00 = in00 ? Io<T>::load(plane + o00) : 0.f;
    const float v01 = in01 ? Io<T>::load(plane + o01) : 0.f;
    const float v10 = in10 ? Io<T>::load(plane + o10) : 0.f;
    const float v11 = in11 ? Io<T>::load(plane + o11) : 0.f;
    float acc = __fmul_rn(__fmul_rn(v00, uy), ux);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, uy), wx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, wy), ux));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, wy), wx));
    Io<T>::store(dst + c * hw, acc);
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* flow, void* out, int B,
                   int C, int H, int W, int mode, cudaStream_t stream) {
  const long long n = (long long)B * H * W;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  warp_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), flow, static_cast<T*>(out), B, C, H, W,
      mode);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/warp.py::_warp_fwd_cuda, which
// validates every argument first (dtypes, shapes, contiguity, one device).
// img, out: (B, C, H, W), f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// flow: (B, 2, H, W) f32, channel 0 = u; mode: 0 border, 1 zeros_mask,
// 2 spynet.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_warp_fwd(const void* img, const void* flow, void* out,
                            int B, int C, int H, int W, int mode, int is_bf16,
                            void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || mode < kBorder || mode > kSpynet) {
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
