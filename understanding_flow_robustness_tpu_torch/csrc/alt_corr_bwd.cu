// Backward of the on-demand RAFT correlation lookup for Hopper (sm_90a):
// the gradients with respect to f1 and the pooled fmap2 levels.
//
// Replaces understanding_flow_robustness_tpu/ops/pallas/alt_corr.py::
// _alt_corr_bwd_kernel, the TPU kernel behind ops/correlation.py::
// _alt_corr_bwd_pallas.  It computes the same values from the compact
// cotangent layout; the TPU's hat-selector matmuls, query tiles, row slabs,
// fallback tile and sort fallback exist for its VMEM and MXU and are not
// carried over.  The coordinate gradient (deriv="x"/"y") is
// csrc/alt_corr_dcoords.cu's; RAFT never asks for it.
//
// The forward (csrc/alt_corr_fwd.cu) gives, per query q = (b, y, x) and
// level l, out[q, l*n*n + s*n + t] = blend of the integer-grid dots
// v[i][j] = <f1[q], f2_l[y0 + i, x0 + j]> with the four bilinear weights of
// the centre's fraction (ax, ay).  Its transpose, for the cotangent g:
//   U[i][j]  = sum over the taps (s, t) that read v[i][j] of weight * g
//            = (1-ax)(1-ay) G[i][j] + ax(1-ay) G[i][j-1]
//              + (1-ax)ay G[i-1][j] + ax*ay G[i-1][j-1],  G[t][s] = g[s*n+t]
//   df1[q]  += U[i][j] * f2_l[y0 + i, x0 + j]
//   df2_l[y0 + i, x0 + j] += U[i][j] * f1[q]
// over the (2r+2)^2 points inside the level (f1 pre-scaled by 1/sqrt(C);
// the 1/sqrt(C) and the pooling transpose stay in PyTorch's autograd).
//
// Design (the forward kernel's shape): one warp per query.  Lanes hold
// their C/32 channels of f1[q] and of the df1 sum in registers.  Per level
// the warp clamps and floors the centre exactly as the forward does (so the
// window grid is the forward's), stages the level's 81 cotangents in shared
// memory and folds them into the 100 weights U there.  Then for each point
// inside the level it reads the f2 row as 16-byte vectors (df1 needs no
// shuffle: every lane owns its channels) and adds U * f1 into df2 with f32
// vector atomics (atomicAdd on float4, sm_90), one per 4 channels.  Inputs
// are f32 or bf16; sums, g and both outputs are f32.  The JAX TPU backward
// rounds g and U to bf16 (ops/correlation.py:740, alt_corr.py:633-638);
// this kernel keeps them f32, so its gradient is closer to the f32 one.
//
// Bound at RAFT's train geometry (B=4, 36x120 queries, C=256, L=4, r=4):
// 4*4320*4*100*256 = 1.77 G multiply-adds into df1 and as many f32 atomic
// adds into df2 per call (442 M float4 atomics, ~7 GB of atomic traffic),
// ~21 G of each per 12-iteration train step.  The df2 levels total ~23.5 MB
// and stay in the 50 MB L2, where the atomics resolve: the kernel should be
// bound by L2 atomic throughput, not DRAM and not FMA.  Neighbouring queries
// (neighbouring warps of a block) step through windows that are shifted by
// about one point, so they rarely hit one address at the same time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 4;   // queries per block
constexpr int kRadius = 4;  // RAFT's lookup radius

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct GradLevels {
  float* ptr[kMaxLevels];
};

// 16-byte vector of T widened to f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// kCpl: 16-byte chunks of a feature row per lane (C / (32 * Vec::kN),
// rounded up).
template <typename T, int kCpl>
__global__ void __launch_bounds__(kWarps * 32)
alt_corr_bwd_kernel(const T* __restrict__ f1, Levels lv, int num_levels,
                    const float* __restrict__ coords,
                    const float* __restrict__ g, float* __restrict__ df1,
                    GradLevels dlv, int BN, int N, int C) {
  constexpr int kV = Vec<T>::kN;
  constexpr int kR = kRadius;
  constexpr int kN1 = 2 * kR + 1;  // window side
  constexpr int kD = kN1 + 1;      // integer grid side
  constexpr int kNn = kN1 * kN1;
  __shared__ float g_s[kWarps][kNn];
  __shared__ float u_s[kWarps][kD * kD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= BN) return;  // whole warp leaves; no block-wide barrier below
  const long long b = q / N;
  const int nchunk = C / kV;
  float* gs = g_s[warp];
  float* us = u_s[warp];

  float a[kCpl][kV];
  float acc[kCpl][kV];
#pragma unroll
  for (int k = 0; k < kCpl; ++k) {
    const int c = lane + 32 * k;
    if (c < nchunk) {
      Vec<T>::load(f1 + q * C + (long long)c * kV, a[k]);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) a[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[k][i] = 0.f;
  }
  const float x = coords[2 * q];
  const float y = coords[2 * q + 1];

  for (int l = 0; l < num_levels; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const long long base = b * H * W * (long long)C;
    const T* f2 = static_cast<const T*>(lv.ptr[l]) + base;
    float* df2 = dlv.ptr[l] + base;
    const float inv = 1.f / (float)(1 << l);  // exact: a power of two
    // the forward's clamp, before any float->int conversion: a centre
    // further out has its whole window outside the level and gets nothing
    const float cx = fminf(fmaxf(x * inv, -(kR + 2.f)), W + kR + 1.f);
    const float cy = fminf(fmaxf(y * inv, -(kR + 2.f)), H + kR + 1.f);
    const float fx = floorf(cx);
    const float fy = floorf(cy);
    const float ax = cx - fx;
    const float ay = cy - fy;
    const int x0 = (int)fx - kR;
    const int y0 = (int)fy - kR;

    const float* gq = g + q * (long long)(num_levels * kNn) + l * kNn;
    for (int c = lane; c < kNn; c += 32) gs[c] = gq[c];
    __syncwarp();
    // U[i][j], i the row (y) and j the column (x) of the integer grid;
    // g is s-major: G[t][s] = gs[s * kN1 + t]
    for (int c = lane; c < kD * kD; c += 32) {
      const int i = c / kD;
      const int j = c % kD;
      float u = 0.f;
      if (i < kN1 && j < kN1) u += (1.f - ax) * (1.f - ay) * gs[j * kN1 + i];
      if (i < kN1 && j > 0) u += ax * (1.f - ay) * gs[(j - 1) * kN1 + i];
      if (i > 0 && j < kN1) u += (1.f - ax) * ay * gs[j * kN1 + i - 1];
      if (i > 0 && j > 0) u += ax * ay * gs[(j - 1) * kN1 + i - 1];
      us[c] = u;
    }
    __syncwarp();

    for (int i = 0; i < kD; ++i) {
      const int yy = y0 + i;
      if (yy < 0 || yy >= H) continue;  // warp-uniform
      for (int j = 0; j < kD; ++j) {
        const int xx = x0 + j;
        const float u = us[i * kD + j];
        if (xx < 0 || xx >= W || u == 0.f) continue;  // warp-uniform
        const long long p = ((long long)yy * W + xx) * C;
#pragma unroll
        for (int k = 0; k < kCpl; ++k) {
          const int c = lane + 32 * k;
          if (c < nchunk) {
            float v[kV];
            Vec<T>::load(f2 + p + c * kV, v);
#pragma unroll
            for (int e = 0; e < kV; ++e) acc[k][e] = fmaf(u, v[e], acc[k][e]);
            float4* d = reinterpret_cast<float4*>(df2 + p + c * kV);
#pragma unroll
            for (int e = 0; e < kV; e += 4) {
              atomicAdd(d + e / 4, make_float4(u * a[k][e], u * a[k][e + 1],
                                               u * a[k][e + 2],
                                               u * a[k][e + 3]));
            }
          }
        }
      }
    }
    __syncwarp();  // the next level overwrites gs and us
  }

#pragma unroll
  for (int k = 0; k < kCpl; ++k) {
    const int c = lane + 32 * k;
    if (c < nchunk) {
      float4* o = reinterpret_cast<float4*>(df1 + q * C + (long long)c * kV);
#pragma unroll
      for (int e = 0; e < kV; e += 4) {
        o[e / 4] = make_float4(acc[k][e], acc[k][e + 1], acc[k][e + 2],
                               acc[k][e + 3]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* f1, const Levels& lv, int L,
                   const float* coords, const float* g, float* df1,
                   const GradLevels& dlv, int B, int N, int C,
                   cudaStream_t stream) {
  const int BN = B * N;
  const dim3 grid((BN + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const T* f = static_cast<const T*>(f1);
  if (C / Vec<T>::kN <= 32) {
    alt_corr_bwd_kernel<T, 1><<<grid, block, 0, stream>>>(
        f, lv, L, coords, g, df1, dlv, BN, N, C);
  } else {
    alt_corr_bwd_kernel<T, 2><<<grid, block, 0, stream>>>(
        f, lv, L, coords, g, df1, dlv, BN, N, C);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_alt_corr_bwd_cuda,
// which validates every argument first (dtype, shapes, contiguity,
// alignment, C a multiple of the vector width up to 64 chunks, radius 4,
// 1..8 levels).  f1: (B, N, C); levels[l]: (B, h, w, C), with
// hw = {h0, w0, h1, w1, ...}; coords: (B, N, 2) f32; g: (B, N, L*n*n) f32;
// df1: (B, N, C) f32, written whole; dlevels[l]: (B, h, w, C) f32, zeroed
// by the caller and accumulated into.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int ufr_alt_corr_bwd(const void* f1, const void* const* levels,
                                const int* hw, int num_levels,
                                const void* coords, const void* g, void* df1,
                                void* const* dlevels, int B, int N, int C,
                                int radius, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius != kRadius ||
      C % (16 / (is_bf16 ? 2 : 4)) || C / (16 / (is_bf16 ? 2 : 4)) > 64) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  GradLevels dlv;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.ptr[l] = l < num_levels ? levels[l] : nullptr;
    lv.h[l] = l < num_levels ? hw[2 * l] : 0;
    lv.w[l] = l < num_levels ? hw[2 * l + 1] : 0;
    dlv.ptr[l] = l < num_levels ? static_cast<float*>(dlevels[l]) : nullptr;
  }
  const float* c = static_cast<const float*>(coords);
  const float* gg = static_cast<const float*>(g);
  float* d1 = static_cast<float*>(df1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(f1, lv, num_levels, c, gg, d1, dlv, B,
                                      N, C, s)
              : launch<float>(f1, lv, num_levels, c, gg, d1, dlv, B, N, C, s);
  return (int)err;
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
