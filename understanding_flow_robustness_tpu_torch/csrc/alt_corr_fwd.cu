// On-demand RAFT correlation lookup for Hopper (sm_90a).
//
// Replaces understanding_flow_robustness_tpu/ops/pallas/alt_corr.py::
// _alt_corr_kernel (deriv="none"), the TPU kernel behind
// ops/correlation.py::alt_corr_features.  It computes the same values in
// the reference's compact layout; the TPU's query tiles, hat-selector
// matrices and row slabs exist for its VMEM and are not carried over.
//
// For each query q = (b, y, x) and pyramid level l:
//   out[q, l*n*n + s*n + t] = bilinear sample at (cx/2^l - r + s,
//                             cy/2^l - r + t) of
//   corr_l[h, w] = <f1[q], f2_l[b, h, w]>        (f1 pre-scaled by 1/sqrt(C))
// with n = 2r+1, align_corners=True centres and zeros outside the level
// (models/raft/corr.py:72-96, the alt_cuda_corr of models/raft/corr.py:
// 109-137).  The all-pairs volume is never built.
//
// Design (the reference alt_cuda_corr's shape): one warp per query.  The
// warp keeps f1[q] in registers (C/32 values per lane), and per level
// computes the (2r+2)^2 integer-grid dots around the window: each f2 row
// is C contiguous values read as 16-byte vectors by neighbouring lanes,
// each dot ends in a warp-shuffle reduction, and points outside the level
// give 0.  The dots go to shared memory and are blended bilinearly into
// the (2r+1)^2 outputs, written s-major.  Accumulation is f32 for f32 and
// bf16 inputs alike; outputs are f32.
//
// Work at RAFT's KITTI geometry (B=8, 48x160 queries, C=256, r=4, L=4):
// 4 levels x 100 dots x 256 x 2 = 51 kFLOP per query per level, 12.6 GFLOP
// per iteration and ~151 GFLOP per 12-iteration forward.  Each query reads
// 400 f2 rows (~205 KB in bf16), almost all from L1/L2 because neighbouring
// queries -- neighbouring warps of one block -- share most of their window.
// So it should be bound by cache bandwidth and load/shuffle instructions,
// not by DRAM or tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 4;  // queries per block
constexpr int kRadius = 4;  // RAFT's lookup radius

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// kCpl: 16-byte chunks of a feature row per lane (C / (32 * Vec::kN),
// rounded up).
template <typename T, int kCpl>
__global__ void __launch_bounds__(kWarps * 32)
alt_corr_fwd_kernel(const T* __restrict__ f1, Levels lv, int num_levels,
                    const float* __restrict__ coords, float* __restrict__ out,
                    int BN, int N, int C) {
  constexpr int kV = Vec<T>::kN;
  constexpr int kR = kRadius;
  constexpr int kD = 2 * kR + 2;  // integer grid side
  constexpr int kNn = (2 * kR + 1) * (2 * kR + 1);
  __shared__ float dots_s[kWarps][kD * kD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= BN) return;  // whole warp leaves; no block-wide barrier below
  const long long b = q / N;
  const int nchunk = C / kV;
  float* dots = dots_s[warp];

  float a[kCpl][kV];
#pragma unroll
  for (int k = 0; k < kCpl; ++k) {
    const int c = lane + 32 * k;
    if (c < nchunk) {
      Vec<T>::load(f1 + q * C + (long long)c * kV, a[k]);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) a[k][i] = 0.f;
    }
  }
  const float x = coords[2 * q];
  const float y = coords[2 * q + 1];

  for (int l = 0; l < num_levels; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* f2 = static_cast<const T*>(lv.ptr[l]) + b * H * W * (long long)C;
    const float inv = 1.f / (float)(1 << l);  // exact: a power of two
    // clamp before any float->int conversion: a centre further out than
    // this has its whole window outside the level, and stays so
    const float cx = fminf(fmaxf(x * inv, -(kR + 2.f)), W + kR + 1.f);
    const float cy = fminf(fmaxf(y * inv, -(kR + 2.f)), H + kR + 1.f);
    const float fx = floorf(cx);
    const float fy = floorf(cy);
    const float ax = cx - fx;
    const float ay = cy - fy;
    const int x0 = (int)fx - kR;
    const int y0 = (int)fy - kR;

    for (int i = 0; i < kD; ++i) {
      const int yy = y0 + i;
      const bool row_in = yy >= 0 && yy < H;
      float part[kD];
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int xx = x0 + j;
        float s = 0.f;
        if (row_in && xx >= 0 && xx < W) {  // warp-uniform
          const T* row = f2 + ((long long)yy * W + xx) * C;
#pragma unroll
          for (int k = 0; k < kCpl; ++k) {
            const int c = lane + 32 * k;
            if (c < nchunk) {
              float v[kV];
              Vec<T>::load(row + c * kV, v);
#pragma unroll
              for (int e = 0; e < kV; ++e) s = fmaf(a[k][e], v[e], s);
            }
          }
        }
        part[j] = s;
      }
#pragma unroll
      for (int j = 0; j < kD; ++j) part[j] = warp_sum(part[j]);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kD; ++j) dots[i * kD + j] = part[j];
      }
    }
    __syncwarp();

    float* o = out + q * (long long)(num_levels * kNn) + l * kNn;
    for (int c = lane; c < kNn; c += 32) {
      const int s = c / (2 * kR + 1);  // x offset (major)
      const int t = c % (2 * kR + 1);  // y offset
      const float v00 = dots[t * kD + s];
      const float v01 = dots[t * kD + s + 1];
      const float v10 = dots[(t + 1) * kD + s];
      const float v11 = dots[(t + 1) * kD + s + 1];
      o[c] = (1.f - ax) * (1.f - ay) * v00 + ax * (1.f - ay) * v01 +
             (1.f - ax) * ay * v10 + ax * ay * v11;
    }
    __syncwarp();  // the next level overwrites dots
  }
}

template <typename T>
cudaError_t launch(const void* f1, const Levels& lv, int L,
                   const float* coords, float* out, int B, int N, int C,
                   cudaStream_t stream) {
  const int BN = B * N;
  const dim3 grid((BN + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const T* f = static_cast<const T*>(f1);
  if (C / Vec<T>::kN <= 32) {
    alt_corr_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(f, lv, L, coords, out, BN, N, C);
  } else {
    alt_corr_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(f, lv, L, coords, out, BN, N, C);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_alt_corr_lookup_cuda,
// which validates every argument first (dtype, shapes, contiguity,
// alignment, C a multiple of the vector width up to 64 chunks, radius 4,
// 1..8 levels).  f1: (B, N, C); levels[l]: (B, h, w, C), with
// hw = {h0, w0, h1, w1, ...}; coords: (B, N, 2) f32; out: (B, N, L*n*n)
// f32.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_alt_corr_fwd(const void* f1, const void* const* levels,
                                const int* hw, int num_levels,
                                const void* coords, void* out, int B, int N,
                                int C, int radius, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius != kRadius ||
      C % (16 / (is_bf16 ? 2 : 4)) || C / (16 / (is_bf16 ? 2 : 4)) > 64) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.ptr[l] = l < num_levels ? levels[l] : nullptr;
    lv.h[l] = l < num_levels ? hw[2 * l] : 0;
    lv.w[l] = l < num_levels ? hw[2 * l + 1] : 0;
  }
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(f1, lv, num_levels, c, o, B, N, C, s)
              : launch<float>(f1, lv, num_levels, c, o, B, N, C, s);
  return (int)err;
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
