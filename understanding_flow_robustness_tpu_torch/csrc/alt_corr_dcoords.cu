// Coordinate gradient of the on-demand RAFT correlation lookup for Hopper
// (sm_90a).
//
// Replaces understanding_flow_robustness_tpu/ops/pallas/alt_corr.py::
// _alt_corr_kernel with deriv="x" and deriv="y" (its sign-hat selectors,
// alt_corr.py:66-88 and :150-151) together with the contraction of their
// window images with the cotangent that follows them in
// ops/correlation.py::_alt_corr_bwd_pallas (:767-779).  On the TPU that is
// two full forward passes, each writing a (B, N, 16, L*16) window image,
// then an XLA reduction; here one launch reads the cotangent in its compact
// s-major layout and writes only dcoords.
//
// The forward (csrc/alt_corr_fwd.cu) gives, per query q = (b, y, x) and
// level l, with the centre (cx, cy) = coords[q] / 2^l, fraction
// (ax, ay) = (cx - floor(cx), cy - floor(cy)) and the integer-grid dots
// v[i][j] = <f1[q], f2_l[y0 + i, x0 + j]> (x0 = floor(cx) - r, zeros outside
// the level):
//   out[q, l*n*n + s*n + t] = sum_{i,j} hat(y0 + i - (cy - r + t)) v[i][j]
//                                       hat(x0 + j - (cx - r + s)),
// hat(d) = relu(1 - |d|).  The TPU kernel's x-derivative replaces the column
// hat by sign(d) on the open support |d| < 1.  With ax in (0, 1) that is -1
// at j = s and +1 at j = s + 1, so
//   dx[t][s] = (1 - ay)(v[t][s+1] - v[t][s]) + ay (v[t+1][s+1] - v[t+1][s]);
// with ax = 0 (the window on the grid) it is 0: sign(0) = 0 at j = s, and
// |d| = 1 at j = s + 1 lies outside the open support.  dy is symmetric.  Then
//   dcoords[q] = sum_l 2^-l sum_{s,t} g[q, l*n*n + s*n + t] (dx, dy)[t][s],
// 2^-l being the chain factor of coords -> coords / 2^l.  The forward
// difference that autograd through a floor-based sampler gives at ax = 0 is
// NOT what B3 computes; this kernel follows B3.
//
// Design: alt_corr_fwd.cu's one warp per query.  The warp keeps f1[q] in
// registers, forms each level's 10x10 dots once (16-byte vector loads of the
// f2 rows by neighbouring lanes, warp-shuffle sums) into shared memory, then
// each lane takes some of the 81 window positions, forms both derivatives
// and contracts them with g; two warp sums give (dcx, dcy).  The level's
// pointer and size are selected with constant indices: indexing the
// parameter struct with a runtime level would copy it to local memory in
// every thread.  Inputs f32 or bf16; sums, g and dcoords f32.
//
// Bound at RAFT's serving geometry (B=8, 48x160 queries, C=256, L=4, bf16):
// bytes, ~0.046 ms (f1 31.5 MB, levels 41.8 MB, g 79.6 MB read once).  Like
// the forward, each query re-reads its 400 f2 rows from L1/L2, so it is
// bound by cache bandwidth and load/shuffle instructions in practice.

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
alt_corr_dcoords_kernel(const T* __restrict__ f1, Levels lv, int num_levels,
                        const float* __restrict__ coords,
                        const float* __restrict__ g,
                        float* __restrict__ dcoords, int BN, int N, int C) {
  constexpr int kV = Vec<T>::kN;
  constexpr int kR = kRadius;
  constexpr int kN1 = 2 * kR + 1;  // window side
  constexpr int kD = kN1 + 1;      // integer grid side
  constexpr int kNn = kN1 * kN1;
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
  float dcx = 0.f;
  float dcy = 0.f;

  for (int l = 0; l < num_levels; ++l) {
    // the level's pointer and size, selected with constant indices
    const void* base = nullptr;
    int H = 0, W = 0;
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      if (i == l) {
        base = lv.ptr[i];
        H = lv.h[i];
        W = lv.w[i];
      }
    }
    const T* f2 = static_cast<const T*>(base) + b * H * W * (long long)C;
    const float inv = 1.f / (float)(1 << l);  // exact: a power of two
    // the forward's clamp, before any float->int conversion: a centre
    // further out has its whole window outside the level (derivative 0)
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

    // g is s-major: position c = s * n + t samples (x - r + s, y - r + t)
    const float* gq = g + q * (long long)(num_levels * kNn) + l * kNn;
    float sx = 0.f;
    float sy = 0.f;
    for (int c = lane; c < kNn; c += 32) {
      const int s = c / kN1;  // x offset (major)
      const int t = c % kN1;  // y offset
      const float v00 = dots[t * kD + s];
      const float v01 = dots[t * kD + s + 1];
      const float v10 = dots[(t + 1) * kD + s];
      const float v11 = dots[(t + 1) * kD + s + 1];
      const float gv = gq[c];
      sx = fmaf(gv, (1.f - ay) * (v01 - v00) + ay * (v11 - v10), sx);
      sy = fmaf(gv, (1.f - ax) * (v10 - v00) + ax * (v11 - v01), sy);
    }
    // sign(0) = 0: an axis whose window sits on the grid has derivative 0
    if (ax > 0.f) dcx = fmaf(inv, sx, dcx);
    if (ay > 0.f) dcy = fmaf(inv, sy, dcy);
    __syncwarp();  // the next level overwrites dots
  }

  dcx = warp_sum(dcx);
  dcy = warp_sum(dcy);
  if (lane == 0) {
    dcoords[2 * q] = dcx;
    dcoords[2 * q + 1] = dcy;
  }
}

template <typename T>
cudaError_t launch(const void* f1, const Levels& lv, int L,
                   const float* coords, const float* g, float* dcoords, int B,
                   int N, int C, cudaStream_t stream) {
  const int BN = B * N;
  const dim3 grid((BN + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const T* f = static_cast<const T*>(f1);
  if (C / Vec<T>::kN <= 32) {
    alt_corr_dcoords_kernel<T, 1><<<grid, block, 0, stream>>>(
        f, lv, L, coords, g, dcoords, BN, N, C);
  } else {
    alt_corr_dcoords_kernel<T, 2><<<grid, block, 0, stream>>>(
        f, lv, L, coords, g, dcoords, BN, N, C);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_alt_corr_dcoords_cuda,
// which validates every argument first (dtype, shapes, contiguity,
// alignment, C a multiple of the vector width up to 64 chunks, radius 4,
// 1..8 levels).  f1: (B, N, C); levels[l]: (B, h, w, C), with
// hw = {h0, w0, h1, w1, ...}; coords: (B, N, 2) f32; g: (B, N, L*n*n) f32;
// dcoords: (B, N, 2) f32, written whole.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int ufr_alt_corr_dcoords(const void* f1, const void* const* levels,
                                    const int* hw, int num_levels,
                                    const void* coords, const void* g,
                                    void* dcoords, int B, int N, int C,
                                    int radius, int is_bf16, void* stream) {
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
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dcoords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(f1, lv, num_levels, c, gg, d, B, N, C, s)
              : launch<float>(f1, lv, num_levels, c, gg, d, B, N, C, s);
  return (int)err;
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
