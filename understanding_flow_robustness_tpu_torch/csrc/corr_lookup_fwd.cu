// RAFT window lookup into a precomputed correlation pyramid, for Hopper
// (sm_90a).
//
// Replaces understanding_flow_robustness_tpu/ops/pallas/corr_lookup_fused.py::
// _lookup_kernel (with lookup_level and corr_lookup_pallas), the TPU kernel
// behind ops/correlation.py::corr_lookup(impl="pallas") on RAFT's volume path
// (the reference's CorrBlock, models/raft/corr.py:26-106).  It computes the
// same values in the reference's compact layout; the TPU's query tiles, its
// two hat-selector matmuls over the whole (Hl, Wl) image of every query and
// its 16x16 padded window are not carried over.
//
// For each query q (one row of the flattened (B*N) batch of correlation
// images) and pyramid level l:
//   out[q, l*n*n + s*n + t] = bilinear sample of vol_l[q] at
//                             (x/2^l - r + s, y/2^l - r + t)
// with n = 2r+1, align_corners=True centres (no half-pixel shift) and zeros
// outside the level (grid_sample's zeros padding, models/raft/corr.py:72-96).
// All (2r+1)^2 samples of a window share one fractional offset, so a window
// is a blend of the (2r+2)^2 integer taps around it.
//
// Design: one warp per (query, level), the level on the grid's y axis.  The
// warp reads the 10x10 taps of its window (rows of 10 neighbouring values,
// zeros outside the level) into shared memory and blends them into the 81
// outputs, written s-major as 81 contiguous f32.  The blend takes the plain version's products and sums in
// its order, rounded one by one (no FMA), so outputs equal
// ops/correlation.py::corr_lookup_reference bit for bit on the same inputs;
// bf16 taps are widened to f32 first.
//
// Bound: bytes.  Per query and level the work needs the 100 taps (200 bytes
// in bf16) and writes 81 f32 (324 bytes), with ~400 FLOP of blending: far
// below the card's ~20 FLOP/byte, so no tensor cores and no reuse between
// queries (each query reads its own image).  Rows of 10 taps straddle 32-byte
// sectors, so the DRAM traffic is about twice the bytes counted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 4;   // queries per block, all at one level
constexpr int kRadius = 4;  // RAFT's lookup radius

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_fwd_kernel(Levels lv, int num_levels,
                       const float* __restrict__ coords,
                       float* __restrict__ out, long long BN) {
  constexpr int kR = kRadius;
  constexpr int kN = 2 * kR + 1;  // window side
  constexpr int kD = 2 * kR + 2;  // integer tap grid side
  constexpr int kNn = kN * kN;
  __shared__ float taps_s[kWarps][kD * kD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  const int l = blockIdx.y;
  if (q >= BN) return;  // whole warp leaves; no block barrier
  // the level's pointer and size, selected with constant indices: indexing
  // the parameter struct with l would copy it to local memory in every
  // thread
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
  const T* vol = static_cast<const T*>(base) + q * H * (long long)W;

  const float inv = 1.f / (float)(1 << l);  // exact: a power of two
  // clamp before any float->int conversion: a centre further out than this
  // has its whole window outside the level, and stays so
  const float cx = fminf(fmaxf(coords[2 * q] * inv, -(kR + 2.f)), W + kR + 1.f);
  const float cy =
      fminf(fmaxf(coords[2 * q + 1] * inv, -(kR + 2.f)), H + kR + 1.f);
  const float fx = floorf(cx);
  const float fy = floorf(cy);
  const float ax = cx - fx;
  const float ay = cy - fy;
  const int x0 = (int)fx - kR;
  const int y0 = (int)fy - kR;

  float* taps = taps_s[warp];
  for (int k = lane; k < kD * kD; k += 32) {
    const int yy = y0 + k / kD;
    const int xx = x0 + k % kD;
    taps[k] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? widen(vol[(long long)yy * W + xx])
                  : 0.f;
  }
  __syncwarp();

  const float bx = 1.f - ax;
  const float by = 1.f - ay;
  const float w00 = __fmul_rn(bx, by);
  const float w01 = __fmul_rn(ax, by);
  const float w10 = __fmul_rn(bx, ay);
  const float w11 = __fmul_rn(ax, ay);
  float* o = out + q * (long long)(num_levels * kNn) + l * kNn;
  for (int c = lane; c < kNn; c += 32) {
    const int s = c / kN;  // x offset (major)
    const int t = c % kN;  // y offset
    const float* g = taps + t * kD + s;
    float v = __fmul_rn(w00, g[0]);
    v = __fadd_rn(v, __fmul_rn(w01, g[1]));
    v = __fadd_rn(v, __fmul_rn(w10, g[kD]));
    v = __fadd_rn(v, __fmul_rn(w11, g[kD + 1]));
    o[c] = v;
  }
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::corr_lookup_fwd,
// which validates every argument first (dtype, shapes, contiguity, one
// device, radius 4, 1..8 levels).  levels[l]: (BN, h, w) f32 or bf16, with
// hw = {h0, w0, h1, w1, ...}; coords: (BN, 2) level-0 (x, y) f32; out:
// (BN, L*n*n) f32.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_corr_lookup_fwd(const void* const* levels, const int* hw,
                                   int num_levels, const void* coords,
                                   void* out, long long BN, int radius,
                                   int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius != kRadius ||
      BN < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.ptr[l] = l < num_levels ? levels[l] : nullptr;
    lv.h[l] = l < num_levels ? hw[2 * l] : 0;
    lv.w[l] = l < num_levels ? hw[2 * l + 1] : 0;
  }
  const dim3 grid((unsigned)((BN + kWarps - 1) / kWarps), num_levels);
  const dim3 block(kWarps * 32);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    corr_lookup_fwd_kernel<__nv_bfloat16>
        <<<grid, block, 0, s>>>(lv, num_levels, c, o, BN);
  } else {
    corr_lookup_fwd_kernel<float><<<grid, block, 0, s>>>(lv, num_levels, c, o, BN);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
