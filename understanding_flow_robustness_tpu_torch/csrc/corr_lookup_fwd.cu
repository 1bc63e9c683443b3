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
// Design: one warp per query, across all levels.  The warp loads the
// coords once, computes every level's window origin and issues all of the
// query's tap loads (the 10x10 integer taps of each level, 4 per lane and
// level, zeros outside the level) before it uses the first: a query's
// L x 100 scattered 2-byte reads are latency-bound, so the design keeps
// them in flight together.  The taps go to the warp's shared memory and are
// blended into the L x 81 outputs, stored as float4s where the output row
// is 16-byte aligned (L a multiple of 4, RAFT's 4 levels: 81 float4 per
// query).  The blend takes the plain version's products and sums in its
// order, rounded one by one (no FMA), so outputs equal
// ops/correlation.py::corr_lookup_reference bit for bit on the same inputs;
// bf16 taps are widened to f32 first.  Each level's pointer and size are
// read with constant indices (the level loop is unrolled): indexing the
// parameter struct with a runtime level copies it to local memory in every
// thread.
//
// Bound: bytes.  Per query and level the work needs the 100 taps (200 bytes
// in bf16) and writes 81 f32 (324 bytes), with ~400 FLOP of blending: far
// below the card's ~20 FLOP/byte, so no tensor cores and no reuse between
// queries (each query reads its own image).  Rows of 10 taps straddle 32-byte
// sectors, so the DRAM traffic is about 2.5 times the bytes counted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;   // queries per block
constexpr int kRadius = 4;  // RAFT's lookup radius
constexpr int kN = 2 * kRadius + 1;  // window side
constexpr int kD = 2 * kRadius + 2;  // integer tap grid side
constexpr int kDD = kD * kD;
constexpr int kNn = kN * kN;
constexpr int kRounds = (kDD + 31) / 32;  // tap loads per lane and level

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// output e of a query (level e / 81, s-major within it) from its taps and
// its levels' weights, in the plain version's order
__device__ __forceinline__ float blend(const float* taps, const float4* wts,
                                       int e) {
  const int l = e / kNn;
  const int c = e - l * kNn;
  const int s = c / kN;      // x offset (major)
  const int t = c - s * kN;  // y offset
  const float4 w = wts[l];
  const float* g = taps + l * kDD + t * kD + s;
  float v = __fmul_rn(w.x, g[0]);
  v = __fadd_rn(v, __fmul_rn(w.y, g[1]));
  v = __fadd_rn(v, __fmul_rn(w.z, g[kD]));
  v = __fadd_rn(v, __fmul_rn(w.w, g[kD + 1]));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_lookup_fwd_kernel(Levels lv, int num_levels,
                       const float* __restrict__ coords,
                       float* __restrict__ out, long long BN) {
  constexpr int kR = kRadius;
  __shared__ float taps_s[kWarps][kMaxLevels * kDD];
  __shared__ float4 wts_s[kWarps][kMaxLevels];  // w00, w01, w10, w11

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= BN) return;  // whole warp leaves; no block barrier
  const float x = coords[2 * q];
  const float y = coords[2 * q + 1];

  // every tap load first: tap k = lane + 32 r of level l, at row k / kD,
  // column k % kD of the window's integer grid
  float v[kMaxLevels][kRounds];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) v[l][r] = 0.f;
    if (l < num_levels) {
      const int H = lv.h[l];
      const int W = lv.w[l];
      const T* vol = static_cast<const T*>(lv.ptr[l]) + q * H * (long long)W;
      const float inv = 1.f / (float)(1 << l);  // exact: a power of two
      // clamp before any float->int conversion: a centre further out than
      // this has its whole window outside the level, and stays so
      const float cx = fminf(fmaxf(x * inv, -(kR + 2.f)), W + kR + 1.f);
      const float cy = fminf(fmaxf(y * inv, -(kR + 2.f)), H + kR + 1.f);
      const float fx = floorf(cx);
      const float fy = floorf(cy);
      const int x0 = (int)fx - kR;
      const int y0 = (int)fy - kR;
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int k = lane + 32 * r;
        const int yy = y0 + k / kD;
        const int xx = x0 + k % kD;
        if (k < kDD && yy >= 0 && yy < H && xx >= 0 && xx < W) {
          v[l][r] = widen(vol[(long long)yy * W + xx]);
        }
      }
      if (lane == 0) {
        const float ax = cx - fx;
        const float ay = cy - fy;
        const float bx = 1.f - ax;
        const float by = 1.f - ay;
        wts_s[warp][l] = make_float4(__fmul_rn(bx, by), __fmul_rn(ax, by),
                                     __fmul_rn(bx, ay), __fmul_rn(ax, ay));
      }
    }
  }
  float* taps = taps_s[warp];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = lane + 32 * r;
      if (l < num_levels && k < kDD) taps[l * kDD + k] = v[l][r];
    }
  }
  __syncwarp();

  const int nout = num_levels * kNn;
  float* o = out + q * (long long)nout;
  if (nout % 4 == 0) {  // the row is 16-byte aligned
    for (int e = lane; e < nout / 4; e += 32) {
      reinterpret_cast<float4*>(o)[e] = make_float4(
          blend(taps, wts_s[warp], 4 * e), blend(taps, wts_s[warp], 4 * e + 1),
          blend(taps, wts_s[warp], 4 * e + 2),
          blend(taps, wts_s[warp], 4 * e + 3));
    }
  } else {
    for (int e = lane; e < nout; e += 32) o[e] = blend(taps, wts_s[warp], e);
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
  const dim3 grid((unsigned)((BN + kWarps - 1) / kWarps));
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
