// On-demand RAFT correlation lookup for Hopper (sm_90a).
//
// Replaces understanding_flow_robustness_tpu/ops/pallas/alt_corr.py::
// _alt_corr_kernel (deriv="none"), the TPU kernel behind
// ops/correlation.py::alt_corr_features.  It computes the same values in
// the reference's compact layout; the TPU's hat-selector matrices and row
// slabs exist for its VMEM and are not carried over.
//
// For each query q = (b, y, x) and pyramid level l:
//   out[q, l*n*n + s*n + t] = bilinear sample at (cx/2^l - r + s,
//                             cy/2^l - r + t) of
//   corr_l[h, w] = <f1[q], f2_l[b, h, w]>        (f1 pre-scaled by 1/sqrt(C))
// with n = 2r+1, align_corners=True centres and zeros outside the level
// (models/raft/corr.py:72-96, the alt_cuda_corr of models/raft/corr.py:
// 109-137).  The all-pairs volume is never built.
//
// Radius: the kernel is a template over r, instantiated for 1..7 (the TPU
// kernel's range, csrc/radius.cuh); every size below follows from it (the
// (2r+2)^2 integer grid, the dots' shared memory, the blend).  kBoxCap
// and the tile shape were tuned at r = 4 and are kept for every r.
//
// Bound.  At RAFT's KITTI geometry (B=8, 48x160 queries, C=256, r=4, L=4,
// bf16) a call reads f1, the levels and the coords and writes the f32
// output, ~0.046 ms of bytes at 3.35 TB/s.  Its 4 x 100 integer-grid dots
// of length C per query are 12.6 GFLOP: as f32 FMAs on the CUDA cores no
// less than ~0.19 ms, on the tensor cores ~0.013 ms.  So the dots go to the
// tensor cores, as the TPU kernel puts them on its matrix unit
// (alt_corr.py:130-148).
//
// Design: the tile stage of csrc/alt_corr_tile.cuh, shared with the
// coordinate gradient (csrc/alt_corr_dcoords.cu): a block owns an 8x8 tile
// of neighbouring queries of one image at one level, so the grid is
// (tiles, levels, batch).  tile_box gives the tile's box, the union of its
// live windows clipped to the level.  Then, block-uniformly:
//   Tile path (bf16, C <= 256, the box at most kBoxCap points): tile_dots,
//   the dots of every query of the tile with every box point on the tensor
//   cores (mma.sync m16n8k16), scattered into each query's (2r+2)^2 dots
//   in shared memory.
//   Per-query path (f32 inputs, C > 256, or a box above kBoxCap: per-query
//   wild centres): each warp takes the tile's queries in turn and forms a
//   query's dots with query_dots (lane FMAs, warp-shuffle sums).
// Both paths end in the same blend, the (2r+1)^2 bilinear outputs of a
// query's dots (81 at r = 4) written s-major as contiguous bytes by
// consecutive threads:
// block-wide after the tile path, per query on the per-query path.  An
// optional counter records the path of each (tile, level) with a live
// window.  The level's pointer and size are selected with constant
// indices: indexing the parameter struct with a runtime level copies it to
// local memory in every thread (a 128-byte stack frame).
//
// Numerics: bf16 x bf16 products are exact in f32 and both paths sum them
// in f32, so the kernel differs from the plain version (an f32 bmm) only in
// the order of the sums.  Outputs are f32.

#include <type_traits>

#include "alt_corr_tile.cuh"

namespace {

using namespace ufr;

// Per-query path: each warp takes the tile's queries in turn, computes a
// query's dots into its own row `dots` and writes the query's outputs.
template <typename T, int kCpl, int R>
__device__ void query_path(const int2* org, const float2* frac, float* dots,
                           const T* __restrict__ f1, const T* __restrict__ f2,
                           float* __restrict__ out, int H, int W, int C,
                           long long qbase, int H1, int W1, int ty, int tx,
                           int stride, int l) {
  constexpr int kN1 = Window<R>::kN1;
  constexpr int kD = Window<R>::kD;
  constexpr int kNn = Window<R>::kNn;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int m = warp; m < kTileQ; m += kWarps) {
    const int qy = ty * kTileH + m / kTileW;
    const int qx = tx * kTileW + m % kTileW;
    if (qy >= H1 || qx >= W1) continue;
    const long long q = qbase + (long long)qy * W1 + qx;
    float* o = out + q * stride + l * kNn;
    const int2 og = org[m];
    if (og.x == kDead) {  // no point of the window inside the level
      for (int c = lane; c < kNn; c += 32) o[c] = 0.f;
      continue;
    }
    query_dots<T, kCpl, R>(f1 + q * C, f2, H, W, C, og, dots);
    const float ax = frac[m].x;
    const float ay = frac[m].y;
    for (int c = lane; c < kNn; c += 32) {
      const int sx = c / kN1;       // x offset (major)
      const int sy = c - sx * kN1;  // y offset
      const float* d = dots + sy * kD + sx;
      o[c] = (1.f - ax) * (1.f - ay) * d[0] + ax * (1.f - ay) * d[1] +
             (1.f - ax) * ay * d[kD] + ax * ay * d[kD + 1];
    }
    __syncwarp();  // the next query overwrites dots
  }
}

// kCpl: 16-byte chunks of a feature row per lane on the per-query path
// (C / (32 * Vec::kN), rounded up); R: the lookup radius.  Grid (tiles,
// levels, batch), block kThreads, dynamic shared memory smem_bytes<T,
// R>(C).  path_counts
// (optional): [l] += 1 per (tile, level) with a live window on the tile
// path, [num_levels + l] on the per-query path.
template <typename T, int kCpl, int R>
__global__ void __launch_bounds__(kThreads, 3)
alt_corr_fwd_kernel(const T* __restrict__ f1, Levels lv, int num_levels,
                    const float* __restrict__ coords, float* __restrict__ out,
                    int H1, int W1, int C, int tiles_x,
                    int* __restrict__ path_counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  HeadOf<T, R>& s = *reinterpret_cast<HeadOf<T, R>*>(smem_raw);
  constexpr int kN1 = Window<R>::kN1;
  constexpr int kD = Window<R>::kD;
  constexpr int kDD = Window<R>::kDD;
  constexpr int kNn = Window<R>::kNn;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = blockIdx.x / tiles_x;
  const int tx = blockIdx.x - ty * tiles_x;
  const long long N = (long long)H1 * W1;
  const long long qbase = b * N;
  const int stride = num_levels * kNn;

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
  const T* f2 = static_cast<const T*>(base) + (long long)b * H * W * C;

  const Box box = tile_box<R>(s, coords, qbase, H1, W1, ty, tx, l, H, W);
  const int npts = box.w * box.h;
  bool tile = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    tile = box.any && npts <= kBoxCap && C <= kTileMaxC;
  }
  if (path_counts != nullptr && box.any && tid == 0) {
    atomicAdd(path_counts + (tile ? l : num_levels + l), 1);
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tile) {
      tile_dots<R>(s, reinterpret_cast<__nv_bfloat16*>(smem_raw + sizeof(s)), f1,
                   f2, W, C, qbase, W1, H1, ty, tx, box.x0, box.y0, box.w,
                   npts);
      __syncthreads();
      // the blend: consecutive threads write consecutive outputs of a query
      for (int e = tid; e < kTileQ * kNn; e += kThreads) {
        const int m = e / kNn;
        const int c = e - m * kNn;
        const int qy = ty * kTileH + m / kTileW;
        const int qx = tx * kTileW + m % kTileW;
        if (qy >= H1 || qx >= W1) continue;
        const float ax = s.frac[m].x;
        const float ay = s.frac[m].y;
        const int sx = c / kN1;       // x offset (major)
        const int sy = c - sx * kN1;  // y offset
        const float* d = s.dots + m * kDD + sy * kD + sx;
        out[(qbase + (long long)qy * W1 + qx) * stride + l * kNn + c] =
            (1.f - ax) * (1.f - ay) * d[0] + ax * (1.f - ay) * d[1] +
            (1.f - ax) * ay * d[kD] + ax * ay * d[kD + 1];
      }
      return;
    }
  }
  query_path<T, kCpl, R>(s.org, s.frac, s.dots + warp * kDD, f1, f2, out, H, W,
                         C, qbase, H1, W1, ty, tx, stride, l);
}

template <typename T, int kCpl, int R>
cudaError_t launch_cpl(const T* f1, const Levels& lv, int L,
                       const float* coords, float* out, int B, int H1, int W1,
                       int C, int* path_counts, cudaStream_t stream) {
  const int smem = smem_bytes<T, R>(C);
  cudaError_t err = cudaFuncSetAttribute(
      alt_corr_fwd_kernel<T, kCpl, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W1 + kTileW - 1) / kTileW;
  const int tiles_y = (H1 + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y, L, B);
  alt_corr_fwd_kernel<T, kCpl, R><<<grid, kThreads, smem, stream>>>(
      f1, lv, L, coords, out, H1, W1, C, tiles_x, path_counts);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch(const void* f1, const Levels& lv, int L,
                   const float* coords, float* out, int B, int H1, int W1,
                   int C, int* path_counts, cudaStream_t stream) {
  const T* f = static_cast<const T*>(f1);
  if (C / Vec<T>::kN <= 32) {
    return launch_cpl<T, 1, R>(f, lv, L, coords, out, B, H1, W1, C,
                               path_counts, stream);
  }
  return launch_cpl<T, 2, R>(f, lv, L, coords, out, B, H1, W1, C,
                             path_counts, stream);
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_alt_corr_lookup_cuda,
// which validates every argument first (dtype, shapes, contiguity,
// alignment, C a multiple of the vector width up to 64 chunks, radius
// 1..7, 1..8 levels).  f1: (B, N, C) with N = H1 * W1 queries, row-major on an
// H1 x W1 grid (the grid only groups queries into tiles; any H1 x W1 = N
// gives the same output); levels[l]: (B, h, w, C), with hw = {h0, w0, h1,
// w1, ...}; coords: (B, N, 2) f32; out: (B, N, L*n*n) f32; path_counts:
// null, or 2 * L int32 zeroed by the caller (see the kernel).  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int ufr_alt_corr_fwd(const void* f1, const void* const* levels,
                                const int* hw, int num_levels,
                                const void* coords, void* out, int B, int H1,
                                int W1, int C, int radius, int is_bf16,
                                void* path_counts, void* stream) {
  if (!ufr::args_ok(num_levels, radius, B, H1, W1, C, is_bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const ufr::Levels lv = ufr::level_args(levels, hw, num_levels);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  int* pc = static_cast<int*>(path_counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)ufr::with_radius(radius, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return is_bf16 ? launch<__nv_bfloat16, R>(f1, lv, num_levels, c, o, B, H1,
                                              W1, C, pc, s)
                   : launch<float, R>(f1, lv, num_levels, c, o, B, H1, W1, C,
                                      pc, s);
  });
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
