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
// Design: the lookup's tile stage (csrc/alt_corr_tile.cuh), shared with
// csrc/alt_corr_fwd.cu, with this contraction in place of the blend.  As in
// the lookup, a block owns an 8x8 tile of neighbouring queries of one image
// at one level, so the grid is (tiles, levels, batch); it writes each
// query's share of that level into a scratch of per-level partials, and a
// second, small kernel sums each query's levels in order into dcoords: no
// atomics, the same bits on every launch.  Per (tile, level),
// block-uniformly and as the lookup decides:
//   Tile path (bf16, C <= 256, the tile's box at most kBoxCap points):
//   tile_dots puts every query's (2r+2)^2 dots in shared memory, from
//   f1_tile . box^T on the tensor cores (mma.sync m16n8k16); each f2 row
//   is read once per tile instead of once per query.
//   Per-query path (f32 inputs, C > 256, or a box above kBoxCap: per-query
//   wild centres): each warp takes its queries in turn and forms a query's
//   dots with query_dots (f1 in registers, lane FMAs over 16-byte f2
//   loads, warp-shuffle sums).
// Both paths end in one contraction: a warp takes each of its queries, its
// lanes read the query's (2r+1)^2 cotangents of the level, s-major, as
// contiguous f32, form dx and dy from four dots each and two warp sums
// give the level's (dcx, dcy); each axis is gated on its fraction (sign(0)
// = 0) and scaled by 2^-l.  A warp contracts kBatch queries at once, so
// that their cotangent loads are in flight together, and the level's
// cotangent lines are fetched into L2 before the dots (on an H100, by
// scripts/torch_b3_variants.py: the batches save 12-18 % of bf16 at r = 3,
// the prefetch 3-5 % at calibrated bf16 centres).  Windows with no point
// inside the level (kDead) give exactly 0.  An optional counter records
// the path of each (tile, level) with a live window, as the lookup's does:
// on the same inputs both count the same pairs.  The level's pointer and
// size are selected with constant indices: indexing the parameter struct
// with a runtime level would copy it to local memory in every thread.
// Inputs f32 or bf16; sums, g and dcoords f32.  A template over the
// radius, instantiated for 1..7 (csrc/radius.cuh).
//
// Bound at RAFT's serving geometry (B=8, 48x160 queries, C=256, L=4, bf16):
// bytes, ~0.046 ms (f1 31.5 MB, levels 41.8 MB, g 79.6 MB read once); the
// dots are the lookup's 12.6 GFLOP, ~0.013 ms on the tensor cores.

#include <type_traits>

#include "alt_corr_tile.cuh"

namespace {

using namespace ufr;

constexpr int kQPerWarp = kTileQ / kWarps;  // warp w: queries w + kWarps i
constexpr int kBatch = 4;  // queries a warp contracts at once

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// One lane's share of a query's level contraction: the sums over its
// window positions c of g[c] dx[c] and g[c] dy[c], from the query's dots d
// ([y][x]), fractions (ax, ay) and cotangents gq (s-major: c = s * n + t
// samples (x - r + s, y - r + t)).
template <int R>
__device__ __forceinline__ float2 contract(const float* d, float ax, float ay,
                                           const float* __restrict__ gq) {
  constexpr int kN1 = Window<R>::kN1;
  constexpr int kD = Window<R>::kD;
  constexpr int kNn = Window<R>::kNn;
  const int lane = threadIdx.x & 31;
  float sx = 0.f;
  float sy = 0.f;
#pragma unroll
  for (int k = 0; k < (kNn + 31) / 32; ++k) {
    const int c = lane + 32 * k;
    if (c < kNn) {
      const int s = c / kN1;  // x offset (major)
      const int t = c - s * kN1;  // y offset
      const float v00 = d[t * kD + s];
      const float v01 = d[t * kD + s + 1];
      const float v10 = d[(t + 1) * kD + s];
      const float v11 = d[(t + 1) * kD + s + 1];
      const float gv = __ldg(gq + c);
      sx = fmaf(gv, (1.f - ay) * (v01 - v00) + ay * (v11 - v10), sx);
      sy = fmaf(gv, (1.f - ax) * (v10 - v00) + ax * (v11 - v01), sy);
    }
  }
  return make_float2(sx, sy);
}

// f32 runs the per-query path alone, where a (tile, level) is 64 equal
// query-sized pieces of work.  Two tile rows a block (kSplit blocks a
// tile) give 4x the blocks, so that the last wave of resident blocks is a
// small share of the launch, and with C > 128 (kCpl = 2) 48 registers a
// thread let 10 blocks share an SM (up to r = 4: above, 48 spill; at C =
// 128 the cap was slower).  On an H100 at the serving shape (r = 4, C =
// 256; scripts/torch_b3_variants.py): 1.51-1.56 ms, against 1.71-1.73
// with whole tiles and 1.68-1.69 without the cap.
template <typename T>
constexpr int kSplit = std::is_same<T, float>::value ? 4 : 1;
template <typename T, int kCpl, int R>
constexpr int kMinBlocks =
    std::is_same<T, float>::value && kCpl == 2 && R <= 4 ? 10 : 3;

// kCpl: 16-byte chunks of a feature row per lane on the per-query path
// (C / (32 * Vec::kN), rounded up); R: the lookup radius.  Grid (tiles *
// kSplit<T>, levels, batch), block kThreads, dynamic shared memory
// smem_bytes<T, R>(C); block (tile, part) owns the tile's queries part *
// kPart .. + kPart - 1 (two tile rows for f32).  partial: (B, N,
// num_levels) float2, every in-grid query's entry of the block's level
// written.  path_counts (optional): [l] += 1 per (tile, level) with a live
// window on the tile path, [num_levels + l] on the per-query path.
template <typename T, int kCpl, int R>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, kCpl, R>))
alt_corr_dcoords_kernel(const T* __restrict__ f1, Levels lv, int num_levels,
                        const float* __restrict__ coords,
                        const float* __restrict__ g,
                        float2* __restrict__ partial, int H1, int W1, int C,
                        int tiles_x, int* __restrict__ path_counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  HeadOf<T, R>& s = *reinterpret_cast<HeadOf<T, R>*>(smem_raw);
  constexpr int kDD = Window<R>::kDD;
  constexpr int kNn = Window<R>::kNn;
  constexpr int kLines = (kNn + 31) / 32 + 1;  // 128-byte lines of kNn floats
  constexpr int kPart = kTileQ / kSplit<T>;  // the block's queries
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int part = blockIdx.x % kSplit<T>;
  const int tile_i = blockIdx.x / kSplit<T>;
  const int ty = tile_i / tiles_x;
  const int tx = tile_i - ty * tiles_x;
  const int m0 = part * kPart;  // the block's first query of the tile
  const long long qbase = b * ((long long)H1 * W1);
  const int stride = num_levels * kNn;
  const float inv = 1.f / (float)(1 << l);  // exact: a power of two
  // query q of the tile's m, or -1 outside the grid
  auto query = [&](int m) -> long long {
    const int qy = ty * kTileH + m / kTileW;
    const int qx = tx * kTileW + m % kTileW;
    return qy < H1 && qx < W1 ? qbase + (long long)qy * W1 + qx : -1;
  };
  // query q's share of this level from its warp-summed p and fractions;
  // sign(0) = 0: an axis whose window sits on the grid has derivative 0
  auto put = [&](long long q, float2 p, float2 fr) {
    partial[q * num_levels + l] =
        make_float2(fr.x > 0.f ? inv * p.x : 0.f, fr.y > 0.f ? inv * p.y : 0.f);
  };

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
  for (int e = tid; e < kPart * kLines; e += kThreads) {
    const int j = e / kLines;
    const long long q = query(m0 + j);
    if (q >= 0) {
      prefetch_l2(g + q * stride + l * kNn + min(32 * (e - j * kLines), kNn - 1));
    }
  }

  const Box box = tile_box<R>(s, coords, qbase, H1, W1, ty, tx, l, H, W);
  if (!box.any) {  // block-uniform, as is everything below
    for (int j = tid; j < kPart; j += kThreads) {
      const long long q = query(m0 + j);
      if (q >= 0) partial[q * num_levels + l] = make_float2(0.f, 0.f);
    }
    return;
  }
  const int npts = box.w * box.h;
  bool tile = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    tile = npts <= kBoxCap && C <= kTileMaxC;
  }
  if (path_counts != nullptr && tid == 0 && part == 0) {
    atomicAdd(path_counts + (tile ? l : num_levels + l), 1);
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tile) {
      tile_dots<R>(s, reinterpret_cast<__nv_bfloat16*>(smem_raw + sizeof(s)),
                   f1, f2, W, C, qbase, W1, H1, ty, tx, box.x0, box.y0,
                   box.w, npts);
      __syncthreads();
#pragma unroll
      for (int i0 = 0; i0 < kQPerWarp; i0 += kBatch) {
        float2 p[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int m = warp + kWarps * (i0 + u);
          const long long q = query(m);
          p[u] = q >= 0 && s.org[m].x != kDead
                     ? contract<R>(s.dots + m * kDD, s.frac[m].x, s.frac[m].y,
                                   g + q * stride + l * kNn)
                     : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int m = warp + kWarps * (i0 + u);
          const long long q = query(m);
          p[u] = make_float2(warp_sum(p[u].x), warp_sum(p[u].y));
          if (lane == 0 && q >= 0) put(q, p[u], s.frac[m]);
        }
      }
      return;
    }
  }
  float* dots = s.dots + warp * kDD;
  for (int i = 0; i < kPart / kWarps; ++i) {
    const int m = m0 + warp + kWarps * i;
    const long long q = query(m);
    if (q < 0) continue;  // warp-uniform
    const int2 og = s.org[m];
    if (og.x == kDead) {  // no point of the window inside the level
      if (lane == 0) partial[q * num_levels + l] = make_float2(0.f, 0.f);
      continue;
    }
    query_dots<T, kCpl, R>(f1 + q * C, f2, H, W, C, og, dots);
    const float2 fr = s.frac[m];
    float2 p = contract<R>(dots, fr.x, fr.y, g + q * stride + l * kNn);
    p = make_float2(warp_sum(p.x), warp_sum(p.y));
    if (lane == 0) put(q, p, fr);
    __syncwarp();  // the next query overwrites dots
  }
}

// dcoords[q] = the sum of query q's per-level partials, in level order.
__global__ void sum_levels(const float2* __restrict__ partial,
                           float2* __restrict__ dcoords, long long BN,
                           int num_levels) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= BN) return;
  float2 d = partial[q * num_levels];
  for (int l = 1; l < num_levels; ++l) {
    const float2 p = partial[q * num_levels + l];
    d.x += p.x;
    d.y += p.y;
  }
  dcoords[q] = d;
}

template <typename T, int kCpl, int R>
cudaError_t launch_cpl(const T* f1, const Levels& lv, int L,
                       const float* coords, const float* g, float2* partial,
                       float2* dcoords, int B, int H1, int W1, int C,
                       int* path_counts, cudaStream_t stream) {
  const int smem = smem_bytes<T, R>(C);
  cudaError_t err = cudaFuncSetAttribute(
      alt_corr_dcoords_kernel<T, kCpl, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W1 + kTileW - 1) / kTileW;
  const int tiles_y = (H1 + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y * kSplit<T>, L, B);
  alt_corr_dcoords_kernel<T, kCpl, R><<<grid, kThreads, smem, stream>>>(
      f1, lv, L, coords, g, partial, H1, W1, C, tiles_x, path_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long BN = (long long)B * H1 * W1;
  sum_levels<<<(unsigned)((BN + 255) / 256), 256, 0, stream>>>(partial, dcoords,
                                                              BN, L);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch(const void* f1, const Levels& lv, int L,
                   const float* coords, const float* g, float2* partial,
                   float2* dcoords, int B, int H1, int W1, int C,
                   int* path_counts, cudaStream_t stream) {
  const T* f = static_cast<const T*>(f1);
  if (C / Vec<T>::kN <= 32) {
    return launch_cpl<T, 1, R>(f, lv, L, coords, g, partial, dcoords, B, H1,
                               W1, C, path_counts, stream);
  }
  return launch_cpl<T, 2, R>(f, lv, L, coords, g, partial, dcoords, B, H1, W1,
                             C, path_counts, stream);
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_alt_corr_dcoords_cuda,
// which validates every argument first (dtype, shapes, contiguity,
// alignment, C a multiple of the vector width up to 64 chunks, radius
// 1..7, 1..8 levels).  f1: (B, N, C) with N = H1 * W1 queries, row-major on
// an H1 x W1 grid (the grid only groups queries into tiles; any H1 x W1 = N
// gives the same dcoords); levels[l]: (B, h, w, C), with hw = {h0, w0, h1,
// w1, ...}; coords: (B, N, 2) f32; g: (B, N, L*n*n) f32; partial: a
// scratch of (B, N, L, 2) f32; dcoords: (B, N, 2) f32, written whole;
// path_counts: null, or 2 * L int32 zeroed by the caller (see the kernel).
// Launches both kernels on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_alt_corr_dcoords(const void* f1, const void* const* levels,
                                    const int* hw, int num_levels,
                                    const void* coords, const void* g,
                                    void* partial, void* dcoords, int B,
                                    int H1, int W1, int C, int radius,
                                    int is_bf16, void* path_counts,
                                    void* stream) {
  if (!ufr::args_ok(num_levels, radius, B, H1, W1, C, is_bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const ufr::Levels lv = ufr::level_args(levels, hw, num_levels);
  const float* c = static_cast<const float*>(coords);
  const float* gg = static_cast<const float*>(g);
  float2* p = static_cast<float2*>(partial);
  float2* d = static_cast<float2*>(dcoords);
  int* pc = static_cast<int*>(path_counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)ufr::with_radius(radius, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return is_bf16 ? launch<__nv_bfloat16, R>(f1, lv, num_levels, c, gg, p, d,
                                              B, H1, W1, C, pc, s)
                   : launch<float, R>(f1, lv, num_levels, c, gg, p, d, B, H1,
                                      W1, C, pc, s);
  });
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
