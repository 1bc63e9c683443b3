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
// Design: a block owns an 8x8 tile of neighbouring queries of one image
// (the query grid is H1 x W1 per image; edge tiles are ragged) at one
// level, so the grid is (tiles, levels, batch).  Each query clamps and
// floors its centre as the plain version does; a window with no point
// inside the level is dead.  Warp reductions of the live window origins
// give the tile's box, their union clipped to the level
// (csrc/alt_corr_bwd.cu's step 1).  Then, block-uniformly:
//   Tile path (bf16, C <= 256, the box at most kBoxCap points): the dots
//   of every query of the tile with every box point, f1_tile . box^T, by
//   mma.sync m16n8k16 (bf16 in, f32 accumulators).  Each warp keeps the A
//   fragments of its 16 queries (16 x C) in registers for the whole box;
//   the box streams through shared memory in slabs of kSlab points
//   (cp.async, double-buffered; f2 rows are C-contiguous, the "col" layout
//   mma takes for B; rows padded by 16 bytes so ldmatrix has no bank
//   conflicts).  Every accumulator whose box point lies in its query's
//   (2r+2)^2 window is scattered into that query's dots in shared memory,
//   zeroed first: points outside the level are never written.  Each f2 row
//   is read once per tile instead of once per query.
//   Per-query path (f32 inputs, C > 256, or a box above kBoxCap: per-query
//   wild centres): each warp takes the tile's queries in turn, f1 in
//   registers, the (2r+2)^2 dots by lane FMAs over 16-byte f2 loads and
//   warp-shuffle sums into one row of dots per warp (f32 blocks stay small,
//   leaving L1 to the f2 rows the warps read).  Plain TF32 would miss the
//   f32 bar (1e-4), so f32 inputs stay here, on f32 FMAs.
// Both paths end in the same blend, the (2r+1)^2 bilinear outputs of a
// query's dots (81 at r = 4) written s-major as contiguous bytes by
// consecutive threads:
// block-wide after the tile path, per query on the per-query path.  An
// optional counter records the path of each (tile, level) with a live
// window.  The level's pointer and size are selected with constant
// indices: indexing the parameter struct with a runtime level copies it to
// local memory in every thread (a 128-byte stack frame).
//
// kBoxCap: the tile path does 64 x |box| x C multiply-adds on the tensor
// cores, the per-query path 64 x (2r+2)^2 x C on the CUDA cores at
// ~1/15-1/30 of the rate.  Timed on an H100 at the serving shape (r = 4),
// caps of 768 and
// 1024 points tie, 512 sends calibrated level-0 boxes to the slower
// per-query path and 2048 makes wild boxes slower on the tensor cores than
// per query.  Whole coarse levels (12x40 = 480 and 6x20 = 120 points)
// always fit.
//
// Numerics: bf16 x bf16 products are exact in f32 and both paths sum them
// in f32, so the kernel differs from the plain version (an f32 bmm) only in
// the order of the sums.  Outputs are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "radius.cuh"

namespace {

using ufr::Window;

constexpr int kMaxLevels = 8;
constexpr int kTileW = 8;                  // a tile of the query grid
constexpr int kTileH = 8;
constexpr int kTileQ = kTileW * kTileH;
constexpr int kWarps = kTileQ / 16;        // a warp holds one m16 row tile
constexpr int kThreads = kWarps * 32;
constexpr int kRedWarps = kTileQ / 32;     // warps with a query of setup
constexpr int kMaxK = 16;                  // 16-channel steps in registers
constexpr int kTileMaxC = 16 * kMaxK;      // C of the tile path
constexpr int kSlab = 32;                  // box points per slab
constexpr int kStages = 2;                 // slabs in flight or in use
constexpr int kBoxCap = 1024;              // box points of the tile path
constexpr int kDead = -(1 << 20);          // origin of a dead window

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8x8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's shared memory; the tile path's slab ring follows it.  kRows
// rows of kDD dots: every query's on the tile path (bf16), one per warp on
// the per-query path alone (f32, where a smaller block leaves L1 to the f2
// rows the warps read).
template <int kRows, int kDD>
struct Head {
  float dots[kRows * kDD];  // integer-grid dots, [y][x]
  int2 org[kTileQ];         // window origins (x0, y0); kDead if dead
  float2 frac[kTileQ];      // the centres' fractions (ax, ay)
  // per warp of setup queries: the live windows' min x0, max x0, min y0,
  // max y0
  int4 red[kRedWarps];
};
template <typename T, int R>
using HeadOf = Head<std::is_same<T, __nv_bfloat16>::value ? kTileQ : kWarps,
                    Window<R>::kDD>;

// bf16 elements of a slab row: C rounded up to 16, plus 8 of padding, so
// that the 8 rows an ldmatrix reads start in 8 different 16-byte bank groups
__host__ __device__ constexpr int slab_stride(int C) {
  return (C + 15) / 16 * 16 + 8;
}

// i / d for 0 <= i < 2^22 from rd = 1 / d in f32: the product's error,
// under (i + 0.5) / d * 2^-23, stays below the 0.5 / d between (i + 0.5) / d
// and the nearest integer
__device__ __forceinline__ int div_small(int i, float rd) {
  return (int)(((float)i + 0.5f) * rd);
}

// Query m of tile (ty, tx)'s feature row, or null outside the grid.
template <typename T>
__device__ __forceinline__ const T* query_row(const T* f1, int m,
                                              long long qbase, int H1, int W1,
                                              int ty, int tx, int C) {
  const int qy = ty * kTileH + m / kTileW;
  const int qx = tx * kTileW + m % kTileW;
  if (qy >= H1 || qx >= W1) return nullptr;
  return f1 + (qbase + (long long)qy * W1 + qx) * C;
}

// Tile path: the dots of the tile's queries with the box's points, on
// the tensor cores, scattered into s.dots, which it zeroes first.
template <int R>
__device__ void tile_dots(Head<kTileQ, Window<R>::kDD>& s, __nv_bfloat16* ring,
                          const __nv_bfloat16* __restrict__ f1,
                          const __nv_bfloat16* __restrict__ f2, int W, int C,
                          long long qbase, int W1, int H1, int ty, int tx,
                          int bx0, int by0, int bw, int npts) {
  constexpr int kD = Window<R>::kD;
  constexpr int kDD = Window<R>::kDD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (query) / column (point) group
  const int t = lane & 3;   // fragment column pair
  const int ksteps = (C + 15) >> 4;
  const int S = slab_stride(C);
  const int chunks = C >> 3;  // 16-byte pieces of a feature row
  const float rbw = 1.f / (float)bw;
  const float rchunks = 1.f / (float)chunks;

  for (int e = tid; e < kTileQ * kDD / 4; e += kThreads) {
    reinterpret_cast<float4*>(s.dots)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // a C that is not a multiple of 16 leaves 8 channels of every slab row
  // that cp.async never writes: zero, since 0 x a stale NaN is NaN
  if (C & 15) {
    for (int r = tid; r < kStages * kSlab; r += kThreads) {
      *reinterpret_cast<uint4*>(ring + r * S + C) = make_uint4(0, 0, 0, 0);
    }
  }

  const int nslabs = (npts + kSlab - 1) / kSlab;
  auto issue = [&](int slab) {  // one slab of box points into its stage
    if (slab < nslabs) {
      __nv_bfloat16* dst = ring + (slab % kStages) * kSlab * S;
      for (int e = tid; e < kSlab * chunks; e += kThreads) {
        const int pt = div_small(e, rchunks);
        const int ch = e - pt * chunks;
        const int p = slab * kSlab + pt;
        if (p < npts) {
          const int py = div_small(p, rbw);
          const int px = p - py * bw;
          cp_async16(dst + pt * S + ch * 8,
                     f2 + ((long long)(by0 + py) * W + (bx0 + px)) * C + ch * 8);
        }
      }
    }
    cp_async_commit();  // empty past the last slab: the wait counts stay
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  // the A fragments of this warp's 16 queries, rows r0 and r1 = r0 + 8 of
  // the fragment; zero for a query outside the grid and for channels past C
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const __nv_bfloat16* p0 = query_row(f1, r0, qbase, H1, W1, ty, tx, C);
  const __nv_bfloat16* p1 = query_row(f1, r1, qbase, H1, W1, ty, tx, C);
  uint32_t a[kMaxK][4];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    const int c0 = k * 16 + 2 * t;
    const int c1 = c0 + 8;
    a[k][0] = p0 && c0 < C ? __ldg(reinterpret_cast<const uint32_t*>(p0 + c0)) : 0u;
    a[k][1] = p1 && c0 < C ? __ldg(reinterpret_cast<const uint32_t*>(p1 + c0)) : 0u;
    a[k][2] = p0 && c1 < C ? __ldg(reinterpret_cast<const uint32_t*>(p0 + c1)) : 0u;
    a[k][3] = p1 && c1 < C ? __ldg(reinterpret_cast<const uint32_t*>(p1 + c1)) : 0u;
  }
  // the two queries' window origins relative to the box (a dead window's
  // kDead puts every box point outside it)
  const int rx0 = s.org[r0].x - bx0, ry0 = s.org[r0].y - by0;
  const int rx1 = s.org[r1].x - bx0, ry1 = s.org[r1].y - by0;
  // ldmatrix rows of lane: point (lane & 7) + 8 (lane >= 16), channels
  // + 8 for lanes 8-15 and 24-31; x4 gives b0, b1 of two n8 tiles
  const int boff = ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;

  for (int sl = 0; sl < nslabs; ++sl) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab sl landed
    __syncthreads();  // everyone's; and every warp is done with slab sl - 1
    issue(sl + kStages - 1);  // into slab sl - 1's stage
    const __nv_bfloat16* bp = ring + (sl % kStages) * kSlab * S + boff;
    float acc[kSlab / 8][4];
#pragma unroll
    for (int j = 0; j < kSlab / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < ksteps) {
#pragma unroll
        for (int j = 0; j < kSlab / 16; ++j) {
          uint32_t bb[4];
          ldmatrix_x4(bb, bp + j * 16 * S + k * 16);
          mma_bf16(acc[2 * j], a[k], bb[0], bb[1]);
          mma_bf16(acc[2 * j + 1], a[k], bb[2], bb[3]);
        }
      }
    }
    // acc[j]: {0, 1} query r0, {2, 3} query r1; box point sl*kSlab + 8j +
    // 2t + {0, 1}
#pragma unroll
    for (int j = 0; j < kSlab / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = sl * kSlab + j * 8 + 2 * t + e;
        if (p < npts) {
          const int py = div_small(p, rbw);
          const int px = p - py * bw;
          int dx = px - rx0, dy = py - ry0;
          if ((unsigned)dx < (unsigned)kD && (unsigned)dy < (unsigned)kD) {
            s.dots[r0 * kDD + dy * kD + dx] = acc[j][e];
          }
          dx = px - rx1;
          dy = py - ry1;
          if ((unsigned)dx < (unsigned)kD && (unsigned)dy < (unsigned)kD) {
            s.dots[r1 * kDD + dy * kD + dx] = acc[j][2 + e];
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; nothing in flight
}

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
  constexpr int kV = Vec<T>::kN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nchunk = C / kV;
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
    for (int i = 0; i < kD; ++i) {
      const int yy = og.y + i;
      const bool row_in = yy >= 0 && yy < H;
      float part[kD];
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int xx = og.x + j;
        float sum = 0.f;
        if (row_in && xx >= 0 && xx < W) {  // warp-uniform
          const T* row = f2 + ((long long)yy * W + xx) * C;
#pragma unroll
          for (int k = 0; k < kCpl; ++k) {
            const int c = lane + 32 * k;
            if (c < nchunk) {
              float v[kV];
              Vec<T>::load(row + c * kV, v);
#pragma unroll
              for (int e = 0; e < kV; ++e) sum = fmaf(a[k][e], v[e], sum);
            }
          }
        }
        part[j] = sum;
      }
#pragma unroll
      for (int j = 0; j < kD; ++j) part[j] = warp_sum(part[j]);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kD; ++j) dots[i * kD + j] = part[j];
      }
    }
    __syncwarp();
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
  constexpr int kR = R;
  constexpr int kN1 = Window<R>::kN1;
  constexpr int kD = Window<R>::kD;
  constexpr int kDD = Window<R>::kDD;
  constexpr int kNn = Window<R>::kNn;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
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

  if (tid < kTileQ) {  // the first kRedWarps warps, a query each
    const int qy = ty * kTileH + tid / kTileW;
    const int qx = tx * kTileW + tid % kTileW;
    bool live = false;
    int x0 = 0, y0 = 0;
    float2 fr = make_float2(0.f, 0.f);
    if (qy < H1 && qx < W1) {
      const long long q = qbase + (long long)qy * W1 + qx;
      const float inv = 1.f / (float)(1 << l);  // exact: a power of two
      // clamp before any float->int conversion: a centre further out than
      // this has its whole window outside the level, and stays so
      const float cx = fminf(fmaxf(coords[2 * q] * inv, -(kR + 2.f)), W + kR + 1.f);
      const float cy = fminf(fmaxf(coords[2 * q + 1] * inv, -(kR + 2.f)), H + kR + 1.f);
      const float fx = floorf(cx);
      const float fy = floorf(cy);
      fr = make_float2(cx - fx, cy - fy);
      x0 = (int)fx - kR;
      y0 = (int)fy - kR;
      live = x0 + kD > 0 && x0 < W && y0 + kD > 0 && y0 < H;
    }
    s.org[tid] = live ? make_int2(x0, y0) : make_int2(kDead, kDead);
    s.frac[tid] = fr;
    const int m0 = __reduce_min_sync(0xffffffffu, live ? x0 : INT_MAX);
    const int m1 = __reduce_max_sync(0xffffffffu, live ? x0 : INT_MIN);
    const int m2 = __reduce_min_sync(0xffffffffu, live ? y0 : INT_MAX);
    const int m3 = __reduce_max_sync(0xffffffffu, live ? y0 : INT_MIN);
    if (lane == 0) s.red[warp] = make_int4(m0, m1, m2, m3);
  }
  __syncthreads();
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
  for (int w = 0; w < kRedWarps; ++w) {
    const int4 r = s.red[w];
    bx0 = min(bx0, r.x);
    bx1 = max(bx1, r.y);
    by0 = min(by0, r.z);
    by1 = max(by1, r.w);
  }
  const bool any = bx0 <= bx1;  // block-uniform, as is everything below
  int bw = 0, bh = 0;
  if (any) {  // the windows' union, clipped to the level
    bx1 = min(bx1 + kD - 1, W - 1);
    by1 = min(by1 + kD - 1, H - 1);
    bx0 = max(bx0, 0);
    by0 = max(by0, 0);
    bw = bx1 - bx0 + 1;
    bh = by1 - by0 + 1;
  }
  const int npts = bw * bh;
  bool tile = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    tile = any && npts <= kBoxCap && C <= kTileMaxC;
  }
  if (path_counts != nullptr && any && tid == 0) {
    atomicAdd(path_counts + (tile ? l : num_levels + l), 1);
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tile) {
      tile_dots<R>(s, reinterpret_cast<__nv_bfloat16*>(smem_raw + sizeof(s)), f1,
                f2, W, C, qbase, W1, H1, ty, tx, bx0, by0, bw, npts);
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

template <typename T, int R>
int smem_bytes(int C) {
  // (n+1)^2 = 4 (r+1)^2 floats a row of dots
  static_assert(sizeof(HeadOf<T, R>) % 16 == 0,
                "the slab ring is 16-byte aligned");
  int bytes = (int)sizeof(HeadOf<T, R>);
  if (std::is_same<T, __nv_bfloat16>::value && C <= kTileMaxC) {
    bytes += kStages * kSlab * slab_stride(C) * (int)sizeof(__nv_bfloat16);
  }
  return bytes;
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
  const int vec = 16 / (is_bf16 ? 2 : 4);
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1 ||
      radius > ufr::kMaxRadius || B < 1 || B > 65535 || H1 < 1 || W1 < 1 || C < 1 || C % vec ||
      C / vec > 64 || (long long)H1 * W1 > INT_MAX) {
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
