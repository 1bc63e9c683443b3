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
// Bound.  At RAFT's train geometry (B=4, 36x120 queries, C=256, L=4, r=4,
// bf16) a call reads f1, the levels, the coords and the 22 MB cotangent and
// writes df1 and the f32 df2 levels: ~84 MB, 25 us at 3.35 TB/s.  Its
// 2 x 1.77 G multiply-adds are f32 on the CUDA cores here (~106 us at 67
// TFLOP/s).  Scattering df2 with one float4 atomic per (query, window
// point, 4 channels) is 442 M atomics, ~7 GB of L2 atomic traffic, per
// call, and bound by them (the per-query path below); the tile path cuts
// both.
//
// Design: a block owns an 8x8 tile of neighbouring queries of one image
// (the query grid is H1 x W1 per image; edge tiles are ragged) and one
// chunk of 32 channels, so the grid is (tiles, chunks, batch) and df1 and
// df2 split exactly over the chunks.  Thread (q, sub) owns query q and 8
// channels of the chunk; it keeps its f1 channels and its df1 sums in
// registers, and df1 is written whole at the end, without atomics (a query
// lies in exactly one tile).  A warp holds one tile row.  Per level:
//   1. Each query clamps and floors its centre exactly as the forward does
//      (so the window grid is the forward's); a window with no point inside
//      the level is dead.  Warp reductions give each tile row's range of
//      live window origins, and their union the tile's box, clipped to the
//      level.
//   2. The block folds every live query's n^2 cotangents into its (n+1)^2
//      weights U (81 into 100 at r = 4) in shared memory (a thread per query column), while the
//      box's f2 chunk, if it fits in kBoxBytes (1024 points bf16, 512 f32),
//      streams into shared memory by cp.async.
//   3. Tile path (the box fits): df1 by gather -- each thread sums U * f2
//      over its query's window points from the box; df2 by gather -- an
//      item is a column of kBand box points and 4 channels, which sums
//      U * f1 over the tile's queries whose window covers each point,
//      skipping the tile rows whose origins rule them out, then adds each
//      sum into df2 with one float4 atomic (boxes of neighbouring tiles
//      overlap).  On a smooth field that is ~|box| atomics per tile
//      instead of 64 x (n+1)^2, and each f2 row is read once per tile instead
//      of once per query.  The tile path is bound by instruction issue in
//      its two gathers (shared-memory loads, FMAs, covering tests), not by
//      its atomics.
//   4. Per-query path (the box does not fit: per-query wild centres): each
//      thread loops over its query's window, f2 from global memory and one
//      float4 atomic per (point, 4 channels).
// The choice is block-uniform, per (tile, level); an optional counter
// records it.  The level's pointers and sizes are selected with constant
// indices: indexing the parameter structs with a runtime level would copy
// them to local memory in every thread (a 192-byte stack frame).
//
// Numerics: inputs f32 or bf16 (widened to f32 in registers); g, U, every
// sum and both outputs are f32.  The df2 sums land in an order that
// changes from run to run (atomics).  The JAX TPU backward rounds g and U
// to bf16 (ops/correlation.py:740, alt_corr.py:633-638); this kernel keeps
// them f32, so its gradient is closer to the f32 one.
//
// Radius: a template over r, instantiated for 1..7 (csrc/radius.cuh); the
// (n+1)^2 weights U, their shared memory and the fold follow from it.  The
// tile shape, kBand and kBoxBytes were tuned at r = 4 and are kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "radius.cuh"

namespace {

using ufr::Window;

constexpr int kMaxLevels = 8;
constexpr int kTileW = 8;                   // a tile of the query grid
constexpr int kTileQ = kTileW * kTileW;
constexpr int kChunk = 32;                  // channels of a block
constexpr int kPieces = kChunk / 4;         // 4-channel pieces of a chunk
constexpr int kBand = 4;                    // box rows of a df2 item
constexpr int kSub = 4;                     // threads per query, 8 channels
constexpr int kThreads = kTileQ * kSub;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == kTileW, "a warp holds one tile row of queries");
constexpr int kBoxBytes = 64 * 1024;        // the box's f2 chunk, shared
constexpr int kDead = -(1 << 20);           // origin of a dead window

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct GradLevels {
  float* ptr[kMaxLevels];
};

// 4 channels of T, widened to f32; Raw is their bytes.
template <typename T>
struct V4;

template <>
struct V4<float> {
  using Raw = float4;
  __device__ __forceinline__ static void widen(const Raw& t, float (&v)[4]) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

template <>
struct V4<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static void widen(const Raw& t, float (&v)[4]) {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};

template <typename T>
__device__ __forceinline__ void ldg4(const T* p, float (&v)[4]) {
  V4<T>::widen(__ldg(reinterpret_cast<const typename V4<T>::Raw*>(p)), v);
}

template <typename T>
__device__ __forceinline__ void lds4(const T* p, float (&v)[4]) {
  V4<T>::widen(*reinterpret_cast<const typename V4<T>::Raw*>(p), v);
}

// one 4-channel piece global -> shared, asynchronously (8 or 16 bytes)
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(typename V4<T>::Raw) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float (&acc)[4], float u,
                                     const float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = fmaf(u, v[e], acc[e]);
}

template <typename T, int R>
struct Smem {
  // box points of f2 that fit in kBoxBytes: 1024 bf16, 512 f32
  static constexpr int kBoxCap = kBoxBytes / (kChunk * (int)sizeof(T));
  float u[kTileQ * Window<R>::kDD];  // every query's weights U[i][j]
  float f1[kTileQ * kChunk];    // the tile's f1 chunk, f32
  int2 org[kTileQ];             // window origins (x0, y0); kDead if dead
  float2 frac[kTileQ];          // the centres' fractions (ax, ay)
  // per warp, i.e. per tile row of 8 queries: the live windows' min x0,
  // max x0, min y0, max y0
  int4 red[kWarps];
  alignas(16) T box[kBoxCap * kChunk];  // the box's f2 chunk, point-major
};

// R: the lookup radius.  Grid (tiles, chunks, batch), block kThreads,
// dynamic shared memory sizeof(Smem<T, R>).  path_counts (optional): [l] += 1 per (tile, level) on
// the tile path, [num_levels + l] per-query path, counted by chunk 0.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 2)
alt_corr_bwd_kernel(const T* __restrict__ f1, Levels lv, int num_levels,
                    const float* __restrict__ coords,
                    const float* __restrict__ g, float* __restrict__ df1,
                    GradLevels dlv, int H1, int W1, int C, int tiles_x,
                    int* __restrict__ path_counts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, R>& s = *reinterpret_cast<Smem<T, R>*>(smem_raw);
  constexpr int kR = R;
  constexpr int kN1 = Window<R>::kN1;
  constexpr int kD = Window<R>::kD;
  constexpr int kDD = Window<R>::kDD;
  constexpr int kNn = Window<R>::kNn;
  constexpr int kCap = Smem<T, R>::kBoxCap;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kChunk;
  const int cc = min(kChunk, C - c0);  // channels of this chunk
  const int ty = blockIdx.x / tiles_x;
  const int tx = blockIdx.x - ty * tiles_x;
  const long long N = (long long)H1 * W1;

  const int q = tid / kSub;
  const int sub = tid % kSub;
  const int qy = ty * kTileW + q / kTileW;
  const int qx = tx * kTileW + q % kTileW;
  const bool qvalid = qy < H1 && qx < W1;
  const long long qn = b * N + (long long)qy * W1 + qx;
  // the thread's 8 channels, two 4-channel pieces (C is a multiple of 4,
  // so a chunk may end after the first)
  const int p0 = sub * 8;
  const int p1 = p0 + 4;
  const bool in0 = p0 < cc;
  const bool in1 = p1 < cc;

  float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
  float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
  float x = 0.f, y = 0.f;
  if (qvalid) {
    const T* row = f1 + qn * C + c0;
    if (in0) ldg4(row + p0, a0);
    if (in1) ldg4(row + p1, a1);
    x = coords[2 * qn];
    y = coords[2 * qn + 1];
  }
  *reinterpret_cast<float4*>(s.f1 + q * kChunk + p0) =
      make_float4(a0[0], a0[1], a0[2], a0[3]);
  *reinterpret_cast<float4*>(s.f1 + q * kChunk + p1) =
      make_float4(a1[0], a1[1], a1[2], a1[3]);

  for (int l = 0; l < num_levels; ++l) {
    // the level's pointers and size, selected with constant indices
    const void* base = nullptr;
    float* dbase = nullptr;
    int H = 0, W = 0;
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) {
      if (i == l) {
        base = lv.ptr[i];
        dbase = dlv.ptr[i];
        H = lv.h[i];
        W = lv.w[i];
      }
    }
    const long long lbase = (long long)b * H * W * C + c0;
    const T* f2 = static_cast<const T*>(base) + lbase;
    float* df2 = dbase + lbase;
    const float inv = 1.f / (float)(1 << l);  // exact: a power of two
    // the forward's clamp, before any float->int conversion: a centre
    // further out has its whole window outside the level and gets nothing
    const float cx = fminf(fmaxf(x * inv, -(kR + 2.f)), W + kR + 1.f);
    const float cy = fminf(fmaxf(y * inv, -(kR + 2.f)), H + kR + 1.f);
    const float fx = floorf(cx);
    const float fy = floorf(cy);
    const int x0 = (int)fx - kR;
    const int y0 = (int)fy - kR;
    const bool live = qvalid && x0 + kD > 0 && x0 < W && y0 + kD > 0 && y0 < H;
    if (sub == 0) {
      s.org[q] = live ? make_int2(x0, y0) : make_int2(kDead, kDead);
      s.frac[q] = make_float2(cx - fx, cy - fy);
    }
    {  // the bounding box of the live windows' origins
      const int r0 = __reduce_min_sync(0xffffffffu, live ? x0 : INT_MAX);
      const int r1 = __reduce_max_sync(0xffffffffu, live ? x0 : INT_MIN);
      const int r2 = __reduce_min_sync(0xffffffffu, live ? y0 : INT_MAX);
      const int r3 = __reduce_max_sync(0xffffffffu, live ? y0 : INT_MIN);
      if (lane == 0) s.red[warp] = make_int4(r0, r1, r2, r3);
    }
    __syncthreads();
    int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
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
    const bool tile = any && npts <= kCap;

    if (tile) {  // the box's f2 chunk, streaming in while U is folded
      for (int e = tid; e < npts * kPieces; e += kThreads) {
        const int pt = e / kPieces;
        const int pc = e % kPieces;
        if (pc * 4 >= cc) continue;
        const int py = pt / bw;
        const int px = pt - py * bw;
        cp_async4(s.box + pt * kChunk + pc * 4,
                  f2 + ((long long)(by0 + py) * W + (bx0 + px)) * C + pc * 4);
      }
    }
    if (any) {
      // U, one column j of one query per item: G's columns j and j-1 are
      // n consecutive cotangents each (g is s-major: G[t][s] = g[s*n + t])
      for (int e = tid; e < kTileQ * kD; e += kThreads) {
        const int qq = e / kD;
        const int j = e - qq * kD;
        float* uc = s.u + qq * kDD + j;
        if (s.org[qq].x == kDead) {
#pragma unroll
          for (int i = 0; i < kD; ++i) uc[i * kD] = 0.f;
          continue;
        }
        const float2 fr = s.frac[qq];
        const float ax = fr.x, ay = fr.y;
        const long long n = b * N + (long long)(ty * kTileW + qq / kTileW) * W1 +
                            (tx * kTileW + qq % kTileW);
        const float* gq = g + n * (long long)(num_levels * kNn) + l * kNn;
        float gj[kN1], gm[kN1];  // G[.][j], G[.][j-1]
#pragma unroll
        for (int t = 0; t < kN1; ++t) {
          gj[t] = j < kN1 ? __ldg(gq + j * kN1 + t) : 0.f;
          gm[t] = j > 0 ? __ldg(gq + (j - 1) * kN1 + t) : 0.f;
        }
        const float w00 = (1.f - ax) * (1.f - ay), w01 = ax * (1.f - ay);
        const float w10 = (1.f - ax) * ay, w11 = ax * ay;
#pragma unroll
        for (int i = 0; i < kD; ++i) {
          float u = 0.f;
          if (i < kN1) u += w00 * gj[i] + w01 * gm[i];
          if (i > 0) u += w10 * gj[i - 1] + w11 * gm[i - 1];
          uc[i * kD] = u;
        }
      }
      if (path_counts != nullptr && blockIdx.y == 0 && tid == 0) {
        atomicAdd(path_counts + (tile ? l : num_levels + l), 1);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    const float* uq = s.u + q * kDD;
    if (tile) {
      // df1: this thread's query over its window's points inside the box
      if (live) {
        const int ox = x0 - bx0;
        const int oy = y0 - by0;
        const int i0 = max(0, -oy), i1 = min(kD, bh - oy);
        const int j0 = max(0, -ox), j1 = min(kD, bw - ox);
        for (int i = i0; i < i1; ++i) {
          const T* brow = s.box + ((oy + i) * bw + ox) * kChunk;
          for (int j = j0; j < j1; ++j) {
            const float u = uq[i * kD + j];
            const T* pt = brow + j * kChunk;
            float v[4];
            if (in0) {
              lds4(pt + p0, v);
              fma4(acc0, u, v);
            }
            if (in1) {
              lds4(pt + p1, v);
              fma4(acc1, u, v);
            }
          }
        }
      }
      // df2: an item is a column of kBand box points and one 4-channel
      // piece; it sums U * f1 over the tile's queries whose window covers
      // each point (skipping the tile rows whose windows all miss the
      // column), then adds each sum into df2 with one float4 atomic
      const int bands = (bh + kBand - 1) / kBand;
      for (int e = tid; e < bw * bands * kPieces; e += kThreads) {
        const int pc = e % kPieces;
        if (pc * 4 >= cc) continue;
        const int cell = e / kPieces;
        const int band = cell / bw;
        const int gx = bx0 + (cell - band * bw);
        const int gy = by0 + band * kBand;
        const int rows = min(kBand, bh - band * kBand);
        float sum[kBand][4] = {};
        unsigned hit = 0;
        for (int tr = 0; tr < kTileW; ++tr) {  // tile rows (= warps)
          const int4 rr = s.red[tr];  // a dead row has x = INT_MAX
          if (gx < rr.x || gx > rr.y + kD - 1 || gy + rows <= rr.z ||
              gy > rr.w + kD - 1) {
            continue;
          }
#pragma unroll
          for (int k = tr * kTileW; k < (tr + 1) * kTileW; ++k) {
            const int2 o = s.org[k];
            const int dx = gx - o.x;
            if ((unsigned)dx >= (unsigned)kD) continue;
            const float4 f =
                *reinterpret_cast<const float4*>(s.f1 + k * kChunk + pc * 4);
            const float* uk = s.u + k * kDD + dx;
            const int dy0 = gy - o.y;
#pragma unroll
            for (int r = 0; r < kBand; ++r) {
              const int dy = dy0 + r;
              if ((unsigned)dy < (unsigned)kD && r < rows) {
                const float u = uk[dy * kD];
                sum[r][0] = fmaf(u, f.x, sum[r][0]);
                sum[r][1] = fmaf(u, f.y, sum[r][1]);
                sum[r][2] = fmaf(u, f.z, sum[r][2]);
                sum[r][3] = fmaf(u, f.w, sum[r][3]);
                hit |= 1u << r;
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kBand; ++r) {
          if (hit & (1u << r)) {
            atomicAdd(reinterpret_cast<float4*>(
                          df2 + ((long long)(gy + r) * W + gx) * C + pc * 4),
                      make_float4(sum[r][0], sum[r][1], sum[r][2], sum[r][3]));
          }
        }
      }
    } else if (any && live) {
      // per-query path: f2 from global memory, one atomic per 4 channels
      for (int i = 0; i < kD; ++i) {
        const int yy = y0 + i;
        if (yy < 0 || yy >= H) continue;
        for (int j = 0; j < kD; ++j) {
          const int xx = x0 + j;
          const float u = uq[i * kD + j];
          if (xx < 0 || xx >= W || u == 0.f) continue;
          const long long p = ((long long)yy * W + xx) * C;
          float v[4];
          if (in0) {
            ldg4(f2 + p + p0, v);
            fma4(acc0, u, v);
            atomicAdd(reinterpret_cast<float4*>(df2 + p + p0),
                      make_float4(u * a0[0], u * a0[1], u * a0[2], u * a0[3]));
          }
          if (in1) {
            ldg4(f2 + p + p1, v);
            fma4(acc1, u, v);
            atomicAdd(reinterpret_cast<float4*>(df2 + p + p1),
                      make_float4(u * a1[0], u * a1[1], u * a1[2], u * a1[3]));
          }
        }
      }
    }
    __syncthreads();  // the next level overwrites org, frac, red, u, box
  }

  if (qvalid) {
    float* o = df1 + qn * C + c0;
    if (in0) {
      *reinterpret_cast<float4*>(o + p0) =
          make_float4(acc0[0], acc0[1], acc0[2], acc0[3]);
    }
    if (in1) {
      *reinterpret_cast<float4*>(o + p1) =
          make_float4(acc1[0], acc1[1], acc1[2], acc1[3]);
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* f1, const Levels& lv, int L,
                   const float* coords, const float* g, float* df1,
                   const GradLevels& dlv, int B, int H1, int W1, int C,
                   int* path_counts, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<T, R>);
  cudaError_t err = cudaFuncSetAttribute(
      alt_corr_bwd_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W1 + kTileW - 1) / kTileW;
  const int tiles_y = (H1 + kTileW - 1) / kTileW;
  const dim3 grid(tiles_x * tiles_y, (C + kChunk - 1) / kChunk, B);
  alt_corr_bwd_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(f1), lv, L, coords, g, df1, dlv, H1, W1, C,
      tiles_x, path_counts);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_alt_corr_bwd_cuda,
// which validates every argument first (dtype, shapes, contiguity,
// alignment, C a multiple of the vector width, radius 1..7, 1..8 levels).
// f1: (B, N, C) with N = H1 * W1 queries, row-major on an H1 x W1 grid (the
// grid only groups queries into tiles; any H1 x W1 = N is right);
// levels[l]: (B, h, w, C), with hw = {h0, w0, h1, w1, ...}; coords: (B, N,
// 2) f32; g: (B, N, L*n*n) f32; df1: (B, N, C) f32, written whole;
// dlevels[l]: (B, h, w, C) f32, zeroed by the caller and accumulated into;
// path_counts: null, or 2 * L int32 zeroed by the caller (see the
// kernel).  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_alt_corr_bwd(const void* f1, const void* const* levels,
                                const int* hw, int num_levels,
                                const void* coords, const void* g, void* df1,
                                void* const* dlevels, int B, int H1, int W1,
                                int C, int radius, int is_bf16,
                                void* path_counts, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1 ||
      radius > ufr::kMaxRadius || B < 1 || B > 65535 || H1 < 1 || W1 < 1 || C < 1 ||
      C % (16 / (is_bf16 ? 2 : 4)) || (long long)H1 * W1 > INT_MAX ||
      (C + kChunk - 1) / kChunk > 65535) {
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
  int* pc = static_cast<int*>(path_counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)ufr::with_radius(radius, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return is_bf16 ? launch<__nv_bfloat16, R>(f1, lv, num_levels, c, gg, d1,
                                              dlv, B, H1, W1, C, pc, s)
                   : launch<float, R>(f1, lv, num_levels, c, gg, d1, dlv, B,
                                      H1, W1, C, pc, s);
  });
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
