// Spatial correlation (kernel 1, stride 1, padding 0), backward, for Hopper
// (sm_90a): the gradients of csrc/spatial_corr_fwd.cu with respect to both
// feature maps for the output cotangent g.
//
// The port's counterpart of XLA's autodiff of the JAX package's banded
// einsums (understanding_flow_robustness_tpu/ops/correlation.py:56-182);
// the reference's spatial-correlation-sampler op has its own backward.  The
// global attacks on FlowNetC and PWC-Net run it.
//
// NCHW f1 (B, C, H, W), f2 (B, C, H2, W), g (B, P*P, H, W), df1 (B, C, H,
// W) and df2 (B, C, H2, W), all f32 or all bf16 (PWC-Net's autocast hands
// a bf16 cotangent and wants bf16 gradients, so no cast pass runs around
// the kernel); sums in f32.  With the forward's row offset row0, du =
// (pu-r)*d, dv = (pv-r)*d, p = pu*P + pv:
//   df1[b,c,y,x] = sum_p g[b,p,y,x]              * f2[b,c,y+row0+du,x+dv]
//   df2[b,c,y,x] = sum_p g[b,p,y-row0-du,x-dv]   * f1[b,c,y-row0-du,x-dv]
// with zeros outside the maps.  Both are gathers, so no atomics: every
// output element is written once, by one thread.  On a spatial mesh's row
// block df2 covers f2's halo rows too; ops/correlation.py's halo exchange
// adds those into their owners' rows.
//
// Design, FlowNetC's (21, 2) and PWC-Net's (9, 1):
// `spatial_corr_bwd_tile_kernel`, register-tiled.  A block owns a tile of
// G groups of 8 consecutive columns of two output rows y0 and y0 + d,
// 128 / G * 2 channels (G = 4 or 8 as C asks: 64 or 32) and one of the two
// gradients (blockIdx.z: batch, channel group, which).  A thread owns one
// group and two channels.  The block walks the feature rows its two
// output rows reach, each once (P + 1 of them, those inside the map): per
// row, TMA copies bring the block's feature rows and, for each output row
// it serves, the P cotangent rows of that output's displacement row, zeros
// outside the map, into one of two buffers (an mbarrier each, so the next
// row lands while this one is computed on); a thread loads its channels'
// windows (8 + 2rd columns) into registers once per row and takes, per
// output row and pv, the cotangent's 8 values, the same for all lanes of
// a warp (a broadcast), into 2 x 8 FMAs.  The sums leave through a
// shared-memory tile, stored along the rows.  Where W or an input's
// alignment rules TMA out, an element-wise stand-in stages the same
// layout.
//
// Any other odd patch and dilation takes
// `spatial_corr_bwd_generic_kernel`, the port's first design: a block owns
// one output row's tile of 32 columns (a lane each), 32 channels (4 a
// thread, 8 warps) and one gradient; per pu it stages, as f32 with zeros
// outside the map, the P cotangent rows and the 32 feature rows, then per
// pv a thread reads its cotangent once and FMAs it into its 4 channels.
// Sums in f32, in an order of their own.
//
// Bound: at FlowNetC's attack shape (1, 256, 32, 80), P=21, d=2, the
// ~0.7 GFLOP of products inside the map (0.01 ms at 67 TFLOP/s f32)
// against ~15 MB of traffic (0.005 ms): operations.  The tile kernel's
// staging bounds it first: each feature row is brought in once per pair
// of output rows that reach it.
//
// Shared memory: ops/correlation.py::spatial_corr_smem_bytes states what
// each kernel takes, and the wrapper refuses what exceeds the limit; the
// launchers here compute the same numbers.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "spatial_corr_tile.cuh"

constexpr int kTX = 32;    // output columns a block, one per lane
constexpr int kWarps = 8;
constexpr int kCK = 4;     // channels a thread
constexpr int kChannels = kWarps * kCK;  // channels a block
constexpr int kThreads = kTX * kWarps;
constexpr long long kSmemMax = 232448;  // the H100's per-block limit

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spatial_corr_bwd_generic_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                        const T* __restrict__ g, T* __restrict__ df1,
                        T* __restrict__ df2, int C, int H, int W, int H2,
                        int row0, int P, int d, int chunks) {
  extern __shared__ float smem[];
  const int r = (P - 1) / 2;
  const int reach = r * d;
  const int sw = kTX + 2 * reach;
  const int P2 = P * P;
  float* g_s = smem;           // [P][sw]: the cotangent rows of one pu
  float* f_s = smem + P * sw;  // [kChannels][sw]: the feature rows

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTX;
  const int y = blockIdx.y;
  const int which = blockIdx.z & 1;  // 0: df1, 1: df2
  const int bc = blockIdx.z >> 1;
  const int b = bc / chunks;
  const int c0 = (bc - b * chunks) * kChannels;
  T* dst = which ? df2 : df1;
  // the gradient's rows, the feature map's, and the feature row of output
  // row y at displacement 0
  const int Ho = which ? H2 : H, Hf = which ? H : H2;
  if (dst == nullptr || y >= Ho) return;  // not wanted, or past its rows
  const int n = min(kChannels, C - c0);
  const long long plane = (long long)H * W;  // f1's and g's
  const long long plane_f = (long long)Hf * W, plane_o = (long long)Ho * W;
  const int yb = which ? y - row0 : y + row0;
  const T* feat = (which ? f1 : f2) + ((long long)b * C + c0) * plane_f;
  const T* gb = g + (long long)b * P2 * plane;

  float acc[kCK];
#pragma unroll
  for (int k = 0; k < kCK; ++k) acc[k] = 0.f;
  for (int pu = 0; pu < P; ++pu) {
    const int du = (pu - r) * d;
    const int yy = which ? yb - du : yb + du;  // the feature row
    if (yy < 0 || yy >= Hf) continue;
    const int gy = which ? yy : y;           // the cotangent row
    for (int row = warp; row < P; row += kWarps) {
      const T* src = gb + (long long)(pu * P + row) * plane
                     + (long long)gy * W;
      for (int j = lane; j < sw; j += 32) {
        const int xx = x0 - reach + j;
        g_s[row * sw + j] = (xx >= 0 && xx < W) ? widen(src[xx]) : 0.f;
      }
    }
    for (int row = warp; row < n; row += kWarps) {
      const T* src = feat + row * plane_f + (long long)yy * W;
      for (int j = lane; j < sw; j += 32) {
        const int xx = x0 - reach + j;
        f_s[row * sw + j] = (xx >= 0 && xx < W) ? widen(src[xx]) : 0.f;
      }
    }
    __syncthreads();
    for (int pv = 0; pv < P; ++pv) {
      // the staged column of x + dv (df1) or x - dv (df2)
      const int j = which ? lane + (2 * r - pv) * d : lane + pv * d;
      const float gv = g_s[pv * sw + (which ? j : lane + reach)];
#pragma unroll
      for (int k = 0; k < kCK; ++k) {
        acc[k] = fmaf(gv, f_s[(warp + kWarps * k) * sw + j], acc[k]);
      }
    }
    __syncthreads();
  }

  const int x = x0 + lane;
  if (x >= W) return;
  T* o = dst + ((long long)b * C + c0) * plane_o + (long long)y * W + x;
#pragma unroll
  for (int k = 0; k < kCK; ++k) {
    const int c = warp + kWarps * k;
    if (c < n) o[c * plane_o] = narrow<T>(acc[k]);
  }
}

template <typename T>
int launch_generic(const void* f1, const void* f2, const void* g, void* df1,
           void* df2, int B, int C, int H, int W, int H2, int row0, int P,
           int d, cudaStream_t s) {
  const int r = (P - 1) / 2;
  const long long sw = kTX + 2LL * r * d;
  const long long bytes = 4LL * (P + kChannels) * sw;
  const int chunks = (C + kChannels - 1) / kChannels;
  if (bytes > kSmemMax || H > 65535 || 2LL * B * chunks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = spatial_corr_bwd_generic_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kTX - 1) / kTX, H > H2 ? H : H2, 2 * B * chunks);
  kern<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(g), static_cast<T*>(df1),
      static_cast<T*>(df2), C, H, W, H2, row0, P, d, chunks);
  return (int)cudaGetLastError();
}

// ---- the register-tiled kernel: FlowNetC's (21, 2), PWC-Net's (9, 1) ----

template <typename T, int P_, int D_, int G_>
struct BwdTile {
  static constexpr int P = P_, D = D_, G = G_;
  static constexpr int kCX = 8;          // columns a thread
  static constexpr int kCK = 2;          // channels a thread
  static constexpr int kY = 2;           // output rows a block, d apart
  static constexpr int kThreads = 128;
  static constexpr int kS = kThreads / G;        // channel slots a group
  static constexpr int kCB = kS * kCK;           // channels a block
  static constexpr int kR = (P - 1) / 2;
  static constexpr int kTX = G * kCX;            // columns a tile
  static constexpr int kLead = round_up(kR * D, kVec<T>) - kR * D;
  // a staged row: columns x0 - rd - kLead .. (16-byte aligned)
  static constexpr int kCols = round_up(kLead + kTX + 2 * kR * D, kVec<T>);
  static constexpr int kRow = row_stride<T>(kCols);
  static constexpr int kWin = round_up(kCX + 2 * kR * D, 4);  // window
  // a step's buffer: kY boxes of [P][kRow] cotangent rows, then [kCB][kRow]
  // feature rows, each region on 128 bytes (TMA destinations)
  static constexpr int kAlign = 128 / (int)sizeof(T);  // elements
  static constexpr int kGBox = round_up(P * kRow, kAlign);  // an output's
  static constexpr int kFOff = kY * kGBox;
  static constexpr int kBuf = round_up(kFOff + kCB * kRow + 4 * kVec<T>,
                                       kAlign);  // + slack
  static constexpr int kOutRow = kTX + 4;  // the output tile's row (f32)
  static constexpr long long kBufBytes = (long long)kBuf * sizeof(T);
  static constexpr long long kSmem =
      round_up(2 * kBufBytes > 4LL * kY * kCB * kOutRow
                   ? (int)(2 * kBufBytes) : 4 * kY * kCB * kOutRow, 16)
      + 16;  // + the two mbarriers
  static_assert(kLead % 4 == 0 && (kR * D) % 4 == 0 && kCX % 4 == 0,
                "aligned windows");
};

// Block: a tile of kTX columns (blockIdx.x) of the kY output rows y0,
// y0 + d, ... (blockIdx.y), kCB channels and one gradient (blockIdx.z:
// batch, channel group, which).  Thread: channels slot + kS*k (k < kCK),
// columns i0 .. i0+kCX-1 of the tile.  The block walks the feature rows
// its outputs reach, ys = y0 +- row0 + (s - r) d (+ for df1, whose
// features are f2's rows; - for df2) for s = 0 .. P + kY - 2, each
// once: output row t takes row s at displacement row pu = s - t (df1) or
// P - 1 - (s - t) (df2).  Per step s, the kCB feature rows and, for each
// output row it serves, the P cotangent rows of its pu arrive by TMA (one
// thread issues them, double buffered over s, an mbarrier each) or by the
// element-wise stand-in (the same layout); each thread loads its
// channels' windows (kCX + 2rd columns) into registers once and takes per
// output row and pv the cotangent's kCX values (the same for all its
// channels, broadcast across the warp) into kCK x kCX FMAs.  The sums go
// out through a shared-memory tile, stored along the rows.
template <typename T, class K>
__global__ void __launch_bounds__(K::kThreads)
spatial_corr_bwd_tile_kernel(const __grid_constant__ CUtensorMap f1_map,
                             const __grid_constant__ CUtensorMap f2_map,
                             const __grid_constant__ CUtensorMap g_map,
                             const T* __restrict__ f1,
                             const T* __restrict__ f2,
                             const T* __restrict__ g, T* __restrict__ df1,
                             T* __restrict__ df2, int C, int H, int W,
                             int H2, int row0, int groups, int tma) {
  constexpr int P = K::P, D = K::D, CX = K::kCX, CK = K::kCK, r = K::kR;
  constexpr int Y = K::kY;
  extern __shared__ __align__(128) unsigned char bsm[];
  T* buf = reinterpret_cast<T*>(bsm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bsm + K::kSmem - 16);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * K::kTX;
  const int y0 = blockIdx.y / D * (Y * D) + blockIdx.y % D;
  const int which = blockIdx.z & 1;  // 0: df1, 1: df2
  const int bc = blockIdx.z >> 1;
  const int b = bc / groups;
  const int c0 = (bc - b * groups) * K::kCB;
  T* dst = which ? df2 : df1;
  if (dst == nullptr) return;  // that gradient is not wanted
  const int n = min(K::kCB, C - c0);
  // the gradient's rows and the feature map's (df1: H and f2's H2; df2:
  // H2 and f1's H)
  const int Ho = which ? H2 : H, Hf = which ? H : H2;
  const long long plane = (long long)H * W;  // f1's and g's
  const long long plane_f = (long long)Hf * W, plane_o = (long long)Ho * W;
  const T* feat = (which ? f1 : f2) + (long long)b * C * plane_f;
  const T* gb = g + (long long)b * P * P * plane;

  const int grp = tid / K::kS;
  const int slot = tid - grp * K::kS;
  const int i0 = grp * CX;
  const bool active = x0 + i0 < W;
  // the feature row of step r (output row y0 at displacement 0), and the
  // feature rows inside the map: s in [lo, hi]
  const int yb = which ? y0 - row0 : y0 + row0;
  const int lo = max(0, r - floor_div(yb, D));
  const int hi =
      y0 < Ho ? min(P + Y - 2, r + floor_div(Hf - 1 - yb, D)) : -1;
  const int steps = hi - lo + 1;
  // a staged row's first column
  const int xs = x0 - r * D - K::kLead;
  // output row t takes step s (q = s - t in [0, P)) if it lies in the map
  auto serves = [&](int t, int s) {
    return s - t >= 0 && s - t < P && y0 + t * D < Ho;
  };

  // step i (s = lo + i) into buffer i & 1
  auto stage = [&](int i) {
    T* sb = buf + (i & 1) * K::kBuf;
    const int s = lo + i;
    const int ys = yb + (s - r) * D;  // the feature row
    if (tma) {
      if (tid == 0) {
        fence_async_smem();
        int rows = K::kCB;
#pragma unroll
        for (int t = 0; t < Y; ++t) rows += serves(t, s) ? P : 0;
        mbar_expect(&bar[i & 1], (unsigned)(rows * K::kRow * sizeof(T)));
        tma_load(sb + K::kFOff, which ? &f1_map : &f2_map, &bar[i & 1], xs,
                 ys, c0, b);
#pragma unroll
        for (int t = 0; t < Y; ++t) {
          if (!serves(t, s)) continue;
          const int pu = which ? P - 1 - (s - t) : s - t;
          tma_load(sb + t * K::kGBox, &g_map, &bar[i & 1], xs,
                   which ? ys : y0 + t * D, pu * P, b);
        }
      }
      return;
    }
    box_load(sb + K::kFOff, K::kRow, feat, W, Hf, C, xs, ys, c0, K::kCols, 1,
             1, 1, n);
#pragma unroll
    for (int t = 0; t < Y; ++t) {
      if (!serves(t, s)) continue;
      const int pu = which ? P - 1 - (s - t) : s - t;
      box_load(sb + t * K::kGBox, K::kRow, gb, W, H, P * P, xs,
               which ? ys : y0 + t * D, pu * P, K::kCols, 1, 1, 1, P);
    }
  };

  if (tma) {
    if (tid == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
    }
    __syncthreads();
    if (steps > 0) stage(0);
  }

  float acc[Y][CK][CX];
#pragma unroll
  for (int t = 0; t < Y; ++t) {
#pragma unroll
    for (int kk = 0; kk < CK; ++kk) {
#pragma unroll
      for (int k = 0; k < CX; ++k) acc[t][kk][k] = 0.f;
    }
  }
  for (int i = 0; i < steps; ++i) {
    if (tma) {
      if (i + 1 < steps) stage(i + 1);  // into the buffer freed at i - 1
      mbar_wait(&bar[i & 1], (i >> 1) & 1);
    } else {  // into the buffer freed at i - 1
      stage(i);
      __syncthreads();
    }
    const int s = lo + i;
    if (active) {
      const T* sb = buf + (i & 1) * K::kBuf;
      // the windows: columns x0 + i0 - rd .. x0 + i0 + kCX - 1 + rd
      float fw[CK][K::kWin];
#pragma unroll
      for (int kk = 0; kk < CK; ++kk) {
        load_vals<K::kWin>(sb + K::kFOff + (slot + K::kS * kk) * K::kRow
                           + K::kLead + i0, fw[kk]);
      }
#pragma unroll
      for (int t = 0; t < Y; ++t) {
        if (!serves(t, s)) continue;
        const T* gr = sb + t * K::kGBox + K::kLead + i0;
        if (which) {
          // df2[x] += g[pv][x - dv] * f1[x - dv]: window column k + o
#pragma unroll
          for (int pv = 0; pv < P; ++pv) {
            const int o = (2 * r - pv) * D;
            float gv[CX + 4];
            load_vals<CX + 4>(gr + pv * K::kRow + o / 4 * 4, gv);
#pragma unroll
            for (int kk = 0; kk < CK; ++kk) {
#pragma unroll
              for (int k = 0; k < CX; ++k) {
                acc[t][kk][k] = fmaf(gv[o % 4 + k], fw[kk][k + o],
                                     acc[t][kk][k]);
              }
            }
          }
        } else {
          // df1[x] += g[pv][x] * f2[x + dv]: window column k + pv * d
#pragma unroll
          for (int pv = 0; pv < P; ++pv) {
            float gv[CX];
            load_vals<CX>(gr + pv * K::kRow + r * D, gv);
#pragma unroll
            for (int kk = 0; kk < CK; ++kk) {
#pragma unroll
              for (int k = 0; k < CX; ++k) {
                acc[t][kk][k] = fmaf(gv[k], fw[kk][k + pv * D],
                                     acc[t][kk][k]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is free for step i + 2
  }

  // the sums through a [kY][kCB][kTX] tile of f32, out along its rows
  float* tile = reinterpret_cast<float*>(bsm);
#pragma unroll
  for (int t = 0; t < Y; ++t) {
#pragma unroll
    for (int kk = 0; kk < CK; ++kk) {
#pragma unroll
      for (int q = 0; q < CX / 4; ++q) {
        store_vals(tile + (t * K::kCB + slot + K::kS * kk) * K::kOutRow + i0
                   + 4 * q, acc[t][kk] + 4 * q);
      }
    }
  }
  __syncthreads();
  T* o = dst + ((long long)b * C + c0) * plane_o + (long long)y0 * W + x0;
  for (int e = tid; e < Y * K::kCB * K::kTX; e += K::kThreads) {
    const int row = e / K::kTX;  // t * kCB + c
    const int col = e - row * K::kTX;
    const int t = row / K::kCB;
    const int c = row - t * K::kCB;
    if (c < n && x0 + col < W && y0 + t * D < Ho) {
      o[c * plane_o + t * D * W + col] =
          narrow<T>(tile[row * K::kOutRow + col]);
    }
  }
}

// the channel group a block takes follows C: 32 (8 groups of 8 columns)
// or 64 (4 groups); 2 output rows a block (1, 3 or 4 measured no faster at
// FlowNetC's attack and patch shapes on the H100)
template <typename T, int P, int D>
int launch_tile(const void* f1, const void* f2, const void* g, void* df1,
                void* df2, int B, int C, int H, int W, int H2, int row0,
                cudaStream_t s) {
  constexpr bool bf16 = sizeof(T) == 2;
  auto go = [&](auto tile) {
    using K = decltype(tile);
    const int groups = (C + K::kCB - 1) / K::kCB;
    // both gradients' rows: df1's H, df2's H2
    const int rows = H > H2 ? H : H2;
    const int ygroups = (rows + K::kY * D - 1) / (K::kY * D) * D;
    if (2LL * B * groups > 65535 || ygroups > 65535) {
      return (int)cudaErrorInvalidValue;
    }
    auto kern = spatial_corr_bwd_tile_kernel<T, K>;
    if (K::kSmem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmem);
      if (e != cudaSuccess) return (int)e;
    }
    CUtensorMap f1_map{}, f2_map{}, g_map{};
    const int tma =
        make_map(&f1_map, f1, bf16, W, H, C, B, K::kRow, 1, K::kCB, 1)
        && make_map(&f2_map, f2, bf16, W, H2, C, B, K::kRow, 1, K::kCB, 1)
        && make_map(&g_map, g, bf16, W, H, P * P, B, K::kRow, 1, P, 1);
    const dim3 grid((W + K::kTX - 1) / K::kTX, ygroups, 2 * B * groups);
    kern<<<grid, K::kThreads, K::kSmem, s>>>(
        f1_map, f2_map, g_map, static_cast<const T*>(f1),
        static_cast<const T*>(f2), static_cast<const T*>(g),
        static_cast<T*>(df1), static_cast<T*>(df2), C, H, W, H2, row0, groups,
        tma);
    return (int)cudaGetLastError();
  };
  if (C <= 32) return go(BwdTile<T, P, D, 8>{});
  return go(BwdTile<T, P, D, 4>{});
}

// FlowNetC's and PWC-Net's patches take the tile kernel, any other the
// generic one
template <typename T>
int launch(const void* f1, const void* f2, const void* g, void* df1,
           void* df2, int B, int C, int H, int W, int H2, int row0, int P,
           int d, cudaStream_t s) {
  if (H > 65535 || H2 > 65535) return (int)cudaErrorInvalidValue;
  if (P == 21 && d == 2) {
    return launch_tile<T, 21, 2>(f1, f2, g, df1, df2, B, C, H, W, H2, row0,
                                 s);
  }
  if (P == 9 && d == 1) {
    return launch_tile<T, 9, 1>(f1, f2, g, df1, df2, B, C, H, W, H2, row0,
                                s);
  }
  return launch_generic<T>(f1, f2, g, df1, df2, B, C, H, W, H2, row0, P, d,
                           s);
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_spatial_corr_bwd_cuda,
// which validates every argument first.  f1: (B, C, H, W); f2: (B, C, H2,
// W); g: (B, P*P, H, W); df1 (B, C, H, W) and df2 (B, C, H2, W), either may
// be null (not computed); all f32 or all bf16; row0: the forward's row
// offset.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_spatial_corr_bwd(const void* f1, const void* f2,
                                    const void* g, void* df1, void* df2,
                                    int B, int C, int H, int W, int H2,
                                    int row0, int P, int d, int is_bf16,
                                    void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || H2 < 1 || P < 1 || P % 2 == 0 ||
      d < 1 || row0 < -65535 || row0 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(f1, f2, g, df1, df2, B, C, H, W, H2, row0,
                                 P, d, s);
  }
  return launch<float>(f1, f2, g, df1, df2, B, C, H, W, H2, row0, P, d, s);
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
