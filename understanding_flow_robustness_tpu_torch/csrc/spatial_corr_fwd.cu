// Spatial correlation (kernel 1, stride 1, padding 0), forward, for Hopper
// (sm_90a).
//
// The port's counterpart of an XLA op, not of a Pallas kernel: the JAX
// package computes this correlation as banded einsums
// (understanding_flow_robustness_tpu/ops/correlation.py:56-182,
// spatial_correlation -> _corr_k1_band), the reference as the
// spatial-correlation-sampler CUDA op.  FlowNetC's correlation (patch 21,
// patch dilation 2) and PWC-Net's (patch 9) run on it.
//
// NCHW f1, f2 (B, C, H, W), f32 or bf16; out (B, P*P, H, W) in the inputs'
// type, P odd, r = (P-1)/2, patch dilation d, du-major:
//   out[b, pu*P + pv, y, x] = sum_c f1[b, c, y, x]
//                                   * f2[b, c, y + (pu-r)*d, x + (pv-r)*d]
// with zeros where the displaced pixel leaves the map; products and sums
// in f32 (bf16 inputs widened), not divided by C.
//
// Bound: at FlowNetC's serving shape (8, 256, 48, 160), P=21, d=2, the
// products inside the map, 2 FLOP each, are ~10 GFLOP at 67 TFLOP/s f32
// (0.15 ms) against 234 MB at 3.35 TB/s (0.07 ms): operations.  At
// PWC-Net's bf16 levels the output's bytes bound it.
//
// Design, FlowNetC's (21, 2) and PWC-Net's (9, 1):
// `spatial_corr_fwd_tile_kernel`, register-tiled.  A block owns a tile of
// one output row, G groups of kCX = 8 consecutive columns.  A thread owns
// one group, one displacement row pu and half of the P displacements pv
// along it (two "pv parts", so that a thread holds 88 sums for FlowNetC
// and the SM keeps 12 warps; one thread with all 168 sums, 240 registers,
// kept 6 and ran slower on the H100).  Per channel it reads its 8 f1
// values and a window of 8 + (P/2) d f2 values of row pu as 16-byte (f32)
// or 8-byte (bf16) words, each f2 value serving up to 8 (column, pv)
// pairs from registers: FlowNetC 88 FMAs from 36 shared-memory words (the
// first design read one a FMA).  Lanes of a warp share a group and differ
// in pu; staged rows lie an odd number of 16-byte words apart, so the f2
// reads are conflict-free, and the f1 reads broadcast.  Chunks of kNC
// channels arrive by two TMA copies (the P f2 rows, stride d along H, and
// the f1 row, zeros outside the map) into one of two buffers, an mbarrier
// each, so the next chunk lands while this one is computed on; where W or
// an input's alignment rules TMA out, an element-wise stand-in stages the
// same layout.  A thread whose row is outside the map, or whose columns
// all lie beyond W, skips its products.  The sums leave through a
// shared-memory tile, stored along the rows.
//
// Any other odd patch and dilation takes
// `spatial_corr_fwd_generic_kernel`, the port's first design: a block owns 32
// columns, a lane each, 8 warps, warp w the displacements w, w+8, ... (16
// of them; patches beyond 128 displacements take several passes over
// blockIdx.z), one shared-memory word a FMA, chunks of channels staged
// with 4-byte cp.async in two buffers.
//
// Shared memory: ops/correlation.py::spatial_corr_smem_bytes states what
// each kernel takes, and the wrapper refuses what exceeds the limit; the
// launchers here compute the same numbers.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "spatial_corr_tile.cuh"

constexpr int kTX = 32;     // output columns a block, one per lane
constexpr int kWarps = 8;   // the generic kernel's displacement groups
constexpr int kMaxChunk = 16;                 // channels staged at a time
constexpr long long kSmemTarget = 32 * 1024;  // bytes a buffer aims for
constexpr long long kSmemMax = 232448;        // the H100's per-block limit
constexpr int kBatch = 4;   // bf16 loads a thread has in flight
constexpr int kGenericAcc = 16;  // generic kernel: displacements a thread

// an asynchronous 4-byte copy to shared memory that writes zero instead
// where `ok` is false (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Where element e of a chunk's staged f2 rows comes from: flat e ->
// (channel c, displacement row pu, column j) by multiply-high quotients
// (m = ceil(2^32 / divisor), exact while e * divisor < 2^32, which the
// shared-memory limit keeps; for P = 1, where 2^32 does not fit in 32 bits,
// m_p is 0 and c = row); false where it lies outside the map.
struct Rows {
  int P, r, d, sw, x0, y, H, W;
  unsigned m_sw, m_p;
  long long plane;

  __device__ __forceinline__ bool source(int e, int c0, long long* idx) const {
    const int row = __umulhi((unsigned)e, m_sw);
    const int j = e - row * sw;
    const int c = m_p ? __umulhi((unsigned)row, m_p) : row;
    const int yy = y + (row - c * P - r) * d;
    const int xx = x0 - r * d + j;
    *idx = (c0 + c) * plane + (long long)yy * W + xx;
    return yy >= 0 && yy < H && xx >= 0 && xx < W;
  }
};

__device__ __forceinline__ Rows make_rows(int P, int d, int H, int W) {
  Rows g;
  g.P = P;
  g.r = (P - 1) / 2;
  g.d = d;
  g.sw = kTX + 2 * g.r * d;
  g.x0 = blockIdx.x * kTX;
  g.y = blockIdx.y;
  g.H = H;
  g.W = W;
  g.m_sw = (unsigned)(0xFFFFFFFFull / (unsigned)g.sw + 1);
  g.m_p = P == 1 ? 0u : (unsigned)(0xFFFFFFFFull / (unsigned)P + 1);
  g.plane = (long long)H * W;
  return g;
}

// stage channels [c0, c0 + n) of the block's f1 tile and f2 rows into buf:
// [chunk][kTX] of f1, then [chunk][P][sw] of f2
template <typename T>
__device__ __forceinline__ void stage_chunk(float* buf, const T* f1b,
                                            const T* f2b, int c0, int n,
                                            int chunk, const Rows& g) {
  float* f1_s = buf;
  float* f2_s = buf + chunk * kTX;
  const int nt = blockDim.x;
  const int total = n * g.P * g.sw;
  if constexpr (sizeof(T) == 4) {
    for (int e = threadIdx.x; e < n * kTX; e += nt) {
      const int x = g.x0 + (e & 31);
      const bool ok = x < g.W;
      cp_async4(f1_s + e, f1b + (ok ? (c0 + (e >> 5)) * g.plane
                                     + (long long)g.y * g.W + x : 0), ok);
    }
    for (int e = threadIdx.x; e < total; e += nt) {
      long long idx;
      const bool ok = g.source(e, c0, &idx);
      cp_async4(f2_s + e, f2b + (ok ? idx : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * kTX; e += nt) {
      const int x = g.x0 + (e & 31);
      f1_s[e] = x < g.W ? __bfloat162float(
          f1b[(c0 + (e >> 5)) * g.plane + (long long)g.y * g.W + x]) : 0.f;
    }
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * nt) {
      float v[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        long long idx;
        const int e = e0 + t * nt;
        v[t] = e < total && g.source(e, c0, &idx)
                   ? __bfloat162float(f2b[idx]) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (e0 + t * nt < total) f2_s[e0 + t * nt] = v[t];
      }
    }
  }
}

// The chunk loop both kernels share: channels in chunks, two buffers,
// `compute(buf, n)` on each staged chunk of n channels.
template <typename T, typename F>
__device__ __forceinline__ void over_chunks(const T* f1b, const T* f2b,
                                            int C, int chunk, const Rows& g,
                                            F compute) {
  extern __shared__ float smem[];
  const int per_buf = chunk * (kTX + g.P * g.sw);
  const int nchunks = (C + chunk - 1) / chunk;
  stage_chunk(smem, f1b, f2b, 0, min(chunk, C), chunk, g);
  commit();
  for (int i = 0; i < nchunks; ++i) {
    const int c0 = i * chunk;
    if (i + 1 < nchunks) {
      stage_chunk(smem + ((i + 1) & 1) * per_buf, f1b, f2b, c0 + chunk,
                  min(chunk, C - c0 - chunk), chunk, g);
    }
    commit();
    wait_all_but_newest();
    __syncthreads();
    compute(smem + (i & 1) * per_buf, min(chunk, C - c0));
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spatial_corr_fwd_generic_kernel(const T* __restrict__ f1,
                                const T* __restrict__ f2,
                                T* __restrict__ out, int C, int H, int W,
                                int P, int d, int passes, int chunk) {
  const Rows g = make_rows(P, d, H, W);
  const int P2 = P * P;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z / passes;
  const int p0 = (blockIdx.z - b * passes) * (kWarps * kGenericAcc);

  // each displacement's offset into a channel's staged rows: row pu,
  // column lane + pv*d
  int off[kGenericAcc];
#pragma unroll
  for (int k = 0; k < kGenericAcc; ++k) {
    const int p = p0 + warp + kWarps * k;
    const int pu = p / P;
    off[k] = p < P2 ? pu * g.sw + (p - pu * P) * d + lane : lane;
  }
  float acc[kGenericAcc];
#pragma unroll
  for (int k = 0; k < kGenericAcc; ++k) acc[k] = 0.f;
  const T* f1b = f1 + (long long)b * C * g.plane;
  const T* f2b = f2 + (long long)b * C * g.plane;
  over_chunks(f1b, f2b, C, chunk, g, [&](const float* buf, int n) {
    for (int c = 0; c < n; ++c) {
      const float a = buf[c * kTX + lane];
      const float* rows = buf + chunk * kTX + c * P * g.sw;
#pragma unroll
      for (int k = 0; k < kGenericAcc; ++k) {
        acc[k] = fmaf(a, rows[off[k]], acc[k]);
      }
    }
  });

  const int x = g.x0 + lane;
  if (x >= W) return;
  T* o = out + (long long)b * P2 * g.plane + (long long)g.y * W + x;
#pragma unroll
  for (int k = 0; k < kGenericAcc; ++k) {
    const int p = p0 + warp + kWarps * k;
    if (p < P2) o[p * g.plane] = narrow<T>(acc[k]);
  }
}

// channels a chunk, and the bytes of a block's two buffers of them
long long chunk_of(int P, int d, long long* bytes) {
  const long long sw = kTX + (long long)(P - 1) * d;
  const long long per_channel = 4LL * (kTX + P * sw);
  long long chunk = kSmemTarget / per_channel;
  chunk = chunk < 1 ? 1 : (chunk > kMaxChunk ? kMaxChunk : chunk);
  *bytes = 2 * chunk * per_channel;
  return chunk;
}

template <typename K>
int prepare(K kern, long long bytes) {
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return 0;
}

// ---- the register-tiled kernel: FlowNetC's (21, 2), PWC-Net's (9, 1) ----

template <typename T, int P_, int D_, int G_, int NC_>
struct FwdTile {
  static constexpr int P = P_, D = D_, G = G_;
  static constexpr int kSplit = 2;  // threads sharing a displacement row
  static constexpr int kPV = (P + kSplit - 1) / kSplit;  // pv a thread
  static constexpr int kNC = NC_;   // channels a staged chunk
  static constexpr int kCX = 8;     // columns a thread
  static constexpr int kR = (P - 1) / 2;
  static constexpr int kTX = G * kCX;                 // columns a tile
  static constexpr int kLead = round_up(kR * D, kVec<T>) - kR * D;
  // a staged f2 row: columns x0 - rd - kLead .. (16-byte aligned)
  static constexpr int kCols = round_up(kLead + kTX + 2 * kR * D, kVec<T>);
  static constexpr int kRow = row_stride<T>(kCols);
  // a thread's window: columns (pv0 d rounded down to 4) + .. for its kPV
  static constexpr int kWin = round_up(kCX + (kPV - 1) * D + 3, 4);
  static constexpr int kAlign = 128 / (int)sizeof(T);  // elements
  static constexpr int kF1 = round_up(kNC * P * kRow, kAlign);  // f1 rows
  // + slack, whole 128 bytes
  static constexpr int kBuf =
      round_up(kF1 + kNC * kTX + 4 * kVec<T>, kAlign);
  static constexpr int kOutRow = kTX + 4;  // the output tile's row (f32)
  // threads of one pv part: whole warps
  static constexpr int kGroupT = (P * G + 31) / 32 * 32;
  static constexpr int kThreads = kSplit * kGroupT;
  static constexpr long long kBufBytes = (long long)kBuf * sizeof(T);
  static constexpr long long kSmem =
      round_up(2 * kBufBytes > 4LL * P * P * kOutRow
                   ? (int)(2 * kBufBytes) : 4 * P * P * kOutRow, 16)
      + 16;  // + the two mbarriers
  static_assert(kLead % 4 == 0 && kTX % kVec<T> == 0, "aligned windows");
};

// Block: one output row's tile of kTX columns (blockIdx.x, y, b).  Thread:
// pv part h, displacement row pu, columns i0 .. i0+7 of the tile.  Chunks of kNC
// channels arrive by two TMA copies (the f2 rows, the f1 row; one thread
// issues them, double buffered, an mbarrier each) or, where W or an
// input's alignment does not allow them, by the element-wise stand-in
// (the same layout); the products run from shared
// memory as 16-byte (f32) or 8-byte (bf16) words; the sums go out through
// a shared-memory tile, stored along the rows.
template <typename T, class K>
__global__ void __launch_bounds__(K::kThreads)
spatial_corr_fwd_tile_kernel(const __grid_constant__ CUtensorMap f1_map,
                             const __grid_constant__ CUtensorMap f2_map,
                             const T* __restrict__ f1,
                             const T* __restrict__ f2, T* __restrict__ out,
                             int C, int H, int W, int tma) {
  constexpr int P = K::P, D = K::D, CX = K::kCX, r = K::kR;
  extern __shared__ __align__(128) unsigned char fsm[];
  T* buf = reinterpret_cast<T*>(fsm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(fsm + K::kSmem - 16);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * K::kTX;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const long long plane = (long long)H * W;
  const T* f1b = f1 + (long long)b * C * plane;
  const T* f2b = f2 + (long long)b * C * plane;

  // tid = h * kGroupT + grp * P + pu: a warp's lanes share h, mostly grp,
  // and differ in pu
  const int h = tid / K::kGroupT;  // this thread's pv: h kPV .. + kPV - 1
  const int grp = (tid - h * K::kGroupT) / P;
  const int pu = tid - h * K::kGroupT - grp * P;
  const int i0 = grp * CX;
  const int yy = y + (pu - r) * D;
  const bool active = grp < K::G && yy >= 0 && yy < H && x0 + i0 < W;
  const int nchunks = (C + K::kNC - 1) / K::kNC;
  // a staged f2 row's first column
  const int xs = x0 - r * D - K::kLead;

  // chunk i into buffer i & 1: [c][P][kRow] of f2 (rows y - rd .. y + rd,
  // d apart), then [c][kTX] of f1
  auto stage = [&](int i) {
    T* s = buf + (i & 1) * K::kBuf;
    const int c0 = i * K::kNC;
    if (tma) {
      if (tid == 0) {
        fence_async_smem();
        mbar_expect(&bar[i & 1], (unsigned)(K::kNC * sizeof(T)
                    * (P * K::kRow + K::kTX)));
        tma_load(s, &f2_map, &bar[i & 1], xs, y - r * D, c0, b);
        tma_load(s + K::kF1, &f1_map, &bar[i & 1], x0, y, c0, b);
      }
      return;
    }
    const int n = min(K::kNC, C - c0);
    box_load(s, K::kRow, f2b, W, H, C, xs, y - r * D, c0, K::kCols, 1, P, D,
             n);
    box_load(s + K::kF1, K::kTX, f1b, W, H, C, x0, y, c0, K::kTX, 1, 1, 1,
             n);
  };

  if (tma) {
    if (tid == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
    }
    __syncthreads();
    stage(0);
  }

  float acc[CX][K::kPV];
#pragma unroll
  for (int k = 0; k < CX; ++k) {
#pragma unroll
    for (int i = 0; i < K::kPV; ++i) acc[k][i] = 0.f;
  }
  for (int i = 0; i < nchunks; ++i) {
    if (tma) {
      if (i + 1 < nchunks) stage(i + 1);  // into the buffer freed at i - 1
      mbar_wait(&bar[i & 1], (i >> 1) & 1);
    } else {  // into the buffer freed at i - 1
      stage(i);
      __syncthreads();
    }
    const T* s = buf + (i & 1) * K::kBuf;
    const int n = min(K::kNC, C - i * K::kNC);
    // the products of pv part H (compile-time, so that every register
    // index is)
    auto part = [&](auto part_index) {
      constexpr int pv0 = decltype(part_index)::value * K::kPV;
      constexpr int w0 = pv0 * D / 4 * 4;  // the window's first column
      const T* f_s = s + pu * K::kRow + K::kLead + i0 + w0;
      const T* a_s = s + K::kF1 + i0;
#pragma unroll 2
      for (int c = 0; c < n; ++c) {
        float a[CX], v[K::kWin];
        load_vals<CX>(a_s + c * K::kTX, a);
        load_vals<K::kWin>(f_s + c * P * K::kRow, v);
        // v[j]: f2 column x0 + i0 - rd + w0 + j; column k, pv0 + i takes
        // j = k + (pv0 + i) d - w0
#pragma unroll
        for (int k = 0; k < CX; ++k) {
#pragma unroll
          for (int i = 0; i < K::kPV; ++i) {
            if (pv0 + i < P) {
              acc[k][i] = fmaf(a[k], v[k + (pv0 + i) * D - w0], acc[k][i]);
            }
          }
        }
      }
    };
    if (active) {
      if (h == 0) {
        part(std::integral_constant<int, 0>{});
      } else {
        part(std::integral_constant<int, 1>{});
      }
    }
    __syncthreads();  // the buffer is free for chunk i + 2
  }

  // the sums through a [P*P][kTX] tile of f32, out along its rows
  float* tile = reinterpret_cast<float*>(fsm);
  if (grp < K::G) {
    const int pv0 = h * K::kPV;
#pragma unroll
    for (int i = 0; i < K::kPV; ++i) {
      if (pv0 + i >= P) break;
#pragma unroll
      for (int q = 0; q < CX / 4; ++q) {
        const float v[4] = {acc[4 * q][i], acc[4 * q + 1][i],
                            acc[4 * q + 2][i], acc[4 * q + 3][i]};
        store_vals(tile + (pu * P + pv0 + i) * K::kOutRow + i0 + 4 * q, v);
      }
    }
  }
  __syncthreads();
  T* o = out + (long long)b * P * P * plane + (long long)y * W + x0;
  for (int e = tid; e < P * P * K::kTX; e += K::kThreads) {
    const int p = e / K::kTX;
    const int col = e - p * K::kTX;
    if (x0 + col < W) {
      o[p * plane + col] = narrow<T>(tile[p * K::kOutRow + col]);
    }
  }
}

// FlowNetC: 2 pv parts x (21 displacement rows x 4 groups = 32 columns;
// 84 threads in 96) = 192 threads, 88 sums each, 8 channels a chunk;
// PWC-Net: 2 pv parts x (9 x 10 groups = 80 columns; 90 in 96), 16
// channels a chunk.  (Two output rows a block, sharing 20 of FlowNetC's
// 22 f2 rows, measured no faster on the H100.)
template <typename T>
using FlowNetCFwd = FwdTile<T, 21, 2, 4, 8>;
template <typename T>
using PwcFwd = FwdTile<T, 9, 1, 10, 16>;

template <typename T, class K>
int launch_tile(const void* f1, const void* f2, void* out, int B, int C,
                int H, int W, cudaStream_t s) {
  auto kern = spatial_corr_fwd_tile_kernel<T, K>;
  if (const int e = prepare(kern, K::kSmem)) return e;
  constexpr bool bf16 = sizeof(T) == 2;
  CUtensorMap f1_map{}, f2_map{};
  const int tma =
      make_map(&f2_map, f2, bf16, W, H, C, B, K::kRow, (K::P - 1) * K::D + 1,
               K::kNC, K::D)
      && make_map(&f1_map, f1, bf16, W, H, C, B, K::kTX, 1, K::kNC, 1);
  const dim3 grid((W + K::kTX - 1) / K::kTX, H, B);
  kern<<<grid, K::kThreads, K::kSmem, s>>>(
      f1_map, f2_map, static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), C, H, W, tma);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_generic(const void* f1, const void* f2, void* out, int B, int C,
                   int H, int W, int P, int d, cudaStream_t s) {
  long long bytes;
  const int chunk = (int)chunk_of(P, d, &bytes);
  constexpr int per_pass = kWarps * kGenericAcc;
  const int passes = (P * P + per_pass - 1) / per_pass;
  if ((long long)B * passes > 65535) return (int)cudaErrorInvalidValue;
  auto kern = spatial_corr_fwd_generic_kernel<T>;
  if (const int e = prepare(kern, bytes)) return e;
  const dim3 grid((W + kTX - 1) / kTX, H, B * passes);
  kern<<<grid, kWarps * 32, bytes, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), C, H, W, P, d, passes, chunk);
  return (int)cudaGetLastError();
}

// FlowNetC's and PWC-Net's patches take the tile kernel; any other, the
// generic kernel, in as many passes as its 8 * kGenericAcc displacements a
// block take to cover P*P
template <typename T>
int dispatch(const void* f1, const void* f2, void* out, int B, int C, int H,
             int W, int P, int d, cudaStream_t s) {
  if (P == 21 && d == 2) {
    return launch_tile<T, FlowNetCFwd<T>>(f1, f2, out, B, C, H, W, s);
  }
  if (P == 9 && d == 1) {
    return launch_tile<T, PwcFwd<T>>(f1, f2, out, B, C, H, W, s);
  }
  return launch_generic<T>(f1, f2, out, B, C, H, W, P, d, s);
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_spatial_corr_fwd_cuda,
// which validates every argument first (dtype, shapes, contiguity, one
// device, P odd, d >= 1, shared memory).  f1, f2: (B, C, H, W); out: (B,
// P*P, H, W), all f32 or all bf16.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int ufr_spatial_corr_fwd(const void* f1, const void* f2, void* out,
                                    int B, int C, int H, int W, int P, int d,
                                    int is_bf16, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || P < 1 || P % 2 == 0 || d < 1 ||
      H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(f1, f2, out, B, C, H, W, P, d, s);
  }
  return dispatch<float>(f1, f2, out, B, C, H, W, P, d, s);
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
