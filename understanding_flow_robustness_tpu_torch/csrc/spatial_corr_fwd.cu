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
// Design: a block owns one output row's tile of 32 columns, a lane each.
// Over chunks of channels it stages in shared memory, as f32, the f1 tile
// and, per channel, the P rows of f2 its displacements reach, each 32 + 2rd
// columns wide with zeros outside the map, in two buffers: f32 inputs are
// copied with cp.async (zero-filling outside the map), so the next chunk
// arrives while the current one is computed on; bf16 inputs are loaded
// four at a time a thread, widened and stored.  A thread then does one FMA
// a displacement and channel, reading f2 from shared memory conflict-free
// along the lanes, its f1 value once per channel, and accumulates in f32
// registers; outputs are stored along the lanes.
//   - FlowNetC's (21, 2) and PWC-Net's (9, 1) take
//     `spatial_corr_fwd_rows_kernel`, with P and d compile-time: a warp
//     owns whole displacement rows (3 of FlowNetC's 21 in 7 warps, 1 of
//     PWC-Net's 9 in 9 warps), so every shared-memory offset is its row's
//     base plus a constant, and a thread holds 63 or 9 accumulators.
//   - Any other odd patch and dilation takes
//     `spatial_corr_fwd_generic_kernel`: 8 warps, warp w owns
//     displacements w, w+8, ... (16 of them, their offsets in registers;
//     patches beyond 128 displacements take several passes over
//     blockIdx.z).
//
// Bound: at FlowNetC's serving shape (8, 256, 48, 160), P=21, d=2, the
// products inside the map, 2 FLOP each, are ~10 GFLOP at 67 TFLOP/s f32
// (0.15 ms) against 234 MB at 3.35 TB/s (0.07 ms): operations.  This design
// reads one shared-memory word per FMA (and multiplies the zeros outside
// the map too), so shared-memory bandwidth bounds it first; register
// tiling over several columns a thread (one f2 value serves several
// displacements) is the later step.  At PWC-Net's bf16 levels the output
// writes bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;     // output columns a block, one per lane
constexpr int kWarps = 8;   // the generic kernel's displacement groups
constexpr int kMaxChunk = 16;                 // channels staged at a time
constexpr long long kSmemTarget = 32 * 1024;  // bytes a buffer aims for
constexpr long long kSmemMax = 232448;        // the H100's per-block limit
constexpr int kBatch = 4;   // bf16 loads a thread has in flight
constexpr int kGenericAcc = 16;  // generic kernel: displacements a thread

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T, int P, int D, int ROWS>
__global__ void __launch_bounds__(32 * (P / ROWS))
spatial_corr_fwd_rows_kernel(const T* __restrict__ f1,
                             const T* __restrict__ f2, T* __restrict__ out,
                             int C, int H, int W, int chunk) {
  constexpr int SW = kTX + (P - 1) * D;
  const Rows g = make_rows(P, D, H, W);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const T* f1b = f1 + (long long)b * C * g.plane;
  const T* f2b = f2 + (long long)b * C * g.plane;

  float acc[ROWS][P];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int pv = 0; pv < P; ++pv) acc[i][pv] = 0.f;
  }
  over_chunks(f1b, f2b, C, chunk, g, [&](const float* buf, int n) {
    // the warp's rows; (lane, pv) reads column lane + pv*d of its row
    const float* rows = buf + chunk * kTX + warp * ROWS * SW + lane;
    for (int c = 0; c < n; ++c) {
      const float a = buf[c * kTX + lane];
      const float* rc = rows + c * P * SW;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int pv = 0; pv < P; ++pv) {
          acc[i][pv] = fmaf(a, rc[i * SW + pv * D], acc[i][pv]);
        }
      }
    }
  });

  const int x = g.x0 + lane;
  if (x >= W) return;
  T* o = out + ((long long)b * P * P + warp * ROWS * P) * g.plane
         + (long long)g.y * W + x;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
#pragma unroll
    for (int pv = 0; pv < P; ++pv) {
      o[(i * P + pv) * g.plane] = narrow<T>(acc[i][pv]);
    }
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

template <typename T, int P, int D, int ROWS>
int launch_rows(const void* f1, const void* f2, void* out, int B, int C,
                int H, int W, cudaStream_t s) {
  long long bytes;
  const int chunk = (int)chunk_of(P, D, &bytes);
  auto kern = spatial_corr_fwd_rows_kernel<T, P, D, ROWS>;
  if (const int e = prepare(kern, bytes)) return e;
  const dim3 grid((W + kTX - 1) / kTX, H, B);
  kern<<<grid, 32 * (P / ROWS), bytes, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), C, H, W, chunk);
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

// FlowNetC's and PWC-Net's patches take the rows kernel; any other, the
// generic kernel, in as many passes as its 8 * kGenericAcc displacements a
// block take to cover P*P
template <typename T>
int dispatch(const void* f1, const void* f2, void* out, int B, int C, int H,
             int W, int P, int d, cudaStream_t s) {
  if (P == 21 && d == 2) {
    return launch_rows<T, 21, 2, 3>(f1, f2, out, B, C, H, W, s);
  }
  if (P == 9 && d == 1) {
    return launch_rows<T, 9, 1, 1>(f1, f2, out, B, C, H, W, s);
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
