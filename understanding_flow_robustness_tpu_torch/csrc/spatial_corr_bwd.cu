// Spatial correlation (kernel 1, stride 1, padding 0), backward, for Hopper
// (sm_90a): the gradients of csrc/spatial_corr_fwd.cu with respect to both
// feature maps for the output cotangent g.
//
// The port's counterpart of XLA's autodiff of the JAX package's banded
// einsums (understanding_flow_robustness_tpu/ops/correlation.py:56-182);
// the reference's spatial-correlation-sampler op has its own backward.  The
// global attacks on FlowNetC and PWC-Net run it.
//
// NCHW f1, f2 (B, C, H, W), g (B, P*P, H, W) and df1, df2 (B, C, H, W),
// all f32 or all bf16 (PWC-Net's autocast hands a bf16 cotangent and wants
// bf16 gradients, so no cast pass runs around the kernel); sums in f32.
// With du = (pu-r)*d, dv = (pv-r)*d, p = pu*P + pv:
//   df1[b,c,y,x] = sum_p g[b,p,y,x]         * f2[b,c,y+du,x+dv]
//   df2[b,c,y,x] = sum_p g[b,p,y-du,x-dv]   * f1[b,c,y-du,x-dv]
// with zeros outside the map.  Both are gathers, so no atomics: every
// output element is written once, by one thread.
//
// Design: a block owns one output row's tile of 32 columns (a lane each),
// 32 channels (4 a thread, 8 warps) and one of the two gradients
// (blockIdx.z: batch, channel chunk, which).  For each displacement row pu
// whose source row lies inside the map (a block-uniform test), it stages
// in shared memory, as f32 with zeros outside the map, the P cotangent
// rows of that pu and the 32 channels' feature row, each 32 + 2rd columns
// wide; then per pv a thread reads its cotangent once and FMAs it into its
// 4 channels.  Sums in f32, in an order of their own.
//
// Bound: at FlowNetC's attack shape (1, 256, 32, 80), P=21, d=2, the
// ~0.7 GFLOP of products inside the map (0.01 ms at 67 TFLOP/s f32)
// against ~15 MB of traffic (0.005 ms): operations.  The design reads
// 1.25 shared-memory words a FMA and syncs twice per pu; it is sized for
// the attacks, whose steps run it once each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;    // output columns a block, one per lane
constexpr int kWarps = 8;
constexpr int kCK = 4;     // channels a thread
constexpr int kChannels = kWarps * kCK;  // channels a block
constexpr int kThreads = kTX * kWarps;
constexpr long long kSmemMax = 232448;  // the H100's per-block limit

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spatial_corr_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                        const T* __restrict__ g, T* __restrict__ df1,
                        T* __restrict__ df2, int C, int H, int W, int P,
                        int d, int chunks) {
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
  if (dst == nullptr) return;  // that gradient is not wanted
  const int n = min(kChannels, C - c0);
  const long long plane = (long long)H * W;
  const T* feat = (which ? f1 : f2) + ((long long)b * C + c0) * plane;
  const T* gb = g + (long long)b * P2 * plane;

  float acc[kCK];
#pragma unroll
  for (int k = 0; k < kCK; ++k) acc[k] = 0.f;
  for (int pu = 0; pu < P; ++pu) {
    const int du = (pu - r) * d;
    const int yy = which ? y - du : y + du;  // the feature row
    if (yy < 0 || yy >= H) continue;
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
      const T* src = feat + row * plane + (long long)yy * W;
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
  T* o = dst + ((long long)b * C + c0) * plane + (long long)y * W + x;
#pragma unroll
  for (int k = 0; k < kCK; ++k) {
    const int c = warp + kWarps * k;
    if (c < n) o[c * plane] = narrow<T>(acc[k]);
  }
}

template <typename T>
int launch(const void* f1, const void* f2, const void* g, void* df1,
           void* df2, int B, int C, int H, int W, int P, int d,
           cudaStream_t s) {
  const int r = (P - 1) / 2;
  const long long sw = kTX + 2LL * r * d;
  const long long bytes = 4LL * (P + kChannels) * sw;
  const int chunks = (C + kChannels - 1) / kChannels;
  if (bytes > kSmemMax || H > 65535 || 2LL * B * chunks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = spatial_corr_bwd_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kTX - 1) / kTX, H, 2 * B * chunks);
  kern<<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const T*>(g), static_cast<T*>(df1),
      static_cast<T*>(df2), C, H, W, P, d, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/correlation.py::_spatial_corr_bwd_cuda,
// which validates every argument first.  f1, f2: (B, C, H, W); g: (B, P*P,
// H, W); df1, df2: (B, C, H, W), either may be null (not computed); all f32
// or all bf16.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int ufr_spatial_corr_bwd(const void* f1, const void* f2,
                                    const void* g, void* df1, void* df2,
                                    int B, int C, int H, int W, int P, int d,
                                    int is_bf16, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || P < 1 || P % 2 == 0 || d < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(f1, f2, g, df1, df2, B, C, H, W, P, d, s);
  }
  return launch<float>(f1, f2, g, df1, df2, B, C, H, W, P, d, s);
}

extern "C" const char* ufr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
