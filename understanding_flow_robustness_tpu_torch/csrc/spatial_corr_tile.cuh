// Helpers shared by csrc/spatial_corr_fwd.cu and csrc/spatial_corr_bwd.cu:
// the Tensor Memory Accelerator (TMA) copies that stage their rows, the
// mbarriers that report them, the element-wise staging that stands in where
// a TMA copy cannot take the tensor, and loads of staged f32 or bf16 values
// as f32.  Each source includes it inside its own anonymous namespace.
//
// A staged "box" is a block of rows, each a run of columns x .. x + n0 - 1
// of one channel (n0 whole 16-byte words, an odd number of them, so that
// lanes reading neighbouring rows hit distinct banks), for several
// channels and, in the forward, the P displacement rows (a row stride d
// along H).  One TMA copy takes a box, filling what lies outside the
// tensor with zeros; it needs 16-byte aligned bases and W a multiple of 16
// bytes.

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- loads of staged values, widened to f32 ----

// out[0..N) = p[0..N): N a multiple of 4, p aligned to 4 elements (16
// bytes f32, 8 bytes bf16)
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  static_assert(N % 4 == 0, "4-element words");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * q);
    out[4 * q] = v.x; out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z; out[4 * q + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float* out) {
  static_assert(N % 4 == 0, "4-element words");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + 4 * q);
    out[4 * q] = __uint_as_float(v.x << 16);
    out[4 * q + 1] = __uint_as_float(v.x & 0xffff0000u);
    out[4 * q + 2] = __uint_as_float(v.y << 16);
    out[4 * q + 3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// out[0..4) = v[0..4) as f32 (16 bytes aligned)
__device__ __forceinline__ void store_vals(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// values per 16-byte word
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

constexpr int round_up(int n, int k) { return (n + k - 1) / k * k; }

// elements of a staged row of n elements of T: whole 16-byte words, an odd
// number of them
template <typename T>
constexpr int row_stride(int n) {
  return (round_up(n, kVec<T>) / kVec<T> % 2 ? round_up(n, kVec<T>)
                                             : round_up(n, kVec<T>) + kVec<T>);
}

// ---- mbarriers and TMA copies (PTX) ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the one arrival of a phase, which then waits for `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// order this thread's earlier shared-memory accesses before later TMA
// writes to the same memory
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// copy the box of `map` at (x, y, c, b) into dst (128-byte aligned);
// completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y, int c,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(c), "r"(b)
      : "memory");
}

// element-wise stand-in for tma_load (a box of nc channels, nr rows
// traversed with stride sy, n0 columns with stride sx, zeros outside the
// tensor; rows ld elements apart in dst), run by all threads of the block
template <typename T>
__device__ __forceinline__ void box_load(T* dst, int ld, const T* src,
                                         int W, int H, int C, int x, int y,
                                         int c, int n0, int sx, int nr,
                                         int sy, int nc) {
  const long long plane = (long long)H * W;
  const int per_c = nr * n0;
  for (int e = threadIdx.x; e < nc * per_c; e += blockDim.x) {
    const int row = e / n0;  // channel-major: cc * nr + rr
    const int cc = row / nr;
    const int j = e - row * n0;
    const int xx = x + j * sx, yy = y + (row - cc * nr) * sy, ch = c + cc;
    dst[row * ld + j] = xx >= 0 && xx < W && yy >= 0 && yy < H && ch < C
                            ? src[ch * plane + (long long)yy * W + xx]
                            : narrow<T>(0.f);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---- tensor maps (host) ----

// A 4-D tensor map of an NCHW tensor (W, H, C, B innermost first) with the
// box (box_w, box_h, box_c, 1), rows traversed with stride sy; false where
// the TMA cannot take it (alignment, W's bytes) or cuTensorMapEncodeTiled
// refuses it.  The encoder is looked up through the runtime
// (cudaGetDriverEntryPoint), so the library links no libcuda.
bool make_map(CUtensorMap* map, const void* base, bool bf16, int W, int H,
              int C, int B, int box_w, int box_h, int box_c, int sy) {
  const int size = bf16 ? 2 : 4;
  if (!aligned(base, 16) || (long long)W * size % 16) return false;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || fn == nullptr) {
      return false;
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * size,
                                 (cuuint64_t)W * H * size,
                                 (cuuint64_t)W * H * C * size};
  const cuuint32_t box[4] = {(cuuint32_t)box_w, (cuuint32_t)box_h,
                             (cuuint32_t)box_c, 1};
  const cuuint32_t step[4] = {1, (cuuint32_t)sy, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
