// The lookup radii of RAFT's window kernels (csrc/alt_corr_fwd.cu,
// alt_corr_bwd.cu, alt_corr_dcoords.cu, corr_lookup_fwd.cu).
//
// The TPU kernels take any radius whose (2r+2)-wide integer grid fits
// their 16-wide tile, r <= 7 (ops/pallas/alt_corr.py:321-322,
// corr_lookup_fused.py:111-112); RAFT uses 4, small RAFT 3.  Here every
// kernel is a template over r, instantiated for 1..kMaxRadius, and the host
// entry points pick the instantiation at run time with with_radius.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ufr {

constexpr int kMaxRadius = 7;

// The window geometry of radius R: n = 2R+1 samples a side, the (n+1)^2
// integer grid they blend.
template <int R>
struct Window {
  static_assert(R >= 1 && R <= kMaxRadius, "radius out of range");
  static constexpr int kN1 = 2 * R + 1;  // window side
  static constexpr int kD = kN1 + 1;     // integer grid side
  static constexpr int kDD = kD * kD;    // integer grid points
  static constexpr int kNn = kN1 * kN1;  // outputs per level
};

// f(std::integral_constant<int, r>{}) for the run-time radius r in
// 1..kMaxRadius; cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t with_radius(int r, F&& f) {
  switch (r) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ufr
