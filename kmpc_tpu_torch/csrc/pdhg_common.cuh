// Device helpers shared by the PDHG kernels of this package: NaN-propagating
// max / min (jnp.maximum / minimum propagate NaN, so these do too), the
// warp butterfly sum over the asset lanes, and the Michelot/Newton threshold
// sweeps of the simplex and l1-ball projections.
//
// Layout assumed throughout: one warp owns one problem; asset i of a row
// sits on lane i % 32, slot i / 32 (K = ceil(N/32) slots); a [HM][K]
// register array holds the H <= HM horizon rows. Padded asset slots carry
// -1e30 in threshold inputs, so they never enter an active set. After a
// butterfly every lane holds the same sum: thresholds are warp-uniform.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 4;
// Shared memory one block may use on sm_90 (by opt-in above 48 KB).
constexpr int kSmemPerBlock = 232448;

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// x[t] <- sum over the warp's lanes, for every row t < H.
template <int HM>
__device__ __forceinline__ void warp_sum(float (&x)[HM], int H) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < HM; ++t)
      if (t < H) x[t] += __shfl_xor_sync(kFull, x[t], o);
  }
}

// One Michelot/Newton sweep per row: theta <- (sum_{v > theta} v - rad) /
// max(count, 1), over the pre-masked values vm.
template <int HM, int K>
__device__ __forceinline__ void sweep(const float (&vm)[HM][K],
                                      float (&theta)[HM],
                                      const float (&rad)[HM], int H) {
  float cnt[HM], s[HM];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    cnt[t] = 0.f;
    s[t] = 0.f;
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool a = vm[t][k] > theta[t];
        cnt[t] += a ? 1.f : 0.f;
        s[t] += a ? vm[t][k] : 0.f;
      }
    }
  }
  warp_sum<HM>(cnt, H);
  warp_sum<HM>(s, H);
#pragma unroll
  for (int t = 0; t < HM; ++t)
    if (t < H) theta[t] = (s[t] - rad[t]) / jmax(cnt[t], 1.f);
}

// Threshold of the simplex (rad = 1) or of the ball: a cold start
// (sum of the unmasked values - rad) / N followed by n sweeps, or n sweeps
// from the carried theta.
template <int HM, int K>
__device__ __forceinline__ void threshold(const float (&vm)[HM][K],
                                          float (&theta)[HM],
                                          const float (&rad)[HM], int H,
                                          int N, bool cold, int n) {
  if (cold) {
    float s[HM];
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      s[t] = 0.f;
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          s[t] += vm[t][k] > 0.5f * kNeg ? vm[t][k] : 0.f;
      }
    }
    warp_sum<HM>(s, H);
#pragma unroll
    for (int t = 0; t < HM; ++t)
      if (t < H) theta[t] = (s[t] - rad[t]) / (float)N;
  }
  for (int i = 0; i < n; ++i) sweep<HM, K>(vm, theta, rad, H);
}

}  // namespace
