// The mean-variance PDHG kernel with fixed steps in the lane layout:
// `_make_packed_mv_kernel` without `params.adaptive` in
// kmpc_tpu/ops/mpc_pallas.py, at one horizon row. The kernel, its design
// and its bound are in pdhg_mean_variance_lanes.cuh; this file
// instantiates the fixed-step body and gives it the C interface of
// pdhg_mean_variance.cu with the sweep (`inlane`) after `shared`.

#include "pdhg_mean_variance_lanes.cuh"

// sigma is [B, N, N], or [N, N] with `shared` = 1; H must be 1. `inlane`
// = 1 runs the threshold's sweeps in every lane (up to 32 assets), 0 by
// the warp butterfly. Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_lanes(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, int B, int H, int N, int shared, int inlane, int max_iters,
    int refresh, int warm_iters, int cold_iters, float c, float gamma,
    float rho, float step_scale, float sigma_scale, int warm, void* stream) {
  return mv_lanes_dispatch<false>(cw, mu, sigma, w_out, fp_out, nullptr, B,
                                  H, N, shared, inlane, max_iters, refresh,
                                  warm_iters, cold_iters, c, gamma, rho,
                                  step_scale, sigma_scale, warm, stream);
}

// The lane plan, for the wrapper's copy to be checked against: the warps a
// CTA (0 where the layout does not take N) and the bytes of shared memory
// a CTA takes (-1 there).
extern "C" int kmpc_mv_lanes_warps(int N, int shared) {
  return mv_lanes_plan(N, shared).warps;
}

extern "C" long long kmpc_mv_lanes_smem_bytes(int N, int shared) {
  return mv_lanes_plan(N, shared).bytes;
}
