// The mean-variance PDHG kernel with residual-balancing adaptive steps in
// the lane layout: the `params.adaptive` branch of `_make_packed_mv_kernel`
// in kmpc_tpu/ops/mpc_pallas.py, at one horizon row. The kernel, its
// design and its bound are in pdhg_mean_variance_lanes.cuh; this file
// instantiates the adaptive body, apart from the fixed-step instantiations
// of pdhg_mean_variance_lanes.cu, and gives it a C interface.

#include "pdhg_mean_variance_lanes.cuh"

// sigma is [B, N, N], or [N, N] with `shared` = 1; H must be 1. `inlane`
// as in pdhg_mean_variance_lanes.cu. steps_out, [B, 6] or null, receives
// each problem's last tau, sigma and alpha, its last balancing's residuals
// and the signed sum of the iterations that moved its steps. Returns the
// launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_lanes_adaptive(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int inlane, int max_iters, int adapt_every, int warm_iters,
    int cold_iters, float c, float gamma, float rho, float step_scale,
    float sigma_scale, int warm, void* stream) {
  return mv_lanes_dispatch<true>(cw, mu, sigma, w_out, fp_out, steps_out, B,
                                 H, N, shared, inlane, max_iters, adapt_every,
                                 warm_iters, cold_iters, c, gamma, rho,
                                 step_scale, sigma_scale, warm, stream);
}
