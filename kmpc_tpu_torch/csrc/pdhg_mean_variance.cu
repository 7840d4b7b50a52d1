// The mean-variance PDHG kernel with fixed steps: `_make_packed_mv_kernel`
// without `params.adaptive` in kmpc_tpu/ops/mpc_pallas.py. The kernel, its
// design and its bound are in pdhg_mean_variance.cuh; this file
// instantiates the fixed-step body and gives it a C interface.

#include "pdhg_mean_variance.cuh"

// sigma is [B, N, N], or [N, N] with `shared` = 1. Returns the launch's
// cudaError_t.
extern "C" int kmpc_pdhg_mean_variance(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, int B, int H, int N, int shared, int max_iters,
    int refresh, int warm_iters, int cold_iters, float c, float gamma,
    float rho, float step_scale, float sigma_scale, int warm, void* stream) {
  return mv_dispatch<false>(cw, mu, sigma, w_out, fp_out, nullptr, B, H, N,
                            shared, max_iters, refresh, warm_iters,
                            cold_iters, c, gamma, rho, step_scale,
                            sigma_scale, warm, stream);
}
