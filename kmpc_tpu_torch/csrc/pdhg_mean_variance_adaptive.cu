// The mean-variance PDHG kernel with residual-balancing adaptive steps:
// the `params.adaptive` branch of `_make_packed_mv_kernel` in
// kmpc_tpu/ops/mpc_pallas.py. The kernel, its design and its bound are in
// pdhg_mean_variance.cuh; this file instantiates the adaptive body, apart
// from the fixed-step instantiations of pdhg_mean_variance.cu, and gives it
// a C interface.

#include "pdhg_mean_variance.cuh"

// sigma is [B, N, N], or [N, N] with `shared` = 1. steps_out, [B, 6] or
// null, receives each problem's last tau, sigma and alpha, its last
// balancing's residuals and the signed sum of the iterations that moved its
// steps. Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_adaptive(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int max_iters, int adapt_every, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    void* stream) {
  return mv_dispatch<true>(cw, mu, sigma, w_out, fp_out, steps_out, B, H, N,
                           shared, max_iters, adapt_every, warm_iters,
                           cold_iters, c, gamma, rho, step_scale,
                           sigma_scale, warm, stream);
}
