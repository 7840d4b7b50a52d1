// The mean-variance PDHG kernel with residual-balancing adaptive steps in
// the tile layout: the `params.adaptive` branch of `_make_packed_mv_kernel`
// in kmpc_tpu/ops/mpc_pallas.py. The kernel, its design and its bound are
// in pdhg_mean_variance_tile.cuh; this file instantiates the adaptive body
// and gives it the C interface of pdhg_mean_variance_block_adaptive.cu with
// the problems a CTA after `shared`.

#include "pdhg_mean_variance_tile.cuh"

// sigma is [B, N, N], or [N, N] with `shared` = 1, and symmetric; P is
// the problems a CTA, 0 for kmpc_mv_tile_problems' count. steps_out, [B, 6]
// or null, receives each problem's last tau, sigma and alpha, its last
// balancing's residuals and the signed sum of the iterations that moved its
// steps. Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_tile_adaptive(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared, int P,
    int max_iters, int adapt_every, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    void* stream) {
  return mv_tile_dispatch<true>(cw, mu, sigma, w_out, fp_out, steps_out, B,
                                H, N, shared, P, max_iters, adapt_every,
                                warm_iters, cold_iters, c, gamma, rho,
                                step_scale, sigma_scale, warm, stream);
}
