// The mean-variance PDHG kernel with residual-balancing adaptive steps in
// the global layout: the `params.adaptive` branch of
// `_make_packed_mv_kernel` in kmpc_tpu/ops/mpc_pallas.py at the shapes whose
// iterates do not fit a block's shared memory. The body is the block
// layout's; the kernel, its plan and its bound are in
// pdhg_mean_variance_block.cuh. This file instantiates the adaptive body
// (and its allow_short form) and gives it a C interface.

#include "pdhg_mean_variance_block.cuh"

// The arguments of kmpc_pdhg_mean_variance_block_adaptive, then the
// workspace ws of `grid` slots (see pdhg_mean_variance_global.cu). Returns
// the launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_global_adaptive(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int max_iters, int adapt_every, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    int short_, void* ws, int grid, void* stream) {
  return mv_global_dispatch<true>(cw, mu, sigma, w_out, fp_out, steps_out, B,
                                  H, N, shared, max_iters, adapt_every,
                                  warm_iters, cold_iters, c, gamma, rho,
                                  step_scale, sigma_scale, warm, short_, ws,
                                  grid, stream);
}

extern "C" int kmpc_pdhg_mean_variance_global_adaptive_ctas(int H, int N,
                                                            int short_) {
  return mv_global_ctas_per_sm<true>(H, N, short_);
}
