// The scenario-averaged log-utility PDHG kernel with residual-balancing
// adaptive steps in the global layout: `_make_packed_kernel` with S set and
// `params.adaptive` in kmpc_tpu/ops/mpc_pallas.py (`body_adaptive`) at the
// shapes no other layout's plan holds. The body is the block layout's, each
// problem's returns read in place; the kernel, its plan and its bound are in
// pdhg_log_utility_block.cuh. This file instantiates the adaptive body (and
// its allow_short form) and gives it a C interface.

#include "pdhg_log_utility_block.cuh"

// r is [B, S, H, N]; the arguments of
// kmpc_pdhg_log_utility_scenarios_block_adaptive, then the workspace ws of
// `grid` slots (see pdhg_log_utility_global.cu). Returns the launch's
// cudaError_t.
extern "C" int kmpc_pdhg_log_utility_scenarios_global_adaptive(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, void* steps_out, int B, int S,
    int H, int N, int max_iters, int adapt_every, int warm_iters,
    int cold_iters, float c, float tau_to, float ridge, float rho,
    float step_scale, float sigma_scale, int precond, int use_ball, int warm,
    int short_, void* ws, int grid, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, S,
                           H, N, max_iters, 0, warm_iters, cold_iters, c,
                           tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  const AdaptArgs ad = {static_cast<float*>(steps_out), adapt_every};
  return global_dispatch<true, true>(a, ad, 0, short_, ws, grid, stream);
}

extern "C" int kmpc_pdhg_log_utility_scenarios_global_adaptive_ctas(
    int S, int H, int N, int short_) {
  return global_ctas_per_sm<true, true>(S, H, N, short_);
}
