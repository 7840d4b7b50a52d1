// The scenario-averaged log-utility PDHG kernel with residual-balancing
// adaptive steps in the row-per-warp layout: `_make_packed_kernel` with S
// set and `params.adaptive` in kmpc_tpu/ops/mpc_pallas.py
// (`body_adaptive`), one CTA per problem and one warp per horizon row. The
// kernel, its design and its bound are in pdhg_log_utility_rows.cuh; this
// file instantiates the adaptive body with a row's S returns in registers
// or in the CTA's shared memory, and gives it a C interface.

#include "pdhg_log_utility_rows.cuh"

// r is [B, S, H, N]. w_warm, p_warm, p_out and steps_out (as in
// pdhg_log_utility_rows_adaptive.cu) may be null. Returns the launch's
// cudaError_t.
extern "C" int kmpc_pdhg_log_utility_scenarios_rows_adaptive(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, void* steps_out, int B, int S,
    int H, int N, int max_iters, int adapt_every, int warm_iters,
    int cold_iters, float c, float tau_to, float ridge, float rho,
    float step_scale, float sigma_scale, int precond, int use_ball, int warm,
    void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, S,
                           H, N, max_iters, 0, warm_iters, cold_iters, c,
                           tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  const AdaptArgs ad = {static_cast<float*>(steps_out), adapt_every};
  return rows_dispatch<true, true>(a, ad, 0, stream);
}
