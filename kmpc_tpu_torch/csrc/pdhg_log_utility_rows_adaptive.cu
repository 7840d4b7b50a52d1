// The log-utility PDHG kernel with residual-balancing adaptive steps in the
// row-per-warp layout, one deterministic forecast per problem:
// `_make_packed_kernel` with S=None and `params.adaptive` in
// kmpc_tpu/ops/mpc_pallas.py (`body_adaptive`), one CTA per problem and one
// warp per horizon row. The kernel, its design and its bound are in
// pdhg_log_utility_rows.cuh; this file instantiates the adaptive body and
// gives it a C interface.

#include "pdhg_log_utility_rows.cuh"

// w_warm, p_warm and p_out may be null: a cold start, a zero warm dual, no
// dual output. steps_out, [B, 2 H + 4] or null, receives each problem's last
// tau and sigma per row, its alpha, its last balancing's residuals and the
// signed sum of the iterations that moved its steps.
// Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility_rows_adaptive(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, void* steps_out, int B, int H,
    int N, int max_iters, int adapt_every, int warm_iters, int cold_iters,
    float c, float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, 0,
                           H, N, max_iters, 0, warm_iters, cold_iters, c,
                           tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  const AdaptArgs ad = {static_cast<float*>(steps_out), adapt_every};
  return rows_dispatch<false, true>(a, ad, 0, stream);
}
