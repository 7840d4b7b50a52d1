// The scenario-averaged (stochastic-Kelly) log-utility PDHG kernel:
// `_make_packed_kernel` with S set in kmpc_tpu/ops/mpc_pallas.py, behind
// `solve_mpc_log_utility_scenarios_packed`. The kernel, its design and its
// bound are in pdhg_log_utility.cuh; this file instantiates it with each
// problem's [S, H, N] returns staged in its warp's shared memory and gives
// it a C interface.

#include "pdhg_log_utility.cuh"

// r is [B, S, H, N]. w_warm, p_warm and p_out may be null. Returns the
// launch's cudaError_t (cudaErrorInvalidValue when one problem's returns
// exceed a block's shared memory).
extern "C" int kmpc_pdhg_log_utility_scenarios(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int S, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, S,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return dispatch<true, false>(a, AdaptArgs{nullptr, 0}, stream);
}
