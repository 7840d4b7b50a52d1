// The log-utility PDHG kernel for one deterministic forecast per problem:
// `_make_packed_kernel` with S=None in kmpc_tpu/ops/mpc_pallas.py. The
// kernel, its design and its bound are in pdhg_log_utility.cuh; this file
// instantiates it with the returns in registers and gives it a C interface.

#include "pdhg_log_utility.cuh"

// w_warm, p_warm and p_out may be null: a cold start, a zero warm dual, no
// dual output. Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, 0,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return dispatch<false, false>(a, AdaptArgs{nullptr, 0}, stream);
}
