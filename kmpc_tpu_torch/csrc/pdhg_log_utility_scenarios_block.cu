// The scenario-averaged (stochastic-Kelly) log-utility PDHG kernel in the
// block-per-problem layout: `_make_packed_kernel` with S set in
// kmpc_tpu/ops/mpc_pallas.py (`make_body`, `make_body_cond`,
// `make_trip_pipe`) at the shapes beyond the warp kernel's budgets. The
// kernel, its design and its bound are in pdhg_log_utility_block.cuh; this
// file instantiates its fixed-step bodies with each problem's [S, H, N]
// returns in its block's shared memory and gives them a C interface.

#include "pdhg_log_utility_block.cuh"

// r is [B, S, H, N]. w_warm, p_warm and p_out may be null. pipe != 0 runs
// `make_trip_pipe` (warm and refresh > 1); short_ != 0 projects the primal
// on the hyperplane sum(w) = 1 (allow_short, with warm = 0). Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility_scenarios_block(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int S, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int pipe,
    int short_, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, S,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return block_dispatch<true, false>(a, AdaptArgs{nullptr, 0}, pipe,
                                     short_, stream);
}
