// The scenario-averaged (stochastic-Kelly) log-utility PDHG kernel in the
// global layout: `_make_packed_kernel` with S set in
// kmpc_tpu/ops/mpc_pallas.py (`make_body`, `make_body_cond`,
// `make_trip_pipe`) at the shapes no other layout's plan holds (S=16 at
// H=20 N=500 and past), where kmpc_tpu's wrapper hands the solve to its XLA
// solver. The body is the block layout's, each problem's [S, H, N] returns
// read in place from the input; the kernel, its plan and its bound are in
// pdhg_log_utility_block.cuh. This file instantiates its fixed-step bodies
// (and their allow_short forms) and gives them a C interface.

#include "pdhg_log_utility_block.cuh"

// r is [B, S, H, N]; the arguments of kmpc_pdhg_log_utility_scenarios_block,
// then the workspace ws of `grid` slots (see pdhg_log_utility_global.cu).
// Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility_scenarios_global(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int S, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int pipe,
    int short_, void* ws, int grid, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, S,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return global_dispatch<true, false>(a, AdaptArgs{nullptr, 0}, pipe,
                                     short_, ws, grid, stream);
}

extern "C" int kmpc_pdhg_log_utility_scenarios_global_ctas(int S, int H,
                                                           int N,
                                                           int short_) {
  return global_ctas_per_sm<true, false>(S, H, N, short_);
}
