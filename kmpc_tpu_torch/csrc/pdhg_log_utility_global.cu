// The log-utility PDHG kernel in the global layout, one deterministic
// forecast per problem: `_make_packed_kernel` with S=None in
// kmpc_tpu/ops/mpc_pallas.py (`make_body`, `make_body_cond`,
// `make_trip_pipe`) at the shapes whose problem does not fit a block's
// shared memory, where kmpc_tpu's wrapper hands the solve to its XLA solver
// (`_default_tile_b_packed` gives None). The body is the block layout's; the
// kernel, its plan and its bound are in pdhg_log_utility_block.cuh. This file
// instantiates its fixed-step bodies (and their allow_short forms) and gives
// them a C interface.

#include "pdhg_log_utility_block.cuh"

// The arguments of kmpc_pdhg_log_utility_block, then the workspace ws of
// `grid` slots of kmpc_log_global_slot_bytes each (a grid of min(grid, B)
// CTAs runs). Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility_global(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int pipe,
    int short_, void* ws, int grid, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, 0,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return global_dispatch<false, false>(a, AdaptArgs{nullptr, 0}, pipe,
                                      short_, ws, grid, stream);
}

// Bytes of one CTA's workspace slot and of its shared memory in the global
// layout (global_plan) for S scenarios (0: one forecast), for the wrapper's
// copy of the plan to be checked against.
extern "C" long long kmpc_log_global_slot_bytes(int S, int H, int N) {
  return global_plan(S > 0 ? S : 1, H, N).slot * (long long)sizeof(float);
}

extern "C" long long kmpc_log_global_smem_bytes(int S, int H, int N) {
  return global_plan(S > 0 ? S : 1, H, N).smem * (long long)sizeof(float);
}

// CTAs of this kernel an SM holds at once at this shape.
extern "C" int kmpc_pdhg_log_utility_global_ctas(int S, int H, int N,
                                                 int short_) {
  return global_ctas_per_sm<false, false>(S, H, N, short_);
}
