// The scenario-averaged (stochastic-Kelly) log-utility PDHG kernel in the
// wide-row layout: `_make_packed_kernel` with S set in
// kmpc_tpu/ops/mpc_pallas.py (`make_body`, `make_body_cond`,
// `make_trip_pipe`) past the row layout's four slots, one CTA per problem
// and one warp per horizon row, the row in shared memory. The kernel, its
// design and its bound are in pdhg_log_utility_wide.cuh; this file
// instantiates its fixed-step bodies with a row's S returns resident in the
// CTA's shared memory or streamed through each warp's ring, and gives them
// a C interface.

#include "pdhg_log_utility_wide.cuh"

// r is [B, S, H, N]. w_warm, p_warm and p_out may be null: a cold start, a
// zero warm dual, no dual output. pipe != 0 runs `make_trip_pipe` (warm and
// refresh > 1). storage: 1 resident, 2 streamed. Returns the launch's
// cudaError_t.
extern "C" int kmpc_pdhg_log_utility_scenarios_wide(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int S, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int pipe,
    int storage, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, S,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return wide_dispatch<true, false>(a, AdaptArgs{nullptr, 0}, pipe, storage,
                                    stream);
}

// The shared memory one problem's CTA takes, in bytes, and the streamed
// ring's stages and scenarios a stage, as the launch computes them: the
// wrapper's copy of this plan routes shapes.
extern "C" long long kmpc_wide_scen_smem_bytes(int S, int H, int N,
                                               int adaptive, int storage) {
  return wide_scen_plan(S, H, N, adaptive != 0, storage).total *
         (long long)sizeof(float);
}
extern "C" int kmpc_wide_scen_ring(int S, int H, int N, int adaptive) {
  const WidePlan P = wide_scen_plan(S, H, N, adaptive != 0, kStreamed);
  return P.stages * 10 + P.chunk;
}
