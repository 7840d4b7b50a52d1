// The log-utility PDHG kernel in the row-per-warp layout, one deterministic
// forecast per problem: `_make_packed_kernel` with S=None in
// kmpc_tpu/ops/mpc_pallas.py (`make_body`, `make_body_cond`,
// `make_trip_pipe`), one CTA per problem and one warp per horizon row. The
// kernel, its design and its bound are in pdhg_log_utility_rows.cuh; this
// file instantiates its fixed-step bodies and gives them a C interface.

#include "pdhg_log_utility_rows.cuh"

// w_warm, p_warm and p_out may be null: a cold start, a zero warm dual, no
// dual output. pipe != 0 runs `make_trip_pipe` (warm and refresh > 1).
// Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility_rows(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int pipe,
    void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, 0,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return rows_dispatch<false, false>(a, AdaptArgs{nullptr, 0}, pipe, stream);
}

// The shared memory one problem's CTA takes (S = 0: one forecast), in bytes,
// as the launch computes it: the wrapper's copy of this plan routes shapes.
extern "C" long long kmpc_rows_smem_bytes(int S, int H, int N, int adaptive) {
  return rows_plan(S, H, N, adaptive != 0).total * (long long)sizeof(float);
}
