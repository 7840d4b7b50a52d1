// The mean-variance PDHG kernel with fixed steps in the block-per-problem
// layout: `_make_packed_mv_kernel` without `params.adaptive` in
// kmpc_tpu/ops/mpc_pallas.py at the shapes beyond one warp's registers.
// The kernel, its design and its bound are in pdhg_mean_variance_block.cuh;
// this file instantiates the fixed-step body and gives it the C interface
// of pdhg_mean_variance.cu.

#include "pdhg_mean_variance_block.cuh"

// sigma is [B, N, N], or [N, N] with `shared` = 1, and symmetric. short_
// != 0 projects the primal on the hyperplane sum(w) = 1 (allow_short, with
// warm = 0). Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_block(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, int B, int H, int N, int shared, int max_iters,
    int refresh, int warm_iters, int cold_iters, float c, float gamma,
    float rho, float step_scale, float sigma_scale, int warm, int short_,
    void* stream) {
  return mv_block_dispatch<false>(cw, mu, sigma, w_out, fp_out, nullptr, B,
                                  H, N, shared, max_iters, refresh,
                                  warm_iters, cold_iters, c, gamma, rho,
                                  step_scale, sigma_scale, warm, short_,
                                  stream);
}

// Bytes of shared memory one problem of this shape takes in the block
// layout (mv_block_plan), for the wrapper's copy of the plan to be checked
// against.
extern "C" long long kmpc_mv_block_smem_bytes(int H, int N) {
  return mv_block_plan(H, N).total * (long long)sizeof(float);
}
