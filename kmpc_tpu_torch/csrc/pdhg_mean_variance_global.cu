// The mean-variance PDHG kernel with fixed steps in the global layout:
// `_make_packed_mv_kernel` without `params.adaptive` in
// kmpc_tpu/ops/mpc_pallas.py at the shapes whose iterates do not fit a
// block's shared memory (H=20 N=1000, H >= 33 N >= 500), where kmpc_tpu's
// wrapper hands the solve to its XLA solver. The body is the block layout's;
// the kernel, its plan and its bound are in pdhg_mean_variance_block.cuh.
// This file instantiates the fixed-step body (and its allow_short form)
// and gives it a C interface.

#include "pdhg_mean_variance_block.cuh"

// The arguments of kmpc_pdhg_mean_variance_block, then the workspace ws of
// `grid` slots of kmpc_mv_global_slot_bytes each (a grid of min(grid, B)
// CTAs runs). Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_global(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, int B, int H, int N, int shared, int max_iters,
    int refresh, int warm_iters, int cold_iters, float c, float gamma,
    float rho, float step_scale, float sigma_scale, int warm, int short_,
    void* ws, int grid, void* stream) {
  return mv_global_dispatch<false>(cw, mu, sigma, w_out, fp_out, nullptr, B,
                                   H, N, shared, max_iters, refresh,
                                   warm_iters, cold_iters, c, gamma, rho,
                                   step_scale, sigma_scale, warm, short_,
                                   ws, grid, stream);
}

// Bytes of one CTA's workspace slot and of its shared memory in the global
// layout (mv_global_plan), for the wrapper's copy of the plan to be checked
// against.
extern "C" long long kmpc_mv_global_slot_bytes(int H, int N) {
  return mv_global_plan(H, N).slot * (long long)sizeof(float);
}

extern "C" long long kmpc_mv_global_smem_bytes(int H, int N) {
  return mv_global_plan(H, N).smem * (long long)sizeof(float);
}

// CTAs of this kernel an SM holds at once at this shape.
extern "C" int kmpc_pdhg_mean_variance_global_ctas(int H, int N,
                                                   int short_) {
  return mv_global_ctas_per_sm<false>(H, N, short_);
}
