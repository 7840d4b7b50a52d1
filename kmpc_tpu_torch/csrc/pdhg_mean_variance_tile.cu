// The mean-variance PDHG kernel with fixed steps in the tile layout:
// `_make_packed_mv_kernel` without `params.adaptive` in
// kmpc_tpu/ops/mpc_pallas.py, one warp per (problem, horizon row), several
// problems a CTA, one Sigma a CTA resident or streamed. The kernel, its
// design and its bound are in pdhg_mean_variance_tile.cuh; this file
// instantiates the fixed-step body and gives it the C interface of
// pdhg_mean_variance_block.cu with the problems a CTA after `shared`.

#include "pdhg_mean_variance_tile.cuh"

// sigma is [B, N, N], or [N, N] with `shared` = 1, and symmetric; P is
// the problems a CTA (1 with a per-problem sigma), 0 for
// kmpc_mv_tile_problems' count. Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_tile(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, int B, int H, int N, int shared, int P, int max_iters,
    int refresh, int warm_iters, int cold_iters, float c, float gamma,
    float rho, float step_scale, float sigma_scale, int warm, void* stream) {
  return mv_tile_dispatch<false>(cw, mu, sigma, w_out, fp_out, nullptr, B,
                                 H, N, shared, P, max_iters, refresh,
                                 warm_iters, cold_iters, c, gamma, rho,
                                 step_scale, sigma_scale, warm, stream);
}

// The tile plan, for the wrapper's copy to be checked against: the bytes
// of shared memory a CTA of P problems takes (-1 where the plan does not
// fit), the rows of Sigma a ring stage holds (0: Sigma resident), and the
// problems a CTA the kernel is given for B problems (0: not taken).
extern "C" long long kmpc_mv_tile_smem_bytes(int P, int H, int N,
                                             int adapt) {
  const MvTilePlan L = mv_tile_layout(P, H, N, adapt != 0);
  return L.ok ? L.total * (long long)sizeof(float) : -1;
}

extern "C" int kmpc_mv_tile_ring_rows(int P, int H, int N, int adapt) {
  return mv_tile_layout(P, H, N, adapt != 0).Tj;
}

extern "C" int kmpc_mv_tile_problems(int B, int H, int N, int shared,
                                     int adapt) {
  return mv_tile_problems(B, H, N, shared != 0, adapt != 0);
}
