// The mean-variance PDHG kernel with residual-balancing adaptive steps in
// the cluster layout: the `params.adaptive` branch of
// `_make_packed_mv_kernel` in kmpc_tpu/ops/mpc_pallas.py, the block
// layout's body with one problem's asset columns split over a thread-block
// cluster. The kernel, its design and its bound are in
// pdhg_mean_variance_cluster.cuh; this file instantiates the adaptive body
// and gives it a C interface.

#include "pdhg_mean_variance_cluster.cuh"

// The arguments of kmpc_pdhg_mean_variance_block_adaptive without short_,
// then the cluster's CTAs C. steps_out, [B, 6] or null, receives each
// problem's last tau, sigma and alpha, its last balancing's residuals and
// the signed sum of the iterations that moved its steps. Returns the
// launch's cudaError_t.
extern "C" int kmpc_pdhg_mean_variance_cluster_adaptive(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int max_iters, int adapt_every, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    int C, void* stream) {
  const MvArgs a = make_mv_args<true>(
      cw, mu, sigma, w_out, fp_out, B, H, N, shared, max_iters, adapt_every,
      warm_iters, cold_iters, c, gamma, rho, step_scale, sigma_scale, warm);
  return mv_cluster_dispatch<true>(
      a, MvAdaptArgs{static_cast<float*>(steps_out), adapt_every}, C,
      static_cast<cudaStream_t>(stream), nullptr);
}

extern "C" int kmpc_pdhg_mean_variance_cluster_adaptive_clusters(int H, int N,
                                                                 int C) {
  const MvArgs a = make_mv_args<true>(nullptr, nullptr, nullptr, nullptr,
                                      nullptr, 1, H, N, 0, 1, 2, 1, 1, 0.f,
                                      0.f, 1.f, 1.f, 1.f, 0);
  int n = 0;
  const int e = mv_cluster_dispatch<true>(a, MvAdaptArgs{nullptr, 2}, C,
                                          nullptr, &n);
  return e != 0 ? -e : n;
}
