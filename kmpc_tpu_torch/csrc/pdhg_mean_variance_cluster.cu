// The mean-variance PDHG kernel with fixed steps in the cluster layout:
// `_make_packed_mv_kernel` without `params.adaptive` in
// kmpc_tpu/ops/mpc_pallas.py, the block layout's body with one problem's
// asset columns split over a thread-block cluster and its covariance held
// in the cluster's shared memory as far as it fits. The kernel, its design
// and its bound are in pdhg_mean_variance_cluster.cuh; this file
// instantiates the fixed-step body and gives it a C interface.

#include "pdhg_mean_variance_cluster.cuh"

// The arguments of kmpc_pdhg_mean_variance_block without short_, then the
// cluster's CTAs C (a divisor of block_threads(N) / 32, at most 16).
// Returns the launch's cudaError_t (cudaErrorInvalidConfiguration where the
// card runs no cluster of this shape).
extern "C" int kmpc_pdhg_mean_variance_cluster(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, int B, int H, int N, int shared, int max_iters,
    int refresh, int warm_iters, int cold_iters, float c, float gamma,
    float rho, float step_scale, float sigma_scale, int warm, int C,
    void* stream) {
  const MvArgs a = make_mv_args<false>(
      cw, mu, sigma, w_out, fp_out, B, H, N, shared, max_iters, refresh,
      warm_iters, cold_iters, c, gamma, rho, step_scale, sigma_scale, warm);
  return mv_cluster_dispatch<false>(a, MvAdaptArgs{nullptr, 0}, C,
                                    static_cast<cudaStream_t>(stream),
                                    nullptr);
}

// The plan, for the wrapper's copy to be checked against: a CTA's shared
// memory in bytes and the rows of Sigma it stages with C CTAs (0 where the
// plan refuses C), for the fixed-step body (adapt 0) or the adaptive one.
extern "C" long long kmpc_mv_cluster_bytes(int H, int N, int C, int adapt) {
  const MvClusterPlan P = mv_cluster_plan(H, N, C, adapt != 0);
  return P.C ? P.total * (long long)sizeof(float) : 0;
}
extern "C" int kmpc_mv_cluster_rows(int H, int N, int C, int adapt) {
  const MvClusterPlan P = mv_cluster_plan(H, N, C, adapt != 0);
  return P.C ? P.js : 0;
}

// Clusters of C CTAs of this shape the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int kmpc_pdhg_mean_variance_cluster_clusters(int H, int N, int C) {
  const MvArgs a = make_mv_args<false>(nullptr, nullptr, nullptr, nullptr,
                                       nullptr, 1, H, N, 0, 1, 0, 1, 1, 0.f,
                                       0.f, 1.f, 1.f, 1.f, 0);
  int n = 0;
  const int e = mv_cluster_dispatch<false>(a, MvAdaptArgs{nullptr, 0}, C,
                                           nullptr, &n);
  return e != 0 ? -e : n;
}
