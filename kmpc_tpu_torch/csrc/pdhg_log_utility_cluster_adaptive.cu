// The adaptive log-utility PDHG kernel in the cluster layout, one
// deterministic forecast per problem: `body_adaptive` of
// `_make_packed_kernel` (kmpc_tpu/ops/mpc_pallas.py) with S=None, at the
// shapes whose problem no CTA's shared memory holds but a cluster of at most
// 8 CTAs does. The kernel, its design and its bound are in
// pdhg_log_utility_cluster.cuh; this file instantiates its adaptive body and
// gives it a C interface.

#include "pdhg_log_utility_cluster.cuh"

// The arguments of kmpc_pdhg_log_utility_wide_adaptive, then the cluster's
// CTAs C. Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility_cluster_adaptive(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, void* steps_out, int B, int H,
    int N, int max_iters, int adapt_every, int warm_iters, int cold_iters,
    float c, float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int C,
    void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, 0,
                           H, N, max_iters, 0, warm_iters, cold_iters, c,
                           tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  const AdaptArgs ad = {static_cast<float*>(steps_out), adapt_every};
  return cluster_dispatch<false, true>(a, ad, 0, kRegisters, C, 0, 1, N,
                                       stream);
}

// The plan, as kmpc_pdhg_log_utility_cluster_bytes and _size give it, for
// the adaptive body.
extern "C" long long kmpc_pdhg_log_utility_cluster_adaptive_bytes(
    int S, int H, int N, int storage, int C, int stages, int chunk) {
  return cluster_plan(0, (H + C - 1) / C, N, true, kRegisters, 0, 1).total *
         (long long)sizeof(float);
}
extern "C" int kmpc_pdhg_log_utility_cluster_adaptive_size(
    int S, int H, int N, int storage, int stages, int chunk) {
  return cluster_size(0, H, N, true, kRegisters, 0, 1);
}

extern "C" int kmpc_pdhg_log_utility_cluster_adaptive_clusters(
    int S, int H, int N, int storage, int C, int stages, int chunk,
    int pipe) {
  Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, 1, 0, H, N, 1, 1, 1, 1, 0.f, 0.f, 0.f, 1.f, 1.f,
                     1.f, 0, 0, 0);
  int n = -1;
  const int e = cluster_dispatch<false, true>(a, AdaptArgs{nullptr, 1}, 0,
                                              kRegisters, C, 0, 1, N, nullptr,
                                              &n);
  return e != 0 ? -e : n;
}
