// The log-utility PDHG kernel in the cluster layout, one deterministic
// forecast per problem: `_make_packed_kernel` with S=None in
// kmpc_tpu/ops/mpc_pallas.py (`make_body`, `make_body_cond`,
// `make_trip_pipe`) at the shapes whose problem no CTA's shared memory holds
// but a cluster of at most 8 CTAs does (H=20 N=1000), where kmpc_tpu's
// wrapper hands the solve to its XLA solver. The kernel, its design and its
// bound are in pdhg_log_utility_cluster.cuh; this file instantiates its
// fixed-step bodies and gives them a C interface.

#include "pdhg_log_utility_cluster.cuh"

// The arguments of kmpc_pdhg_log_utility_wide, then the cluster's CTAs C
// (kmpc_pdhg_log_utility_cluster_size, or more up to 8 for a private
// launch). Returns the launch's cudaError_t (cudaErrorInvalidConfiguration
// where no cluster of this shape fits the card).
extern "C" int kmpc_pdhg_log_utility_cluster(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int pipe, int C,
    void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, 0,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return cluster_dispatch<false, false>(a, AdaptArgs{nullptr, 0}, pipe,
                                        kRegisters, C, 0, 1, N, stream);
}

// The plan, for the wrapper's copy to be checked against: a CTA's shared
// memory in bytes with C CTAs, and the fewest CTAs whose plan fits (0: none
// up to 8). S, storage, stages and chunk as the scenario sources take them
// (unread here: one forecast).
extern "C" long long kmpc_pdhg_log_utility_cluster_bytes(
    int S, int H, int N, int storage, int C, int stages, int chunk) {
  return cluster_plan(0, (H + C - 1) / C, N, false, kRegisters, 0, 1).total *
         (long long)sizeof(float);
}
extern "C" int kmpc_pdhg_log_utility_cluster_size(int S, int H, int N,
                                                  int storage, int stages,
                                                  int chunk) {
  return cluster_size(0, H, N, false, kRegisters, 0, 1);
}

// Clusters of this shape the card runs at once (cudaOccupancyMaxActiveClusters).
extern "C" int kmpc_pdhg_log_utility_cluster_clusters(int S, int H, int N,
                                                      int storage, int C,
                                                      int stages, int chunk,
                                                      int pipe) {
  Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, 1, 0, H, N, 1, 1, 1, 1, 0.f, 0.f, 0.f, 1.f, 1.f,
                     1.f, 0, 0, 0);
  int n = -1;
  const int e = cluster_dispatch<false, false>(a, AdaptArgs{nullptr, 0}, pipe,
                                               kRegisters, C, 0, 1, N,
                                               nullptr, &n);
  return e != 0 ? -e : n;
}
