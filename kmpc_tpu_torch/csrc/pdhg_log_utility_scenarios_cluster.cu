// The scenario-averaged (stochastic-Kelly) log-utility PDHG kernel in the
// cluster layout: `_make_packed_kernel` with S set in
// kmpc_tpu/ops/mpc_pallas.py (`make_body`, `make_body_cond`,
// `make_trip_pipe`) at the shapes whose problem no CTA's shared memory holds
// but a cluster of at most 8 CTAs does (S=16 H=20 N=1000), a row's S returns
// resident in its CTA's shared memory or streamed through each warp's ring
// by TMA bulk copies. The kernel, its design and its bound are in
// pdhg_log_utility_cluster.cuh; this file instantiates its fixed-step bodies
// and gives them a C interface.

#include "pdhg_log_utility_cluster.cuh"

// r is [B, S, H, ldr] (ldr >= N a multiple of 4, the columns past N zero;
// 16-byte aligned where streamed). The arguments of
// kmpc_pdhg_log_utility_scenarios_wide (storage: 1 resident, 2 streamed),
// then the cluster's CTAs C, the streamed ring's stages (2 or 3) and
// scenarios a stage (4, 2 or 1), and ldr. Returns the launch's cudaError_t.
extern "C" int kmpc_pdhg_log_utility_scenarios_cluster(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int S, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, int pipe,
    int storage, int C, int stages, int chunk, int ldr, void* stream) {
  const Args a = make_args(cw, r, w_warm, p_warm, w_out, fp_out, p_out, B, S,
                           H, N, max_iters, refresh, warm_iters, cold_iters,
                           c, tau_to, ridge, rho, step_scale, sigma_scale,
                           precond, use_ball, warm);
  return cluster_dispatch<true, false>(a, AdaptArgs{nullptr, 0}, pipe,
                                       storage, C, stages, chunk, ldr,
                                       stream);
}

// The plan, for the wrapper's copy to be checked against: a CTA's shared
// memory in bytes with C CTAs, and the fewest CTAs whose plan fits (0: none
// up to 8), for S scenarios in `storage` through a ring of (stages, chunk).
extern "C" long long kmpc_pdhg_log_utility_scenarios_cluster_bytes(
    int S, int H, int N, int storage, int C, int stages, int chunk) {
  return cluster_plan(S, (H + C - 1) / C, N, false, storage, stages, chunk)
             .total *
         (long long)sizeof(float);
}
extern "C" int kmpc_pdhg_log_utility_scenarios_cluster_size(
    int S, int H, int N, int storage, int stages, int chunk) {
  return cluster_size(S, H, N, false, storage, stages, chunk);
}

extern "C" int kmpc_pdhg_log_utility_scenarios_cluster_clusters(
    int S, int H, int N, int storage, int C, int stages, int chunk,
    int pipe) {
  Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, 1, S, H, N, 1, 1, 1, 1, 0.f, 0.f, 0.f, 1.f, 1.f,
                     1.f, 0, 0, 0);
  int n = -1;
  const int e = cluster_dispatch<true, false>(
      a, AdaptArgs{nullptr, 0}, pipe, storage, C, stages, chunk,
      (N + 3) / 4 * 4, nullptr, &n);
  return e != 0 ? -e : n;
}
