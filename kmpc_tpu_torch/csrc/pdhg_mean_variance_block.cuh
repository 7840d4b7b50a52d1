// The mean-variance PDHG solve (the Markowitz baseline's program) in a
// block-per-problem layout, for the shapes whose iterates do not fit one
// warp's registers (pdhg_mean_variance.cuh caps pow2ceil(H) * ceil(N/32) at
// 16 and N at 128): long horizons (H=20), wide universes with one shared
// covariance (N=960). The same program and arithmetic as the warp kernel:
// `_make_packed_mv_kernel` of kmpc_tpu/ops/mpc_pallas.py, its fixed-step
// body (full warm budget, the refresh schedule of `proj_refresh_every`, or
// cold projections) and, with ADAPT, its adaptive branch (residual
// balancing on every `adapt_every`-th iteration, the refresh schedule off);
// over-relaxation, the clip-form dual (the program has no turnover ball),
// a per-problem or a shared covariance, and the extra primal half-step with
// the fixed-point residual.
//
// Design. One CTA owns one problem, 32 * ceil(N/32) threads up to 512
// (block_threads; beyond 512 assets a thread walks several columns), as
// pdhg_log_utility_block.cuh lays out kernel A: w, p, mu, the projection
// input and the dual input live in shared memory as [H][N] for the whole
// solve, and thread i owns the asset columns i, i + T, ..., walking each
// column's H rows, so the elementwise phases touch only its own columns.
// The sums over assets (the thresholds' counts and sums, the residuals,
// the Frobenius norm, the fixed-point residual) are that header's stacked
// block reduces, so thresholds and balancing decisions are block-uniform.
//
// The quadratic gradient is the one phase that reads other threads'
// columns: thread i accumulates (Sigma w_t)[i] = sum_j Sigma[i, j] w_t[j]
// for up to eight rows at once, sequential FMAs over j in plain FP32 (no
// tensor cores: the reference pins this product to float32), with w_t[j]
// a broadcast read of shared memory and Sigma[i, j] read as Sigma[j * N + i]
// (Sigma is symmetric; the wrapper symmetrises it), so a warp's reads are
// consecutive. A barrier before the product orders it after the last
// update of w. Sigma is staged in shared memory beside the iterates where
// the whole plan fits a block (N <= 238 at H=1; every per-problem
// covariance the TPU kernel takes), else read from global memory on every
// iteration: a shared Sigma then stays resident in the 50 MB L2 and every
// problem-iteration reads its N^2 floats from there.
//
// The global layout runs the same body for the shapes whose iterates do not
// fit a block's shared memory (H=20 N=1000, H >= 33 N >= 500): w, p and the
// projection and dual inputs in the CTA's slot of a global-memory
// workspace (mv_global_plan), mu, the current weights and Sigma read in
// place, a persistent grid of min(B, the CTAs the card holds at once).
// SHORT (``allow_short``, both layouts): the primal projection is onto the
// hyperplane sum(w) = 1 (a cold threshold of no sweeps, no clip), no
// threshold carried, the start the hyperplane projection of the current
// weights (kmpc_tpu/ops/mpc.py's mean-variance solver).
//
// Barriers per iteration: 1 for the product, 2 per Michelot sweep (a cold
// projection 2 (cold_iters + 1)), 2 more on a balancing iteration (the two
// residuals in one stacked reduce).
//
// Bound. Per iteration and row, N FMAs per element for Sigma w_t and ~20
// FP32 operations beside it; inputs are read once. The product is bound by
// the shared-memory pipe (a broadcast w_t[j] and a Sigma[j][i] load per
// FMA, eight rows sharing each Sigma load) or, with Sigma in global
// memory, by L2 bandwidth (N^2 * 4 bytes per problem-iteration) where the
// covariances in flight fit the 50 MB L2 (a shared one), else by HBM: at
// H=1 N=1000 with a covariance per problem, hundreds of problems in flight
// read 4 MB each an iteration from device memory (2.34 TB/s measured);
// small shapes by the latency of the reduce chain.

#pragma once

#include "pdhg_log_utility_block.cuh"
#include "pdhg_mean_variance.cuh"

namespace {

// Rows of the quadratic gradient that share one load of Sigma[j][i].
constexpr int kMvRows = 8;

// Offsets (in floats) of one problem's shared-memory arrays and their
// total: w, p, mu, the projection input (then w_new) and the dual input as
// [H][N], the current weights, the per-row thresholds, the residuals, each
// warp's staging of the largest stacked reduce (a sweep's count and sum of
// every row: M = 2 H), and last the covariance [N][N] where it fits.
struct MvBlockPlan {
  long long w, p, mu, vm, q, cw, thw, res, red, M, sg, total;
  bool staged;
};

__host__ __device__ inline MvBlockPlan mv_block_plan(int H, int N) {
  MvBlockPlan P;
  const long long HN = (long long)H * N;
  long long o = 0;
  P.w = o; o += HN;
  P.p = o; o += HN;
  P.mu = o; o += HN;
  P.vm = o; o += HN;
  P.q = o; o += HN;
  P.cw = o; o += N;
  P.thw = o; o += H;
  P.res = o; o += 4;
  P.M = 2LL * H;
  P.red = o; o += (block_threads(N) / 32) * P.M;
  P.sg = o;
  P.staged = (o + (long long)N * N) * (long long)sizeof(float) <=
             kSmemPerBlock;
  if (P.staged) o += (long long)N * N;
  P.total = o;
  return P;
}

// The global layout's plan for kernel C, per CTA of a persistent grid: w,
// p, the projection input and the dual input as [H][N] in the CTA's slot of
// a global-memory workspace (mu, the current weights and Sigma are read in
// place); the thresholds, the residuals and the reduce staging (mv_block_plan's
// thw, res and red: H + 4 + (warps) 2 H floats) in shared memory where they
// fit a block's, else in the slot after the four arrays (smem 0).
struct MvGlobalPlan {
  long long w, p, vm, q, small, slot, smem;
};

__host__ __device__ inline long long mv_small_floats(int H, int N) {
  return H + 4 + (block_threads(N) / 32) * 2LL * H;
}

__host__ __device__ inline MvGlobalPlan mv_global_plan(int H, int N) {
  MvGlobalPlan G;
  const long long HN = (long long)H * N;
  const long long small = mv_small_floats(H, N);
  G.w = 0;
  G.p = HN;
  G.vm = 2 * HN;
  G.q = 3 * HN;
  if (small * (long long)sizeof(float) <= kSmemPerBlock) {
    G.small = -1;
    G.slot = 4 * HN;
    G.smem = small;
  } else {
    G.small = 4 * HN;
    G.slot = 4 * HN + small;
    G.smem = 0;
  }
  return G;
}

// Where one problem's arrays live while its CTA solves it: mu, the current
// weights and Sigma (in shared memory in the block layout where staged, in
// place in the inputs in the global layout), the four [H][N] iterates, and
// the thresholds, residuals and reduce staging (thw, res, red in order).
struct MvMem {
  const float *mu, *cw, *Sg;
  float *w, *p, *vm, *q;
  float *small;
};

// The solve of problem b by the whole CTA; SHORT (``allow_short``): the
// primal projection is onto the hyperplane sum(w) = 1 (a cold threshold of
// no sweeps, unclipped), with warm = 0 from the wrapper.
template <bool ADAPT, bool SHORT>
__device__ __forceinline__ void mv_block_solve(const MvArgs& a,
                                               const MvAdaptArgs& ad, int b,
                                               const MvMem& m) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int H = a.H, N = a.N;
  float* const w = m.w;
  float* const p = m.p;
  const float* const mu = m.mu;
  float* const vm = m.vm;  // the projection input, then w_new
  float* const q = m.q;    // p_new (adaptive body)
  const float* const cw = m.cw;
  float* const thw = m.small;
  float* const res = m.small + H;
  const BlockCtx ctx{tid, T, H, N, m.small + H + 4};
  const float* const Sg = m.Sg;

  for (int i = tid; i < N; i += T)
    for (int t = 0; t < H; ++t) p[t * N + i] = 0.f;
  __syncthreads();

  // L = max(2 gamma ||Sigma||_F, 1e-6); sigma = sigma_scale sqrt(L + 1) / 2;
  // tau = step_scale / (L/2 + 4 sigma).
  block_reduce<0, 1>(
      ctx, 1, 1,
      [=](int, float (&v)[1]) {
        float s = 0.f;
        for (int i = tid; i < N; i += T)
          for (int j = 0; j < N; ++j) {
            const float x = Sg[(size_t)j * N + i];
            s += x * x;
          }
        v[0] = s;
      },
      [=](int, auto tot) { res[0] = tot(0); });
  const float two_gamma = 2.f * a.gamma;
  const float L = jmax(two_gamma * sqrtf(res[0]), 1e-6f);
  // Under ADAPT sig, tau and alpha are carried through the loop, the same
  // in every thread.
  float sig = a.sigma_scale * sqrtf(L + 1.f) / 2.f;
  float tau = a.step_scale / (0.5f * L + sig * 4.f);
  float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;

  auto one = [](int) { return 1.f; };
  auto at_vm = [=](int t, int i) { return vm[t * N + i]; };
  auto proj = [](float x) { return SHORT ? x : jmax(x, 0.f); };
  auto primal_threshold = [=](bool cold, int n) {
    if constexpr (SHORT)
      block_threshold(ctx, at_vm, thw, one, true, 0);
    else
      block_threshold(ctx, at_vm, thw, one, cold, n);
  };

  // w0 = cold simplex projection of the current weights on every row.
  for (int i = tid; i < N; i += T)
    for (int t = 0; t < H; ++t) vm[t * N + i] = cw[i];
  primal_threshold(true, a.cold_iters);
  for (int i = tid; i < N; i += T)
    for (int t = 0; t < H; ++t)
      w[t * N + i] = proj(vm[t * N + i] - thw[t]);

  // v = w - tau ((2 gamma Sigma w_t - mu_t) + D'p) into vm, down the
  // thread's columns; the barrier orders the product after every column's
  // last update of w.
  auto primal = [&](float step) {
    __syncthreads();
    for (int i = tid; i < N; i += T) {
      for (int t0 = 0; t0 < H; t0 += kMvRows) {
        const int nr = min(kMvRows, H - t0);
        const float* const wr = w + t0 * N;
        float acc[kMvRows];
#pragma unroll
        for (int u = 0; u < kMvRows; ++u) acc[u] = 0.f;
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
          const float s = Sg[(size_t)j * N + i];
#pragma unroll
          for (int u = 0; u < kMvRows; ++u)
            if (u < nr) acc[u] += s * wr[u * N + j];
        }
#pragma unroll
        for (int u = 0; u < kMvRows; ++u) {
          if (u < nr) {
            const int t = t0 + u, e = t * N + i;
            const float g = two_gamma * acc[u] - mu[e];
            const float nxt = t + 1 < H ? p[e + N] : 0.f;
            vm[e] = w[e] - step * (g + (p[e] - nxt));
          }
        }
      }
    }
  };
  const bool relax = a.rho != 1.f;
  auto update = [=](int e, float wn, float pn) {
    if (relax) {
      w[e] = w[e] + a.rho * (wn - w[e]);
      p[e] = p[e] + a.rho * (pn - p[e]);
    } else {
      w[e] = wn;
      p[e] = pn;
    }
  };

  const bool warm = a.warm != 0;
  if constexpr (!ADAPT) {
    const bool cond = warm && a.refresh > 1;
    for (int it = 0; it < a.max_iters; ++it) {
      int n_sw;
      if (!warm)
        n_sw = a.cold_iters;
      else if (cond)
        n_sw = (it % a.refresh) == 0 ? a.warm_iters : 1;
      else
        n_sw = a.warm_iters;
      primal(tau);
      primal_threshold(!warm, n_sw);
      // The new primal, the dual q = p + sigma D(2 w_new - w) clipped to
      // [-c, c], and the update, row by row down the thread's columns.
      for (int i = tid; i < N; i += T) {
        float wbp = cw[i];
        for (int t = 0; t < H; ++t) {
          const int e = t * N + i;
          const float wn = proj(vm[e] - thw[t]);
          const float wb = 2.f * wn - w[e];
          const float pn = jmin(jmax(p[e] + sig * (wb - wbp), -a.c), a.c);
          wbp = wb;
          update(e, wn, pn);
        }
      }
    }
  } else {
    const int n_sw = warm ? a.warm_iters : a.cold_iters;
    for (int it = 0; it < a.max_iters; ++it) {
      primal(tau);
      primal_threshold(!warm, n_sw);
      for (int i = tid; i < N; i += T) {
        float wbp = cw[i];
        for (int t = 0; t < H; ++t) {
          const int e = t * N + i;
          const float wn = proj(vm[e] - thw[t]);
          const float wb = 2.f * wn - w[e];
          q[e] = jmin(jmax(p[e] + sig * (wb - wbp), -a.c), a.c);
          vm[e] = wn;
          wbp = wb;
        }
      }
      // Residual balancing (ratio 1.5, alpha *= 0.95), from the moves
      // before over-relaxation: pr = ||dw / tau - D'dp||,
      // dr = ||dp / sigma - D0 dw|| over all rows and assets.
      if (ad.adapt_every <= 1 ||
          (it % ad.adapt_every) == ad.adapt_every - 1) {
        block_reduce<0, 2>(
            ctx, 2, 1,
            [=](int, float (&v)[2]) {
              v[0] = 0.f;
              v[1] = 0.f;
              for (int i = tid; i < N; i += T) {
                for (int t = 0; t < H; ++t) {
                  const int e = t * N + i;
                  const float dw = w[e] - vm[e];
                  const float dp = p[e] - q[e];
                  const float dpn = t + 1 < H ? p[e + N] - q[e + N] : 0.f;
                  const float dwp = t == 0 ? 0.f : w[e - N] - vm[e - N];
                  const float e1 = dw / tau - (dp - dpn);
                  const float e2 = dp / sig - (dw - dwp);
                  v[0] += e1 * e1;
                  v[1] += e2 * e2;
                }
              }
            },
            [=](int, auto tot) {
              res[0] = sqrtf(tot(0));
              res[1] = sqrtf(tot(1));
            });
        const float pr = res[0], dr = res[1];
        pr_last = pr;
        dr_last = dr;
        const bool big_p = pr > 1.5f * dr;
        const bool big_d = dr > 1.5f * pr;
        const float shrink = 1.f - alpha;
        if (big_p) {
          tau = tau / shrink;
          sig = sig * shrink;
        } else if (big_d) {
          tau = tau * shrink;
          sig = sig / shrink;
        }
        if (big_p || big_d) alpha = alpha * 0.95f;
        if (big_p) moved += (float)(it + 1);
        if (!big_p && big_d) moved -= (float)(it + 1);
      }
      for (int i = tid; i < N; i += T)
        for (int t = 0; t < H; ++t)
          update(t * N + i, vm[t * N + i], q[t * N + i]);
    }
    if (ad.steps_out != nullptr && tid == 0) {
      float* o = ad.steps_out + (size_t)b * 6;
      o[0] = tau;
      o[1] = sig;
      o[2] = alpha;
      o[3] = pr_last;
      o[4] = dr_last;
      o[5] = moved;
    }
  }

  // Extra primal half-step with a cold full-budget projection: the
  // returned iterate is w_last and fp = max |w_last - w|.
  primal(tau);
  primal_threshold(true, a.cold_iters);
  float fp = 0.f;
  for (int i = tid; i < N; i += T) {
    for (int t = 0; t < H; ++t) {
      const int e = t * N + i;
      const float wl = proj(vm[e] - thw[t]);
      fp = jmax(fp, fabsf(wl - w[e]));
      a.w_out[((size_t)b * H + t) * N + i] = wl;
    }
  }
  block_reduce<2, 1>(
      ctx, 1, 1, [=](int, float (&v)[1]) { v[0] = fp; },
      [=](int, auto tot) { a.fp_out[b] = tot(0); });
}

// The block layout: one CTA per problem, its arrays in shared memory at the
// offsets of mv_block_plan; Sigma staged there where it fits, else read
// from global memory. The inputs are copied in by the thread that owns the
// column; the body's first barrier orders them before any other read.
template <bool ADAPT, bool SHORT>
__global__ void __launch_bounds__(kBlockMaxThreads)
pdhg_mean_variance_block_kernel(MvArgs a, MvAdaptArgs ad) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x;
  const int H = a.H, N = a.N;
  const MvBlockPlan P = mv_block_plan(H, N);
  const float* const src = a.sigma + (a.shared ? 0 : (size_t)b * N * N);
  const float* Sg = src;
  if (P.staged) {
    float* const s = smem + P.sg;
    for (int k = tid; k < N * N; k += T) s[k] = src[k];
    Sg = s;
  }
  float* const mu = smem + P.mu;
  float* const cw = smem + P.cw;
  for (int i = tid; i < N; i += T) {
    cw[i] = a.cw[(size_t)b * N + i];
    for (int t = 0; t < H; ++t)
      mu[t * N + i] = a.mu[((size_t)b * H + t) * N + i];
  }
  const MvMem m{mu, cw, Sg, smem + P.w, smem + P.p, smem + P.vm,
                smem + P.q, smem + P.thw};
  mv_block_solve<ADAPT, SHORT>(a, ad, b, m);
}

// The global layout: the same body for the shapes whose iterates do not
// fit a block's shared memory. A persistent grid; CTA k solves problems
// k, k + gridDim.x, ... with its iterates in slot k of the workspace
// (mv_global_plan), mu and the current weights read in place and Sigma
// read from global memory (the shared one stays resident in L2).
template <bool ADAPT, bool SHORT>
__global__ void __launch_bounds__(kBlockMaxThreads)
pdhg_mean_variance_global_kernel(MvArgs a, MvAdaptArgs ad, float* ws) {
  extern __shared__ float smem[];
  const int H = a.H, N = a.N;
  const MvGlobalPlan G = mv_global_plan(H, N);
  float* const slot = ws + (size_t)blockIdx.x * G.slot;
  float* const small = G.small < 0 ? smem : slot + G.small;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const MvMem m{a.mu + (size_t)b * H * N, a.cw + (size_t)b * N,
                  a.sigma + (a.shared ? 0 : (size_t)b * N * N), slot + G.w,
                  slot + G.p, slot + G.vm, slot + G.q, small};
    mv_block_solve<ADAPT, SHORT>(a, ad, b, m);
  }
}

// `shared` = 1: sigma is one [N, N] matrix for the whole batch; `schedule`
// is `refresh` for the fixed-step body and `adapt_every` for the adaptive
// one; `steps_out` may be null.
template <bool ADAPT>
MvArgs make_mv_args(const void* cw, const void* mu, const void* sigma,
                    void* w_out, void* fp_out, int B, int H, int N,
                    int shared, int max_iters, int schedule, int warm_iters,
                    int cold_iters, float c, float gamma, float rho,
                    float step_scale, float sigma_scale, int warm) {
  MvArgs a;
  a.cw = static_cast<const float*>(cw);
  a.mu = static_cast<const float*>(mu);
  a.sigma = static_cast<const float*>(sigma);
  a.w_out = static_cast<float*>(w_out);
  a.fp_out = static_cast<float*>(fp_out);
  a.B = B;
  a.H = H;
  a.N = N;
  a.shared = shared;
  a.max_iters = max_iters;
  a.refresh = ADAPT ? 0 : schedule;
  a.warm_iters = warm_iters;
  a.cold_iters = cold_iters;
  a.c = c;
  a.gamma = gamma;
  a.rho = rho;
  a.step_scale = step_scale;
  a.sigma_scale = sigma_scale;
  a.warm = warm;
  return a;
}

// One block per problem, the shared memory of mv_block_plan (above 48 KB
// by opt-in); short_ != 0 projects on the hyperplane (allow_short). Shapes
// whose iterates do not fit a block's shared memory return
// cudaErrorInvalidValue (the wrapper checks first).
template <bool ADAPT>
int mv_block_dispatch(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int max_iters, int schedule, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    int short_, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const MvArgs a = make_mv_args<ADAPT>(
      cw, mu, sigma, w_out, fp_out, B, H, N, shared, max_iters, schedule,
      warm_iters, cold_iters, c, gamma, rho, step_scale, sigma_scale, warm);
  const MvAdaptArgs ad = {static_cast<float*>(steps_out),
                          ADAPT ? schedule : 0};
  const MvBlockPlan P = mv_block_plan(H, N);
  const long long smem = P.total * (long long)sizeof(float);
  if (smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  auto k = short_ ? &pdhg_mean_variance_block_kernel<ADAPT, true>
                  : &pdhg_mean_variance_block_kernel<ADAPT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<B, block_threads(N), (size_t)smem,
      static_cast<cudaStream_t>(stream)>>>(a, ad);
  return (int)cudaGetLastError();
}

// A grid of min(grid, B) CTAs over the workspace ws of grid slots of
// mv_global_plan's floats (the wrapper allocates it).
template <bool ADAPT>
int mv_global_dispatch(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int max_iters, int schedule, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    int short_, void* ws, int grid, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || grid <= 0 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const MvArgs a = make_mv_args<ADAPT>(
      cw, mu, sigma, w_out, fp_out, B, H, N, shared, max_iters, schedule,
      warm_iters, cold_iters, c, gamma, rho, step_scale, sigma_scale, warm);
  const MvAdaptArgs ad = {static_cast<float*>(steps_out),
                          ADAPT ? schedule : 0};
  const long long smem = mv_global_plan(H, N).smem * (long long)sizeof(float);
  auto k = short_ ? &pdhg_mean_variance_global_kernel<ADAPT, true>
                  : &pdhg_mean_variance_global_kernel<ADAPT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ctas = grid < B ? grid : B;
  k<<<ctas, block_threads(N), (size_t)smem,
      static_cast<cudaStream_t>(stream)>>>(a, ad, static_cast<float*>(ws));
  return (int)cudaGetLastError();
}

// CTAs of the global layout's kernel an SM holds at once; 0 on an error.
template <bool ADAPT>
int mv_global_ctas_per_sm(int H, int N, int short_) {
  const size_t smem = (size_t)mv_global_plan(H, N).smem * sizeof(float);
  auto k = short_ ? &pdhg_mean_variance_global_kernel<ADAPT, true>
                  : &pdhg_mean_variance_global_kernel<ADAPT, false>;
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k,
                                                      block_threads(N), smem);
  return e == cudaSuccess ? n : 0;
}

}  // namespace
