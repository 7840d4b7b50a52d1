// Fused Condat-Vu PDHG solve of the batched mean-variance MPC program (the
// Markowitz baseline's):
//
//   min_w  sum_t [gamma w_t' Sigma w_t - w_t . mu_t] + c sum_t ||w_t - w_{t-1}||_1
//   s.t.   w_t on the simplex
//
// Replaces the TPU kernel `_make_packed_mv_kernel` behind
// `solve_mpc_mean_variance_pallas_packed` in kmpc_tpu/ops/mpc_pallas.py:
// the fixed-step body with the full warm Michelot budget, the refresh
// schedule (one warm sweep per iteration, the full budget every
// `refresh`-th) or cold projections, over-relaxation, a per-problem or a
// shared covariance, and the extra primal half-step. The program has no
// turnover ball, so the dual prox is a clip to [-c, c]. With ADAPT = true
// (a template flag, instantiated in a source of its own) the steps are
// carried per problem, also under a shared covariance, and balanced by the
// primal and dual residuals on every `adapt_every`-th iteration (one
// butterfly over the per-lane partial sums of both); the refresh schedule
// is then off and the tail steps by the last tau.
//
// Design. One warp owns one problem, asset i on lane i % 32, slot i / 32,
// the H rows of w, p and mu in registers (as the log-utility kernels). The
// covariance lives in shared memory, column by column: entry (i, j) at
// [j * K*32 + i], zeros in the padded rows, so lane i reads its row of
// Sigma without bank conflicts. A per-problem Sigma is staged by its warp
// in the warp's own slice; a shared Sigma once per block. Sigma w_t: lane i
// accumulates Sigma[i, j] * w_t[j] over j = 0..N-1 with w_t[j] broadcast
// from its owner lane by __shfl_sync: plain FP32 multiply-adds, no tensor
// cores (the reference pins this product to exact float32).
//
// Bound. Per iteration and row, N multiply-adds and N shuffles per slot for
// the quadratic gradient beside ~15 FP32 operations per element and two
// butterflies per Michelot sweep; inputs are read once (Sigma is N*N
// floats per problem). Bound by the FP32 and shuffle pipes, not by HBM.
// Shared memory: N * K*32 floats per warp (per block when shared) sets the
// warps per block; registers cap pow2ceil(H) * K as in the log-utility
// kernels. The wrapper checks both.

#pragma once

#include "pdhg_common.cuh"

namespace {

struct MvArgs {
  const float* cw;     // [B, N] current weights
  const float* mu;     // [B, H, N] forecast log-returns
  const float* sigma;  // [B, N, N], or [N, N] when shared
  float* w_out;        // [B, H, N] extra-half-step iterate
  float* fp_out;       // [B] fixed-point residual
  int B, H, N, shared;
  int max_iters, refresh, warm_iters, cold_iters;
  float c, gamma, rho, step_scale, sigma_scale;
  int warm;
};

// What only the adaptive body reads, apart from MvArgs so that the
// fixed-step instantiations keep the argument block they had.
struct MvAdaptArgs {
  float* steps_out;  // [B, 6]: the last tau, sigma and alpha, the residuals
                     // of the last balancing, and the signed sum of the
                     // iterations that moved the steps (+it grew tau, -it
                     // shrank it), which two equal step histories share; or
                     // null
  int adapt_every;   // balance when it % k == k - 1
};

// v = w - tau * ((2 gamma Sigma w - mu) + D'p), masked for the thresholds.
template <int HM, int K>
__device__ __forceinline__ void primal_pre(
    const float (&w)[HM][K], const float (&p)[HM][K],
    const float (&mu)[HM][K], const bool (&valid)[K], const float* Sg,
    float two_gamma, float tau, int H, int N, int lane, float (&vm)[HM][K]) {
  float quad[HM][K];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k) quad[t][k] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int jn = min(32, N - kk * 32);
    for (int jj = 0; jj < jn; ++jj) {
      const float* col = Sg + (size_t)(kk * 32 + jj) * (K * 32) + lane;
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
          const float wj = __shfl_sync(kFull, w[t][kk], jj);
#pragma unroll
          for (int k = 0; k < K; ++k) quad[t][k] += col[k * 32] * wj;
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float g = two_gamma * quad[t][k] - mu[t][k];
        const float nxt = (t + 1 < H) ? p[t + 1][k] : 0.f;
        const float v = w[t][k] - tau * (g + (p[t][k] - nxt));
        vm[t][k] = valid[k] ? v : kNeg;
      }
    }
  }
}

template <int HM, int K, bool ADAPT>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
pdhg_mean_variance_kernel(MvArgs a, MvAdaptArgs ad) {
  extern __shared__ float smem[];
  constexpr int KP = K * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  const int H = a.H, N = a.N;
  const bool live = b < a.B;

  // Sigma into shared memory, [j][i] with zero padding in i.
  const float* Sg;
  if (a.shared) {
    for (int idx = threadIdx.x; idx < N * KP; idx += blockDim.x) {
      const int j = idx / KP, i = idx % KP;
      smem[idx] = i < N ? a.sigma[(size_t)i * N + j] : 0.f;
    }
    __syncthreads();
    Sg = smem;
  } else {
    float* mine = smem + (size_t)warp * N * KP;
    if (live) {
      const float* src = a.sigma + (size_t)b * N * N;
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          mine[(size_t)j * KP + i] = i < N ? src[(size_t)i * N + j] : 0.f;
        }
      }
    }
    __syncwarp();
    Sg = mine;
  }
  if (!live) return;  // after the block barrier; whole warps leave

  bool valid[K];
  float cw[K];
  float w[HM][K], p[HM][K], mu[HM][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    valid[k] = i < N;
    cw[k] = valid[k] ? a.cw[(size_t)b * N + i] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < HM; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mu[t][k] = 0.f;
      p[t][k] = 0.f;
      if (t < H && valid[k])
        mu[t][k] = a.mu[((size_t)b * H + t) * N + k * 32 + lane];
    }
  }

  // L = max(2 gamma ||Sigma||_F, 1e-6); sigma = sigma_scale sqrt(L + 1) / 2;
  // tau = step_scale / (L/2 + 4 sigma).
  float fro2[1] = {0.f};
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float x = Sg[(size_t)j * KP + k * 32 + lane];
      fro2[0] += x * x;
    }
  }
  warp_sum<1>(fro2, 1);
  const float two_gamma = 2.f * a.gamma;
  const float L = jmax(two_gamma * sqrtf(fro2[0]), 1e-6f);
  // Under ADAPT sig, tau and alpha are carried through the loop.
  float sig = a.sigma_scale * sqrtf(L + 1.f) / 2.f;
  float tau = a.step_scale / (0.5f * L + sig * 4.f);
  float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;

  // w0 = cold simplex projection of the current weights on every row.
  float one[HM], thw[HM];
  float vm[HM][K];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    one[t] = 1.f;
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) vm[t][k] = valid[k] ? cw[k] : kNeg;
    }
  }
  threshold<HM, K>(vm, thw, one, H, N, true, a.cold_iters);
#pragma unroll
  for (int t = 0; t < HM; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      w[t][k] = t < H ? jmax(vm[t][k] - thw[t], 0.f) : 0.f;
  }

  const bool warm = a.warm != 0;
  const bool cond = !ADAPT && warm && a.refresh > 1;
  const bool relax = a.rho != 1.f;
  for (int it = 0; it < a.max_iters; ++it) {
    int n_sw;
    if (!warm)
      n_sw = a.cold_iters;
    else if (cond)
      n_sw = (it % a.refresh) == 0 ? a.warm_iters : 1;
    else
      n_sw = a.warm_iters;

    primal_pre<HM, K>(w, p, mu, valid, Sg, two_gamma, tau, H, N, lane, vm);
    threshold<HM, K>(vm, thw, one, H, N, !warm, n_sw);

    float wn[HM][K];
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) wn[t][k] = jmax(vm[t][k] - thw[t], 0.f);
      }
    }
    float pn[HM][K];
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float wb = 2.f * wn[t][k] - w[t][k];
          const float wbp = t == 0 ? cw[k] : 2.f * wn[t - 1][k] - w[t - 1][k];
          const float q = p[t][k] + sig * (wb - wbp);
          pn[t][k] = jmin(jmax(q, -a.c), a.c);
        }
      }
    }
    if constexpr (ADAPT) {
      // Residual balancing (ratio 1.5, alpha *= 0.95), from the moves
      // before over-relaxation: pr = ||dw / tau - D'dp||,
      // dr = ||dp / sigma - D0 dw|| over all rows and assets.
      if (ad.adapt_every <= 1 ||
          (it % ad.adapt_every) == ad.adapt_every - 1) {
        float res[2] = {0.f, 0.f};
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float dw = w[t][k] - wn[t][k];
              const float dp = p[t][k] - pn[t][k];
              const float dpn =
                  (t + 1 < H) ? p[t + 1][k] - pn[t + 1][k] : 0.f;
              const float dwp = t == 0 ? 0.f : w[t - 1][k] - wn[t - 1][k];
              const float e1 = dw / tau - (dp - dpn);
              const float e2 = dp / sig - (dw - dwp);
              res[0] += e1 * e1;
              res[1] += e2 * e2;
            }
          }
        }
        warp_sum<2>(res, 2);
        const float pr = sqrtf(res[0]), dr = sqrtf(res[1]);
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
    }
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (relax) {
            w[t][k] = w[t][k] + a.rho * (wn[t][k] - w[t][k]);
            p[t][k] = p[t][k] + a.rho * (pn[t][k] - p[t][k]);
          } else {
            w[t][k] = wn[t][k];
            p[t][k] = pn[t][k];
          }
        }
      }
    }
  }

  // Extra primal half-step with a cold full-budget projection: the
  // returned iterate is w_last and fp = max |w_last - w|.
  primal_pre<HM, K>(w, p, mu, valid, Sg, two_gamma, tau, H, N, lane, vm);
  threshold<HM, K>(vm, thw, one, H, N, true, a.cold_iters);
  float fp = 0.f;
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (valid[k]) {
          const float wl = jmax(vm[t][k] - thw[t], 0.f);
          fp = jmax(fp, fabsf(wl - w[t][k]));
          a.w_out[((size_t)b * H + t) * N + k * 32 + lane] = wl;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    fp = jmax(fp, __shfl_xor_sync(kFull, fp, o));
  if (lane == 0) a.fp_out[b] = fp;
  if constexpr (ADAPT) {
    if (ad.steps_out != nullptr && lane == 0) {
      float* o = ad.steps_out + (size_t)b * 6;
      o[0] = tau;
      o[1] = sig;
      o[2] = alpha;
      o[3] = pr_last;
      o[4] = dr_last;
      o[5] = moved;
    }
  }
}

// Warps per block: four, or as many per-problem covariances as fit a
// block's shared memory (at least one; the wrapper refuses larger N).
template <int HM, int K, bool ADAPT>
cudaError_t launch(const MvArgs& a, const MvAdaptArgs& ad,
                   cudaStream_t stream) {
  const size_t one_sigma = (size_t)a.N * (K * 32) * sizeof(float);
  if (one_sigma > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  int warps = kMaxWarpsPerBlock;
  size_t smem = one_sigma;
  if (!a.shared) {
    if (one_sigma * warps > (size_t)kSmemPerBlock)
      warps = (int)(kSmemPerBlock / one_sigma);
    smem = one_sigma * warps;
  }
  cudaError_t e = cudaFuncSetAttribute(
      pdhg_mean_variance_kernel<HM, K, ADAPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (a.B + warps - 1) / warps;
  pdhg_mean_variance_kernel<HM, K, ADAPT>
      <<<blocks, warps * 32, smem, stream>>>(a, ad);
  return cudaGetLastError();
}

// Shapes with K = ceil(N/32) <= 4 and pow2ceil(H) * K <= 16 are compiled;
// anything else returns cudaErrorInvalidValue (the wrapper checks first).
// `shared` = 1: sigma is one [N, N] matrix for the whole batch. `schedule`
// is `refresh` for the fixed-step body and `adapt_every` for the adaptive
// one; `steps_out` may be null.
template <bool ADAPT>
int mv_dispatch(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int max_iters, int schedule, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    void* stream) {
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
  const MvAdaptArgs ad = {static_cast<float*>(steps_out),
                          ADAPT ? schedule : 0};
  a.warm_iters = warm_iters;
  a.cold_iters = cold_iters;
  a.c = c;
  a.gamma = gamma;
  a.rho = rho;
  a.step_scale = step_scale;
  a.sigma_scale = sigma_scale;
  a.warm = warm;
  if (B <= 0 || H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (N + 31) / 32;
  int hm = 1;
  while (hm < H) hm <<= 1;

#define KMPC_CASE(HM_, K_) \
  if (hm == HM_ && K == K_) return (int)launch<HM_, K_, ADAPT>(a, ad, s);
  KMPC_CASE(1, 1) KMPC_CASE(2, 1) KMPC_CASE(4, 1) KMPC_CASE(8, 1)
  KMPC_CASE(16, 1)
  KMPC_CASE(1, 2) KMPC_CASE(2, 2) KMPC_CASE(4, 2) KMPC_CASE(8, 2)
  KMPC_CASE(1, 3) KMPC_CASE(2, 3) KMPC_CASE(4, 3)
  KMPC_CASE(1, 4) KMPC_CASE(2, 4) KMPC_CASE(4, 4)
#undef KMPC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
