// Fused Condat-Vu PDHG solve of the batched log-utility MPC program, for one
// deterministic forecast (SCEN = false) or for the mean over S Monte-Carlo
// scenarios (SCEN = true, the stochastic-Kelly program):
//
//   min_w  -(1/S) sum_s sum_t log(w_t . r^s_t) + c sum_t ||w_t - w_{t-1}||_1
//   s.t.   w_t on the simplex,  ||w_t - w_{t-1}||_1 <= tau_to
//
// Replaces the TPU kernel `_make_packed_kernel` in
// kmpc_tpu/ops/mpc_pallas.py, behind `solve_mpc_log_utility_pallas_packed`
// (S=None) and `solve_mpc_log_utility_scenarios_packed` (S set): the
// fixed-step bodies `make_body` (warm or cold thresholds) and
// `make_body_cond` (one warm Michelot sweep per iteration, the full budget
// every `refresh`-th), with uniform or per-row (`precond`) steps, ridge,
// over-relaxation, with or without the l1 turnover ball, optional warm
// primal/dual iterates, an optional dual output, and the extra primal
// half-step with the fixed-point residual at the end. With ADAPT = true the
// loop is `body_adaptive` instead: residual-balancing steps carried through
// the loop (per horizon row under precond, one factor per problem), the
// smooth gradient with tau outside the portfolio reciprocal, the dual prox
// on the a-scale (v = q / sigma, ball radius tau_to), the full projection
// budget every iteration, and on every `adapt_every`-th iteration the
// primal and dual residuals, one butterfly each over the per-lane partial
// sums of all rows, which decide warp-uniformly how the steps move. The
// TPU kernel block-unrolls that schedule to avoid a conditional; here the
// predicate is warp-uniform and a plain branch. ADAPT is a template flag,
// instantiated in sources of its own, so the fixed-step instantiations keep
// their registers.
//
// Design. One warp owns one problem for the whole solve. Asset i of a row
// sits on lane i % 32, slot i / 32 (K = ceil(N/32) slots); the H rows of
// w and p and every temporary live in registers, so one launch runs all
// iterations with no device-memory traffic between them. Every sum over
// assets (portfolio values, Michelot count and sum, the ball's l1) is a
// __shfl_xor_sync butterfly, after which the thresholds are warp-uniform
// scalars: the threshold recursion, the refresh predicate and the
// warm/cold choice never diverge. The kernel reads the public [B, H, N]
// layout directly. With SCEN = false the returns r live in registers too.
// With SCEN = true a problem's S*H*N returns do not fit registers: the
// warp stages them once in its slice of shared memory, [S][H][K*32] with
// zeros in the padded slots (a lane reads back only what it wrote, no bank
// conflicts), and walks the scenarios s = 0..S-1 in order every iteration,
// one butterfly per scenario and row.
//
// Bound. A problem moves its inputs and outputs once, but does ~30 FP32
// operations per element and ~5*(2 + 2*sweeps + 3) shuffles per horizon row
// per iteration (plus 5 shuffles and ~4 operations per element per
// scenario and row), so it is bound by the FP32 and shuffle pipes, never by
// HBM. Registers: ~7 live [H][K] arrays per lane, hence the cap on
// pow2ceil(H) * K checked by the wrapper; shared memory: S*H*K*32 floats
// per warp, which sets the warps per block of the scenario kernel.
//
// Arithmetic follows the TPU kernel operation for operation (no fast-math
// intrinsics). In the fixed-step bodies tau is folded into the portfolio
// reciprocal per scenario, before the scenario mean, as there; the adaptive
// body recomputes 1 / sigma and c / sigma every iteration and divides the
// residuals' terms by the carried steps, as there.

#pragma once

#include "pdhg_common.cuh"

namespace {

struct Args {
  const float* cw;      // [B, N] current weights
  const float* r;       // [B, H, N] or [B, S, H, N] gross returns exp(y)
  const float* w_warm;  // [B, H, N] warm primal, or null
  const float* p_warm;  // [B, H, N] warm dual, or null (zeros)
  float* w_out;         // [B, H, N] extra-half-step iterate
  float* fp_out;        // [B] fixed-point residual
  float* p_out;         // [B, H, N] the loop's last dual, or null
  int B, S, H, N;
  int max_iters, refresh, warm_iters, cold_iters;
  float c, tau_to, ridge, rho, step_scale, sigma_scale;
  int precond, use_ball, warm;
};

// What only the adaptive body reads, apart from Args so that the fixed-step
// instantiations keep the argument block they had.
struct AdaptArgs {
  float* steps_out;  // [B, 2 H + 4]: the last tau and sigma of every row,
                     // alpha, the primal and dual residual of the last
                     // balancing, and the signed sum of the iterations that
                     // moved the steps (+it grew tau, -it shrank it), which
                     // two equal step histories share; or null
  int adapt_every;   // balance when it % k == k - 1
};

// g[t][k] = r[t][k] * scale[t] / max(w_t . r_t, 1e-12); with SCEN the mean
// over the scenarios of the same expression, summed in the order s = 0..S-1.
template <int HM, int K, bool SCEN>
__device__ __forceinline__ void scaled_returns(
    const float (&w)[HM][K], const float (&r)[HM][K], const float* rs,
    const float (&scale)[HM], int S, int H, int lane, float (&g)[HM][K]) {
  if constexpr (!SCEN) {
    float port[HM];
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      port[t] = 0.f;
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) port[t] += w[t][k] * r[t][k];
      }
    }
    warp_sum<HM>(port, H);
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
        const float f = scale[t] / jmax(port[t], 1e-12f);
#pragma unroll
        for (int k = 0; k < K; ++k) g[t][k] = r[t][k] * f;
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < HM; ++t) {
#pragma unroll
      for (int k = 0; k < K; ++k) g[t][k] = 0.f;
    }
    for (int s = 0; s < S; ++s) {
      const float* rr = rs + (size_t)s * H * (K * 32) + lane;
      float port[HM];
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        port[t] = 0.f;
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            port[t] += w[t][k] * rr[(t * K + k) * 32];
        }
      }
      warp_sum<HM>(port, H);
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
          const float f = scale[t] / jmax(port[t], 1e-12f);
#pragma unroll
          for (int k = 0; k < K; ++k) g[t][k] += rr[(t * K + k) * 32] * f;
        }
      }
    }
    const float fS = (float)S;
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) g[t][k] = g[t][k] / fS;
      }
    }
  }
}

// ratio[t] = ||r_t||^2 / max(min_i r_t[i], 1e-12)^2 over the valid assets
// of the rows x[t][k] (padded slots hold 0).
template <int HM, int K>
__device__ __forceinline__ void curvature_ratio(const float (&x)[HM][K],
                                                const bool (&valid)[K], int H,
                                                float (&ratio)[HM]) {
  float n2[HM], mn[HM];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    n2[t] = 0.f;
    mn[t] = __int_as_float(0x7f800000);  // +inf
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        n2[t] += x[t][k] * x[t][k];
        if (valid[k]) mn[t] = jmin(mn[t], x[t][k]);
      }
    }
  }
  warp_sum<HM>(n2, H);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < HM; ++t)
      if (t < H) mn[t] = jmin(mn[t], __shfl_xor_sync(kFull, mn[t], o));
  }
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    ratio[t] = 0.f;
    if (t < H) {
      const float m = jmax(mn[t], 1e-12f);
      ratio[t] = n2[t] / (m * m);
    }
  }
}

// The l1 ball's share of the dual bound, per row: 0 where the masked
// magnitudes am lie inside the ball (their l1 <= rad), else max(theta, 0)
// with theta the ball's threshold after n_sw sweeps: from a cold start, or
// (warm) from the carried theta, the l1 riding the first sweep's reductions.
template <int HM, int K>
__device__ __forceinline__ void ball_excess(
    const float (&am)[HM][K], const bool (&valid)[K], float (&thp)[HM],
    const float (&rad)[HM], int H, int N, bool warm, int n_sw,
    float (&excess)[HM]) {
  float l1[HM];
  if (!warm) {
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      l1[t] = 0.f;
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) l1[t] += valid[k] ? am[t][k] : 0.f;
      }
    }
    warp_sum<HM>(l1, H);
    threshold<HM, K>(am, thp, rad, H, N, true, n_sw);
  } else {
    float cnt[HM], s[HM];
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      cnt[t] = 0.f;
      s[t] = 0.f;
      l1[t] = 0.f;
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool act = am[t][k] > thp[t];
          cnt[t] += act ? 1.f : 0.f;
          s[t] += act ? am[t][k] : 0.f;
          l1[t] += valid[k] ? am[t][k] : 0.f;
        }
      }
    }
    warp_sum<HM>(cnt, H);
    warp_sum<HM>(s, H);
    warp_sum<HM>(l1, H);
#pragma unroll
    for (int t = 0; t < HM; ++t)
      if (t < H) thp[t] = (s[t] - rad[t]) / jmax(cnt[t], 1.f);
    threshold<HM, K>(am, thp, rad, H, N, false, n_sw - 1);
  }
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    excess[t] = 0.f;
    if (t < H) excess[t] = l1[t] <= rad[t] ? 0.f : jmax(thp[t], 0.f);
  }
}

template <int HM, int K, bool SCEN, bool ADAPT>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
pdhg_log_utility_kernel(Args a, AdaptArgs ad) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;  // whole warp leaves together; no block barriers
  const int H = a.H, N = a.N, S = a.S;

  bool valid[K];
  float cw[K];
  float w[HM][K], p[HM][K], r[HM][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    valid[k] = i < N;
    cw[k] = valid[k] ? a.cw[(size_t)b * N + i] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < HM; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k) r[t][k] = 0.f;
  }

  // Returns into registers (or shared memory), and the curvature bounds:
  // Lrow[t] per horizon row (used under precond) and the global L.
  float* rs = nullptr;
  float Lrow[HM], L;
  if constexpr (!SCEN) {
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          r[t][k] = valid[k] ? a.r[((size_t)b * H + t) * N + i] : 0.f;
        }
      }
    }
    float ratio[HM];
    curvature_ratio<HM, K>(r, valid, H, ratio);
    float mx = ratio[0];
#pragma unroll
    for (int t = 1; t < HM; ++t)
      if (t < H) mx = jmax(mx, ratio[t]);
    L = mx + a.ridge;  // max_t (ratio_t + ridge)
#pragma unroll
    for (int t = 0; t < HM; ++t) Lrow[t] = ratio[t] + a.ridge;
  } else {
    rs = smem + (size_t)warp * S * H * (K * 32);
    float row_sum[HM], max_sum = 0.f;
#pragma unroll
    for (int t = 0; t < HM; ++t) row_sum[t] = 0.f;
    for (int s = 0; s < S; ++s) {
      float x[HM][K];
#pragma unroll
      for (int t = 0; t < HM; ++t) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          x[t][k] = 0.f;
          if (t < H) {
            const int i = k * 32 + lane;
            if (valid[k])
              x[t][k] = a.r[(((size_t)b * S + s) * H + t) * N + i];
            rs[((size_t)(s * H + t) * K + k) * 32 + lane] = x[t][k];
          }
        }
      }
      float ratio[HM];
      curvature_ratio<HM, K>(x, valid, H, ratio);
      float mx = ratio[0];
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
          mx = jmax(mx, ratio[t]);
          row_sum[t] += ratio[t];
        }
      }
      max_sum += mx;
    }
    __syncwarp();
    const float fS = (float)S;
    if (a.precond) {
      // Per-row bound: the scenario mean of the rows; the global scale
      // from the max of those means.
      L = 0.f;
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        Lrow[t] = row_sum[t] / fS + a.ridge;
        if (t < H) L = t == 0 ? Lrow[0] : jmax(L, Lrow[t]);
      }
    } else {
      // Scenario mean of the per-scenario max over the horizon.
      L = max_sum / fS + a.ridge;
#pragma unroll
      for (int t = 0; t < HM; ++t) Lrow[t] = L;
    }
  }

  float sig[HM], tau[HM], sig_tau[HM], c1[HM], one[HM], minus_one[HM];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    sig[t] = 0.f;
    tau[t] = 0.f;
  }
  {
    const float s0 = a.sigma_scale * sqrtf(L) / 2.f;
    if (a.precond) {
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
          const float rowdeg = t == 0 ? 1.f : 2.f;
          const float coldeg = t == H - 1 ? 1.f : 2.f;
          sig[t] = 2.f * s0 / rowdeg;
          tau[t] = a.step_scale / (0.5f * Lrow[t] + 2.f * s0 * coldeg);
        }
      }
    } else {
      const float tp = a.step_scale / (0.5f * L + s0 * 4.f);
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        sig[t] = s0;
        tau[t] = tp;
      }
    }
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      sig_tau[t] = sig[t] * a.tau_to;
      c1[t] = 1.f - tau[t] * a.ridge;
      one[t] = 1.f;
      minus_one[t] = -1.f;
    }
  }

  // Start: the cold simplex projection of the current weights on every
  // row with a zero dual; or the warm iterates as given, with a cold
  // threshold taken on the warm primal. The ball threshold starts at 0.
  float thw[HM], thp[HM];
  float vm[HM][K];
  const bool warm_start = a.w_warm != nullptr;
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    thp[t] = 0.f;
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const size_t at = ((size_t)b * H + t) * N + k * 32 + lane;
        float x = cw[k];
        if (warm_start) x = valid[k] ? a.w_warm[at] : 0.f;
        vm[t][k] = valid[k] ? x : kNeg;
        w[t][k] = x;
        p[t][k] = (warm_start && a.p_warm != nullptr && valid[k])
                      ? a.p_warm[at] : 0.f;
      }
    }
  }
  threshold<HM, K>(vm, thw, one, H, N, true, a.cold_iters);
  if (!warm_start) {
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) w[t][k] = jmax(vm[t][k] - thw[t], 0.f);
      }
    }
  }

  const bool warm = a.warm != 0;
  const bool ridge0 = a.ridge == 0.f;
  const bool relax = a.rho != 1.f;
  if constexpr (!ADAPT) {
    const bool cond = warm && a.refresh > 1;  // make_body_cond
    for (int it = 0; it < a.max_iters; ++it) {
      int n_sw;
      if (!warm)
        n_sw = a.cold_iters;
      else if (cond)
        n_sw = (it % a.refresh) == 0 ? a.warm_iters : 1;
      else
        n_sw = a.warm_iters;

      // Primal step: w - tau (grad g(w) + ridge w + D'p), tau folded into the
      // portfolio reciprocal and the ridge into c1.
      {
        float g[HM][K];
        scaled_returns<HM, K, SCEN>(w, r, rs, tau, S, H, lane, g);
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float nxt = (t + 1 < H) ? p[t + 1][k] : 0.f;
              const float base = ridge0 ? w[t][k] : c1[t] * w[t][k];
              const float v = base + (g[t][k] - tau[t] * (p[t][k] - nxt));
              vm[t][k] = valid[k] ? v : kNeg;
            }
          }
        }
      }
      threshold<HM, K>(vm, thw, one, H, N, !warm, n_sw);

      // w_new, the extrapolation 2 w_new - w, and q = p + sigma D(w_bar).
      float wn[HM][K], q[HM][K];
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k) wn[t][k] = jmax(vm[t][k] - thw[t], 0.f);
        }
      }
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float wb = 2.f * wn[t][k] - w[t][k];
            const float wbp = t == 0 ? cw[k] : 2.f * wn[t - 1][k] - w[t - 1][k];
            q[t][k] = p[t][k] + sig[t] * (wb - wbp);
          }
        }
      }

      // Dual prox on the q scale, clip form: clip(q, -bound, bound) with
      // bound = c inside the ball, c + max(theta, 0) outside.
      float bound[HM];
      if (a.use_ball) {
        float aq[HM][K];
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float x = jmax(fabsf(q[t][k]) - a.c, 0.f);
              aq[t][k] = valid[k] ? x : kNeg;
            }
          }
        }
        float excess[HM];
        ball_excess<HM, K>(aq, valid, thp, sig_tau, H, N, warm, n_sw, excess);
#pragma unroll
        for (int t = 0; t < HM; ++t) bound[t] = a.c + excess[t];
      } else {
#pragma unroll
        for (int t = 0; t < HM; ++t) bound[t] = a.c;
      }

#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float pn = jmin(jmax(q[t][k], -bound[t]), bound[t]);
            if (relax) {
              w[t][k] = w[t][k] + a.rho * (wn[t][k] - w[t][k]);
              p[t][k] = p[t][k] + a.rho * (pn - p[t][k]);
            } else {
              w[t][k] = wn[t][k];
              p[t][k] = pn;
            }
          }
        }
      }
    }
  } else {
    // body_adaptive. tau and sig are the carried steps from here on (the
    // tail then steps by the last tau); alpha is one scalar per problem.
    float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;
    float rad[HM];
#pragma unroll
    for (int t = 0; t < HM; ++t) rad[t] = a.tau_to;
    const int n_sw = warm ? a.warm_iters : a.cold_iters;
    for (int it = 0; it < a.max_iters; ++it) {
      // Primal step: w - tau (grad g(w) + ridge w + D'p).
      {
        float g[HM][K];
        scaled_returns<HM, K, SCEN>(w, r, rs, minus_one, S, H, lane, g);
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              float gg = g[t][k];
              if (!ridge0) gg = gg + a.ridge * w[t][k];
              const float nxt = (t + 1 < H) ? p[t + 1][k] : 0.f;
              const float v = w[t][k] - tau[t] * (gg + (p[t][k] - nxt));
              vm[t][k] = valid[k] ? v : kNeg;
            }
          }
        }
      }
      threshold<HM, K>(vm, thw, one, H, N, !warm, n_sw);

      // w_new, and q = p + sigma D(2 w_new - w).
      float wn[HM][K], q[HM][K];
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k) wn[t][k] = jmax(vm[t][k] - thw[t], 0.f);
        }
      }
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float wb = 2.f * wn[t][k] - w[t][k];
            const float wbp = t == 0 ? cw[k] : 2.f * wn[t - 1][k] - w[t - 1][k];
            q[t][k] = p[t][k] + sig[t] * (wb - wbp);
          }
        }
      }

      // Dual prox on the a-scale: v = q / sigma, a = max(|v| - c / sigma, 0),
      // the ball of radius tau_to, p_new = q - sigma (v - clip(v, +-bound)).
      float inv_s[HM], bound[HM];
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        inv_s[t] = t < H ? 1.f / sig[t] : 0.f;
        bound[t] = a.c * inv_s[t];
      }
      if (a.use_ball) {
        float am[HM][K];
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float x = jmax(fabsf(q[t][k] * inv_s[t]) - bound[t], 0.f);
              am[t][k] = valid[k] ? x : kNeg;
            }
          }
        }
        float excess[HM];
        ball_excess<HM, K>(am, valid, thp, rad, H, N, warm, n_sw, excess);
#pragma unroll
        for (int t = 0; t < HM; ++t) bound[t] = bound[t] + excess[t];
      }
      // q becomes p_new.
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float v = q[t][k] * inv_s[t];
            const float inner = v - jmin(jmax(v, -bound[t]), bound[t]);
            q[t][k] = q[t][k] - sig[t] * inner;
          }
        }
      }

      // Residual balancing (ratio 1.5, alpha *= 0.95), from the moves before
      // over-relaxation: pr = ||dw / tau - D'dp||, dr = ||dp / sigma - D0 dw||
      // over all rows and assets of the problem.
      if (ad.adapt_every <= 1 ||
          (it % ad.adapt_every) == ad.adapt_every - 1) {
        float res[2] = {0.f, 0.f};
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float dw = w[t][k] - wn[t][k];
              const float dp = p[t][k] - q[t][k];
              const float dpn = (t + 1 < H) ? p[t + 1][k] - q[t + 1][k] : 0.f;
              const float dwp = t == 0 ? 0.f : w[t - 1][k] - wn[t - 1][k];
              const float e1 = dw / tau[t] - (dp - dpn);
              const float e2 = dp / sig[t] - (dw - dwp);
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
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          if (t < H) {
            if (big_p) {
              tau[t] = tau[t] / shrink;
              sig[t] = sig[t] * shrink;
            } else if (big_d) {
              tau[t] = tau[t] * shrink;
              sig[t] = sig[t] / shrink;
            }
          }
        }
        if (big_p || big_d) alpha = alpha * 0.95f;
        if (big_p) moved += (float)(it + 1);
        if (!big_p && big_d) moved -= (float)(it + 1);
      }

#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (relax) {
              w[t][k] = w[t][k] + a.rho * (wn[t][k] - w[t][k]);
              p[t][k] = p[t][k] + a.rho * (q[t][k] - p[t][k]);
            } else {
              w[t][k] = wn[t][k];
              p[t][k] = q[t][k];
            }
          }
        }
      }
    }
    if (ad.steps_out != nullptr && lane == 0) {
      float* o = ad.steps_out + (size_t)b * (2 * H + 4);
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
          o[t] = tau[t];
          o[H + t] = sig[t];
        }
      }
      o[2 * H] = alpha;
      o[2 * H + 1] = pr_last;
      o[2 * H + 2] = dr_last;
      o[2 * H + 3] = moved;
    }
  }

  // Extra primal half-step with a cold full-budget projection; the
  // returned iterate is w_last and fp = max |w_last - w|. The dual written
  // out is the loop's last p.
  {
    float g[HM][K];
    scaled_returns<HM, K, SCEN>(w, r, rs, minus_one, S, H, lane, g);
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float gg = g[t][k];
          if (!ridge0) gg = gg + a.ridge * w[t][k];
          const float nxt = (t + 1 < H) ? p[t + 1][k] : 0.f;
          const float v = w[t][k] - tau[t] * (gg + (p[t][k] - nxt));
          vm[t][k] = valid[k] ? v : kNeg;
        }
      }
    }
    threshold<HM, K>(vm, thw, one, H, N, true, a.cold_iters);
    float fp = 0.f;
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (valid[k]) {
            const size_t at = ((size_t)b * H + t) * N + k * 32 + lane;
            const float wl = jmax(vm[t][k] - thw[t], 0.f);
            fp = jmax(fp, fabsf(wl - w[t][k]));
            a.w_out[at] = wl;
            if (a.p_out != nullptr) a.p_out[at] = p[t][k];
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      fp = jmax(fp, __shfl_xor_sync(kFull, fp, o));
    if (lane == 0) a.fp_out[b] = fp;
  }
}

// Warps per block: four, or as many problems' returns as fit a block's
// shared memory (at least one; the wrapper refuses shapes beyond that).
template <int HM, int K, bool SCEN, bool ADAPT>
cudaError_t launch(const Args& a, const AdaptArgs& ad,
                   cudaStream_t stream) {
  int warps = kMaxWarpsPerBlock;
  size_t smem = 0;
  if (SCEN) {
    const size_t per_warp = (size_t)a.S * a.H * (K * 32) * sizeof(float);
    if (per_warp > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
    if (per_warp * warps > (size_t)kSmemPerBlock)
      warps = (int)(kSmemPerBlock / per_warp);
    smem = per_warp * warps;
    cudaError_t e = cudaFuncSetAttribute(
        pdhg_log_utility_kernel<HM, K, SCEN, ADAPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.B + warps - 1) / warps;
  pdhg_log_utility_kernel<HM, K, SCEN, ADAPT>
      <<<blocks, warps * 32, smem, stream>>>(a, ad);
  return cudaGetLastError();
}

// Shapes with K = ceil(N/32) <= 4 and pow2ceil(H) * K <= 16 are compiled;
// anything else returns cudaErrorInvalidValue (the wrapper checks first).
// The cap is measured: at pow2ceil(H) * K = 24 and 32 ptxas runs out of the
// 255 registers and spills hundreds of bytes to local memory per thread.
template <bool SCEN, bool ADAPT>
int dispatch(const Args& a, const AdaptArgs& ad, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0 || (SCEN && a.S <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (a.N + 31) / 32;
  int hm = 1;
  while (hm < a.H) hm <<= 1;

#define KMPC_CASE(HM_, K_) \
  if (hm == HM_ && K == K_) return (int)launch<HM_, K_, SCEN, ADAPT>(a, ad, s);
  KMPC_CASE(1, 1) KMPC_CASE(2, 1) KMPC_CASE(4, 1) KMPC_CASE(8, 1)
  KMPC_CASE(16, 1)
  KMPC_CASE(1, 2) KMPC_CASE(2, 2) KMPC_CASE(4, 2) KMPC_CASE(8, 2)
  KMPC_CASE(1, 3) KMPC_CASE(2, 3) KMPC_CASE(4, 3)
  KMPC_CASE(1, 4) KMPC_CASE(2, 4) KMPC_CASE(4, 4)
#undef KMPC_CASE
  return (int)cudaErrorInvalidValue;
}

inline Args make_args(
    const void* cw, const void* r, const void* w_warm, const void* p_warm,
    void* w_out, void* fp_out, void* p_out, int B, int S, int H, int N,
    int max_iters, int refresh, int warm_iters, int cold_iters, float c,
    float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm) {
  Args a;
  a.cw = static_cast<const float*>(cw);
  a.r = static_cast<const float*>(r);
  a.w_warm = static_cast<const float*>(w_warm);
  a.p_warm = static_cast<const float*>(p_warm);
  a.w_out = static_cast<float*>(w_out);
  a.fp_out = static_cast<float*>(fp_out);
  a.p_out = static_cast<float*>(p_out);
  a.B = B;
  a.S = S;
  a.H = H;
  a.N = N;
  a.max_iters = max_iters;
  a.refresh = refresh;
  a.warm_iters = warm_iters;
  a.cold_iters = cold_iters;
  a.c = c;
  a.tau_to = tau_to;
  a.ridge = ridge;
  a.rho = rho;
  a.step_scale = step_scale;
  a.sigma_scale = sigma_scale;
  a.precond = precond;
  a.use_ball = use_ball;
  a.warm = warm;
  return a;
}

}  // namespace
