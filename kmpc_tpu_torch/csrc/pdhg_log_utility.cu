// Fused Condat-Vu PDHG solve of the batched log-utility MPC program.
//
//   min_w  -sum_t log(w_t . r_t) + c sum_t ||w_t - w_{t-1}||_1
//   s.t.   w_t on the simplex,  ||w_t - w_{t-1}||_1 <= tau_to
//
// Replaces the TPU kernel `_make_packed_kernel` (S=None) behind
// `solve_mpc_log_utility_pallas_packed` in kmpc_tpu/ops/mpc_pallas.py: the
// fixed-step bodies `make_body` (warm or cold thresholds) and
// `make_body_cond` (one warm Michelot sweep per iteration, the full budget
// every `refresh`-th), with uniform or per-row (`precond`) steps, ridge,
// over-relaxation, with or without the l1 turnover ball, and the extra
// primal half-step with the fixed-point residual at the end.
//
// Design. One warp owns one problem for the whole solve. Asset i of a row
// sits on lane i % 32, slot i / 32 (K = ceil(N/32) slots); the H rows of
// w, p and r and every temporary live in registers, so one launch runs all
// iterations with no device-memory traffic between them. Every sum over
// assets (portfolio values, Michelot count and sum, the ball's l1) is a
// __shfl_xor_sync butterfly, after which the thresholds are warp-uniform
// scalars: the threshold recursion, the refresh predicate and the
// warm/cold choice never diverge. Padded asset slots carry -1e30 in the
// threshold inputs (the TPU kernel's mask rule), so they never enter an
// active set. The kernel reads the public [B, H, N] layout directly.
//
// Bound. A problem moves (H*N*2 + N + 1)*4 bytes once, but does ~30 FP32
// operations per element and ~5*(2 + 2*sweeps + 3) shuffles per horizon row
// per iteration, so it is bound by the FP32 and shuffle pipes, never by
// HBM. Registers: ~7 live [H][K] arrays per lane, hence the cap on
// pow2ceil(H) * K checked by the wrapper.
//
// Arithmetic follows the TPU kernel operation for operation (jnp.maximum /
// minimum propagate NaN, so jmax / jmin do too; no fast-math intrinsics).

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

struct Args {
  const float* cw;   // [B, N] current weights
  const float* r;    // [B, H, N] gross returns exp(y)
  float* w_out;      // [B, H, N] extra-half-step iterate
  float* fp_out;     // [B] fixed-point residual
  int B, H, N;
  int max_iters, refresh, warm_iters, cold_iters;
  float c, tau_to, ridge, rho, step_scale, sigma_scale;
  int precond, use_ball, warm;
};

__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// x[t] <- sum over the warp's lanes, for every row t < H.
template <int HM>
__device__ __forceinline__ void warp_sum(float (&x)[HM], int H) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < HM; ++t)
      if (t < H) x[t] += __shfl_xor_sync(kFull, x[t], o);
  }
}

// One Michelot/Newton sweep per row: theta <- (sum_{v > theta} v - rad) /
// max(count, 1), over the pre-masked values vm.
template <int HM, int K>
__device__ __forceinline__ void sweep(const float (&vm)[HM][K],
                                      float (&theta)[HM],
                                      const float (&rad)[HM], int H) {
  float cnt[HM], s[HM];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    cnt[t] = 0.f;
    s[t] = 0.f;
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool a = vm[t][k] > theta[t];
        cnt[t] += a ? 1.f : 0.f;
        s[t] += a ? vm[t][k] : 0.f;
      }
    }
  }
  warp_sum<HM>(cnt, H);
  warp_sum<HM>(s, H);
#pragma unroll
  for (int t = 0; t < HM; ++t)
    if (t < H) theta[t] = (s[t] - rad[t]) / jmax(cnt[t], 1.f);
}

// Threshold of the simplex (rad = 1) or of the ball: a cold start
// (sum of the unmasked values - rad) / N followed by n sweeps, or n sweeps
// from the carried theta.
template <int HM, int K>
__device__ __forceinline__ void threshold(const float (&vm)[HM][K],
                                          float (&theta)[HM],
                                          const float (&rad)[HM], int H,
                                          int N, bool cold, int n) {
  if (cold) {
    float s[HM];
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      s[t] = 0.f;
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          s[t] += vm[t][k] > 0.5f * kNeg ? vm[t][k] : 0.f;
      }
    }
    warp_sum<HM>(s, H);
#pragma unroll
    for (int t = 0; t < HM; ++t)
      if (t < H) theta[t] = (s[t] - rad[t]) / (float)N;
  }
  for (int i = 0; i < n; ++i) sweep<HM, K>(vm, theta, rad, H);
}

template <int HM, int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pdhg_log_utility_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= a.B) return;  // whole warp leaves together
  const int H = a.H, N = a.N;

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
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = k * 32 + lane;
        r[t][k] = valid[k] ? a.r[((size_t)b * H + t) * N + i] : 0.f;
        p[t][k] = 0.f;
      }
    }
  }

  // Per-problem Lipschitz bound and steps (uniform, or per row).
  float ratio[HM];
  {
    float n2[HM], mn[HM];
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      n2[t] = 0.f;
      mn[t] = __int_as_float(0x7f800000);  // +inf
      if (t < H) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          n2[t] += r[t][k] * r[t][k];
          if (valid[k]) mn[t] = jmin(mn[t], r[t][k]);
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
      if (t < H) {
        const float m = jmax(mn[t], 1e-12f);
        ratio[t] = n2[t] / (m * m);
      }
    }
  }
  float sig[HM], tau[HM], sig_tau[HM], c1[HM], one[HM];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    sig[t] = 0.f;
    tau[t] = 0.f;
  }
  {
    float mx = ratio[0];
#pragma unroll
    for (int t = 1; t < HM; ++t)
      if (t < H) mx = jmax(mx, ratio[t]);
    const float L = mx + a.ridge;  // max_t (ratio_t + ridge)
    if (a.precond) {
      const float s0 = a.sigma_scale * sqrtf(L) / 2.f;
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        if (t < H) {
          const float rowdeg = t == 0 ? 1.f : 2.f;
          const float coldeg = t == H - 1 ? 1.f : 2.f;
          sig[t] = 2.f * s0 / rowdeg;
          tau[t] = a.step_scale / (0.5f * (ratio[t] + a.ridge) +
                                   2.f * s0 * coldeg);
        }
      }
    } else {
      const float s = a.sigma_scale * sqrtf(L) / 2.f;
      const float tp = a.step_scale / (0.5f * L + s * 4.f);
#pragma unroll
      for (int t = 0; t < HM; ++t) {
        sig[t] = s;
        tau[t] = tp;
      }
    }
#pragma unroll
    for (int t = 0; t < HM; ++t) {
      sig_tau[t] = sig[t] * a.tau_to;
      c1[t] = 1.f - tau[t] * a.ridge;
      one[t] = 1.f;
    }
  }

  // w0 = cold simplex projection of the current weights on every row.
  float thw[HM], thp[HM];
  float vm[HM][K];
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    thp[t] = 0.f;
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) vm[t][k] = valid[k] ? cw[k] : kNeg;
    }
  }
  threshold<HM, K>(vm, thw, one, H, N, true, a.cold_iters);
#pragma unroll
  for (int t = 0; t < HM; ++t) {
    if (t < H) {
#pragma unroll
      for (int k = 0; k < K; ++k) w[t][k] = jmax(vm[t][k] - thw[t], 0.f);
    }
  }

  const bool warm = a.warm != 0;
  const bool cond = warm && a.refresh > 1;  // make_body_cond
  const bool ridge0 = a.ridge == 0.f;
  const bool relax = a.rho != 1.f;
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
        const float f = tau[t] / jmax(port[t], 1e-12f);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float g = r[t][k] * f;
          const float nxt = (t + 1 < H) ? p[t + 1][k] : 0.f;
          const float base = ridge0 ? w[t][k] : c1[t] * w[t][k];
          const float v = base + (g - tau[t] * (p[t][k] - nxt));
          vm[t][k] = valid[k] ? v : kNeg;
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
      float l1[HM];
      if (!warm) {
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          l1[t] = 0.f;
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) l1[t] += valid[k] ? aq[t][k] : 0.f;
          }
        }
        warp_sum<HM>(l1, H);
        threshold<HM, K>(aq, thp, sig_tau, H, N, true, n_sw);
      } else {
        // Warm: l1 rides the first sweep's reductions.
        float cnt[HM], s[HM];
#pragma unroll
        for (int t = 0; t < HM; ++t) {
          cnt[t] = 0.f;
          s[t] = 0.f;
          l1[t] = 0.f;
          if (t < H) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const bool act = aq[t][k] > thp[t];
              cnt[t] += act ? 1.f : 0.f;
              s[t] += act ? aq[t][k] : 0.f;
              l1[t] += valid[k] ? aq[t][k] : 0.f;
            }
          }
        }
        warp_sum<HM>(cnt, H);
        warp_sum<HM>(s, H);
        warp_sum<HM>(l1, H);
#pragma unroll
        for (int t = 0; t < HM; ++t)
          if (t < H) thp[t] = (s[t] - sig_tau[t]) / jmax(cnt[t], 1.f);
        threshold<HM, K>(aq, thp, sig_tau, H, N, false, n_sw - 1);
      }
#pragma unroll
      for (int t = 0; t < HM; ++t)
        if (t < H)
          bound[t] = a.c + (l1[t] <= sig_tau[t] ? 0.f : jmax(thp[t], 0.f));
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

  // Extra primal half-step with a cold full-budget projection; the
  // returned iterate is w_last and fp = max |w_last - w|.
  {
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
        const float f = -1.f / jmax(port[t], 1e-12f);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float g = r[t][k] * f;
          if (!ridge0) g = g + a.ridge * w[t][k];
          const float nxt = (t + 1 < H) ? p[t + 1][k] : 0.f;
          const float v = w[t][k] - tau[t] * (g + (p[t][k] - nxt));
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
  }
}

template <int HM, int K>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pdhg_log_utility_kernel<HM, K><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shapes with K = ceil(N/32) <= 4 and pow2ceil(H) * K <= 16 are compiled;
// anything else returns cudaErrorInvalidValue (the wrapper checks first).
// The cap is measured: at pow2ceil(H) * K = 24 and 32 ptxas runs out of the
// 255 registers and spills hundreds of bytes to local memory per thread; at
// 16 only the (HM=16, K=1) instantiation spills (260 bytes).
extern "C" int kmpc_pdhg_log_utility(
    const void* cw, const void* r, void* w_out, void* fp_out, int B, int H,
    int N, int max_iters, int refresh, int warm_iters, int cold_iters,
    float c, float tau_to, float ridge, float rho, float step_scale,
    float sigma_scale, int precond, int use_ball, int warm, void* stream) {
  Args a;
  a.cw = static_cast<const float*>(cw);
  a.r = static_cast<const float*>(r);
  a.w_out = static_cast<float*>(w_out);
  a.fp_out = static_cast<float*>(fp_out);
  a.B = B;
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
  if (B <= 0 || H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (N + 31) / 32;
  int hm = 1;
  while (hm < H) hm <<= 1;

#define KMPC_CASE(HM_, K_) \
  if (hm == HM_ && K == K_) return (int)launch<HM_, K_>(a, s);
  KMPC_CASE(1, 1) KMPC_CASE(2, 1) KMPC_CASE(4, 1) KMPC_CASE(8, 1)
  KMPC_CASE(16, 1)
  KMPC_CASE(1, 2) KMPC_CASE(2, 2) KMPC_CASE(4, 2) KMPC_CASE(8, 2)
  KMPC_CASE(1, 3) KMPC_CASE(2, 3) KMPC_CASE(4, 3)
  KMPC_CASE(1, 4) KMPC_CASE(2, 4) KMPC_CASE(4, 4)
#undef KMPC_CASE
  return (int)cudaErrorInvalidValue;
}
