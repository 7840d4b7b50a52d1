// The log-utility PDHG solve in a block-per-problem layout, for the shapes
// whose iterates do not fit one warp's registers (pdhg_log_utility.cuh caps
// pow2ceil(H) * ceil(N/32) at 16): long horizons (H=20), many assets
// (N=500), many scenarios. The same program and arithmetic as the warp
// kernels: `_make_packed_kernel` of kmpc_tpu/ops/mpc_pallas.py with S=None
// or S set, its bodies `make_body` (warm or cold thresholds),
// `make_body_cond` (refresh schedule), `make_trip_pipe` (`pipe`, the
// pipelined reductions) and, with ADAPT, `body_adaptive`; precond, ridge,
// over-relaxation, ball on or off, warm inputs, the dual output and the
// extra primal half-step with the fixed-point residual.
//
// Design. One CTA owns one problem, 32 * ceil(N/32) threads up to 512 (a
// warp per 32 assets; beyond 512 assets a thread walks several). The
// problem lives in shared memory for the whole solve, each array [H][N]
// (r, w, p, the projection input, the dual input; r once per scenario), and
// thread j owns the asset columns j, j + T, ...: it walks its columns row by
// row, so every elementwise phase (the primal step with D'p, the
// extrapolation with D(2 w_new - w), the clip, over-relaxation) touches only
// its own columns and needs no barrier. Only the sums over assets cross
// threads. Each is a stacked reduce: every quantity of a phase (all H rows,
// and count, masked sum and l1 together, and the portfolio values of every
// scenario) is summed per warp by butterfly, eight at a time, staged in
// shared memory, and after one __syncthreads one thread per row combines
// the warps' sums pairwise and writes the row's result (a threshold,
// the ball's l1, a step-scaled portfolio reciprocal); a second
// __syncthreads publishes it. Every thread then reads the same value, so
// the thresholds and the refresh and balancing decisions are block-uniform
// and no branch diverges across the barriers.
//
// Barriers per iteration (a reduce is two), with warm thresholds, the ball
// on and n_sw sweeps per projection: `make_body` 4 n_sw + 2 (14 at the
// default 3: the portfolio reduce, n_sw primal sweeps, the ball's stacked
// l1-and-sweep and n_sw - 1 sweeps); `make_body_cond` 6 on an iteration of
// one sweep, 14 on a refresh; `make_trip_pipe` 4 on a pipelined iteration,
// 14 on its synchronous one: the pipelined iteration clips the dual with
// the carried ball threshold and l1, so the ball's sweep of this
// iteration's magnitudes rides in one stacked reduce with the next
// iteration's portfolio values, and the reduce -> threshold chain has two
// links instead of three. `body_adaptive` 4 n_sw + 2, plus 2 on a balancing
// iteration (the two residuals). Without the ball the ball's reduces drop
// out; with cold projections each projection is a cold start and cold_iters
// sweeps (16 at N > 256).
//
// Bound. A problem reads its inputs and writes its outputs once; per
// iteration it does ~30 FP32 operations per element and a handful of
// stacked reduces, so it is bound by the dependent chain of reduces and
// barriers (and by the shuffle pipe when H or S is large), never by HBM.
// Shared memory per problem: block_plan below (5 [H][N] arrays and S - 1
// more with scenarios); a block of 512 threads holds 16 warps, so at N=500
// the SM runs two to four problems at once.

#pragma once

#include "pdhg_log_utility.cuh"

namespace {

constexpr int kBlockMaxThreads = 512;

// Threads of one problem's block.
__host__ __device__ inline int block_threads(int N) {
  const int n = N < kBlockMaxThreads ? N : kBlockMaxThreads;
  return 32 * ((n + 31) / 32);
}

// Offsets (in floats) of one problem's shared-memory arrays, for S1
// scenarios (1 without), and their total. M is the most quantities one
// stacked reduce stages per warp: the portfolio values of every scenario
// and row with the ball's count, sum and l1 of every row.
struct BlockPlan {
  long long r, w, p, vm, q, cw, tau, sig, sig_tau, c1, inv_s, thw, thp, l1s,
      pf, rat, res, red, M, total;
};

__host__ __device__ inline BlockPlan block_plan(int S1, int H, int N) {
  BlockPlan P;
  const long long HN = (long long)H * N, SH = (long long)S1 * H;
  long long o = 0;
  P.r = o; o += S1 * HN;
  P.w = o; o += HN;
  P.p = o; o += HN;
  P.vm = o; o += HN;
  P.q = o; o += HN;
  P.cw = o; o += N;
  P.tau = o; o += H;
  P.sig = o; o += H;
  P.sig_tau = o; o += H;
  P.c1 = o; o += H;
  P.inv_s = o; o += H;
  P.thw = o; o += H;
  P.thp = o; o += H;
  P.l1s = o; o += H;
  P.pf = o; o += SH;
  P.rat = o; o += SH;
  P.res = o; o += 4;
  P.M = SH + 3LL * H;
  P.red = o; o += (block_threads(N) / 32) * P.M;
  P.total = o;
  return P;
}

// Sum (OP 0), min (1) or max (2); min and max propagate NaN as jmin / jmax.
template <int OP>
__device__ __forceinline__ float combine(float x, float y) {
  if constexpr (OP == 0) return x + y;
  else if constexpr (OP == 1) return jmin(x, y);
  else return jmax(x, y);
}

template <int OP>
__device__ __forceinline__ float identity() {
  if constexpr (OP == 1) return __int_as_float(0x7f800000);  // +inf
  else return 0.f;  // sums, and the max of magnitudes
}

struct BlockCtx {
  int tid, T, H, N;
  float* red;  // the warps' staged sums
};

// One stacked reduce over the block: fill(j0, v) gives this thread's
// partials of quantities j0 .. j0 + W - 1 of M; each warp combines them by
// butterfly, W at a time, and lane 0 stages them. After a barrier
// finish(j, tot) runs for j = 0 .. R - 1 spread over the threads, where
// tot(q) is quantity q combined over the warps pairwise, in a fixed tree
// (so a value is the same wherever it is read, and a sum of 16 warps' 500
// values with a common offset keeps the butterfly's accuracy); a second
// barrier publishes what finish wrote. Every thread of the block must call
// it.
template <int OP, int W, class Fill, class Finish>
__device__ __forceinline__ void block_reduce(const BlockCtx& c, int M, int R,
                                             Fill fill, Finish finish) {
  const int lane = c.tid & 31, warp = c.tid >> 5, NW = c.T >> 5;
  for (int j0 = 0; j0 < M; j0 += W) {
    float v[W];
    fill(j0, v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < W; ++u)
        v[u] = combine<OP>(v[u], __shfl_xor_sync(kFull, v[u], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < W; ++u)
        if (j0 + u < M) c.red[warp * M + j0 + u] = v[u];
    }
  }
  __syncthreads();
  const float* red = c.red;
  auto tot = [=](int q) {
    if (NW == 1) return red[q];
    constexpr int kMaxWarps = kBlockMaxThreads / 32;
    float s[kMaxWarps];
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w)
      s[w] = w < NW ? red[w * M + q] : identity<OP>();
#pragma unroll
    for (int h = 1; h < kMaxWarps; h <<= 1) {
#pragma unroll
      for (int w = 0; w + h < kMaxWarps; w += 2 * h)
        s[w] = combine<OP>(s[w], s[w + h]);
    }
    return s[0];
  };
  for (int j = c.tid; j < R; j += c.T) finish(j, tot);
  __syncthreads();
}

// The fill of a reduce whose quantity j combines part(j, i) over the
// thread's asset columns i.
template <int OP, int W, class Part>
__device__ __forceinline__ auto columns(const BlockCtx& c, int M, Part part) {
  return [=](int j0, float (&v)[W]) {
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = j0 + u;
      float acc = identity<OP>();
      if (j < M)
        for (int i = c.tid; i < c.N; i += c.T)
          acc = combine<OP>(acc, part(j, i));
      v[u] = acc;
    }
  };
}

// One Michelot/Newton sweep per row over the values val(t, i):
// theta <- (sum_{v > theta} v - rad) / max(count, 1).
template <class Val, class Rad>
__device__ __forceinline__ void block_sweep(const BlockCtx& c, Val val,
                                            float* theta, Rad rad) {
  const int H = c.H;
  block_reduce<0, 8>(
      c, 2 * H, H,
      columns<0, 8>(c, 2 * H, [=](int j, int i) {
        const int t = j < H ? j : j - H;
        const float x = val(t, i);
        const bool act = x > theta[t];
        return j < H ? (act ? 1.f : 0.f) : (act ? x : 0.f);
      }),
      [=](int t, auto tot) {
        theta[t] = (tot(H + t) - rad(t)) / jmax(tot(t), 1.f);
      });
}

// Threshold of the simplex or the ball: a cold start (sum - rad) / N and n
// sweeps, or n sweeps from the carried theta. With l1 set, the cold start's
// sum is also the ball's l1 (the same values summed in the same order).
template <class Val, class Rad>
__device__ __forceinline__ void block_threshold(const BlockCtx& c, Val val,
                                                float* theta, Rad rad,
                                                bool cold, int n,
                                                float* l1 = nullptr) {
  if (cold) {
    block_reduce<0, 8>(
        c, c.H, c.H, columns<0, 8>(c, c.H, val),
        [=](int t, auto tot) {
          const float s = tot(t);
          theta[t] = (s - rad(t)) / (float)c.N;
          if (l1 != nullptr) l1[t] = s;
        });
  }
  for (int k = 0; k < n; ++k) block_sweep(c, val, theta, rad);
}

// The ball's l1 and one warm sweep of its threshold from the carried
// theta: count, masked sum and l1 of every row in one stacked reduce.
template <class Val, class Rad>
__device__ __forceinline__ void block_ball_l1_and_sweep(const BlockCtx& c,
                                                        Val val, float* thp,
                                                        float* l1s, Rad rad) {
  const int H = c.H;
  block_reduce<0, 8>(
      c, 3 * H, H,
      columns<0, 8>(c, 3 * H, [=](int j, int i) {
        const int kind = j < H ? 0 : (j < 2 * H ? 1 : 2);
        const int t = j - kind * H;
        const float x = val(t, i);
        const bool act = x > thp[t];
        return kind == 0 ? (act ? 1.f : 0.f)
                         : (kind == 1 ? (act ? x : 0.f) : x);
      }),
      [=](int t, auto tot) {
        thp[t] = (tot(H + t) - rad(t)) / jmax(tot(t), 1.f);
        l1s[t] = tot(2 * H + t);
      });
}

// The ball's threshold after n_sw sweeps and its l1: warm from the carried
// theta (the l1 riding the first sweep), or from a cold start.
template <class Val, class Rad>
__device__ __forceinline__ void block_ball(const BlockCtx& c, Val val,
                                           float* thp, float* l1s, Rad rad,
                                           bool warm, int n_sw) {
  if (warm) {
    block_ball_l1_and_sweep(c, val, thp, l1s, rad);
    block_threshold(c, val, thp, rad, false, n_sw - 1);
  } else {
    block_threshold(c, val, thp, rad, true, n_sw, l1s);
  }
}

template <bool SCEN, bool ADAPT>
__global__ void __launch_bounds__(kBlockMaxThreads)
pdhg_log_utility_block_kernel(Args a, AdaptArgs ad, int pipe) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x;
  const int H = a.H, N = a.N, S1 = SCEN ? a.S : 1;
  const BlockPlan P = block_plan(S1, H, N);
  float* const r = smem + P.r;
  float* const w = smem + P.w;
  float* const p = smem + P.p;
  float* const vm = smem + P.vm;  // the projection input, then w_new
  float* const q = smem + P.q;    // the dual input (pipelined: its magnitudes)
  float* const cw = smem + P.cw;
  float* const tau = smem + P.tau;
  float* const sig = smem + P.sig;
  float* const sig_tau = smem + P.sig_tau;
  float* const c1 = smem + P.c1;
  float* const inv_s = smem + P.inv_s;
  float* const thw = smem + P.thw;
  float* const thp = smem + P.thp;
  float* const l1s = smem + P.l1s;
  float* const pf = smem + P.pf;  // scale / max(w . r^s, 1e-12) per (s, t)
  float* const rat = smem + P.rat;
  float* const res = smem + P.res;
  const BlockCtx ctx{tid, T, H, N, smem + P.red};
  const int SH = S1 * H;
  const float fS = (float)S1;
  const bool ridge0 = a.ridge == 0.f;
  const bool relax = a.rho != 1.f;
  const bool warm = a.warm != 0;
  const bool use_ball = a.use_ball != 0;

  auto one = [](int) { return 1.f; };
  auto at_vm = [=](int t, int i) { return vm[t * N + i]; };
  // |q| - c, clipped at 0: the dual magnitudes of the fixed-step bodies.
  auto at_aq = [=](int t, int i) {
    return jmax(fabsf(q[t * N + i]) - a.c, 0.f);
  };
  auto at_sig_tau = [=](int t) { return sig_tau[t]; };
  // The ball's excess over c of the dual bound, per row.
  auto excess = [=](int t, float rad) {
    return l1s[t] <= rad ? 0.f : jmax(thp[t], 0.f);
  };

  // Inputs, by the thread that owns the column.
  for (int i = tid; i < N; i += T) {
    cw[i] = a.cw[(size_t)b * N + i];
    for (int e = 0; e < SH; ++e)
      r[e * N + i] = a.r[((size_t)b * SH + e) * N + i];
  }

  // Curvature: ratio = ||r_t||^2 / max(min_i r_t[i], 1e-12)^2 per scenario
  // and row.
  block_reduce<0, 8>(
      ctx, SH, SH,
      columns<0, 8>(ctx, SH, [=](int j, int i) {
        const float x = r[j * N + i];
        return x * x;
      }),
      [=](int j, auto tot) { rat[j] = tot(j); });
  block_reduce<1, 8>(
      ctx, SH, SH,
      columns<1, 8>(ctx, SH, [=](int j, int i) { return r[j * N + i]; }),
      [=](int j, auto tot) {
        const float m = jmax(tot(j), 1e-12f);
        rat[j] = rat[j] / (m * m);
      });

  // The global bound L (every thread alike) and the per-row steps.
  auto row_mean = [=](int t) {  // scenario mean of a row's ratio, + ridge
    float s = 0.f;
    for (int k = 0; k < S1; ++k) s += rat[k * H + t];
    return s / fS + a.ridge;
  };
  float L;
  if constexpr (!SCEN) {
    float mx = rat[0];
    for (int t = 1; t < H; ++t) mx = jmax(mx, rat[t]);
    L = mx + a.ridge;
  } else if (a.precond) {
    L = row_mean(0);
    for (int t = 1; t < H; ++t) L = jmax(L, row_mean(t));
  } else {
    float max_sum = 0.f;
    for (int k = 0; k < S1; ++k) {
      float mx = rat[k * H];
      for (int t = 1; t < H; ++t) mx = jmax(mx, rat[k * H + t]);
      max_sum += mx;
    }
    L = max_sum / fS + a.ridge;
  }
  const float s0 = a.sigma_scale * sqrtf(L) / 2.f;
  for (int t = tid; t < H; t += T) {
    if (a.precond) {
      const float Lrow = SCEN ? row_mean(t) : rat[t] + a.ridge;
      const float rowdeg = t == 0 ? 1.f : 2.f;
      const float coldeg = t == H - 1 ? 1.f : 2.f;
      sig[t] = 2.f * s0 / rowdeg;
      tau[t] = a.step_scale / (0.5f * Lrow + 2.f * s0 * coldeg);
    } else {
      sig[t] = s0;
      tau[t] = a.step_scale / (0.5f * L + s0 * 4.f);
    }
    sig_tau[t] = sig[t] * a.tau_to;
    c1[t] = 1.f - tau[t] * a.ridge;
    inv_s[t] = 1.f / sig[t];
    thp[t] = 0.f;
    l1s[t] = 0.f;
  }

  // Start: the cold simplex projection of the current weights on every row
  // with a zero dual; or the warm iterates as given, with a cold threshold
  // taken on the warm primal.
  const bool warm_start = a.w_warm != nullptr;
  for (int i = tid; i < N; i += T) {
    for (int t = 0; t < H; ++t) {
      const size_t g = ((size_t)b * H + t) * N + i;
      const float x = warm_start ? a.w_warm[g] : cw[i];
      vm[t * N + i] = x;
      w[t * N + i] = x;
      p[t * N + i] = (warm_start && a.p_warm != nullptr) ? a.p_warm[g] : 0.f;
    }
  }
  block_threshold(ctx, at_vm, thw, one, true, a.cold_iters);
  if (!warm_start) {
    for (int i = tid; i < N; i += T)
      for (int t = 0; t < H; ++t)
        w[t * N + i] = jmax(vm[t * N + i] - thw[t], 0.f);
  }

  // g_t = r_t * pf_t, or the scenario mean of r^s_t * pf^s_t in s order.
  auto scaled = [=](int t, int i) {
    if constexpr (!SCEN) {
      return r[t * N + i] * pf[t];
    } else {
      float g = 0.f;
      for (int k = 0; k < S1; ++k)
        g += r[(k * H + t) * N + i] * pf[k * H + t];
      return g / fS;
    }
  };
  // The portfolio values w_t . r^s_t of every scenario and row, stored as
  // pf = scale_t / max(., 1e-12) (scale tau_t where a fixed-step iteration
  // follows, -1 before the adaptive body's step and the tail); with
  // `ball`, stacked with the pipelined ball sweep of the magnitudes in q
  // against the carried theta, which gives the next iteration's pair.
  auto portfolio = [=](bool minus, bool ball) {
    const int M = ball ? SH + 3 * H : SH;
    block_reduce<0, 8>(
        ctx, M, H,
        columns<0, 8>(ctx, M, [=](int j, int i) {
          if (j < SH) return w[(j % H) * N + i] * r[j * N + i];
          const int kind = j < SH + H ? 0 : (j < SH + 2 * H ? 1 : 2);
          const int t = j - SH - kind * H;
          const float x = q[t * N + i];
          const bool act = x > thp[t];
          return kind == 0 ? (act ? 1.f : 0.f)
                           : (kind == 1 ? (act ? x : 0.f) : x);
        }),
        [=](int t, auto tot) {
          const float sc = minus ? -1.f : tau[t];
          for (int k = 0; k < S1; ++k)
            pf[k * H + t] = sc / jmax(tot(k * H + t), 1e-12f);
          if (ball) {
            thp[t] = (tot(SH + H + t) - sig_tau[t]) / jmax(tot(SH + t), 1.f);
            l1s[t] = tot(SH + 2 * H + t);
          }
        });
  };
  // The new primal and the dual input: w_new into vm, q = p + sigma
  // D(2 w_new - w) into q, row by row down the thread's columns.
  auto extrapolate = [=]() {
    for (int i = tid; i < N; i += T) {
      float wbp = cw[i];
      for (int t = 0; t < H; ++t) {
        const int e = t * N + i;
        const float wn = jmax(vm[e] - thw[t], 0.f);
        const float wb = 2.f * wn - w[e];
        q[e] = p[e] + sig[t] * (wb - wbp);
        vm[e] = wn;
        wbp = wb;
      }
    }
  };
  auto update = [=](int e, float wn, float pn) {
    if (relax) {
      w[e] = w[e] + a.rho * (wn - w[e]);
      p[e] = p[e] + a.rho * (pn - p[e]);
    } else {
      w[e] = wn;
      p[e] = pn;
    }
  };

  if constexpr (!ADAPT) {
    const bool cond = warm && a.refresh > 1;  // make_body_cond
    // make_trip_pipe (pipe; warm, refresh > 1): trips of kp - 1 pipelined
    // iterations and one synchronous one, synchronous iterations for the
    // remainder. The ball's theta and l1 start at 0.
    const int kp = min(max(a.refresh, 1), 8);
    const int full = pipe ? a.max_iters / kp * kp : 0;
    portfolio(a.max_iters == 0, false);
    for (int it = 0; it < a.max_iters; ++it) {
      const bool last = it == a.max_iters - 1;
      bool sync = true;
      int n_sw;
      if (pipe) {
        sync = it >= full || (it % kp) == kp - 1;
        n_sw = sync ? a.warm_iters : 1;
      } else if (!warm) {
        n_sw = a.cold_iters;
      } else if (cond) {
        n_sw = (it % a.refresh) == 0 ? a.warm_iters : 1;
      } else {
        n_sw = a.warm_iters;
      }

      // Primal step: w - tau (grad g(w) + ridge w + D'p), tau folded into
      // the portfolio reciprocal and the ridge into c1; its projection.
      for (int i = tid; i < N; i += T) {
        for (int t = 0; t < H; ++t) {
          const int e = t * N + i;
          const float nxt = t + 1 < H ? p[e + N] : 0.f;
          const float base = ridge0 ? w[e] : c1[t] * w[e];
          vm[e] = base + (scaled(t, i) - tau[t] * (p[e] - nxt));
        }
      }
      block_threshold(ctx, at_vm, thw, one, !warm, n_sw);

      if (!sync) {
        // Pipelined: clip with the carried ball pair, keep the magnitudes
        // for the stacked reduce that also takes the next portfolio
        // values.
        for (int i = tid; i < N; i += T) {
          float wbp = cw[i];
          for (int t = 0; t < H; ++t) {
            const int e = t * N + i;
            const float wn = jmax(vm[e] - thw[t], 0.f);
            const float wb = 2.f * wn - w[e];
            const float qq = p[e] + sig[t] * (wb - wbp);
            wbp = wb;
            const float bound = a.c + (use_ball ? excess(t, sig_tau[t]) : 0.f);
            q[e] = jmax(fabsf(qq) - a.c, 0.f);
            update(e, wn, jmin(jmax(qq, -bound), bound));
          }
        }
        portfolio(last, use_ball);
        continue;
      }

      // Dual prox on the q scale, clip form: clip(q, -bound, bound) with
      // bound = c inside the ball, c + max(theta, 0) outside.
      extrapolate();
      if (use_ball)
        block_ball(ctx, at_aq, thp, l1s, at_sig_tau, warm, n_sw);
      for (int i = tid; i < N; i += T) {
        for (int t = 0; t < H; ++t) {
          const int e = t * N + i;
          const float bound = a.c + (use_ball ? excess(t, sig_tau[t]) : 0.f);
          update(e, vm[e], jmin(jmax(q[e], -bound), bound));
        }
      }
      portfolio(last, false);
    }
  } else {
    // body_adaptive: tau and sig are the carried steps (the tail then steps
    // by the last tau); alpha, the last residuals and the moves are the same
    // in every thread.
    float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;
    const int n_sw = warm ? a.warm_iters : a.cold_iters;
    // |q / sigma| - c / sigma, clipped at 0: the a-scale magnitudes.
    auto at_am = [=](int t, int i) {
      return jmax(fabsf(q[t * N + i] * inv_s[t]) - a.c * inv_s[t], 0.f);
    };
    auto at_tau_to = [=](int) { return a.tau_to; };
    portfolio(true, false);
    for (int it = 0; it < a.max_iters; ++it) {
      for (int i = tid; i < N; i += T) {
        for (int t = 0; t < H; ++t) {
          const int e = t * N + i;
          float gg = scaled(t, i);
          if (!ridge0) gg = gg + a.ridge * w[e];
          const float nxt = t + 1 < H ? p[e + N] : 0.f;
          vm[e] = w[e] - tau[t] * (gg + (p[e] - nxt));
        }
      }
      block_threshold(ctx, at_vm, thw, one, !warm, n_sw);
      extrapolate();

      // Dual prox on the a-scale: v = q / sigma, the ball of radius
      // tau_to, p_new = q - sigma (v - clip(v, +-bound)), into q.
      if (use_ball)
        block_ball(ctx, at_am, thp, l1s, at_tau_to, warm, n_sw);
      for (int i = tid; i < N; i += T) {
        for (int t = 0; t < H; ++t) {
          const int e = t * N + i;
          const float bound = a.c * inv_s[t]
              + (use_ball ? excess(t, a.tau_to) : 0.f);
          const float v = q[e] * inv_s[t];
          const float inner = v - jmin(jmax(v, -bound), bound);
          q[e] = q[e] - sig[t] * inner;
        }
      }

      // Residual balancing (ratio 1.5, alpha *= 0.95) from the moves
      // before over-relaxation: pr = ||dw / tau - D'dp||, dr = ||dp / sigma
      // - D0 dw||; one thread per row moves its steps, every thread its
      // copy of alpha.
      if (ad.adapt_every <= 1 ||
          (it % ad.adapt_every) == ad.adapt_every - 1) {
        block_reduce<0, 2>(
            ctx, 2, H,
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
                  const float e1 = dw / tau[t] - (dp - dpn);
                  const float e2 = dp / sig[t] - (dw - dwp);
                  v[0] += e1 * e1;
                  v[1] += e2 * e2;
                }
              }
            },
            [=](int t, auto tot) {
              const float pr = sqrtf(tot(0)), dr = sqrtf(tot(1));
              const float shrink = 1.f - alpha;
              if (pr > 1.5f * dr) {
                tau[t] = tau[t] / shrink;
                sig[t] = sig[t] * shrink;
              } else if (dr > 1.5f * pr) {
                tau[t] = tau[t] * shrink;
                sig[t] = sig[t] / shrink;
              }
              inv_s[t] = 1.f / sig[t];
              if (t == 0) {
                res[0] = pr;
                res[1] = dr;
              }
            });
        const float pr = res[0], dr = res[1];
        pr_last = pr;
        dr_last = dr;
        const bool big_p = pr > 1.5f * dr;
        const bool big_d = dr > 1.5f * pr;
        if (big_p || big_d) alpha = alpha * 0.95f;
        if (big_p) moved += (float)(it + 1);
        if (!big_p && big_d) moved -= (float)(it + 1);
      }

      for (int i = tid; i < N; i += T)
        for (int t = 0; t < H; ++t)
          update(t * N + i, vm[t * N + i], q[t * N + i]);
      portfolio(true, false);
    }
    if (ad.steps_out != nullptr && tid == 0) {
      float* o = ad.steps_out + (size_t)b * (2 * H + 4);
      for (int t = 0; t < H; ++t) {
        o[t] = tau[t];
        o[H + t] = sig[t];
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
  for (int i = tid; i < N; i += T) {
    for (int t = 0; t < H; ++t) {
      const int e = t * N + i;
      float gg = scaled(t, i);
      if (!ridge0) gg = gg + a.ridge * w[e];
      const float nxt = t + 1 < H ? p[e + N] : 0.f;
      vm[e] = w[e] - tau[t] * (gg + (p[e] - nxt));
    }
  }
  block_threshold(ctx, at_vm, thw, one, true, a.cold_iters);
  float fp = 0.f;
  for (int i = tid; i < N; i += T) {
    for (int t = 0; t < H; ++t) {
      const int e = t * N + i;
      const size_t g = ((size_t)b * H + t) * N + i;
      const float wl = jmax(vm[e] - thw[t], 0.f);
      fp = jmax(fp, fabsf(wl - w[e]));
      a.w_out[g] = wl;
      if (a.p_out != nullptr) a.p_out[g] = p[e];
    }
  }
  block_reduce<2, 1>(
      ctx, 1, 1, [=](int, float (&v)[1]) { v[0] = fp; },
      [=](int, auto tot) { a.fp_out[b] = tot(0); });
}

// One block per problem; the shared memory of block_plan, above 48 KB by
// opt-in. Shapes beyond a block's shared memory return
// cudaErrorInvalidValue (the wrapper checks first).
template <bool SCEN, bool ADAPT>
int block_dispatch(const Args& a, const AdaptArgs& ad, int pipe,
                   void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0 || (SCEN && a.S <= 0))
    return (int)cudaErrorInvalidValue;
  const BlockPlan P = block_plan(SCEN ? a.S : 1, a.H, a.N);
  const long long smem = P.total * (long long)sizeof(float);
  if (smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      pdhg_log_utility_block_kernel<SCEN, ADAPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pdhg_log_utility_block_kernel<SCEN, ADAPT>
      <<<a.B, block_threads(a.N), (size_t)smem,
         static_cast<cudaStream_t>(stream)>>>(a, ad, pipe);
  return (int)cudaGetLastError();
}

}  // namespace
