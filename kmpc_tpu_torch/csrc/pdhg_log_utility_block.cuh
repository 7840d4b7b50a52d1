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
//
// The global layout (pdhg_log_utility_global_kernel, beside the block
// kernel, both over block_solve) runs the
// same body for every shape whose problem does not fit a block's shared
// memory (kmpc_tpu's wrapper hands those to its XLA solver): the four
// [H][N] iterates live in the CTA's slot of a global-memory workspace
// (global_plan), the returns [S][H][N] and the current weights are read in
// place from the inputs, and the per-row values and the reduce staging stay
// in shared memory where they fit (else they join the slot). The grid is
// persistent: min(B, the CTAs the card holds at once), each CTA looping over
// problems blockIdx.x, blockIdx.x + gridDim.x, ..., so the workspace is
// sized by the grid. The same operations in the same order as the block
// layout: at a shape both take, the two give the same bits. Bound: every
// iterate access goes to L1/L2 (about 320 KB a problem at H=20 N=1000, the
// grid's slots near the 50 MB L2 at one CTA an SM); with S scenarios the
// returns are read from global memory twice an iteration (the portfolio
// values and the gradient), S H N floats each, which binds B at S=16.
//
// SHORT (``allow_short``, both layouts): the primal projection is onto the
// hyperplane sum(w) = 1, kmpc_tpu's `project_hyperplane_sum`: a cold
// threshold (sum - 1) / N with no sweeps and no clip; no threshold is
// carried (the wrapper passes warm = 0, so the dual's ball threshold starts
// cold too), and the start is the hyperplane projection of the current
// weights, as kmpc_tpu/ops/mpc.py's solver does.

#pragma once

#include "pdhg_log_utility.cuh"

namespace {

constexpr int kBlockMaxThreads = 512;

// Threads of one problem's block.
__host__ __device__ inline int block_threads(int N) {
  const int n = N < kBlockMaxThreads ? N : kBlockMaxThreads;
  return 32 * ((n + 31) / 32);
}

// Offsets (in floats) of one problem's per-row values and reduce staging,
// for S1 scenarios (1 without), and their total: the steps, thresholds and
// the ball's l1 per row, the portfolio reciprocals and curvature ratios per
// scenario and row, four residual slots, and each warp's staging of the
// largest stacked reduce (M: the portfolio values of every scenario and row
// with the ball's count, sum and l1 of every row).
struct SmallPlan {
  long long tau, sig, sig_tau, c1, inv_s, thw, thp, l1s, pf, rat, res, red, M,
      total;
};

__host__ __device__ inline SmallPlan small_plan(int S1, int H, int N) {
  SmallPlan P;
  const long long SH = (long long)S1 * H;
  long long o = 0;
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

// Offsets (in floats) of one problem's shared-memory arrays in the block
// layout and their total: r per scenario, w, p, the projection input and the
// dual input as [H][N], the current weights, then the small plan.
struct BlockPlan {
  long long r, w, p, vm, q, cw, small, total;
};

__host__ __device__ inline BlockPlan block_plan(int S1, int H, int N) {
  BlockPlan P;
  const long long HN = (long long)H * N;
  long long o = 0;
  P.r = o; o += S1 * HN;
  P.w = o; o += HN;
  P.p = o; o += HN;
  P.vm = o; o += HN;
  P.q = o; o += HN;
  P.cw = o; o += N;
  P.small = o; o += small_plan(S1, H, N).total;
  P.total = o;
  return P;
}

// The global layout's plan, per CTA of a persistent grid: w, p, the
// projection input and the dual input as [H][N] in the CTA's slot of a
// global-memory workspace (the returns and the current weights are read in
// place from the inputs); the small plan in shared memory where it fits a
// block's, else in the slot after the four arrays (smem 0).
struct GlobalPlan {
  long long w, p, vm, q, small, slot, smem;
};

__host__ __device__ inline GlobalPlan global_plan(int S1, int H, int N) {
  GlobalPlan G;
  const long long HN = (long long)H * N;
  const long long small = small_plan(S1, H, N).total;
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

// Where one problem's arrays live while its CTA solves it: the returns and
// the current weights (in shared memory in the block layout, in place in
// the inputs in the global layout), the four [H][N] iterates, and the small
// plan's arrays.
struct BlockMem {
  const float *r, *cw;
  float *w, *p, *vm, *q;
  float *small;
};

// The solve of problem b by the whole CTA. SHORT (``allow_short``): the
// primal projection is onto the hyperplane sum(w) = 1 (a cold threshold of
// no sweeps, unclipped); the wrapper passes warm = 0 with it, so the
// dual's ball threshold starts cold every iteration, as the reference's
// solver does.
template <bool SCEN, bool ADAPT, bool SHORT>
__device__ __forceinline__ void block_solve(const Args& a,
                                            const AdaptArgs& ad, int pipe,
                                            int b, const BlockMem& m) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int H = a.H, N = a.N, S1 = SCEN ? a.S : 1;
  const SmallPlan P = small_plan(S1, H, N);
  const float* const r = m.r;
  const float* const cw = m.cw;
  float* const w = m.w;
  float* const p = m.p;
  float* const vm = m.vm;  // the projection input, then w_new
  float* const q = m.q;    // the dual input (pipelined: its magnitudes)
  float* const tau = m.small + P.tau;
  float* const sig = m.small + P.sig;
  float* const sig_tau = m.small + P.sig_tau;
  float* const c1 = m.small + P.c1;
  float* const inv_s = m.small + P.inv_s;
  float* const thw = m.small + P.thw;
  float* const thp = m.small + P.thp;
  float* const l1s = m.small + P.l1s;
  float* const pf = m.small + P.pf;  // scale / max(w . r^s, 1e-12) per (s, t)
  float* const rat = m.small + P.rat;
  float* const res = m.small + P.res;
  const BlockCtx ctx{tid, T, H, N, m.small + P.red};
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
  // The primal projection of x = v - theta: the simplex's clip, or none
  // on the hyperplane.
  auto proj = [](float x) { return SHORT ? x : jmax(x, 0.f); };
  // The primal projection's threshold of the values in vm: cold or from
  // the carried theta with n sweeps; on the hyperplane (sum - 1) / N.
  auto primal_threshold = [=](bool cold, int n) {
    if constexpr (SHORT)
      block_threshold(ctx, at_vm, thw, one, true, 0);
    else
      block_threshold(ctx, at_vm, thw, one, cold, n);
  };

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
  primal_threshold(true, a.cold_iters);
  if (!warm_start) {
    for (int i = tid; i < N; i += T)
      for (int t = 0; t < H; ++t)
        w[t * N + i] = proj(vm[t * N + i] - thw[t]);
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
        const float wn = proj(vm[e] - thw[t]);
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
      primal_threshold(!warm, n_sw);

      if (!sync) {
        // Pipelined: clip with the carried ball pair, keep the magnitudes
        // for the stacked reduce that also takes the next portfolio
        // values.
        for (int i = tid; i < N; i += T) {
          float wbp = cw[i];
          for (int t = 0; t < H; ++t) {
            const int e = t * N + i;
            const float wn = proj(vm[e] - thw[t]);
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
      primal_threshold(!warm, n_sw);
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
  primal_threshold(true, a.cold_iters);
  float fp = 0.f;
  for (int i = tid; i < N; i += T) {
    for (int t = 0; t < H; ++t) {
      const int e = t * N + i;
      const size_t g = ((size_t)b * H + t) * N + i;
      const float wl = proj(vm[e] - thw[t]);
      fp = jmax(fp, fabsf(wl - w[e]));
      a.w_out[g] = wl;
      if (a.p_out != nullptr) a.p_out[g] = p[e];
    }
  }
  block_reduce<2, 1>(
      ctx, 1, 1, [=](int, float (&v)[1]) { v[0] = fp; },
      [=](int, auto tot) { a.fp_out[b] = tot(0); });
}

// The block layout: one CTA per problem, its arrays in shared memory at
// the offsets of block_plan. The inputs are copied in by the thread that
// owns the column (the body's first reduce reads only its own columns).
template <bool SCEN, bool ADAPT, bool SHORT>
__global__ void __launch_bounds__(kBlockMaxThreads)
pdhg_log_utility_block_kernel(Args a, AdaptArgs ad, int pipe) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x;
  const int H = a.H, N = a.N, SH = (SCEN ? a.S : 1) * H;
  const BlockPlan P = block_plan(SCEN ? a.S : 1, H, N);
  float* const r = smem + P.r;
  float* const cw = smem + P.cw;
  for (int i = tid; i < N; i += T) {
    cw[i] = a.cw[(size_t)b * N + i];
    for (int e = 0; e < SH; ++e)
      r[e * N + i] = a.r[((size_t)b * SH + e) * N + i];
  }
  const BlockMem m{r, cw, smem + P.w, smem + P.p, smem + P.vm, smem + P.q,
                   smem + P.small};
  block_solve<SCEN, ADAPT, SHORT>(a, ad, pipe, b, m);
}

// The global layout: the same body for the shapes whose problem does not
// fit a block's shared memory. A persistent grid; CTA k solves problems
// k, k + gridDim.x, ... with its iterates in slot k of the workspace
// (global_plan) and reads each problem's returns and current weights in
// place. The workspace is sized by the grid, never by the batch.
template <bool SCEN, bool ADAPT, bool SHORT>
__global__ void __launch_bounds__(kBlockMaxThreads)
pdhg_log_utility_global_kernel(Args a, AdaptArgs ad, int pipe, float* ws) {
  extern __shared__ float smem[];
  const int H = a.H, N = a.N, S1 = SCEN ? a.S : 1;
  const long long HN = (long long)H * N;
  const GlobalPlan G = global_plan(S1, H, N);
  float* const slot = ws + (size_t)blockIdx.x * G.slot;
  float* const small = G.small < 0 ? smem : slot + G.small;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const BlockMem m{a.r + (size_t)b * S1 * HN, a.cw + (size_t)b * N,
                     slot + G.w, slot + G.p, slot + G.vm, slot + G.q, small};
    block_solve<SCEN, ADAPT, SHORT>(a, ad, pipe, b, m);
  }
}

inline bool bad_shape(const Args& a, bool scen) {
  return a.B <= 0 || a.H <= 0 || a.N <= 0 || (scen && a.S <= 0);
}

// One block per problem; the shared memory of block_plan, above 48 KB by
// opt-in. Shapes beyond a block's shared memory return
// cudaErrorInvalidValue (the wrapper checks first).
template <bool SCEN, bool ADAPT, bool SHORT>
int block_launch(const Args& a, const AdaptArgs& ad, int pipe,
                 void* stream) {
  if (bad_shape(a, SCEN)) return (int)cudaErrorInvalidValue;
  const BlockPlan P = block_plan(SCEN ? a.S : 1, a.H, a.N);
  const long long smem = P.total * (long long)sizeof(float);
  if (smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      pdhg_log_utility_block_kernel<SCEN, ADAPT, SHORT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pdhg_log_utility_block_kernel<SCEN, ADAPT, SHORT>
      <<<a.B, block_threads(a.N), (size_t)smem,
         static_cast<cudaStream_t>(stream)>>>(a, ad, pipe);
  return (int)cudaGetLastError();
}

// short_ != 0: the hyperplane projection (allow_short).
template <bool SCEN, bool ADAPT>
int block_dispatch(const Args& a, const AdaptArgs& ad, int pipe, int short_,
                   void* stream) {
  return short_ ? block_launch<SCEN, ADAPT, true>(a, ad, pipe, stream)
                : block_launch<SCEN, ADAPT, false>(a, ad, pipe, stream);
}

// A grid of min(grid, B) CTAs over the workspace ws of grid slots of
// global_plan's floats (the wrapper allocates it).
template <bool SCEN, bool ADAPT, bool SHORT>
int global_launch(const Args& a, const AdaptArgs& ad, int pipe, float* ws,
                  int grid, void* stream) {
  if (bad_shape(a, SCEN) || grid <= 0 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const GlobalPlan G = global_plan(SCEN ? a.S : 1, a.H, a.N);
  const long long smem = G.smem * (long long)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pdhg_log_utility_global_kernel<SCEN, ADAPT, SHORT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ctas = grid < a.B ? grid : a.B;
  pdhg_log_utility_global_kernel<SCEN, ADAPT, SHORT>
      <<<ctas, block_threads(a.N), (size_t)smem,
         static_cast<cudaStream_t>(stream)>>>(a, ad, pipe, ws);
  return (int)cudaGetLastError();
}

template <bool SCEN, bool ADAPT>
int global_dispatch(const Args& a, const AdaptArgs& ad, int pipe,
                    int short_, void* ws, int grid, void* stream) {
  float* const w = static_cast<float*>(ws);
  return short_
      ? global_launch<SCEN, ADAPT, true>(a, ad, pipe, w, grid, stream)
      : global_launch<SCEN, ADAPT, false>(a, ad, pipe, w, grid, stream);
}

// CTAs of the global layout's kernel an SM holds at once (by its threads,
// registers and shared memory), for the wrapper's grid; 0 on an error.
template <bool SCEN, bool ADAPT>
int global_ctas_per_sm(int S, int H, int N, int short_) {
  const GlobalPlan G = global_plan(SCEN ? S : 1, H, N);
  const size_t smem = (size_t)G.smem * sizeof(float);
  int n = 0;
  cudaError_t e;
  if (short_) {
    auto k = pdhg_log_utility_global_kernel<SCEN, ADAPT, true>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, k, block_threads(N), smem);
  } else {
    auto k = pdhg_log_utility_global_kernel<SCEN, ADAPT, false>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, k, block_threads(N), smem);
  }
  return e == cudaSuccess ? n : 0;
}

}  // namespace
