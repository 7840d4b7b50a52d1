// The log-utility PDHG solve in a wide-row layout, for one forecast (S=None)
// or S scenarios past the row layout's four slots a lane (N > 128): one CTA
// per problem and one warp per horizon row, the row in shared memory. The
// same program as the row, warp and block kernels: `_make_packed_kernel` of
// kmpc_tpu/ops/mpc_pallas.py with S=None or S set, its bodies `make_body`
// (warm or cold thresholds), `make_body_cond` (refresh schedule),
// `make_trip_pipe` (PIPE, the pipelined reductions) and, with ADAPT,
// `body_adaptive`;
// precond, ridge, over-relaxation, ball on or off, cold projections, warm
// inputs, the dual output and the extra primal half-step with the
// fixed-point residual.
//
// Bound. A solve moves its inputs and outputs once and does ~30 FP32
// operations per element an iteration (chip_smoke.py's `pdhg_bound`), but
// what it waits on is the dependent chain of one iteration: the sums over
// assets of the portfolio value and of every Michelot sweep, each followed
// by an IEEE division. The block layout (pdhg_log_utility_block.cuh) spreads
// a problem's assets over up to 16 warps, so each of those sums is a
// stacked reduce across warps, two __syncthreads and a combine by one
// thread per row, some 14 barriers an iteration (PERF.md section 6).
//
// Design. Warp t owns horizon row t (H <= 32 warps); asset i sits on lane
// i % 32, slot i / 32 (K = ceil(N/32) slots, any K the shared memory
// holds), as in the row and warp layouts. The row's returns, w, p, the
// projection input (then the dual input) and wbar are [K * 32] slices of
// shared memory, and a lane touches only its own column of its own row's
// slices, so a within-row phase needs no barrier and no __syncwarp: the
// slices are the row kernel's registers, made long enough for any N. A
// row's sum runs in two stages, each lane over its slots in slot order,
// then one butterfly: the order of `warp_sum` in the row and warp layouts.
// Rows meet only where D couples neighbours and where the adaptive body
// balances its steps, as in pdhg_log_utility_rows.cuh:
// - the primal step of row t reads p_{t+1} of the previous iteration, the
//   extrapolation this iteration's wbar_{t-1} (the current weights stand
//   in for row -1: wbar's slices are [H + 1][K * 32], row t at t + 1 and
//   the current weights at 0). Two __syncthreads an iteration: wbar is
//   written before barrier A and read between A and B, p read before A and
//   written between A and B, so one buffer of each suffices;
// - on a balancing iteration each row stages its moves (dw before A, dp
//   between A and B) and, after B, each lane its sums over its slots of
//   the residual terms e1^2 and e2^2 of its row; after a third barrier
//   every warp adds the rows' partials in row order, lane by lane, and runs
//   the same butterfly, so every warp takes the same decision from the
//   same bits;
// - L, the largest curvature ratio over the rows, is exchanged once at the
//   start; fp is a max, combined over the warps at the end.
// A projection's sweeps stop at a bitwise fixed point (`settled`, as in
// the row kernels; the exit is warp-uniform and leaves only a sweep loop).
// Registers: the kernel is compiled for at most HB warps (8, 20 or 32, as
// the row kernels); the slots' loops hold a few scalars, not the row.
// Scenarios (kernel B; ST = kResident or kStreamed, as in the row layout):
// a row's S returns are resident as [S][N] floats where the plan fits, else
// streamed through the warp's ring (RowRing) of 2 or 3 stages of CW = 4, 2
// or 1 scenarios of K * 32 floats, the deepest that fits; the gradient's
// scenario mean is summed into the projection input's slice (the returns'
// slice of one forecast is not kept), CW portfolio values a chunk, each
// two-stage, summed by one transposing butterfly as `row_scaled_returns`
// sums them. The one-forecast instantiations
// (ST = kRegisters) keep their code and their bits: every scenario path is
// behind `if constexpr (SCEN)`.

#pragma once

#include "pdhg_log_utility_rows.cuh"

namespace {

constexpr int kWideMaxH = 32;
constexpr int kWideChunk = 4;  // scenarios a chunk, at most

// Offsets (in floats) of one problem's shared memory, and the total: five
// [H][K * 32] row arrays (returns, w, p, the projection and dual input,
// wbar with the current weights in a row of their own), with ADAPT the
// moves dw and dp and each lane's residual partials of every row; the
// rows' curvature ratios and fp. With scenarios (`wide_scen_plan`) also
// the rows' bounds and the returns (rs), the ring's depth and chunk.
struct WidePlan {
  long long r, w, p, v, wb, dw, dp, e, rat, fp, total;
  long long lr, rs;
  int stages, chunk;
};

__host__ __device__ inline WidePlan wide_plan(int H, int N, bool adapt) {
  const long long KW = (long long)(N + 31) / 32 * 32, HR = H * KW;
  WidePlan P;
  long long o = 0;
  P.r = o; o += HR;
  P.w = o; o += HR;
  P.p = o; o += HR;
  P.v = o; o += HR;
  P.wb = o; o += HR + KW;
  P.dw = o; o += adapt ? HR : 0;
  P.dp = o; o += adapt ? HR : 0;
  P.e = o; o += adapt ? 2LL * H * 32 : 0;
  P.rat = o; o += H;
  P.fp = o; o += H;
  P.total = o;
  P.lr = P.rs = o;
  P.stages = P.chunk = 0;
  return P;
}

// The plan of S scenarios (storage kResident or kStreamed): the one-forecast
// plan's arrays but the returns' slice, the curvature ratios of a chunk of
// kWideChunk scenarios, the rows' bounds, and the returns: resident
// [H][S][N], or each warp's ring, the first of (stages, chunk) = (3, 4),
// (2, 4), (2, 2), (2, 1) that fits a block's shared memory.
__host__ __device__ inline WidePlan wide_scen_plan(int S, int H, int N,
                                                   bool adapt, int storage) {
  const long long KW = (long long)(N + 31) / 32 * 32, HR = H * KW;
  WidePlan P;
  long long o = 0;
  P.r = o;
  P.w = o; o += HR;
  P.p = o; o += HR;
  P.v = o; o += HR;
  P.wb = o; o += HR + KW;
  P.dw = o; o += adapt ? HR : 0;
  P.dp = o; o += adapt ? HR : 0;
  P.e = o; o += adapt ? 2LL * H * 32 : 0;
  P.rat = o; o += (long long)H * kWideChunk;
  P.fp = o; o += H;
  P.lr = o; o += H;
  P.rs = o;
  P.stages = 0;
  P.chunk = kWideChunk;
  if (storage == kResident) {
    o += (long long)H * S * N;
  } else {
    const int depth[4] = {3, 2, 2, 2}, chunk[4] = {4, 4, 2, 1};
    int i = 0;
    while (i < 3 && (o + (long long)depth[i] * chunk[i] * HR) *
                            (long long)sizeof(float) > kSmemPerBlock)
      ++i;
    P.stages = depth[i];
    P.chunk = chunk[i];
    o += (long long)depth[i] * chunk[i] * HR;
  }
  P.total = o;
  return P;
}

// A row's slots: element k of a slice lies at x[k * 32] from the lane's
// column.
struct Slots {
  int K, N, lane;
  __device__ __forceinline__ bool valid(int k) const {
    return k * 32 + lane < N;
  }
};

__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One Michelot/Newton sweep of a row: theta <- (sum_{x > theta} x - rad) /
// max(count, 1) over the masked values val(k); count and sum butterflied
// together.
template <class Val>
__device__ __forceinline__ float wide_sweep(const Slots& s, Val val,
                                            float th, float rad) {
  float cnt = 0.f, sum = 0.f;
#pragma unroll 4
  for (int k = 0; k < s.K; ++k) {
    const float x = val(k);
    const bool act = x > th;
    cnt += act ? 1.f : 0.f;
    sum += act ? x : 0.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, o);
    sum += __shfl_xor_sync(kFull, sum, o);
  }
  return (sum - rad) / jmax(cnt, 1.f);
}

// The threshold of a row: with cold, (sum of the unmasked values - rad) / N
// first; then up to n sweeps, stopping at a bitwise fixed point.
template <class Val>
__device__ __forceinline__ float wide_threshold(const Slots& s, Val val,
                                                float th, float rad,
                                                bool cold, int n) {
  if (cold) {
    float sum = 0.f;
#pragma unroll 4
    for (int k = 0; k < s.K; ++k) {
      const float x = val(k);
      sum += x > 0.5f * kNeg ? x : 0.f;
    }
    th = (lane_sum(sum) - rad) / (float)s.N;
  }
  for (int i = 0; i < n; ++i) {
    const unsigned before = bits(th);
    th = wide_sweep(s, val, th, rad);
    if (settled(th, before)) break;
  }
  return th;
}

// The ball's l1 (over the valid slots) and one sweep of its threshold from
// the carried theta, the three sums butterflied together.
template <class Val>
__device__ __forceinline__ float wide_l1_and_sweep(const Slots& s, Val val,
                                                   float& th, float rad) {
  float cnt = 0.f, sum = 0.f, l1 = 0.f;
#pragma unroll 4
  for (int k = 0; k < s.K; ++k) {
    const float x = val(k);
    const bool act = x > th;
    cnt += act ? 1.f : 0.f;
    sum += act ? x : 0.f;
    l1 += s.valid(k) ? x : 0.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, o);
    sum += __shfl_xor_sync(kFull, sum, o);
    l1 += __shfl_xor_sync(kFull, l1, o);
  }
  th = (sum - rad) / jmax(cnt, 1.f);
  return l1;
}

// The ball's share of the dual bound (excess_of): 0 inside the ball, else
// max(theta, 0), theta after n_sw sweeps from a cold start or (warm) from
// the carried theta, the l1 riding the first sweep.
template <class Val>
__device__ __forceinline__ float wide_ball_excess(const Slots& s, Val val,
                                                  float& th, float rad,
                                                  bool warm, int n_sw) {
  float l1;
  if (!warm) {
    l1 = 0.f;
#pragma unroll 4
    for (int k = 0; k < s.K; ++k) l1 += s.valid(k) ? val(k) : 0.f;
    l1 = lane_sum(l1);
    th = wide_threshold(s, val, th, rad, true, n_sw);
  } else {
    const unsigned before = bits(th);
    l1 = wide_l1_and_sweep(s, val, th, rad);
    if (!settled(th, before))
      th = wide_threshold(s, val, th, rad, false, n_sw - 1);
  }
  return l1 <= rad ? 0.f : jmax(th, 0.f);
}

// The row's portfolio value w . r, two-stage.
__device__ __forceinline__ float wide_port(const Slots& s, const float* w,
                                           const float* r) {
  float port = 0.f;
#pragma unroll 4
  for (int k = 0; k < s.K; ++k) port += w[k * 32] * r[k * 32];
  return lane_sum(port);
}

// g <- the scenario mean of r_s * scale / max(w . r_s, 1e-12) over the
// row's S returns, resident (rs: [S][N] at this lane's column) or streamed
// (ring, a RowRing or the cluster layout's TmaRing: its next() gives the
// next chunk at this lane's column): CW scenarios a chunk, their portfolio
// values two-stage (each lane over its slots, then `chunk_factors`'
// transposing butterfly), the gradient summed slot by slot over
// s = 0..S-1.
template <int CW, int ST, class Ring>
__device__ __forceinline__ void wide_scen_returns(const Slots& sl,
                                                  const float* w, float* g,
                                                  const float* rs,
                                                  Ring& ring, float scale,
                                                  int S) {
  const int K = sl.K, N = sl.N;
#pragma unroll 4
  for (int k = 0; k < K; ++k) g[k * 32] = 0.f;
  for (int s0 = 0; s0 < S; s0 += CW) {
    const float* const x =
        ST == kResident ? rs + (size_t)s0 * N : ring.next();
    auto at = [&](int s, int k) {
      if constexpr (ST == kResident)
        return sl.valid(k) && s0 + s < S ? x[s * N + k * 32] : 0.f;
      else
        return x[(s * K + k) * 32];
    };
    float port[CW];
#pragma unroll
    for (int s = 0; s < CW; ++s) port[s] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float wk = w[k * 32];
#pragma unroll
      for (int s = 0; s < CW; ++s) port[s] += wk * at(s, k);
    }
    float f[CW];
    chunk_factors<CW>(port, scale, sl.lane, f);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float acc = g[k * 32];
#pragma unroll
      for (int s = 0; s < CW; ++s)
        if (s0 + s < S) acc += at(s, k) * f[s];
      g[k * 32] = acc;
    }
  }
  const float fS = (float)S;
#pragma unroll 4
  for (int k = 0; k < K; ++k) g[k * 32] = g[k * 32] / fS;
}

template <int HB, int ST, int CW, bool ADAPT, bool PIPE>
__global__ void __launch_bounds__(HB * 32)
pdhg_log_utility_wide_kernel(Args a, AdaptArgs ad) {
  extern __shared__ float smem[];
  constexpr bool SCEN = ST != kRegisters;
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x >> 5;  // this warp's horizon row
  const int b = blockIdx.x;
  const int H = a.H, N = a.N, K = (N + 31) / 32, KW = K * 32;
  const int S = SCEN ? a.S : 0;
  const WidePlan P = SCEN ? wide_scen_plan(S, H, N, ADAPT, ST)
                          : wide_plan(H, N, ADAPT);
  const Slots s{K, N, lane};
  const int mine = t * KW + lane;  // this lane's slot 0 of its row
  const bool last = t + 1 == H;
  float* const r = smem + P.r + mine;
  float* const w = smem + P.w + mine;
  float* const p = smem + P.p + mine;
  float* const v = smem + P.v + mine;   // projection input, then dual input
  float* const wb = smem + P.wb + KW + mine;
  const float* const wbp = smem + P.wb + mine;   // row t - 1 (cw at t = 0)
  const float* const pn = p + KW;                // row t + 1 (not at last)
  float* const sdw = smem + P.dw + mine;
  float* const sdp = smem + P.dp + mine;
  const float* const rs = smem + P.rs + (size_t)t * S * N + lane;
  RowRing<CW> ring{smem + P.rs + (size_t)t * P.stages * CW * KW + lane,
                   a.r + ((size_t)b * S * H + t) * N + lane,
                   (long long)H * N, S, N, K, lane, P.stages,
                   (S + CW - 1) / CW, 0, 0, 0};

  // Returns, current weights (warp 0 into wbar's row -1), curvature bounds.
  float Lrow, L;
  if constexpr (SCEN) {
    // Scenario s of this row: read, kept where resident, its curvature
    // ratio summed for the row and staged in its chunk's slot; without
    // precond the scenario mean of the per-scenario max over the rows, a
    // chunk of staged ratios at a time, in scenario order.
    float* const srat = smem + P.rat;
    float* const slr = smem + P.lr;
    for (int k = 0; k < K; ++k) {
      const int i = k * 32 + lane;
      if (t == 0) smem[P.wb + i] = i < N ? a.cw[(size_t)b * N + i] : 0.f;
    }
    float row_sum = 0.f, max_sum = 0.f;
    for (int s0 = 0; s0 < S; s0 += kWideChunk) {
      const int s1 = min(s0 + kWideChunk, S);
      for (int sc = s0; sc < s1; ++sc) {
        float n2 = 0.f, mn = __int_as_float(0x7f800000);  // +inf
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          const bool ok = i < N;
          const float x =
              ok ? a.r[(((size_t)b * S + sc) * H + t) * N + i] : 0.f;
          if (ST == kResident && ok)
            smem[P.rs + ((size_t)t * S + sc) * N + i] = x;
          n2 += x * x;
          if (ok) mn = jmin(mn, x);
        }
        n2 = lane_sum(n2);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mn = jmin(mn, __shfl_xor_sync(kFull, mn, o));
        const float m = jmax(mn, 1e-12f);
        const float ratio = n2 / (m * m);
        if (lane == 0) srat[(sc - s0) * H + t] = ratio;
        row_sum += ratio;
      }
      if (!a.precond) {
        __syncthreads();
        for (int sc = s0; sc < s1; ++sc) {
          const float* const q = srat + (sc - s0) * H;
          float mx = q[0];
          for (int u = 0; u < H; ++u) mx = jmax(mx, q[u]);
          max_sum += mx;
        }
        __syncthreads();
      }
    }
    const float fS = (float)S;
    if (a.precond) {
      Lrow = row_sum / fS + a.ridge;
      if (lane == 0) slr[t] = Lrow;
      __syncthreads();
      L = slr[0];
      for (int u = 1; u < H; ++u) L = jmax(L, slr[u]);
    } else {
      L = max_sum / fS + a.ridge;
      Lrow = L;
    }
    if constexpr (ST == kStreamed) ring.start();
  } else {
    float n2 = 0.f, mn = __int_as_float(0x7f800000);  // +inf
    for (int k = 0; k < K; ++k) {
      const int i = k * 32 + lane;
      const bool ok = i < N;
      const float x = ok ? a.r[((size_t)b * H + t) * N + i] : 0.f;
      r[k * 32] = x;
      n2 += x * x;
      if (ok) mn = jmin(mn, x);
      if (t == 0)
        smem[P.wb + k * 32 + lane] = ok ? a.cw[(size_t)b * N + i] : 0.f;
    }
    n2 = lane_sum(n2);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mn = jmin(mn, __shfl_xor_sync(kFull, mn, o));
    const float m = jmax(mn, 1e-12f);
    const float ratio = n2 / (m * m);
    float* const srat = smem + P.rat;
    if (lane == 0) srat[t] = ratio;
    Lrow = ratio + a.ridge;
    __syncthreads();
    float mx = srat[0];
    for (int u = 1; u < H; ++u) mx = jmax(mx, srat[u]);
    L = mx + a.ridge;  // max_t (ratio_t + ridge)
  }

  float sig, tau;
  {
    const float s0 = a.sigma_scale * sqrtf(L) / 2.f;
    if (a.precond) {
      const float rowdeg = t == 0 ? 1.f : 2.f;
      const float coldeg = last ? 1.f : 2.f;
      sig = 2.f * s0 / rowdeg;
      tau = a.step_scale / (0.5f * Lrow + 2.f * s0 * coldeg);
    } else {
      sig = s0;
      tau = a.step_scale / (0.5f * L + s0 * 4.f);
    }
  }
  const float sig_tau = sig * a.tau_to;
  const float c1 = 1.f - tau * a.ridge;
  const float c = a.c;
  auto at_v = [=](int k) { return v[k * 32]; };

  // Start: the cold simplex projection of the current weights on every row
  // with a zero dual; or the warm iterates as given, with a cold threshold
  // taken on the warm primal. The ball threshold starts at 0.
  const bool warm_start = a.w_warm != nullptr;
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    const bool ok = i < N;
    const size_t at = ((size_t)b * H + t) * N + i;
    float x = wbp[k * 32 - t * KW];  // the current weights
    if (warm_start) x = ok ? a.w_warm[at] : 0.f;
    v[k * 32] = ok ? x : kNeg;
    w[k * 32] = x;
    p[k * 32] = (warm_start && a.p_warm != nullptr && ok) ? a.p_warm[at]
                                                          : 0.f;
  }
  float thw = wide_threshold(s, at_v, 0.f, 1.f, true, a.cold_iters);
  float thp = 0.f;
  if (!warm_start) {
    for (int k = 0; k < K; ++k) w[k * 32] = jmax(v[k * 32] - thw, 0.f);
  }
  __syncthreads();

  const bool warm = a.warm != 0;
  const bool ridge0 = a.ridge == 0.f;
  const bool relax = a.rho != 1.f;
  // w_new from the projection input; wbar = 2 w_new - w into shared memory
  // (with ADAPT the move w - w_new staged on a balancing iteration), w
  // updated; barrier A; the dual input q = p + sigma (wbar - wbar_{t-1})
  // into the projection input's slice.
  auto extrapolate = [&](bool stage) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float wo = w[k * 32];
      const float wn = jmax(v[k * 32] - thw, 0.f);
      if (stage) sdw[k * 32] = wo - wn;
      wb[k * 32] = 2.f * wn - wo;
      w[k * 32] = relax ? wo + a.rho * (wn - wo) : wn;
    }
    __syncthreads();  // A
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      v[k * 32] = p[k * 32] + sig * (wb[k * 32] - wbp[k * 32]);
  };
  if constexpr (!ADAPT) {
    const bool cond = warm && a.refresh > 1;  // make_body_cond
    // make_trip_pipe (PIPE; warm, refresh > 1): trips of kp - 1 pipelined
    // iterations and one synchronous one, synchronous iterations for the
    // remainder. The ball's l1 is carried; it and theta start at 0.
    const int kp = min(max(a.refresh, 1), 8);
    const int full = PIPE ? a.max_iters / kp * kp : 0;
    float l1s = 0.f;
    // |q| - c, clipped at 0: the dual magnitudes, masked.
    auto at_aq = [=](int k) {
      const float x = jmax(fabsf(v[k * 32]) - c, 0.f);
      return s.valid(k) ? x : kNeg;
    };
    for (int it = 0; it < a.max_iters; ++it) {
      int n_sw;
      bool sync = true;
      if constexpr (PIPE) {
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
      // the portfolio reciprocal and the ridge into c1.
      if constexpr (!SCEN) {
        const float f = tau / jmax(wide_port(s, w, r), 1e-12f);
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float g = r[k * 32] * f;
          const float nxt = !last ? pn[k * 32] : 0.f;
          const float base = ridge0 ? w[k * 32] : c1 * w[k * 32];
          const float x = base + __fmaf_rn(-tau, p[k * 32] - nxt, g);
          v[k * 32] = s.valid(k) ? x : kNeg;
        }
      } else {
        wide_scen_returns<CW, ST>(s, w, v, rs, ring, tau, S);
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float g = v[k * 32];
          const float nxt = !last ? pn[k * 32] : 0.f;
          const float base = ridge0 ? w[k * 32] : c1 * w[k * 32];
          const float x = base + __fmaf_rn(-tau, p[k * 32] - nxt, g);
          v[k * 32] = s.valid(k) ? x : kNeg;
        }
      }
      thw = wide_threshold(s, at_v, thw, 1.f, !warm, n_sw);
      extrapolate(false);

      // Dual prox on the q scale, clip form: clip(q, -bound, bound) with
      // bound = c inside the ball, c + max(theta, 0) outside.
      float bound = c;
      if (a.use_ball) {
        float excess;
        if constexpr (PIPE) {
          if (sync) {
            const unsigned before = bits(thp);
            l1s = wide_l1_and_sweep(s, at_aq, thp, sig_tau);
            if (!settled(thp, before))
              thp = wide_threshold(s, at_aq, thp, sig_tau, false, n_sw - 1);
          }
          excess = l1s <= sig_tau ? 0.f : jmax(thp, 0.f);
          if (!sync) l1s = wide_l1_and_sweep(s, at_aq, thp, sig_tau);
        } else {
          excess = wide_ball_excess(s, at_aq, thp, sig_tau, warm, n_sw);
        }
        bound = c + excess;
      }
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float pc = jmin(jmax(v[k * 32], -bound), bound);
        const float po = p[k * 32];
        p[k * 32] = relax ? po + a.rho * (pc - po) : pc;
      }
      __syncthreads();  // B
    }
  } else {
    // body_adaptive. tau and sig are the carried steps from here on (the
    // tail then steps by the last tau); alpha is one scalar per problem.
    float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;
    const int n_sw = warm ? a.warm_iters : a.cold_iters;
    float* const se = smem + P.e;  // [2][H][32] the lanes' residual sums
    for (int it = 0; it < a.max_iters; ++it) {
      const bool balance = ad.adapt_every <= 1 ||
                           (it % ad.adapt_every) == ad.adapt_every - 1;
      // Primal step: w - tau (grad g(w) + ridge w + D'p).
      if constexpr (!SCEN) {
        const float f = -1.f / jmax(wide_port(s, w, r), 1e-12f);
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          float gg = r[k * 32] * f;
          if (!ridge0) gg = gg + a.ridge * w[k * 32];
          const float nxt = !last ? pn[k * 32] : 0.f;
          const float x = w[k * 32] - tau * (gg + (p[k * 32] - nxt));
          v[k * 32] = s.valid(k) ? x : kNeg;
        }
      } else {
        wide_scen_returns<CW, ST>(s, w, v, rs, ring, -1.f, S);
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          float gg = v[k * 32];
          if (!ridge0) gg = gg + a.ridge * w[k * 32];
          const float nxt = !last ? pn[k * 32] : 0.f;
          const float x = w[k * 32] - tau * (gg + (p[k * 32] - nxt));
          v[k * 32] = s.valid(k) ? x : kNeg;
        }
      }
      thw = wide_threshold(s, at_v, thw, 1.f, !warm, n_sw);
      extrapolate(balance);

      // Dual prox on the a-scale: v = q / sigma, a = max(|v| - c / sigma,
      // 0), the ball of radius tau_to, p_new = q - sigma (v - clip(v)),
      // with c / sigma fused into both of its uses as in the row kernel.
      const float inv_s = 1.f / sig;
      float bound = c * inv_s;
      if (a.use_ball) {
        auto at_am = [=](int k) {
          const float x =
              jmax(__fmaf_rn(-c, inv_s, fabsf(v[k * 32] * inv_s)), 0.f);
          return s.valid(k) ? x : kNeg;
        };
        const float excess =
            wide_ball_excess(s, at_am, thp, a.tau_to, warm, n_sw);
        bound = __fmaf_rn(c, inv_s, excess);
      }
      // The moves before over-relaxation, then the update.
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float q = v[k * 32];
        const float vs = q * inv_s;
        const float inner = vs - jmin(jmax(vs, -bound), bound);
        const float qn = q - sig * inner;
        const float po = p[k * 32];
        if (balance) sdp[k * 32] = po - qn;
        p[k * 32] = relax ? po + a.rho * (qn - po) : qn;
      }
      __syncthreads();  // B

      // Residual balancing (ratio 1.5, alpha *= 0.95): pr = ||dw / tau -
      // D'dp||, dr = ||dp / sigma - D0 dw|| over all rows and assets.
      if (balance) {
        float e1s = 0.f, e2s = 0.f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float dw = sdw[k * 32], dp = sdp[k * 32];
          const float dpn = !last ? sdp[k * 32 + KW] : 0.f;
          const float dwp = t == 0 ? 0.f : sdw[k * 32 - KW];
          const float e1 = dw / tau - (dp - dpn);
          const float e2 = dp / sig - (dw - dwp);
          e1s += e1 * e1;
          e2s += e2 * e2;
        }
        se[t * 32 + lane] = e1s;
        se[(H + t) * 32 + lane] = e2s;
        __syncthreads();  // C
        float res0 = 0.f, res1 = 0.f;
        for (int u = 0; u < H; ++u) {
          res0 += se[u * 32 + lane];
          res1 += se[(H + u) * 32 + lane];
        }
        const float pr = sqrtf(lane_sum(res0)), dr = sqrtf(lane_sum(res1));
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
    if (ad.steps_out != nullptr && lane == 0) {
      float* o = ad.steps_out + (size_t)b * (2 * H + 4);
      o[t] = tau;
      o[H + t] = sig;
      if (t == 0) {
        o[2 * H] = alpha;
        o[2 * H + 1] = pr_last;
        o[2 * H + 2] = dr_last;
        o[2 * H + 3] = moved;
      }
    }
  }

  // Extra primal half-step with a cold full-budget projection; the
  // returned iterate is w_last and fp = max |w_last - w| over the problem.
  // The dual written out is the loop's last p.
  {
    if constexpr (!SCEN) {
      const float f = -1.f / jmax(wide_port(s, w, r), 1e-12f);
      for (int k = 0; k < K; ++k) {
        float gg = r[k * 32] * f;
        if (!ridge0) gg = gg + a.ridge * w[k * 32];
        const float nxt = !last ? pn[k * 32] : 0.f;
        const float x = w[k * 32] - tau * (gg + (p[k * 32] - nxt));
        v[k * 32] = s.valid(k) ? x : kNeg;
      }
    } else {
      wide_scen_returns<CW, ST>(s, w, v, rs, ring, -1.f, S);
      for (int k = 0; k < K; ++k) {
        float gg = v[k * 32];
        if (!ridge0) gg = gg + a.ridge * w[k * 32];
        const float nxt = !last ? pn[k * 32] : 0.f;
        const float x = w[k * 32] - tau * (gg + (p[k * 32] - nxt));
        v[k * 32] = s.valid(k) ? x : kNeg;
      }
    }
    thw = wide_threshold(s, at_v, thw, 1.f, true, a.cold_iters);
    float fp = 0.f;
    for (int k = 0; k < K; ++k) {
      if (s.valid(k)) {
        const size_t at = ((size_t)b * H + t) * N + k * 32 + lane;
        const float wl = jmax(v[k * 32] - thw, 0.f);
        fp = jmax(fp, fabsf(wl - w[k * 32]));
        a.w_out[at] = wl;
        if (a.p_out != nullptr) a.p_out[at] = p[k * 32];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      fp = jmax(fp, __shfl_xor_sync(kFull, fp, o));
    float* const sfp = smem + P.fp;
    if (lane == 0) sfp[t] = fp;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int u = 1; u < H; ++u) fp = jmax(fp, sfp[u]);
      a.fp_out[b] = fp;
    }
  }
  if constexpr (ST == kStreamed) ring_wait(0);  // the chunks in flight
}

template <int HB, int ST, int CW, bool ADAPT, bool PIPE>
cudaError_t wide_launch(const Args& a, const AdaptArgs& ad,
                        cudaStream_t stream) {
  const WidePlan P = ST == kRegisters
                         ? wide_plan(a.H, a.N, ADAPT)
                         : wide_scen_plan(a.S, a.H, a.N, ADAPT, ST);
  const long long smem = P.total * (long long)sizeof(float);
  if (smem > kSmemPerBlock || (ST == kStreamed && P.chunk != CW))
    return cudaErrorInvalidValue;
  auto kernel = pdhg_log_utility_wide_kernel<HB, ST, CW, ADAPT, PIPE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.B, a.H * 32, (size_t)smem, stream>>>(a, ad);
  return cudaGetLastError();
}

template <int HB, int ST, int CW, bool ADAPT>
cudaError_t wide_body(const Args& a, const AdaptArgs& ad, bool pipe,
                      cudaStream_t s) {
  if constexpr (!ADAPT) {
    if (pipe) return wide_launch<HB, ST, CW, ADAPT, true>(a, ad, s);
  }
  return wide_launch<HB, ST, CW, ADAPT, false>(a, ad, s);
}

template <int HB, bool SCEN, bool ADAPT>
cudaError_t wide_returns(const Args& a, const AdaptArgs& ad, bool pipe,
                         int storage, cudaStream_t s) {
  if constexpr (SCEN) {
    if (storage == kResident)
      return wide_body<HB, kResident, kWideChunk, ADAPT>(a, ad, pipe, s);
    if (storage != kStreamed) return cudaErrorInvalidValue;
    const int cw = wide_scen_plan(a.S, a.H, a.N, ADAPT, kStreamed).chunk;
    if (cw == 4) return wide_body<HB, kStreamed, 4, ADAPT>(a, ad, pipe, s);
    if (cw == 2) return wide_body<HB, kStreamed, 2, ADAPT>(a, ad, pipe, s);
    return wide_body<HB, kStreamed, 1, ADAPT>(a, ad, pipe, s);
  } else {
    if (storage != kRegisters) return cudaErrorInvalidValue;
    return wide_body<HB, kRegisters, 1, ADAPT>(a, ad, pipe, s);
  }
}

// One CTA of H warps per problem, compiled for at most 8, 20 or 32 warps,
// one forecast (storage kRegisters) or S scenarios resident or streamed;
// H > 32, another storage or a plan past a block's shared memory return
// cudaErrorInvalidValue (the wrapper checks first). pipe != 0 runs
// `make_trip_pipe` (warm and refresh > 1; never with ADAPT).
template <bool SCEN, bool ADAPT>
int wide_dispatch(const Args& a, const AdaptArgs& ad, int pipe, int storage,
                  void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.H > kWideMaxH || a.N <= 0 ||
      (SCEN && a.S <= 0) || (ADAPT && pipe))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hb = a.H <= 8 ? 8 : (a.H <= 20 ? 20 : 32);
  const bool pp = pipe != 0;
  if (hb == 8) return (int)wide_returns<8, SCEN, ADAPT>(a, ad, pp, storage, s);
  if (hb == 20)
    return (int)wide_returns<20, SCEN, ADAPT>(a, ad, pp, storage, s);
  return (int)wide_returns<32, SCEN, ADAPT>(a, ad, pp, storage, s);
}

}  // namespace
