// The log-utility PDHG solve in a row-per-warp layout, built for latency:
// one CTA per problem and one warp per horizon row. The same program and
// arithmetic as the warp kernels of pdhg_log_utility.cuh:
// `_make_packed_kernel` of kmpc_tpu/ops/mpc_pallas.py with S=None or S set,
// its bodies `make_body` (warm or cold thresholds), `make_body_cond`
// (refresh schedule), `make_trip_pipe` (PIPE, the pipelined reductions) and,
// with ADAPT, `body_adaptive`; precond, ridge, over-relaxation, ball on or
// off, warm inputs, the dual output and the extra primal half-step with the
// fixed-point residual.
//
// Bound. A solve moves its inputs and outputs once and does ~30 FP32
// operations per element an iteration (chip_smoke.py's `pdhg_bound` counts
// them, and stays the yardstick), but on this card what it waits on is the
// dependent chain of one iteration: the butterflies of the portfolio sum
// and of every Michelot sweep, each followed by an IEEE division, one after
// the other. The warp layout runs that chain for all pow2ceil(H) row slots
// of a problem in one warp, each slot behind a runtime `t < H` guard that
// the compiler wraps, shuffles and all, in a convergence barrier
// (BSSY/BSYNC): a lone warp at H=5 takes 13.6 us an iteration against
// 2.1 us at H=1 (PERF.md section 6, step 0), and at B=1 the rest of the card is
// idle.
//
// Design. Warp t owns horizon row t (H <= 32 warps, so at most 1024
// threads); asset i sits on lane i % 32, slot i / 32 (K = ceil(N/32) <= 4)
// as in the warp layout, and the row's w, p, returns, projection input and
// dual input live in registers. A row's sums are one warp's butterflies,
// unguarded, with no barrier: the warp layout's helpers at one row
// (`scaled_returns`, `sweep`, `ball_l1_and_sweep`, `excess_of`,
// `curvature_ratio`, `warp_sum`), or the same expressions in the same
// order, so the bits are the warp kernel's; where the compiler would fuse
// a multiply-add here other than there (the fixed-step primal step, the
// adaptive dual prox), the warp kernel's fma is written out. Rows meet
// only where the difference operator D couples neighbours and where the
// adaptive body balances its steps over the whole problem:
// - the primal step of row t reads the dual p_{t+1} of the previous
//   iteration, and the extrapolation q_t = p_t + sigma_t (wbar_t -
//   wbar_{t-1}) this iteration's wbar_{t-1} (the current weights stand in
//   for row -1). Both go through shared memory with two __syncthreads an
//   iteration: wbar is written before barrier A and read between A and B,
//   p read before A and written between A and B, so a warp that runs ahead
//   never overwrites a value a neighbour has yet to read, and one buffer of
//   each suffices;
// - on a balancing iteration each warp stages its row's moves (dw before A,
//   dp before B), then its per-lane residual terms e1 and e2; after a third
//   barrier every warp sums all rows' terms in the warp layout's order (row
//   outer, slot inner, res += e * e) and runs the same butterfly, so every
//   warp takes the same decision from the same bits;
// - L, the largest curvature ratio over the rows (for scenarios without
//   precond the scenario sum, s = 0..S-1, of the per-scenario maxima), is
//   exchanged once at the start; fp is a max, combined over the warps.
// Scenario returns (kernel B), in one of three storages: in registers
// when S * K <= kRowsRegSlots (S=16 at K=1); resident in the CTA's shared
// memory, [S][N] floats a row packed as the global array holds them (a
// problem of S=512 H=5 N=20 takes 204.8 KB), where the plan fits; else
// streamed, each warp its own row through a ring of 2 or 3 stages of a
// chunk, C = 16 / K scenarios of K * 32 floats, filled by 4-byte cp.async
// (zeros past N and past S) stages - 1 chunks ahead, the chunks of one pass
// wrapping into the next. A lane copies and reads only its own column, so
// its own cp.async.wait_group orders the ring and no barrier is added. Every
// storage hands the same chunks, in the same order, to the same
// expressions: the chunk's C portfolio partials are formed first and summed
// by one transposing butterfly (`chunk_factors`: the per-scenario
// butterfly's bits in 32 shuffles and one division a lane where that takes
// 80 and 16 at C=16) or, where that measured slower (`kTransposedSum`), by
// a butterfly per scenario, and the gradient is summed over s = 0..S-1; the
// storages give the same bits, the warp kernel's. The start's
// scenario mean of the per-scenario maxima over the rows (no precond) is
// reduced a chunk of ratios at a time, so the plan of the streamed storage
// does not grow with S: any S runs at H <= 32 and N <= 128. What bounds the
// streamed storage is the returns' bytes an iteration (S H N 4 a problem,
// read from L2 where the batch's returns fit it, else from HBM); the
// resident one the chunk chain of one CTA an SM.
// A projection's sweeps stop at a bitwise fixed point: a sweep that
// returns the threshold it started from, bit for bit, has the same active
// set, count and sum as every later sweep, so stopping there changes no bit
// and saves up to two of the three warm sweeps once the solve settles (a
// NaN threshold never compares equal and runs the full budget). The exit is
// warp-uniform and per row; it leaves only a sweep loop, never a phase with
// a barrier, so every warp reaches every __syncthreads.
// Registers: the kernel is compiled for at most HB warps (8, 20 or 32:
// __launch_bounds__ gives 255, 102 and 64 registers a thread), so H=5 keeps
// the warp kernel's register room and H=20 spills nothing.

#pragma once

#include "pdhg_log_utility.cuh"

namespace {

constexpr int kRowsMaxH = 32;
constexpr int kRowsRegSlots = 16;  // scenario returns per lane in registers
// Where a problem's scenario returns live (the C interface's `storage`).
constexpr int kRegisters = 0, kResident = 1, kStreamed = 2;

// Scenarios per chunk (and the register cap in scenarios) at K slots.
__host__ __device__ inline int rows_chunk(int K) { return kRowsRegSlots / K; }

// Offsets (in floats) of one problem's shared memory, and the total: the
// dual and wbar exchanged between rows, the adaptive body's moves and
// residual terms, the curvature ratios of a chunk of scenarios and the row
// bounds, the rows' fp, and the scenario returns: resident [H][S][N], or
// each warp's ring of `stages` chunk stages (3 where they fit, else 2).
struct RowsPlan {
  long long p, wb, dw, dp, e1, e2, rat, lr, fp, r, total;
  int stages;
};

__host__ __device__ inline RowsPlan rows_plan(int S, int H, int N,
                                              bool adapt, int storage) {
  const int K = (N + 31) / 32, C = rows_chunk(K);
  const long long HR = (long long)H * K * 32;
  RowsPlan P;
  long long o = 0;
  P.p = o; o += HR;
  P.wb = o; o += HR;
  P.dw = o; o += adapt ? HR : 0;
  P.dp = o; o += adapt ? HR : 0;
  P.e1 = o; o += adapt ? HR : 0;
  P.e2 = o; o += adapt ? HR : 0;
  P.rat = o; o += (long long)H * (S < 1 ? 1 : (S < C ? S : C));
  P.lr = o; o += H;
  P.fp = o; o += H;
  P.r = o;
  P.stages = 0;
  if (storage == kResident) o += (long long)H * S * N;
  if (storage == kStreamed) {
    const long long stage = HR * C;
    P.stages = (o + 3 * stage) * (long long)sizeof(float) <= kSmemPerBlock
                   ? 3 : 2;
    o += P.stages * stage;
  }
  P.total = o;
  return P;
}

// 4-byte asynchronous copy from global to shared memory, zeros where !ok.
// The "memory" clobbers keep the compiler from moving a stage's reads
// across the copies and the waits: no barrier orders them.
__device__ __forceinline__ void ring_copy4(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most `pending` (0 to 2) of this thread's copy groups are left.
__device__ __forceinline__ void ring_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One row's scenario returns streamed through its warp's ring of `stages`
// stages of C scenarios x K * 32 floats: chunk c of a pass holds scenarios
// c C .. c C + C - 1, slot k of scenario s at (s K + k) * 32 + lane. Chunks
// are issued in the order a pass reads them, stages - 1 ahead, wrapping
// from a pass's last chunk to the next pass's first.
template <int C>
struct RowRing {
  float* base;       // stage 0, at this lane's column
  const float* src;  // scenario 0 of this row, at this lane's column
  long long step;    // floats between two scenarios of a row: H N
  int S, N, K, lane, stages, chunks;
  int put, put_chunk, get;

  __device__ __forceinline__ int stage_floats() const { return C * K * 32; }
  __device__ __forceinline__ void issue() {
    float* const dst = base + put * stage_floats();
    const int s0 = put_chunk * C;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      for (int k = 0; k < K; ++k) {
        const bool ok = k * 32 + lane < N && s0 + s < S;
        ring_copy4(dst + (s * K + k) * 32,
                   ok ? src + (s0 + s) * step + k * 32 : src, ok);
      }
    }
    ring_commit();
    put = put + 1 == stages ? 0 : put + 1;
    put_chunk = put_chunk + 1 == chunks ? 0 : put_chunk + 1;
  }
  // The stages - 1 chunks ahead of a pass's first.
  __device__ __forceinline__ void start() {
    for (int i = 0; i + 1 < stages; ++i) issue();
  }
  // The next chunk of the pass: one more issued, the oldest awaited.
  __device__ __forceinline__ const float* next() {
    issue();
    ring_wait(stages - 1);
    const float* const x = base + get * stage_floats();
    get = get + 1 == stages ? 0 : get + 1;
    return x;
  }
};

__device__ __forceinline__ unsigned bits(float x) { return __float_as_uint(x); }

// Whether a sweep from the threshold whose bits are `before` returned it
// unchanged: every later sweep would repeat it, so the projection stops.
__device__ __forceinline__ bool settled(float th, unsigned before) {
  return bits(th) == before;
}

// threshold() at one row, the sweeps stopping at a bitwise fixed point.
template <int K>
__device__ __forceinline__ void row_threshold(const float (&vm)[1][K],
                                              float (&th)[1],
                                              const float (&rad)[1], int N,
                                              bool cold, int n) {
  threshold<1, K>(vm, th, rad, 1, N, cold, 0);
  for (int i = 0; i < n; ++i) {
    const unsigned before = bits(th[0]);
    sweep<1, K>(vm, th, rad, 1);
    if (settled(th[0], before)) break;
  }
}

// ball_excess() at one row, with the same early exit.
template <int K>
__device__ __forceinline__ void row_ball_excess(
    const float (&am)[1][K], const bool (&valid)[K], float (&thp)[1],
    const float (&rad)[1], int N, bool warm, int n_sw, float (&excess)[1]) {
  float l1[1];
  if (!warm) {
    l1[0] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) l1[0] += valid[k] ? am[0][k] : 0.f;
    warp_sum<1>(l1, 1);
    row_threshold<K>(am, thp, rad, N, true, n_sw);
  } else {
    const unsigned before = bits(thp[0]);
    ball_l1_and_sweep<1, K>(am, valid, thp, rad, 1, l1);
    if (!settled(thp[0], before))
      row_threshold<K>(am, thp, rad, N, false, n_sw - 1);
  }
  excess_of<1>(l1, thp, rad, 1, excess);
}

// The C portfolio values of a chunk, each lane's partial over its slots in
// port[s], summed across the warp, and f[s] = scale / max(sum_s, 1e-12) on
// every lane. A transposing butterfly: at each of the first log2(CP) levels
// (CP, C rounded up to a power of two, the values past C zero) a lane keeps
// the half of its values its lane bit picks and adds its partner's partials
// of them, one shuffle a value kept; the last levels are a plain butterfly
// of the one value left. Every partial pairs lane l with lane l ^ o as a
// butterfly per scenario does, so each sum has that butterfly's bits; it
// takes CP - 1 + 5 - log2(CP) shuffles and C more to broadcast (32 at C=16,
// against 80) and one division a lane (against C). Scenario s ends on lanes
// s * 32 / CP to (s + 1) * 32 / CP - 1, whence its factor is broadcast.
template <int C>
__device__ __forceinline__ void chunk_factors(const float (&port)[C],
                                              float scale, int lane,
                                              float (&f)[C]) {
  constexpr int CP = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : C <= 8 ? 8 : 16;
  constexpr int L = CP == 1 ? 0 : CP == 2 ? 1 : CP == 4 ? 2 : CP == 8 ? 3 : 4;
  float v[CP];
#pragma unroll
  for (int s = 0; s < CP; ++s) v[s] = s < C ? port[s] : 0.f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int o = 16 >> j, h = CP >> (j + 1);
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = hi ? v[i] : v[i + h];
      const float keep = hi ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
#pragma unroll
  for (int o = 16 >> L; o > 0; o >>= 1)
    v[0] += __shfl_xor_sync(kFull, v[0], o);
  const float mine = scale / jmax(v[0], 1e-12f);
#pragma unroll
  for (int s = 0; s < C; ++s)
    f[s] = CP == 1 ? mine : __shfl_sync(kFull, mine, s << (5 - L));
}

// Whether an instantiation sums a chunk's portfolio values by the
// transposing butterfly (`chunk_factors`) or by one butterfly per scenario
// with a division each: the same bits either way, so the faster one as
// measured (PERF.md section 6): at one slot and 8 warps a CTA with
// the returns in registers or streamed the butterfly per scenario ran
// 1.3-3x faster, everywhere else the transposing one 1.1-1.5x.
template <int K, int HB, int ST>
constexpr bool kTransposedSum = !(K == 1 && HB == 8 && ST != kResident);

// One chunk of C scenarios x of a row into g: the portfolio values w . x_s
// (each lane over its slots), their factors, and g += x_s f_s for the
// scenarios s0 + s < S, s in order.
template <int K, int C, bool TRANSPOSED>
__device__ __forceinline__ void row_chunk(const float (&w)[1][K],
                                          const float (&x)[C][1][K], int s0,
                                          int S, float scale, int lane,
                                          float (&g)[1][K]) {
  float port[C], f[C];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    port[s] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) port[s] += w[0][k] * x[s][0][k];
  }
  if constexpr (TRANSPOSED) {
    chunk_factors<C>(port, scale, lane, f);
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int s = 0; s < C; ++s)
        port[s] += __shfl_xor_sync(kFull, port[s], o);
    }
#pragma unroll
    for (int s = 0; s < C; ++s) f[s] = scale / jmax(port[s], 1e-12f);
  }
#pragma unroll
  for (int s = 0; s < C; ++s) {
    if (s0 + s < S) {
#pragma unroll
      for (int k = 0; k < K; ++k) g[0][k] += x[s][0][k] * f[s];
    }
  }
}

// scaled_returns() at one row: r * scale / max(w . r, 1e-12); with SCEN the
// scenario mean, summed s = 0..S-1, from the registers rr (kRegisters), the
// row's resident returns rs ([S][N] at this lane's column) or its ring.
template <int K, int C, bool SCEN, int ST, bool TRANSPOSED>
__device__ __forceinline__ void row_scaled_returns(
    const float (&w)[1][K], const float (&r)[1][K],
    const float (&rr)[C][1][K], const float* rs, RowRing<C>& ring,
    const bool (&valid)[K], float scale, int S, int N, int lane,
    float (&g)[1][K]) {
  if constexpr (!SCEN) {
    const float sc[1] = {scale};
    scaled_returns<1, K, false>(w, r, nullptr, sc, 0, 1, lane, g);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) g[0][k] = 0.f;
    if constexpr (ST == kRegisters) {
      row_chunk<K, C, TRANSPOSED>(w, rr, 0, S, scale, lane, g);
    } else {
      for (int s0 = 0; s0 < S; s0 += C) {
        float x[C][1][K];
        if constexpr (ST == kResident) {
#pragma unroll
          for (int s = 0; s < C; ++s) {
#pragma unroll
            for (int k = 0; k < K; ++k)
              x[s][0][k] = valid[k] && s0 + s < S
                               ? rs[(s0 + s) * N + k * 32] : 0.f;
          }
        } else {
          const float* const st = ring.next();
#pragma unroll
          for (int s = 0; s < C; ++s) {
#pragma unroll
            for (int k = 0; k < K; ++k) x[s][0][k] = st[(s * K + k) * 32];
          }
        }
        row_chunk<K, C, TRANSPOSED>(w, x, s0, S, scale, lane, g);
      }
    }
    const float fS = (float)S;
#pragma unroll
    for (int k = 0; k < K; ++k) g[0][k] = g[0][k] / fS;
  }
}

template <int K, int HB, bool SCEN, int ST, bool ADAPT, bool PIPE>
__global__ void __launch_bounds__(HB * 32)
pdhg_log_utility_rows_kernel(Args a, AdaptArgs ad) {
  extern __shared__ float smem[];
  constexpr int C = SCEN ? kRowsRegSlots / K : 1;
  constexpr int KW = K * 32;
  constexpr bool TSUM = kTransposedSum<K, HB, ST>;
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x >> 5;  // this warp's horizon row
  const int b = blockIdx.x;
  const int H = a.H, N = a.N, S = SCEN ? a.S : 0;
  const RowsPlan P = rows_plan(S, H, N, ADAPT, ST);
  float* const sp = smem + P.p;    // [H][K * 32] the current dual
  float* const swb = smem + P.wb;  // [H][K * 32] this iteration's wbar
  float* const sdw = smem + P.dw;  // [H][K * 32] w - w_new (balancing)
  float* const sdp = smem + P.dp;  // [H][K * 32] p - p_new (balancing)
  float* const se1 = smem + P.e1;  // [H][K * 32] residual terms
  float* const se2 = smem + P.e2;
  const int mine = t * KW + lane;  // this lane's slot 0 of its row
  const bool last = t + 1 == H;

  bool valid[K];
  float cw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    valid[k] = i < N;
    cw[k] = valid[k] ? a.cw[(size_t)b * N + i] : 0.f;
  }

  // Returns into registers (or the CTA's shared memory, or the ring's
  // source), the curvature bounds Lrow (this row's, under precond) and L
  // (the problem's).
  float r[1][K];
  float rr[C][1][K];
  float* const rs = smem + P.r + (size_t)t * S * N + lane;
  RowRing<C> ring{smem + P.r + (size_t)t * P.stages * C * KW + lane,
                  a.r + ((size_t)b * S * H + t) * N + lane,
                  (long long)H * N, S, N, K, lane, P.stages,
                  (S + C - 1) / C, 0, 0, 0};
  float Lrow, L;
  {
    float* const srat = smem + P.rat;
    float* const slr = smem + P.lr;
    if constexpr (!SCEN) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = k * 32 + lane;
        r[0][k] = valid[k] ? a.r[((size_t)b * H + t) * N + i] : 0.f;
      }
      float ratio[1];
      curvature_ratio<1, K>(r, valid, 1, ratio);
      if (lane == 0) srat[t] = ratio[0];
      Lrow = ratio[0] + a.ridge;
      __syncthreads();
      float mx = srat[0];
      for (int u = 1; u < H; ++u) mx = jmax(mx, srat[u]);
      L = mx + a.ridge;  // max_t (ratio_t + ridge)
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) r[0][k] = 0.f;
      float row_sum = 0.f, max_sum = 0.f;
      // Scenario s of this row: read, kept where resident, its ratio staged
      // in its chunk's slot and summed.
      auto stage = [&](int s, float (&x)[1][K]) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          x[0][k] = valid[k]
                        ? a.r[(((size_t)b * S + s) * H + t) * N + i] : 0.f;
          if constexpr (ST == kResident)
            if (valid[k]) rs[s * N + k * 32] = x[0][k];
        }
        float ratio[1];
        curvature_ratio<1, K>(x, valid, 1, ratio);
        if (lane == 0) srat[(s % C) * H + t] = ratio[0];
        row_sum += ratio[0];
      };
      // Without precond: the scenario mean of the per-scenario max over the
      // horizon, summed over a chunk's staged ratios in scenario order.
      auto reduce = [&](int s0, int s1) {
        if (a.precond) return;
        __syncthreads();
        for (int s = s0; s < s1; ++s) {
          const float* const q = srat + (s - s0) * H;
          float mx = q[0];
          for (int u = 0; u < H; ++u) mx = jmax(mx, q[u]);
          max_sum += mx;
        }
        __syncthreads();
      };
      if constexpr (ST == kRegisters) {
#pragma unroll
        for (int s = 0; s < C; ++s) {
#pragma unroll
          for (int k = 0; k < K; ++k) rr[s][0][k] = 0.f;
          if (s < S) stage(s, rr[s]);
        }
        reduce(0, S);
      } else {
        for (int s0 = 0; s0 < S; s0 += C) {
          const int s1 = min(s0 + C, S);
          for (int s = s0; s < s1; ++s) {
            float x[1][K];
            stage(s, x);
          }
          reduce(s0, s1);
        }
      }
      const float fS = (float)S;
      if (a.precond) {
        // Per-row bound: the scenario mean of the row's ratios; the global
        // scale from the max of those means.
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
    }
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
  const float sig_tau[1] = {sig * a.tau_to};
  const float c1 = 1.f - tau * a.ridge;
  const float one[1] = {1.f};

  // Start: the cold simplex projection of the current weights on every
  // row with a zero dual; or the warm iterates as given, with a cold
  // threshold taken on the warm primal. The ball threshold starts at 0.
  float thw[1], thp[1] = {0.f};
  float vm[1][K], w[1][K], p[1][K];
  const bool warm_start = a.w_warm != nullptr;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t at = ((size_t)b * H + t) * N + k * 32 + lane;
    float x = cw[k];
    if (warm_start) x = valid[k] ? a.w_warm[at] : 0.f;
    vm[0][k] = valid[k] ? x : kNeg;
    w[0][k] = x;
    p[0][k] = (warm_start && a.p_warm != nullptr && valid[k])
                  ? a.p_warm[at] : 0.f;
    sp[mine + k * 32] = p[0][k];
  }
  row_threshold<K>(vm, thw, one, N, true, a.cold_iters);
  if (!warm_start) {
#pragma unroll
    for (int k = 0; k < K; ++k) w[0][k] = jmax(vm[0][k] - thw[0], 0.f);
  }
  __syncthreads();

  const bool warm = a.warm != 0;
  const bool ridge0 = a.ridge == 0.f;
  const bool relax = a.rho != 1.f;
  // 2 w_new - w of this row into shared memory; q = p + sigma D(wbar)
  // from the row above's (barrier A between).
  auto extrapolate = [&](const float (&wn)[1][K], float (&q)[1][K]) {
    float wb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wb[k] = 2.f * wn[0][k] - w[0][k];
      swb[mine + k * 32] = wb[k];
    }
    __syncthreads();  // A
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float wbp = t == 0 ? cw[k] : swb[mine - KW + k * 32];
      q[0][k] = p[0][k] + sig * (wb[k] - wbp);
    }
  };
  if constexpr (!ADAPT) {
    const bool cond = warm && a.refresh > 1;  // make_body_cond
    // make_trip_pipe (PIPE; warm, refresh > 1): trips of kp - 1 pipelined
    // iterations and one synchronous one, synchronous iterations for the
    // remainder. The ball's l1 is carried; it and theta start at 0.
    const int kp = min(max(a.refresh, 1), 8);
    const int full = PIPE ? a.max_iters / kp * kp : 0;
    float l1s[1] = {0.f};
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
      // the portfolio reciprocal and the ridge into c1. The warp kernel
      // contracts g - tau (p - nxt) as fma(-tau, p - nxt, g), g rounded;
      // left to itself the compiler fuses g's product r f here instead, so
      // the fma is written out.
      {
        float g[1][K];
        row_scaled_returns<K, C, SCEN, ST, TSUM>(w, r, rr, rs, ring, valid,
                                                 tau, S, N, lane, g);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float nxt = !last ? sp[mine + KW + k * 32] : 0.f;
          const float base = ridge0 ? w[0][k] : c1 * w[0][k];
          const float v = base + __fmaf_rn(-tau, p[0][k] - nxt, g[0][k]);
          vm[0][k] = valid[k] ? v : kNeg;
        }
      }
      row_threshold<K>(vm, thw, one, N, !warm, n_sw);

      float wn[1][K], q[1][K];
#pragma unroll
      for (int k = 0; k < K; ++k) wn[0][k] = jmax(vm[0][k] - thw[0], 0.f);
      extrapolate(wn, q);

      // Dual prox on the q scale, clip form: clip(q, -bound, bound) with
      // bound = c inside the ball, c + max(theta, 0) outside.
      float bound = a.c;
      if (a.use_ball) {
        float aq[1][K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float x = jmax(fabsf(q[0][k]) - a.c, 0.f);
          aq[0][k] = valid[k] ? x : kNeg;
        }
        float excess[1];
        if constexpr (PIPE) {
          if (sync) {
            const unsigned before = bits(thp[0]);
            ball_l1_and_sweep<1, K>(aq, valid, thp, sig_tau, 1, l1s);
            if (!settled(thp[0], before))
              row_threshold<K>(aq, thp, sig_tau, N, false, n_sw - 1);
          }
          excess_of<1>(l1s, thp, sig_tau, 1, excess);
          if (!sync) ball_l1_and_sweep<1, K>(aq, valid, thp, sig_tau, 1, l1s);
        } else {
          row_ball_excess<K>(aq, valid, thp, sig_tau, N, warm, n_sw, excess);
        }
        bound = a.c + excess[0];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float pn = jmin(jmax(q[0][k], -bound), bound);
        if (relax) {
          w[0][k] = w[0][k] + a.rho * (wn[0][k] - w[0][k]);
          p[0][k] = p[0][k] + a.rho * (pn - p[0][k]);
        } else {
          w[0][k] = wn[0][k];
          p[0][k] = pn;
        }
        sp[mine + k * 32] = p[0][k];
      }
      __syncthreads();  // B
    }
  } else {
    // body_adaptive. tau and sig are the carried steps from here on (the
    // tail then steps by the last tau); alpha is one scalar per problem.
    float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;
    const float rad[1] = {a.tau_to};
    const int n_sw = warm ? a.warm_iters : a.cold_iters;
    for (int it = 0; it < a.max_iters; ++it) {
      const bool balance = ad.adapt_every <= 1 ||
                           (it % ad.adapt_every) == ad.adapt_every - 1;
      // Primal step: w - tau (grad g(w) + ridge w + D'p).
      {
        float g[1][K];
        row_scaled_returns<K, C, SCEN, ST, TSUM>(w, r, rr, rs, ring, valid,
                                                 -1.f, S, N, lane, g);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float gg = g[0][k];
          if (!ridge0) gg = gg + a.ridge * w[0][k];
          const float nxt = !last ? sp[mine + KW + k * 32] : 0.f;
          const float v = w[0][k] - tau * (gg + (p[0][k] - nxt));
          vm[0][k] = valid[k] ? v : kNeg;
        }
      }
      row_threshold<K>(vm, thw, one, N, !warm, n_sw);

      float wn[1][K], q[1][K], dw[K], dp[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        wn[0][k] = jmax(vm[0][k] - thw[0], 0.f);
        dw[k] = w[0][k] - wn[0][k];
        if (balance) sdw[mine + k * 32] = dw[k];
      }
      extrapolate(wn, q);

      // Dual prox on the a-scale: v = q / sigma, a = max(|v| - c / sigma,
      // 0), the ball of radius tau_to, p_new = q - sigma (v - clip(v)).
      // With the ball the warp kernel fuses c / sigma = c inv_s into both
      // of its uses, |v| - c inv_s and c inv_s + excess; the fmas are
      // written out so that this kernel gives its bits.
      const float inv_s = 1.f / sig;
      float bound = a.c * inv_s;
      if (a.use_ball) {
        float am[1][K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float x =
              jmax(__fmaf_rn(-a.c, inv_s, fabsf(q[0][k] * inv_s)), 0.f);
          am[0][k] = valid[k] ? x : kNeg;
        }
        float excess[1];
        row_ball_excess<K>(am, valid, thp, rad, N, warm, n_sw, excess);
        bound = __fmaf_rn(a.c, inv_s, excess[0]);
      }
      // q becomes p_new; the moves before over-relaxation, then the update.
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v = q[0][k] * inv_s;
        const float inner = v - jmin(jmax(v, -bound), bound);
        q[0][k] = q[0][k] - sig * inner;
        dp[k] = p[0][k] - q[0][k];
        if (balance) sdp[mine + k * 32] = dp[k];
        if (relax) {
          w[0][k] = w[0][k] + a.rho * (wn[0][k] - w[0][k]);
          p[0][k] = p[0][k] + a.rho * (q[0][k] - p[0][k]);
        } else {
          w[0][k] = wn[0][k];
          p[0][k] = q[0][k];
        }
        sp[mine + k * 32] = p[0][k];
      }
      __syncthreads();  // B

      // Residual balancing (ratio 1.5, alpha *= 0.95): pr = ||dw / tau -
      // D'dp||, dr = ||dp / sigma - D0 dw|| over all rows and assets.
      if (balance) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dpn = !last ? sdp[mine + KW + k * 32] : 0.f;
          const float dwp = t == 0 ? 0.f : sdw[mine - KW + k * 32];
          se1[mine + k * 32] = dw[k] / tau - (dp[k] - dpn);
          se2[mine + k * 32] = dp[k] / sig - (dw[k] - dwp);
        }
        __syncthreads();  // C
        float res[2] = {0.f, 0.f};
        for (int u = 0; u < H; ++u) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float e1 = se1[u * KW + k * 32 + lane];
            const float e2 = se2[u * KW + k * 32 + lane];
            res[0] += e1 * e1;
            res[1] += e2 * e2;
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
    float g[1][K];
    row_scaled_returns<K, C, SCEN, ST, TSUM>(w, r, rr, rs, ring, valid,
                                             -1.f, S, N, lane, g);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float gg = g[0][k];
      if (!ridge0) gg = gg + a.ridge * w[0][k];
      const float nxt = !last ? sp[mine + KW + k * 32] : 0.f;
      const float v = w[0][k] - tau * (gg + (p[0][k] - nxt));
      vm[0][k] = valid[k] ? v : kNeg;
    }
    row_threshold<K>(vm, thw, one, N, true, a.cold_iters);
    float fp = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (valid[k]) {
        const size_t at = ((size_t)b * H + t) * N + k * 32 + lane;
        const float wl = jmax(vm[0][k] - thw[0], 0.f);
        fp = jmax(fp, fabsf(wl - w[0][k]));
        a.w_out[at] = wl;
        if (a.p_out != nullptr) a.p_out[at] = p[0][k];
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

template <int K, int HB, bool SCEN, int ST, bool ADAPT, bool PIPE>
cudaError_t rows_launch(const Args& a, const AdaptArgs& ad,
                        cudaStream_t stream) {
  const long long smem = rows_plan(SCEN ? a.S : 0, a.H, a.N, ADAPT, ST).total
                         * (long long)sizeof(float);
  if (smem > kSmemPerBlock) return cudaErrorInvalidValue;
  auto kernel = pdhg_log_utility_rows_kernel<K, HB, SCEN, ST, ADAPT, PIPE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.B, a.H * 32, (size_t)smem, stream>>>(a, ad);
  return cudaGetLastError();
}

template <int K, int HB, bool SCEN, int ST, bool ADAPT>
cudaError_t rows_body(const Args& a, const AdaptArgs& ad, bool pipe,
                      cudaStream_t s) {
  if constexpr (!ADAPT) {
    if (pipe) return rows_launch<K, HB, SCEN, ST, ADAPT, true>(a, ad, s);
  }
  return rows_launch<K, HB, SCEN, ST, ADAPT, false>(a, ad, s);
}

template <int K, int HB, bool SCEN, bool ADAPT>
cudaError_t rows_returns(const Args& a, const AdaptArgs& ad, bool pipe,
                         int storage, cudaStream_t s) {
  if constexpr (SCEN) {
    if (storage == kResident)
      return rows_body<K, HB, SCEN, kResident, ADAPT>(a, ad, pipe, s);
    if (storage == kStreamed)
      return rows_body<K, HB, SCEN, kStreamed, ADAPT>(a, ad, pipe, s);
    if (a.S > rows_chunk(K)) return cudaErrorInvalidValue;
  }
  if (storage != kRegisters) return cudaErrorInvalidValue;
  return rows_body<K, HB, SCEN, kRegisters, ADAPT>(a, ad, pipe, s);
}

// One CTA of H warps per problem, compiled for K = 1..4 and at most 8, 20
// or 32 warps, the scenario returns in the given storage (kRegisters for
// one forecast, and for S * K <= 16 only); H > 32, K > 4, a storage that
// does not take S or a plan past a block's shared memory return
// cudaErrorInvalidValue (the wrapper checks first). pipe != 0 runs
// `make_trip_pipe` (warm and refresh > 1; never with ADAPT).
template <bool SCEN, bool ADAPT>
int rows_dispatch(const Args& a, const AdaptArgs& ad, int pipe, int storage,
                  void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.H > kRowsMaxH || a.N <= 0 ||
      (SCEN && a.S <= 0) || (ADAPT && pipe))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (a.N + 31) / 32;
  const int hb = a.H <= 8 ? 8 : (a.H <= 20 ? 20 : 32);
  const bool pp = pipe != 0;

#define KMPC_ROWS(K_, HB_)                                          \
  if (K == K_ && hb == HB_)                                         \
    return (int)rows_returns<K_, HB_, SCEN, ADAPT>(a, ad, pp, storage, s);
  KMPC_ROWS(1, 8) KMPC_ROWS(2, 8) KMPC_ROWS(3, 8) KMPC_ROWS(4, 8)
  KMPC_ROWS(1, 20) KMPC_ROWS(2, 20) KMPC_ROWS(3, 20) KMPC_ROWS(4, 20)
  KMPC_ROWS(1, 32) KMPC_ROWS(2, 32) KMPC_ROWS(3, 32) KMPC_ROWS(4, 32)
#undef KMPC_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace
