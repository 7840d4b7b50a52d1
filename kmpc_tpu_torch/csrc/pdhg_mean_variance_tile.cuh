// The mean-variance PDHG solve (the Markowitz baseline's program) in a tile
// layout built for the H100: one warp per (problem, horizon row), several
// problems a CTA, and the quadratic gradient Sigma W taken by the whole CTA
// for all of its rows at once, with one Sigma per CTA that is either staged
// once (resident) or streamed through a ring of shared-memory stages.
//
// Replaces the TPU kernel `_make_packed_mv_kernel` of
// kmpc_tpu/ops/mpc_pallas.py:1089 (its adaptive branch :1196), the same
// program and options as the warp and block kernels: the fixed-step body
// (full warm budget, the refresh schedule of `proj_refresh_every`, or cold
// projections) and, with ADAPT, residual balancing on every
// `adapt_every`-th iteration with the steps written out; the Frobenius-norm
// step rule, over-relaxation, the clip-form dual (the program has no
// turnover ball), a per-problem or a shared covariance, and the extra
// primal half-step with the fixed-point residual. The TPU kernel holds one
// shared Sigma in VMEM for a tile of 128 or 256 problems and takes the
// product as one MXU matmul at Precision.HIGHEST (:1145-1159): Sigma is
// reused across the batch tile. The block layout (one problem a CTA,
// pdhg_mean_variance_block.cuh) reuses it across nothing: past shared
// memory every problem reads all N^2 floats of Sigma from L2 on every
// iteration, each thread's loads one after another, and below it the chain
// of stacked block reduces sets the pace.
//
// What bounds it, per shape. The product's FP32 work, N^2 P H FMAs a CTA an
// iteration, and the shared-memory loads that feed it (one 16-byte load of
// Sigma and RC / 4 broadcast loads of W per 4 RC FMAs); with a shared Sigma
// past shared memory (N=960 at H=1, N=320 at H=5) the L2 bytes of Sigma,
// ceil(B / P) N^2 4 an iteration, behind them (the H100 reads one matrix
// from L2 into 264 CTAs at 11.7 TB/s: PERF.md, step 0). With a Sigma that
// fits beside the rows and a small N, the chain of one iteration (three
// barriers, a butterfly and a division per Michelot sweep) and the CTAs
// an SM holds.
//
// Design. P problems a CTA (P = 1 with a per-problem Sigma, so that a CTA
// always holds one Sigma), warp c on column c = (problem c / H, row c % H),
// so P H <= 32 warps. Asset i sits on lane i % 32, slot i / 32 (K slots).
// A row's w, p, mu, projection input and current weights live in
// registers at K <= 4 (KR = K), as in pdhg_log_utility_rows.cuh; past that
// (KR = 0) w, p and the projection input are shared slices only the lane's
// column touches, as in pdhg_log_utility_wide.cuh, and mu and the current
// weights are read from global memory (L2). A row's sums are two-stage
// (slots in order, then one butterfly), the Michelot threshold is taken
// per warp by the row and wide layouts' helpers (`row_threshold`,
// `wide_threshold`), and sweeps stop at a bitwise fixed point.
// Rows t - 1 and t + 1 of a problem meet through shared memory as in the
// row layout: p_{t+1} of the previous iteration and wbar_{t-1} of this
// one; at H = 1 a row meets nobody, and its update is one pass over the
// slots.
// The product G = Sigma W, W the CTA's [N x P H] block of w, kept by asset
// (W^T: [N][CP], columns padded with zeros to the tile width RC) beside the
// rows' own copies: Sigma is symmetric (the wrapper symmetrises it), so
// G[i, c] = sum_j Sigma[j, i] W[j, c] reads whole rows of Sigma. Each
// thread holds a 4 x RC register tile of G (four consecutive assets i, RC
// columns c), reads Sigma's four entries as one 16-byte load and W's RC as
// RC / 4 broadcast 16-byte loads, and adds in j order with plain FP32 FMAs
// (no tensor cores: the reference pins the product to float32; TF32 would
// break the mean-variance bars). Sigma resident (RC = 4): staged once per
// CTA where it fits beside the rows' arrays. Sigma streamed (RC = 8): row
// blocks Sigma[j0:j0 + Tj, :] go through a ring of three stages filled by
// cp.async (16 bytes where N % 4 == 0, else 4), two stages ahead, one
// barrier a stage; the blocks of the next iteration's product are in
// flight while the rows run their phase. With P problems a CTA the L2
// reads of a shared Sigma fall P-fold.
// Per iteration: two barriers around the product (B1 orders the rows'
// writes of W before it, B2 its G before the rows' reads), barrier A
// between wbar's write and its read (H > 1), and on a balancing iteration
// with H > 1 two more (the moves, then the rows' residual partials); tau,
// sigma, alpha and the balancing decision are per problem: every warp of a
// problem sums the problem's rows' partials in row order, lane by lane,
// and runs the same butterfly, so all take the same decision from the
// same bits, with no atomics.
// P and the plan (`mv_tile_problems`, `mv_tile_layout`; the wrapper keeps
// a copy, checked against the built library): P is the largest value
// whose plan fits a block's shared memory with P H <= 32 and that needs no
// more CTAs a wave per SM than a smaller one (the ceil of the CTAs over
// the 132 SMs, times P, least); a ragged last CTA runs its missing
// problems on the CTA's first problem's inputs and writes nothing for
// them. Registers: a resident kernel is compiled for 3 CTAs an SM at 8
// warps and 2 at 20 (85 and 48 registers a thread), so that small solves
// keep several CTAs on an SM; a streamed one holds its tiles.

#pragma once

#include <cstdint>

#include "pdhg_log_utility_wide.cuh"
#include "pdhg_mean_variance.cuh"

namespace {

constexpr int kTileMaxWarps = 32;
constexpr int kTileSMs = 132;     // SMs of an H100 SXM: the plan's wave
constexpr int kTileStages = 3;    // the ring of Sigma's row blocks

// Warps the kernel is compiled for at C columns (as the row kernels), and
// the product's register tiles a thread holds across a ring's stages when
// Sigma is streamed (4 x 8 floats each); a resident Sigma is summed one
// tile at a time.
__host__ __device__ inline int tile_hb(int C) {
  return C <= 8 ? 8 : (C <= 20 ? 20 : 32);
}
__host__ __device__ constexpr int tile_items(int hb) {
  return hb == 8 ? 2 : 1;
}

// Offsets (in floats, multiples of four) of one CTA's shared memory and
// its total: W^T ([N][CP], the rows' w by asset, CP = C rounded up to the
// product's tile width RC: 4 resident, 8 streamed), the rows' w ([C][KW],
// past four slots a lane; in registers below), G then the projection input
// ([C][KW]), the dual, wbar (H > 1), the moves dw and dp (ADAPT, H > 1)
// and the lanes' residual partials (ADAPT), a reduce staging of one float
// a warp, and last Sigma: [N][NP] resident where the whole plan fits
// (Tj = 0), else a ring of three stages of Tj rows, Tj the largest of 16,
// 8, 4 that fits, where every thread's tiles fit its registers
// (tile_items). ok = false: the shape is not taken.
struct MvTilePlan {
  int C, CP, KW, NP, NQ, Tj;
  long long wt, w, v, p, wb, dw, dp, e, red, sg, total;
  bool ok;
};

__host__ __device__ inline MvTilePlan mv_tile_arrays(int P, int H, int N,
                                                      bool adapt, int RC) {
  MvTilePlan L;
  L.C = P * H;
  L.CP = (L.C + RC - 1) / RC * RC;
  L.KW = (N + 31) / 32 * 32;
  L.NP = (N + 3) / 4 * 4;
  L.NQ = L.NP / 4;
  const long long R = L.KW;
  long long o = 0;
  L.wt = o; o += (long long)N * L.CP;
  L.w = o; o += N > 128 ? L.C * R : 0;
  L.v = o; o += L.C * R;
  L.p = o; o += L.C * R;
  L.wb = o; o += H > 1 ? L.C * R : 0;
  L.dw = o; o += adapt && H > 1 ? L.C * R : 0;
  L.dp = o; o += adapt && H > 1 ? L.C * R : 0;
  L.e = o; o += adapt ? 2LL * L.C * 32 : 0;
  L.red = o; o += (L.C + 3) / 4 * 4;
  L.sg = o;
  L.total = o;
  L.Tj = -1;
  L.ok = P >= 1 && H >= 1 && N >= 1 && L.C <= kTileMaxWarps;
  return L;
}

__host__ __device__ inline MvTilePlan mv_tile_layout(int P, int H, int N,
                                                      bool adapt) {
  const long long limit = kSmemPerBlock / (long long)sizeof(float);
  MvTilePlan L = mv_tile_arrays(P, H, N, adapt, 4);
  if (L.total + (long long)N * L.NP <= limit) {
    L.Tj = 0;
    L.total += (long long)N * L.NP;
    return L;
  }
  L = mv_tile_arrays(P, H, N, adapt, 8);
  if ((long long)L.NQ * (L.CP / 8) <=
      (long long)tile_items(tile_hb(L.C)) * 32 * L.C) {
    for (int tj = 16; tj >= 4; tj /= 2) {
      if (L.total + (long long)kTileStages * tj * L.NP <= limit) {
        L.Tj = tj;
        L.total += (long long)kTileStages * tj * L.NP;
        break;
      }
    }
  }
  if (L.Tj < 0) L.ok = false;
  return L;
}

// Problems a CTA for B problems: 1 with a per-problem Sigma; with a shared
// one the largest P whose plan fits and whose ceil(ceil(B / P) / 132) P
// is least. 0: the tile layout does not take the shape.
__host__ __device__ inline int mv_tile_problems(int B, int H, int N,
                                                bool shared, bool adapt) {
  if (B < 1 || H < 1 || N < 1 || H > kTileMaxWarps) return 0;
  if (!shared) return mv_tile_layout(1, H, N, adapt).ok ? 1 : 0;
  int best = 0;
  long long best_cost = 0;
  for (int P = 1; P * H <= kTileMaxWarps; ++P) {
    if (!mv_tile_layout(P, H, N, adapt).ok) continue;
    const long long ctas = (B + P - 1) / P;
    const long long cost = (ctas + kTileSMs - 1) / kTileSMs * P;
    if (best == 0 || cost <= best_cost) {
      best = P;
      best_cost = cost;
    }
  }
  return best;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// rows x N floats of Sigma (row stride N) into shared memory (row stride
// NP), asynchronously, by all T threads (16 bytes a copy where `vec`).
__device__ __forceinline__ void tile_copy(float* dst, const float* src,
                                          int rows, int N, int NP, int tid,
                                          int T, bool vec) {
  const int per_row = vec ? N >> 2 : N;
  int r = tid / per_row, q = tid - r * per_row;
  while (r < rows) {
    if (vec)
      cp_async16(dst + r * NP + 4 * q, src + (size_t)r * N + 4 * q);
    else
      cp_async4(dst + r * NP + q, src + (size_t)r * N + q);
    q += T;
    while (q >= per_row) {
      q -= per_row;
      ++r;
    }
  }
}

// acc[m] += Sigma[j0 + j, 4q..4q+3] x W[j0 + j, RC g..RC g + RC - 1] over
// j < jn, in j order, for this thread's items first + m T (item = q + NQ
// g); S points at Sigma's row j0 (row stride NP), WT is W^T, [N][CP]: one
// 16-byte load of Sigma and RC / 4 broadcast 16-byte loads of W a step.
template <int MI, int RC>
__device__ __forceinline__ void tile_accumulate(float (&acc)[MI][4][RC],
                                                const float* S, int jn,
                                                int j0, const float* WT,
                                                int CP, int NP, int NQ,
                                                int nitems, int first,
                                                int T) {
#pragma unroll
  for (int m = 0; m < MI; ++m) {
    const int it = first + m * T;
    if (it < nitems) {
      const int g = it / NQ, q = it - g * NQ;
      const float* const sr = S + 4 * q;
      const float* const wr = WT + (size_t)j0 * CP + RC * g;
#pragma unroll 2
      for (int j = 0; j < jn; ++j) {
        const float4 s4 = *reinterpret_cast<const float4*>(sr + j * NP);
        const float si[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int h = 0; h < RC / 4; ++h) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(wr + j * CP + 4 * h);
          const float wc[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
              acc[m][ii][4 * h + cc] =
                  fmaf(si[ii], wc[cc], acc[m][ii][4 * h + cc]);
          }
        }
      }
    }
  }
}

// A row's slots: registers (KR > 0) or a shared slice (KR = 0).
template <int KR>
struct TileRow {
  float x[1][KR];
  __device__ __forceinline__ float& operator[](int k) { return x[0][k]; }
};
template <>
struct TileRow<0> {
  float* x;
  __device__ __forceinline__ float& operator[](int k) { return x[k * 32]; }
};

template <int KR, class F>
__device__ __forceinline__ void each_slot(int K, F f) {
  if constexpr (KR > 0) {
#pragma unroll
    for (int k = 0; k < KR; ++k) f(k);
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) f(k);
  }
}

// The simplex threshold of a row: the row layout's helper on registers,
// the wide layout's on a shared slice.
template <int KR>
__device__ __forceinline__ float tile_threshold(TileRow<KR>& vm,
                                                const Slots& s, float th,
                                                bool cold, int n) {
  if constexpr (KR > 0) {
    float th1[1] = {th};
    const float one[1] = {1.f};
    row_threshold<KR>(vm.x, th1, one, s.N, cold, n);
    return th1[0];
  } else {
    const float* const x = vm.x;
    return wide_threshold(s, [=](int k) { return x[k * 32]; }, th, 1.f,
                          cold, n);
  }
}

// CTAs an SM a kernel is compiled for: resident kernels keep several.
__host__ __device__ constexpr int tile_min_ctas(int hb, bool stream) {
  return stream ? 1 : (hb == 8 ? 3 : (hb == 20 ? 2 : 1));
}

template <int KR, int HB, bool STREAM, bool ADAPT>
__global__ void __launch_bounds__(HB * 32, tile_min_ctas(HB, STREAM))
pdhg_mean_variance_tile_kernel(MvArgs a, MvAdaptArgs ad, int P) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  constexpr int MI = STREAM ? tile_items(HB) : 1;
  constexpr int RC = STREAM ? 8 : 4;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31;
  const int c = tid >> 5;  // this warp's column
  const int H = a.H, N = a.N, K = (N + 31) / 32;
  const MvTilePlan L = mv_tile_layout(P, H, N, ADAPT);
  const int KW = L.KW, NP = L.NP, C = L.C, CP = L.CP;
  const int pl = c / H, t = c - pl * H;  // problem in the CTA, row
  const int b = blockIdx.x * P + pl;
  const bool live = b < a.B;
  const int bi = live ? b : blockIdx.x * P;  // a missing problem's inputs
  const bool last = t + 1 == H;
  const Slots s{KR > 0 ? KR : K, N, lane};
  const int mine = c * KW + lane;  // this lane's slot 0 of its column
  float* const swt = smem + L.wt;  // [N][CP] W^T: the product's W
  float* const sv = smem + L.v;    // [C][KW] G, then the projection input
  float* const sp = smem + L.p;    // [C][KW] the dual
  float* const swb = smem + L.wb;  // [C][KW] wbar (H > 1)
  float* const sdw = smem + L.dw;  // [C][KW] w - w_new (balancing, H > 1)
  float* const sdp = smem + L.dp;  // [C][KW] p - p_new (balancing, H > 1)
  float* const se = smem + L.e;    // [2][C][32] the lanes' residual sums
  float* const red = smem + L.red;
  float* const sg = smem + L.sg;   // Sigma, resident or the ring
  const float* const sigma =
      a.sigma + (a.shared ? 0 : (size_t)blockIdx.x * N * N);

  // Zero the plan (W's padding columns, Sigma's padding entries), then
  // Sigma: resident, or the ring's first two stages in flight.
  for (long long e = tid; e < L.total; e += T) smem[e] = 0.f;
  __syncthreads();
  const int Tj = STREAM ? L.Tj : N;
  const int nst = (N + Tj - 1) / Tj;
  const bool vec = N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(sigma) & 15) == 0;
  int issued = 0, used = 0;
  auto issue = [&]() {
    const int j0 = (issued % nst) * Tj;
    tile_copy(sg + (size_t)(issued % kTileStages) * Tj * NP,
              sigma + (size_t)j0 * N, min(Tj, N - j0), N, NP, tid, T, vec);
    cp_async_commit();
    ++issued;
  };
  if constexpr (STREAM) {
    for (int u = 0; u < kTileStages - 1; ++u) issue();
  } else {
    tile_copy(sg, sigma, N, N, NP, tid, T, vec);
    cp_async_commit();
    cp_async_wait<0>();
  }

  // L = max(2 gamma ||Sigma||_F, 1e-6); sigma = sigma_scale sqrt(L + 1) / 2;
  // tau = step_scale / (L/2 + 4 sigma). The squares summed per thread, per
  // warp, then over the warps in order: the same bits in every CTA.
  float fro2 = 0.f;
  {
    float f2 = 0.f;
    for (long long e = tid; e < (long long)N * N; e += T) {
      const float x = sigma[e];
      f2 += x * x;
    }
    f2 = lane_sum(f2);
    if (lane == 0) red[c] = f2;
    __syncthreads();
    for (int u = 0; u < C; ++u) fro2 += red[u];
  }
  const float two_gamma = 2.f * a.gamma;
  const float Lf = jmax(two_gamma * sqrtf(fro2), 1e-6f);
  // Under ADAPT sig, tau and alpha are carried through the loop, the same
  // in every warp of a problem.
  float sig = a.sigma_scale * sqrtf(Lf + 1.f) / 2.f;
  float tau = a.step_scale / (0.5f * Lf + sig * 4.f);
  float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;

  // The row's arrays, and its mu and current weights.
  TileRow<KR> w, p, vm, mur, cwr;
  const float* const mu_g = a.mu + ((size_t)bi * H + t) * N + lane;
  const float* const cw_g = a.cw + (size_t)bi * N + lane;
  if constexpr (KR > 0) {
    each_slot<KR>(K, [&](int k) {
      mur[k] = s.valid(k) ? mu_g[k * 32] : 0.f;
      cwr[k] = s.valid(k) ? cw_g[k * 32] : 0.f;
      p[k] = 0.f;
    });
  } else {
    w.x = smem + L.w + mine;
    p.x = sp + mine;
    vm.x = sv + mine;
  }
  auto mu_at = [&](int k) -> float {
    if constexpr (KR > 0) return mur[k];
    else return s.valid(k) ? __ldg(mu_g + k * 32) : 0.f;
  };
  auto cw_at = [&](int k) -> float {
    if constexpr (KR > 0) return cwr[k];
    else return s.valid(k) ? __ldg(cw_g + k * 32) : 0.f;
  };
  // w[k] := x, and its copy in W^T.
  auto set_w = [&](int k, float x) {
    w[k] = x;
    if (s.valid(k)) swt[(size_t)(k * 32 + lane) * CP + c] = x;
  };

  // G = Sigma W into sv, between barriers B1 and B2.
  const int nitems = L.NQ * (CP / RC);
  auto product = [&]() {
    if constexpr (!STREAM) __syncthreads();  // B1
    for (int base = 0; base < nitems; base += MI * T) {
      float acc[MI][4][RC];
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int cc = 0; cc < RC; ++cc) acc[m][ii][cc] = 0.f;
      if constexpr (!STREAM) {
        tile_accumulate<MI, RC>(acc, sg, N, 0, swt, CP, NP, L.NQ, nitems,
                                base + tid, T);
      } else {
        // One pass (the plan keeps every tile in registers): stage st's
        // rows arrive (B1 at st = 0), the stage two ahead is issued into
        // the buffer every thread has left, then summed.
        for (int st = 0; st < nst; ++st) {
          cp_async_wait<kTileStages - 2>();
          __syncthreads();
          issue();
          const int buf = used % kTileStages;
          ++used;
          tile_accumulate<MI, RC>(acc, sg + (size_t)buf * Tj * NP,
                                  min(Tj, N - st * Tj), st * Tj, swt, CP,
                                  NP, L.NQ, nitems, base + tid, T);
        }
      }
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        const int it = base + tid + m * T;
        if (it < nitems) {
          const int g = it / L.NQ, q = it - g * L.NQ;
#pragma unroll
          for (int cc = 0; cc < RC; ++cc) {
            if (RC * g + cc < C)
              *reinterpret_cast<float4*>(sv + (RC * g + cc) * KW + 4 * q) =
                  make_float4(acc[m][0][cc], acc[m][1][cc], acc[m][2][cc],
                              acc[m][3][cc]);
          }
        }
      }
    }
    __syncthreads();  // B2
  };

  // v = w - tau ((2 gamma Sigma w_t - mu_t) + D'p), masked, into vm.
  auto primal = [&](float step) {
    product();
    each_slot<KR>(K, [&](int k) {
      const float g = two_gamma * sv[mine + k * 32] - mu_at(k);
      const float nxt = !last ? sp[mine + KW + k * 32] : 0.f;
      const float x = w[k] - step * (g + (p[k] - nxt));
      vm[k] = s.valid(k) ? x : kNeg;
    });
  };

  // w0 = cold simplex projection of the current weights on every row.
  each_slot<KR>(K, [&](int k) { vm[k] = s.valid(k) ? cw_at(k) : kNeg; });
  float thw = tile_threshold<KR>(vm, s, 0.f, true, a.cold_iters);
  each_slot<KR>(K, [&](int k) { set_w(k, jmax(vm[k] - thw, 0.f)); });

  const bool warm = a.warm != 0;
  const bool cond = !ADAPT && warm && a.refresh > 1;  // make_body_cond
  const bool relax = a.rho != 1.f;
  for (int it = 0; it < a.max_iters; ++it) {
    int n_sw;
    if (!warm)
      n_sw = a.cold_iters;
    else if (cond)
      n_sw = (it % a.refresh) == 0 ? a.warm_iters : 1;
    else
      n_sw = a.warm_iters;
    bool balance = false;
    if constexpr (ADAPT)
      balance = ad.adapt_every <= 1 ||
                (it % ad.adapt_every) == ad.adapt_every - 1;

    primal(tau);
    thw = tile_threshold<KR>(vm, s, thw, !warm, n_sw);
    // w_new, wbar = 2 w_new - w, the dual q = p + sigma (wbar -
    // wbar_{t-1}) clipped to [-c, c] (the current weights stand in for row
    // -1), the moves w - w_new and p - p_new on a balancing iteration, and
    // the updates (W^T's copy of w too). One pass at H = 1; else wbar goes
    // through shared memory to row t + 1 (barrier A between), and the
    // moves are staged for the neighbours' residual terms.
    float e1s = 0.f, e2s = 0.f;
    if (H == 1) {
      each_slot<KR>(K, [&](int k) {
        const float wo = w[k], po = p[k];
        const float wn = jmax(vm[k] - thw, 0.f);
        const float wb = 2.f * wn - wo;
        const float pn = jmin(jmax(po + sig * (wb - cw_at(k)), -a.c), a.c);
        if constexpr (ADAPT) {
          if (balance) {
            const float dw = wo - wn, dp = po - pn;
            const float e1 = dw / tau - dp;
            const float e2 = dp / sig - dw;
            e1s += e1 * e1;
            e2s += e2 * e2;
          }
        }
        set_w(k, relax ? wo + a.rho * (wn - wo) : wn);
        p[k] = relax ? po + a.rho * (pn - po) : pn;
      });
    } else {
      each_slot<KR>(K, [&](int k) {
        const float wo = w[k];
        const float wn = jmax(vm[k] - thw, 0.f);
        const float wb = 2.f * wn - wo;
        vm[k] = wb;
        swb[mine + k * 32] = wb;
        if constexpr (ADAPT) {
          if (balance) sdw[mine + k * 32] = wo - wn;
        }
        set_w(k, relax ? wo + a.rho * (wn - wo) : wn);
      });
      __syncthreads();  // A
      each_slot<KR>(K, [&](int k) {
        const float wbp = t == 0 ? cw_at(k) : swb[mine - KW + k * 32];
        const float po = p[k];
        const float pn = jmin(jmax(po + sig * (vm[k] - wbp), -a.c), a.c);
        if constexpr (ADAPT) {
          if (balance) sdp[mine + k * 32] = po - pn;
        }
        p[k] = relax ? po + a.rho * (pn - po) : pn;
        if constexpr (KR > 0) sp[mine + k * 32] = p[k];
      });
    }
    if constexpr (ADAPT) {
      // Residual balancing (ratio 1.5, alpha *= 0.95), from the moves
      // before over-relaxation: pr = ||dw / tau - D'dp||,
      // dr = ||dp / sigma - D0 dw|| over the problem's rows and assets.
      if (balance) {
        float r0 = e1s, r1 = e2s;
        if (H > 1) {
          __syncthreads();  // the neighbours' moves
          each_slot<KR>(K, [&](int k) {
            const int at = mine + k * 32;
            const float dw = sdw[at], dp = sdp[at];
            const float dpn = !last ? sdp[at + KW] : 0.f;
            const float dwp = t == 0 ? 0.f : sdw[at - KW];
            const float e1 = dw / tau - (dp - dpn);
            const float e2 = dp / sig - (dw - dwp);
            e1s += e1 * e1;
            e2s += e2 * e2;
          });
          se[c * 32 + lane] = e1s;
          se[(C + c) * 32 + lane] = e2s;
          __syncthreads();  // the rows' partials
          r0 = 0.f;
          r1 = 0.f;
          for (int u = pl * H; u < pl * H + H; ++u) {
            r0 += se[u * 32 + lane];
            r1 += se[(C + u) * 32 + lane];
          }
        }
        const float pr = sqrtf(lane_sum(r0)), dr = sqrtf(lane_sum(r1));
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
  }

  // Extra primal half-step with a cold full-budget projection: the
  // returned iterate is w_last and fp = max |w_last - w| over the problem.
  primal(tau);
  thw = tile_threshold<KR>(vm, s, thw, true, a.cold_iters);
  float fp = 0.f;
  each_slot<KR>(K, [&](int k) {
    if (s.valid(k)) {
      const float wl = jmax(vm[k] - thw, 0.f);
      fp = jmax(fp, fabsf(wl - w[k]));
      if (live) a.w_out[((size_t)b * H + t) * N + k * 32 + lane] = wl;
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    fp = jmax(fp, __shfl_xor_sync(kFull, fp, o));
  if (lane == 0) red[c] = fp;
  __syncthreads();
  if (live && t == 0 && lane == 0) {
    for (int u = pl * H + 1; u < pl * H + H; ++u) fp = jmax(fp, red[u]);
    a.fp_out[b] = fp;
    if constexpr (ADAPT) {
      if (ad.steps_out != nullptr) {
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
  cp_async_wait<0>();  // the ring's last stages, issued ahead
}

template <int KR, int HB, bool STREAM, bool ADAPT>
cudaError_t tile_launch(const MvArgs& a, const MvAdaptArgs& ad, int P,
                        cudaStream_t stream) {
  const MvTilePlan L = mv_tile_layout(P, a.H, a.N, ADAPT);
  if (!L.ok) return cudaErrorInvalidValue;
  const long long smem = L.total * (long long)sizeof(float);
  auto kernel = pdhg_mean_variance_tile_kernel<KR, HB, STREAM, ADAPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(a.B + P - 1) / P, L.C * 32, (size_t)smem, stream>>>(a, ad, P);
  return cudaGetLastError();
}

// P problems a CTA (1 with a per-problem Sigma), P H columns of warps;
// compiled for K = ceil(N/32) = 1..4 slots in registers or any K in shared
// slices, Sigma resident or streamed (shared slices only: a streamed Sigma
// has N > 128), and at most 8, 20 or 32 warps. A plan that does not fit
// (P H > 32, past a block's shared memory, or a streamed product past the
// registers) returns cudaErrorInvalidValue (the wrapper checks first).
// P = 0 takes `mv_tile_problems`' count for B (the wrapper's launches).
// `shared` = 1: sigma is one [N, N] matrix for the whole batch; `schedule`
// is `refresh` for the fixed-step body and `adapt_every` for the adaptive
// one; `steps_out` may be null.
template <bool ADAPT>
int mv_tile_dispatch(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared, int P,
    int max_iters, int schedule, int warm_iters, int cold_iters, float c,
    float gamma, float rho, float step_scale, float sigma_scale, int warm,
    void* stream) {
  if (P == 0 && B > 0 && H > 0 && N > 0)
    P = mv_tile_problems(B, H, N, shared != 0, ADAPT);
  if (B <= 0 || H <= 0 || N <= 0 || P <= 0 || (!shared && P != 1))
    return (int)cudaErrorInvalidValue;
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
  const MvAdaptArgs ad = {static_cast<float*>(steps_out),
                          ADAPT ? schedule : 0};
  const MvTilePlan L = mv_tile_layout(P, H, N, ADAPT);
  if (!L.ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (N + 31) / 32;
  const int kr = K <= 4 ? K : 0;
  const int hb = tile_hb(L.C);
  if (L.Tj > 0) {
    if (kr != 0) return (int)cudaErrorInvalidValue;
    if (hb == 8) return (int)tile_launch<0, 8, true, ADAPT>(a, ad, P, s);
    if (hb == 20) return (int)tile_launch<0, 20, true, ADAPT>(a, ad, P, s);
    return (int)tile_launch<0, 32, true, ADAPT>(a, ad, P, s);
  }

#define KMPC_TILE(KR_, HB_)                                          \
  if (kr == KR_ && hb == HB_)                                        \
    return (int)tile_launch<KR_, HB_, false, ADAPT>(a, ad, P, s);
  KMPC_TILE(0, 8) KMPC_TILE(1, 8) KMPC_TILE(2, 8) KMPC_TILE(3, 8)
  KMPC_TILE(4, 8)
  KMPC_TILE(0, 20) KMPC_TILE(1, 20) KMPC_TILE(2, 20) KMPC_TILE(3, 20)
  KMPC_TILE(4, 20)
  KMPC_TILE(0, 32) KMPC_TILE(1, 32) KMPC_TILE(2, 32) KMPC_TILE(3, 32)
  KMPC_TILE(4, 32)
#undef KMPC_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
