// The mean-variance PDHG solve (kernel C) in a cluster layout: the block
// layout's body (pdhg_mean_variance_block.cuh) with one problem's asset
// columns split over a thread-block cluster of C CTAs, and that problem's
// covariance held in the cluster's shared memory for the whole solve as far
// as it fits. The same program as the other layouts: `_make_packed_mv_kernel`
// of kmpc_tpu/ops/mpc_pallas.py, its fixed-step body (the refresh schedule,
// warm or cold projections) and, with ADAPT, its adaptive branch;
// over-relaxation, the clip-form dual, a per-problem or a shared covariance,
// the extra primal half-step with the fixed-point residual and the steps
// output. No hyperplane projection (`allow_short` stays in the block and
// global layouts).
//
// Bound. Per iteration a problem reads its covariance once per eight
// horizon rows (N^2 floats: 4 MB at N=1000) and does H N^2 FMAs. The block
// layout stages Sigma in shared memory only up to N=238 at H=1 and the
// global layout keeps it in global memory, so at H=1 N=1000 with a Sigma
// per problem and hundreds of problems in flight the block layout streams
// 4 MB a problem-iteration from HBM (2.34 TB/s measured, 70% of HBM's
// rate), and the global layout at H=20 streams it three times an iteration
// at one CTA a problem. Here the iterations read the staged part of Sigma
// from the cluster's shared memory and the rest from L2 or HBM. With many
// CTAs a problem (16 hold 88% of Sigma at N=1000) few problems run at once
// and each is bound by its latency: the dependent chain of each column's N
// FMAs (the product's order is fixed, see below), the rows read from L2,
// and per sweep of a threshold one exchange of partial sums and one
// cluster barrier. With two CTAs (66 problems at once) the rest of Sigma
// streams from HBM as in the block layout, less the staged rows; routing
// takes two where that measured faster (mv_cluster_ctas).
//
// Design. The block kernel runs T = block_threads(N) threads (up to 512);
// thread g owns the asset columns g, g + T, ... (its "slots"). Here CTA k
// of a problem's cluster runs the block kernel's threads k T/C .. (k+1) T/C
// - 1, so every thread owns the same columns as in the block kernel and
// does the same operations on them in the same order:
// - The product: (Sigma w_t)[i] = sum_j Sigma[j][i] w_t[j], one chain of
//   sequential FMAs over j in plain FP32 per (row, column), eight rows
//   sharing a Sigma load (one at H=1), two of the thread's columns at once
//   (each column's chain is unchanged, so the bits are the block kernel's).
//   Sigma's own columns are staged column-major for the first `js` rows
//   (mv_cluster_plan: as many as fit beside the iterates), read 16 bytes a
//   load, a step ahead of the FMAs; the rows past js are read in place
//   from global memory (L2) into two register buffers, the first issued
//   before the staged rows; staging whole rows keeps a warp's loop
//   uniform. The kernel is instantiated once per product shape (one row or
//   eight a pass, one column slot a thread or two), so that each gets its
//   own register allocation: one kernel holding every shape serialised
//   the product's loads (PERF.md). w (all H rows, all N columns) is
//   replicated in every CTA: after each update a CTA writes its own
//   columns into every copy through distributed shared memory
//   (`map_shared_rank`), and the cluster barrier before the product orders
//   those writes before it.
//   p, mu, the projection input, the dual input and the current weights
//   are kept for the CTA's own columns only: every other phase touches a
//   thread's own columns.
// - The reduces (the thresholds' counts and sums, the residuals,
//   ||Sigma||_F, fp): each warp sums its partials by the block kernel's
//   butterfly, and its lanes write them into every CTA's staging through
//   distributed shared memory, at the block kernel's index of the warp; one
//   cluster barrier (release / acquire), and every CTA combines all warps'
//   partials in the block kernel's fixed tree. So every CTA holds the same
//   thresholds, residuals and decisions, and they are the block kernel's
//   bits. The staging is double-buffered: a CTA writes a buffer again only
//   after the next reduce's barrier, which every CTA reaches after its last
//   read of it.
// - Barriers: the block kernel's product barrier and each reduce's barrier
//   are cluster barriers; a reduce's second __syncthreads (publishing what
//   it finished) stays local, each CTA finishing every row for itself. A
//   cluster barrier at the start keeps any CTA from writing into one that
//   has not started; the last remote write precedes the fixed-point
//   residual's barrier, so no CTA is written after it leaves.
//
// The cluster size C divides the block's warps and is at most 16 (past 8 a
// non-portable size, allowed by cudaFuncAttributeNonPortableClusterSizeAllowed);
// the grid is B clusters, no workspace; the wrapper picks C
// (mv_cluster_ctas) among the sizes the card admits
// (cudaOccupancyMaxActiveClusters).

#pragma once

#include <cooperative_groups.h>

#include "pdhg_mean_variance_block.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMvClusterMax = 16;  // CTAs a cluster, at most (non-portable)

__device__ __forceinline__ void mv_cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" :::
                   "memory");
}

// One CTA's plan, offsets in floats: w, every column, as [H][NP] (NP = N
// rounded up to 4); the CTA's own columns of p, mu, the projection input
// and (ADAPT) the dual input as [H][LW] (LW = K Tc: slot s of local thread
// l at s Tc + l); the own current weights [LW]; the thresholds [H], four
// residual slots, two reduce stagings of [NW][2H]; then Sigma's own columns
// for the first js rows, column-major [LW][S]: S = 4 mod 8 floats apart, so
// that a warp's 16-byte loads of four rows of its 32 columns fall in
// distinct banks in each quarter-warp. js is every row where the rest of a
// block's shared memory holds them, else the largest such S. C 0: the plan
// does not fit, or C is not 2 to 16 dividing the block's warps.
struct MvClusterPlan {
  int C, Tc, K, LW, NP, NW, js, S;
  long long w, p, mu, vm, q, cw, thw, res, red, sg, total;
};

__host__ __device__ inline MvClusterPlan mv_cluster_plan(int H, int N, int C,
                                                         bool adapt) {
  MvClusterPlan P;
  const int T = block_threads(N);
  P.NW = T / 32;
  P.C = C;
  P.Tc = C >= 1 ? T / C : 0;
  P.K = (N + T - 1) / T;
  P.LW = P.K * P.Tc;
  P.NP = (N + 3) / 4 * 4;
  const long long HL = (long long)H * P.LW;
  long long o = 0;
  P.w = o; o += (long long)H * P.NP;
  P.p = o; o += HL;
  P.mu = o; o += HL;
  P.vm = o; o += HL;
  P.q = o; o += adapt ? HL : 0;
  P.cw = o; o += P.LW;
  P.thw = o; o += H;
  P.res = o; o += 4;
  P.red = o; o += 2LL * P.NW * 2 * H;
  o = (o + 3) / 4 * 4;
  P.sg = o;
  const long long room = kSmemPerBlock / (long long)sizeof(float) - o;
  const bool ok = C >= 2 && C <= kMvClusterMax && P.NW % C == 0 && room >= 0;
  const long long most = ok ? room / P.LW : 0;
  const long long s4 = most >= 4 ? most - (most - 4) % 8 : 0;
  if (N <= s4) {
    P.js = N;
    P.S = N + ((4 - N) % 8 + 8) % 8;
  } else {
    P.js = (int)s4;
    P.S = (int)s4;
  }
  o += (long long)P.LW * P.S;
  P.total = o;
  if (!ok) P.C = 0;
  return P;
}

// A thread's view of its cluster: its local and block-kernel indices, its
// columns, and the reduce staging's buffers.
struct MvClusterCtx {
  int l, Tc, g, T, K, H, N, NW, C;
  float* red;  // this CTA's two stagings of [NW][2H]
};

// One stacked reduce over the cluster, the block kernel's block_reduce:
// fill(j0, v) gives this thread's partials of quantities j0 .. j0 + W - 1
// of M; each warp combines them by butterfly and its lanes 0 .. C - 1
// write them into CTA lane's staging at the warp's block-kernel index; after
// the cluster barrier every CTA runs finish(j, tot) for j = 0 .. R - 1 over
// its threads, tot(q) combining the NW warps' partials in block_reduce's
// tree; a __syncthreads publishes what finish wrote. `phase` alternates the
// staging buffers. Every thread of the cluster must call it.
template <int OP, int W, class Fill, class Finish>
__device__ __forceinline__ void mv_cluster_reduce(const cg::cluster_group& cl,
                                                  const MvClusterCtx& c,
                                                  int& phase, int M, int R,
                                                  Fill fill, Finish finish) {
  const int lane = c.l & 31, gw = c.g >> 5;
  float* const red = c.red + (size_t)phase * c.NW * 2 * c.H;
  phase ^= 1;
  for (int j0 = 0; j0 < M; j0 += W) {
    float v[W];
    fill(j0, v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < W; ++u)
        v[u] = combine<OP>(v[u], __shfl_xor_sync(kFull, v[u], o));
    }
    // Every lane holds the warp's sums (a butterfly's operands are the
    // same pairs in every lane); lane k < C writes them into CTA k.
    if (lane < c.C) {
      float* const dst = cl.map_shared_rank(red, lane);
#pragma unroll
      for (int u = 0; u < W; ++u)
        if (j0 + u < M) dst[gw * M + j0 + u] = v[u];
    }
  }
  mv_cluster_sync();
  const int NW = c.NW;
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
  for (int j = c.l; j < R; j += c.Tc) finish(j, tot);
  __syncthreads();
}

// The fill of a reduce whose quantity j combines part(j, s) over the
// thread's valid column slots s, in the block kernel's column order.
template <int OP, int W, class Part>
__device__ __forceinline__ auto mv_slots(const MvClusterCtx& c, int M,
                                         Part part) {
  return [=](int j0, float (&v)[W]) {
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = j0 + u;
      float acc = identity<OP>();
      if (j < M)
        for (int s = 0; s < c.K && c.g + s * c.T < c.N; ++s)
          acc = combine<OP>(acc, part(j, s));
      v[u] = acc;
    }
  };
}

// The simplex threshold over the rows' values val(t, s): a cold start
// (sum - 1) / N and n Michelot sweeps, or n sweeps from the carried theta
// (block_threshold with rad 1); W partials a butterfly pass (2 at H=1).
template <int W, class Val>
__device__ __forceinline__ void mv_cluster_threshold(
    const cg::cluster_group& cl, const MvClusterCtx& c, int& phase, Val val,
    float* theta, bool cold, int n) {
  const int H = c.H;
  if (cold) {
    mv_cluster_reduce<0, W>(
        cl, c, phase, H, H, mv_slots<0, W>(c, H, val),
        [=](int t, auto tot) { theta[t] = (tot(t) - 1.f) / (float)c.N; });
  }
  for (int k = 0; k < n; ++k) {
    mv_cluster_reduce<0, W>(
        cl, c, phase, 2 * H, H,
        mv_slots<0, W>(c, 2 * H, [=](int j, int s) {
          const int t = j < H ? j : j - H;
          const float x = val(t, s);
          const bool act = x > theta[t];
          return j < H ? (act ? 1.f : 0.f) : (act ? x : 0.f);
        }),
        [=](int t, auto tot) {
          theta[t] = (tot(H + t) - 1.f) / jmax(tot(t), 1.f);
        });
  }
}


// What one CTA's product phase reads and writes: Sigma's staged own
// columns [LW][S] (a shared-memory address) and its rows in global memory,
// w [H][NP] (every column), the own columns of mu and p and the projection
// input vm [H][LW]; the thread's place in the block kernel's layout.
struct MvRowsArgs {
  const float* src;
  const float *w, *mu, *p;
  float* vm;
  unsigned sg, ws;  // shared-memory addresses of the stage and of w
  int S, js, N, H, NP, LW, Tc, T, K, g, l;
  float two_gamma, step;
};

// Shared-memory loads by address. Volatile: w changes between products
// (the cluster barrier orders its remote writes before them), so a load
// may be neither hoisted out of the iteration loop nor merged with one
// before a barrier.
__device__ __forceinline__ float mv_lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float4 mv_lds4(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// The product's sums acc[k][u] = sum_j Sigma[j][col k] w[row u][j] over
// j = 0 .. N - 1 in order, one FMA a term (the block kernel's chain): the
// first js rows from the column-major stage (column k at sk[k]), V rows a
// step in 16-byte loads, the next step's loads issued before this one's
// FMAs; the rest from global memory (column k at gp[k]), two buffers of G
// rows in registers. At one row (RB 1) the first is issued before the
// staged rows, whose loop keeps the registers for its own loads, and each
// next one before the FMAs of the one before; at eight both are issued
// before the staged rows and each is refilled after its FMAs. Every
// address is valid: a slot past N reads slot 0's column and a row past H
// reads row H - 1, their sums unused; a global row past N is clamped and
// its FMA skipped.
template <int KS, int RB, int V, int G>
__device__ __forceinline__ void mv_cluster_product(
    float (&acc)[KS][RB], const unsigned (&sk)[KS],
    const float* const (&gp)[KS], const unsigned (&wr)[RB], int js,
    int N) {
  float ga[KS][G], gb[KS][G];
  auto gload = [&](float (&b)[KS][G], int j0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t r = (size_t)min(j0 + g, N - 1) * N;
#pragma unroll
      for (int k = 0; k < KS; ++k) b[k][g] = __ldg(gp[k] + r);
    }
  };
  auto gfma = [&](const float (&b)[KS][G], int j0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (j0 + g < N) {
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const float wj = mv_lds(wr[u] + 4u * (unsigned)(j0 + g));
#pragma unroll
          for (int k = 0; k < KS; ++k) acc[k][u] += b[k][g] * wj;
        }
      }
    }
  };
  if (js < N) gload(ga, js);
  if (RB > 1 && js + G < N) gload(gb, js + G);
  // Staged rows, V a step (V a multiple of 4, js a multiple of V or N).
  constexpr int V4 = V / 4;
  const int jv = js / V * V;
  float4 x[KS][V4], wv[RB][V4];
  auto sload = [&](float4 (&xs)[KS][V4], float4 (&ws)[RB][V4], int j) {
#pragma unroll
    for (int q = 0; q < V4; ++q) {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        xs[k][q] = mv_lds4(sk[k] + 4u * (unsigned)(j + 4 * q));
#pragma unroll
      for (int u = 0; u < RB; ++u)
        ws[u][q] = mv_lds4(wr[u] + 4u * (unsigned)(j + 4 * q));
    }
  };
  auto sfma = [&](const float4 (&xs)[KS][V4], const float4 (&ws)[RB][V4]) {
#pragma unroll
    for (int q = 0; q < V4; ++q) {
#pragma unroll
      for (int u = 0; u < RB; ++u) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          acc[k][u] += xs[k][q].x * ws[u][q].x;
          acc[k][u] += xs[k][q].y * ws[u][q].y;
          acc[k][u] += xs[k][q].z * ws[u][q].z;
          acc[k][u] += xs[k][q].w * ws[u][q].w;
        }
      }
    }
  };
  if (jv > 0) sload(x, wv, 0);
#pragma unroll 2
  for (int j = 0; j < jv; j += V) {
    float4 xn[KS][V4], wn[RB][V4];
    sload(xn, wn, j + V < jv ? j + V : j);
    sfma(x, wv);
#pragma unroll
    for (int q = 0; q < V4; ++q) {
#pragma unroll
      for (int k = 0; k < KS; ++k) x[k][q] = xn[k][q];
#pragma unroll
      for (int u = 0; u < RB; ++u) wv[u][q] = wn[u][q];
    }
  }
  for (int j = jv; j < js; ++j) {
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const float wj = mv_lds(wr[u] + 4u * (unsigned)j);
#pragma unroll
      for (int k = 0; k < KS; ++k)
        acc[k][u] += mv_lds(sk[k] + 4u * (unsigned)j) * wj;
    }
  }
  for (int j0 = js; j0 < N; j0 += 2 * G) {
    if constexpr (RB == 1) {
      if (j0 + G < N) gload(gb, j0 + G);
      gfma(ga, j0);
      if (j0 + 2 * G < N) gload(ga, j0 + 2 * G);
      if (j0 + G < N) gfma(gb, j0 + G);
    } else {
      gfma(ga, j0);
      if (j0 + 2 * G < N) gload(ga, j0 + 2 * G);
      if (j0 + G < N) {
        gfma(gb, j0 + G);
        if (j0 + 3 * G < N) gload(gb, j0 + 3 * G);
      }
    }
  }
}

// v = w - step ((2 gamma Sigma w_t - mu_t) + D'p) into vm for the thread's
// columns, RB rows and KS column slots a pass.
template <int KS, int RB>
__device__ __forceinline__ void mv_cluster_rows(const MvRowsArgs& a) {
  constexpr int V = RB == 1 ? 8 : 4;
  constexpr int G = RB == 1 ? 32 / KS : 8;
  const int T = a.T, g = a.g, N = a.N, H = a.H, LW = a.LW;
  for (int s0 = 0; s0 < a.K && s0 * T + g < N; s0 += KS) {
    unsigned sk[KS];
    const float* gp[KS];
    bool v[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      v[k] = s0 + k < a.K && (s0 + k) * T + g < N;
      const int s = v[k] ? s0 + k : s0;
      sk[k] = a.sg + 4u * (unsigned)((s * a.Tc + a.l) * a.S);
      gp[k] = a.src + s * T + g;
    }
    for (int t0 = 0; t0 < H; t0 += RB) {
      unsigned wr[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u)
        wr[u] = a.ws + 4u * (unsigned)(min(t0 + u, H - 1) * a.NP);
      float acc[KS][RB];
#pragma unroll
      for (int k = 0; k < KS; ++k)
#pragma unroll
        for (int u = 0; u < RB; ++u) acc[k][u] = 0.f;
      mv_cluster_product<KS, RB, V, G>(acc, sk, gp, wr, a.js, N);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (!v[k]) continue;
        const int lk = (s0 + k) * a.Tc + a.l, c = (s0 + k) * T + g;
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          if (t0 + u < H) {
            const int t = t0 + u, e = t * LW + lk;
            const float gr = a.two_gamma * acc[k][u] - a.mu[e];
            const float nxt = t + 1 < H ? a.p[e + LW] : 0.f;
            const float we = a.w[(size_t)t * a.NP + c];
            a.vm[e] = we - a.step * (gr + (a.p[e] - nxt));
          }
        }
      }
    }
  }
}

// The cluster layout's kernel: B clusters of C CTAs of T / C threads,
// problem blockIdx.x / C.
template <bool ADAPT, int RB, int KS>
__global__ void __launch_bounds__(kBlockMaxThreads / 2)
pdhg_mean_variance_cluster_kernel(MvArgs a, MvAdaptArgs ad) {
  extern __shared__ float smem[];  // 16-byte aligned
  const cg::cluster_group cl = cg::this_cluster();
  const int H = a.H, N = a.N;
  const MvClusterPlan P = mv_cluster_plan(H, N, (int)cl.num_blocks(), ADAPT);
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / P.C;
  const int l = threadIdx.x, Tc = P.Tc, T = block_threads(N), K = P.K;
  const int g = rank * Tc + l;  // the block kernel's thread index
  const int LW = P.LW, NP = P.NP, js = P.js, S = P.S;
  const MvClusterCtx ctx{l, Tc, g, T, K, H, N, P.NW, P.C, smem + P.red};
  int phase = 0;
  float* const w = smem + P.w;    // [H][NP], every column
  float* const p = smem + P.p;    // own columns, [H][LW]
  float* const mu = smem + P.mu;
  float* const vm = smem + P.vm;  // the projection input, then w_new
  float* const q = smem + P.q;    // p_new (adaptive body)
  float* const cw = smem + P.cw;
  float* const thw = smem + P.thw;
  float* const res = smem + P.res;
  float* const sg = smem + P.sg;  // [LW][S], the first js rows
  const float* const src = a.sigma + (a.shared ? 0 : (size_t)b * N * N);
  // Column of slot s, and whether it is one.
  auto col = [=](int s) { return s * T + g; };
  auto ok = [=](int s) { return col(s) < N; };

  // Inputs: Sigma's first js rows of the own columns (by cp.async, all in
  // flight at once), mu and the current weights of the own columns; p = 0.
  for (int s = 0; s < K; ++s)
    for (int j = 0; j < js; ++j) {
      float* const d = sg + (size_t)(s * Tc + l) * S + j;
      if (ok(s))
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(d)),
                     "l"(src + (size_t)j * N + col(s))
                     : "memory");
      else
        *d = 0.f;
    }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int s = 0; s < K; ++s) {
    const int li = s * Tc + l;
    const bool v = ok(s);
    cw[li] = v ? a.cw[(size_t)b * N + col(s)] : 0.f;
    for (int t = 0; t < H; ++t) {
      mu[t * LW + li] = v ? a.mu[((size_t)b * H + t) * N + col(s)] : 0.f;
      p[t * LW + li] = 0.f;
    }
  }
  __syncthreads();
  mv_cluster_sync();  // every CTA started before any remote write

  // L = max(2 gamma ||Sigma||_F, 1e-6); sigma = sigma_scale sqrt(L + 1) / 2;
  // tau = step_scale / (L/2 + 4 sigma).
  mv_cluster_reduce<0, 1>(
      cl, ctx, phase, 1, 1,
      [=](int, float (&v)[1]) {
        float s2 = 0.f;
        for (int s = 0; s < K && ok(s); ++s) {
          for (int j = 0; j < js; ++j) {
            const float x = sg[(size_t)(s * Tc + l) * S + j];
            s2 += x * x;
          }
#pragma unroll 8
          for (int j = js; j < N; ++j) {
            const float x = __ldg(src + (size_t)j * N + col(s));
            s2 += x * x;
          }
        }
        v[0] = s2;
      },
      [=](int, auto tot) { res[0] = tot(0); });
  const float two_gamma = 2.f * a.gamma;
  const float L = jmax(two_gamma * sqrtf(res[0]), 1e-6f);
  float sig = a.sigma_scale * sqrtf(L + 1.f) / 2.f;
  float tau = a.step_scale / (0.5f * L + sig * 4.f);
  float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;

  auto at_vm = [=](int t, int s) { return vm[t * LW + s * Tc + l]; };
  auto primal_threshold = [&](bool cold, int n) {
    mv_cluster_threshold<RB == 1 ? 2 : 8>(cl, ctx, phase, at_vm, thw, cold,
                                           n);
  };
  // This thread's new w at (t, slot s) into every CTA's copy.
  auto publish = [&](int t, int s, float x) {
    const size_t e = (size_t)t * NP + col(s);
    w[e] = x;
    for (int k = 0; k < P.C; ++k)
      if (k != rank) cl.map_shared_rank(w, k)[e] = x;
  };

  // w0 = cold simplex projection of the current weights on every row.
  for (int s = 0; s < K; ++s)
    for (int t = 0; t < H; ++t) vm[t * LW + s * Tc + l] = cw[s * Tc + l];
  primal_threshold(true, a.cold_iters);
  for (int s = 0; s < K && ok(s); ++s)
    for (int t = 0; t < H; ++t)
      publish(t, s, jmax(vm[t * LW + s * Tc + l] - thw[t], 0.f));

  // The product into vm (mv_cluster_rows); the cluster barrier orders it
  // after every CTA's last write of w.
  MvRowsArgs ra{src, w, mu, p, vm,
                (unsigned)__cvta_generic_to_shared(sg),
                (unsigned)__cvta_generic_to_shared(w), S, js, N, H, NP, LW,
                Tc, T, K, g, l, two_gamma, 0.f};
  auto primal = [&](float step) {
    mv_cluster_sync();
    ra.step = step;
    mv_cluster_rows<KS, RB>(ra);
  };
  const bool relax = a.rho != 1.f;
  // The over-relaxed update of own element (t, s) from wn and pn; the new
  // w published to every CTA.
  auto update = [&](int t, int s, float wn, float pn) {
    const int e = t * LW + s * Tc + l;
    const float wo = w[(size_t)t * NP + col(s)];
    float wx;
    if (relax) {
      wx = wo + a.rho * (wn - wo);
      p[e] = p[e] + a.rho * (pn - p[e]);
    } else {
      wx = wn;
      p[e] = pn;
    }
    publish(t, s, wx);
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
      for (int s = 0; s < K && ok(s); ++s) {
        float wbp = cw[s * Tc + l];
        for (int t = 0; t < H; ++t) {
          const int e = t * LW + s * Tc + l;
          const float wn = jmax(vm[e] - thw[t], 0.f);
          const float wb = 2.f * wn - w[(size_t)t * NP + col(s)];
          const float pn = jmin(jmax(p[e] + sig * (wb - wbp), -a.c), a.c);
          wbp = wb;
          update(t, s, wn, pn);
        }
      }
    }
  } else {
    const int n_sw = warm ? a.warm_iters : a.cold_iters;
    for (int it = 0; it < a.max_iters; ++it) {
      primal(tau);
      primal_threshold(!warm, n_sw);
      for (int s = 0; s < K && ok(s); ++s) {
        float wbp = cw[s * Tc + l];
        for (int t = 0; t < H; ++t) {
          const int e = t * LW + s * Tc + l;
          const float wn = jmax(vm[e] - thw[t], 0.f);
          const float wb = 2.f * wn - w[(size_t)t * NP + col(s)];
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
        mv_cluster_reduce<0, 2>(
            cl, ctx, phase, 2, 1,
            [=](int, float (&v)[2]) {
              v[0] = 0.f;
              v[1] = 0.f;
              for (int s = 0; s < K && ok(s); ++s) {
                for (int t = 0; t < H; ++t) {
                  const int e = t * LW + s * Tc + l;
                  const size_t ew = (size_t)t * NP + col(s);
                  const float dw = w[ew] - vm[e];
                  const float dp = p[e] - q[e];
                  const float dpn =
                      t + 1 < H ? p[e + LW] - q[e + LW] : 0.f;
                  const float dwp = t == 0 ? 0.f : w[ew - NP] - vm[e - LW];
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
      for (int s = 0; s < K && ok(s); ++s)
        for (int t = 0; t < H; ++t) {
          const int e = t * LW + s * Tc + l;
          update(t, s, vm[e], q[e]);
        }
    }
    if (ad.steps_out != nullptr && rank == 0 && l == 0) {
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
  for (int s = 0; s < K && ok(s); ++s) {
    for (int t = 0; t < H; ++t) {
      const float wl = jmax(vm[t * LW + s * Tc + l] - thw[t], 0.f);
      fp = jmax(fp, fabsf(wl - w[(size_t)t * NP + col(s)]));
      a.w_out[((size_t)b * H + t) * N + col(s)] = wl;
    }
  }
  mv_cluster_reduce<2, 1>(
      cl, ctx, phase, 1, 1, [=](int, float (&v)[1]) { v[0] = fp; },
      [=](int, auto tot) {
        if (rank == 0) a.fp_out[b] = tot(0);
      });
}

// Launch (or, with `clusters`, only ask how many clusters of this shape the
// card runs at once): cudaLaunchKernelEx with the cluster dimension C,
// after cudaOccupancyMaxActiveClusters; a cluster the card does not run
// returns cudaErrorInvalidConfiguration, a C the plan refuses
// cudaErrorInvalidValue.
template <bool ADAPT>
int mv_cluster_dispatch(const MvArgs& a, const MvAdaptArgs& ad, int C,
                        cudaStream_t stream, int* clusters) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0) return (int)cudaErrorInvalidValue;
  const MvClusterPlan P = mv_cluster_plan(a.H, a.N, C, ADAPT);
  if (P.C == 0) return (int)cudaErrorInvalidValue;
  const long long smem = P.total * (long long)sizeof(float);
  // One instantiation a product shape (one row or eight a pass, one
  // column slot a thread or two at once), each with its own registers.
  const bool one = a.H == 1, two = P.K > 1;
  auto kernel =
      one ? (two ? pdhg_mean_variance_cluster_kernel<ADAPT, 1, 2>
                 : pdhg_mean_variance_cluster_kernel<ADAPT, 1, 1>)
          : (two ? pdhg_mean_variance_cluster_kernel<ADAPT, kMvRows, 2>
                 : pdhg_mean_variance_cluster_kernel<ADAPT, kMvRows, 1>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * C), 1, 1);
  cfg.blockDim = dim3((unsigned)P.Tc, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters != nullptr) {
    *clusters = n;
    return 0;
  }
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, a, ad);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
