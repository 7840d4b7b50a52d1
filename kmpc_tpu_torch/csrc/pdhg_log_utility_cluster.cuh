// The log-utility PDHG solve in a cluster layout: the wide-row body
// (pdhg_log_utility_wide.cuh) with one problem's horizon rows split over a
// thread-block cluster of C CTAs, for one forecast (S=None) or S scenarios
// whose problem no single CTA's shared memory holds. The same program as the
// other layouts: `_make_packed_kernel` of kmpc_tpu/ops/mpc_pallas.py with
// S=None or S set, its bodies `make_body`, `make_body_cond`,
// `make_trip_pipe` (PIPE) and, with ADAPT, `body_adaptive`; precond, ridge,
// over-relaxation, ball on or off, cold projections, warm inputs, the dual
// output and the extra primal half-step with the fixed-point residual. No
// hyperplane projection (`allow_short` stays in the block and global
// layouts).
//
// Bound. What a solve waits on is the wide body's: the dependent chain of
// one iteration (the sums over assets of the portfolio value and of every
// Michelot sweep, each followed by an IEEE division), and for kernel B the
// returns, S H N floats a problem, read once an iteration: at S=16 H=20
// N=1000 and 1013 problems 1.30 GB an iteration, 0.39 ms at 3.35 TB/s. The
// global layout (pdhg_log_utility_block.cuh) ran the block body's stacked
// reduces (some 14 barriers an iteration) at L2 latency, one CTA an SM, and
// read B's returns twice an iteration.
//
// Design. CTA k of a problem's cluster owns rows k * span .. k * span +
// span - 1 (span = ceil(H / C) <= 32, the last CTA's spare warps exit at the
// start), one warp a row; each row's arrays are the wide plan's [K * 32]
// slices in that CTA's shared memory, so a within-row phase is the wide
// kernel's code and order. C is the fewest CTAs (at most 8, the portable
// cluster size) whose shared memory holds a span (`cluster_size`); the grid
// is B clusters, no workspace, no persistent loop. Rows meet only where the
// wide layout lets them meet, now across CTAs through distributed shared
// memory (`map_shared_rank`): a span's first row reads wbar_{t-1} of the
// CTA before it, its last row p_{t+1} (and with ADAPT dp_{t+1}, and the
// first row dw_{t-1}) of the CTA after it. The wide kernel's two
// __syncthreads an iteration become cluster barriers (barrier.cluster,
// release / acquire): A is a full barrier; B is split, its arrive after the
// dual update and its wait after the next iteration's portfolio values (or,
// for kernel B, the whole scenario gradient), which touch only the row's own
// arrays. L (a max over the rows, at the start) and fp (a max, at the end)
// are read across the cluster in row order; the adaptive balancing's
// residual partials are added in row order, lane by lane, across the
// cluster, so every warp takes the same decision from the same bits. A
// final cluster barrier keeps every CTA resident while another may still
// read its shared memory. So at every shape both take, the cluster kernel
// does the wide kernel's operations in the wide kernel's order.
// Scenarios (kernel B): a row's returns resident as [S][N] floats, or
// streamed through its warp's ring of `stages` stages of CW scenarios of
// K * 32 floats, filled by TMA bulk copies (cp.async.bulk, one a scenario's
// row, issued by lane 0, completing on the stage's mbarrier); a chunk's
// portfolio values and its part of the gradient are both taken while it
// sits in shared memory, so the returns are read from device memory once an
// iteration. A bulk copy needs 16-byte rows: the wrapper passes the returns
// with a row stride `ldr`, N rounded up to a multiple of 4 (padded with
// zeros where N is not); the ring's columns past ldr are zeroed once.

#pragma once

#include <cooperative_groups.h>

#include "pdhg_log_utility_wide.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kClusterMax = 8;  // CTAs a cluster, at most (portable)

// The launch's cluster: C CTAs of `span` rows, the streamed ring's depth,
// and the returns' row stride in floats (N for one forecast).
struct ClusterArgs {
  int C, span, stages, ldr;
};

// Offsets (in floats) of one CTA's shared memory, and the total: the returns
// first (one forecast: [span][K * 32]; S scenarios resident [span][S][N], or
// each warp's ring of stages x chunk x K * 32 floats, 16-byte aligned for
// the bulk copies), then the wide plan's arrays for span rows: w, p, the
// projection and dual input, wbar with one more row (the current weights in
// CTA 0), with ADAPT the moves dw and dp and each lane's residual partials
// [2][span][32]; the rows' curvature ratios (of a chunk of scenarios), fp,
// the rows' bounds; the streamed ring's mbarriers, one a stage a warp.
struct ClusterPlan {
  long long rs, w, p, v, wb, dw, dp, e, rat, fp, lr, bar, total;
};

__host__ __device__ inline ClusterPlan cluster_plan(int S, int span, int N,
                                                    bool adapt, int storage,
                                                    int stages, int chunk) {
  const long long KW = (long long)(N + 31) / 32 * 32, SR = span * KW;
  const bool scen = S > 0, ring = scen && storage == kStreamed;
  ClusterPlan P;
  long long o = 0;
  P.rs = o;
  if (!scen) o += SR;
  else if (ring) o += (long long)span * stages * chunk * KW;
  else o += (long long)span * S * N;
  o = (o + 3) / 4 * 4;
  P.w = o; o += SR;
  P.p = o; o += SR;
  P.v = o; o += SR;
  P.wb = o; o += SR + KW;
  P.dw = o; o += adapt ? SR : 0;
  P.dp = o; o += adapt ? SR : 0;
  P.e = o; o += adapt ? 2LL * span * 32 : 0;
  P.rat = o; o += (long long)span * (scen ? kWideChunk : 1);
  P.fp = o; o += span;
  P.lr = o; o += span;
  o = (o + 1) / 2 * 2;
  P.bar = o; o += ring ? 2LL * span * stages : 0;
  P.total = o;
  return P;
}

// The fewest CTAs, at most kClusterMax, whose plan for ceil(H / C) rows
// fits a block's shared memory with at most kWideMaxH rows a CTA, given as
// ceil(H / span) so that no CTA is left without a row; 0 where none does.
__host__ __device__ inline int cluster_size(int S, int H, int N, bool adapt,
                                            int storage, int stages,
                                            int chunk) {
  for (int C = 1; C <= kClusterMax; ++C) {
    const int span = (H + C - 1) / C;
    if (span > kWideMaxH) continue;
    const ClusterPlan P = cluster_plan(S, span, N, adapt, storage, stages,
                                       chunk);
    if (P.total * (long long)sizeof(float) <= kSmemPerBlock)
      return (H + span - 1) / span;
  }
  return 0;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(1)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One row's scenario returns streamed through its warp's ring of `stages`
// stages of CW scenarios x K * 32 floats, as RowRing lays them out (slot k
// of scenario s at (s K + k) * 32 + lane) but filled by TMA: lane 0 sets the
// stage's mbarrier to expect the chunk's bytes and issues one bulk copy of
// ldr floats a scenario; every lane waits on the mbarrier's phase. Chunks
// are issued in the order a pass reads them, stages - 1 ahead, wrapping from
// a pass's last chunk to the next pass's first; a stage is refilled only
// after every lane of the warp has read it (__syncwarp).
template <int CW>
struct TmaRing {
  float* base;               // stage 0 of this warp's ring
  const float* src;          // scenario 0 of this row
  unsigned long long* bar;   // this warp's stages' mbarriers
  long long step;            // floats between two scenarios of a row: H ldr
  int S, K, lane, stages, chunks;
  unsigned bytes;            // one scenario's row: ldr floats
  int put, put_chunk, get;
  unsigned parity;           // bit i: the parity stage i is waited on next

  __device__ __forceinline__ int stage_floats() const { return CW * K * 32; }
  // Zero the ring (the columns past ldr stay zero) and set up the stages'
  // mbarriers; before the first chunk is issued.
  __device__ __forceinline__ void init() {
    for (int i = lane; i < stages * stage_floats(); i += 32) base[i] = 0.f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) {
      for (int i = 0; i < stages; ++i) mbar_init(bar + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }
  __device__ __forceinline__ void issue() {
    __syncwarp();
    if (lane == 0) {
      const int s0 = put_chunk * CW, n = min(CW, S - s0);
      float* const dst = base + put * stage_floats();
      mbar_expect(bar + put, (unsigned)n * bytes);
      for (int s = 0; s < n; ++s)
        bulk_copy(dst + s * K * 32, src + (s0 + s) * step, bytes, bar + put);
    }
    put = put + 1 == stages ? 0 : put + 1;
    put_chunk = put_chunk + 1 == chunks ? 0 : put_chunk + 1;
  }
  __device__ __forceinline__ void await() {
    mbar_wait(bar + get, (parity >> get) & 1u);
    parity ^= 1u << get;
  }
  // The stages - 1 chunks ahead of a pass's first.
  __device__ __forceinline__ void start() {
    for (int i = 0; i + 1 < stages; ++i) issue();
  }
  // The next chunk of the pass, at this lane's column: one more issued,
  // the oldest awaited.
  __device__ __forceinline__ const float* next() {
    issue();
    await();
    const float* const x = base + get * stage_floats() + lane;
    get = get + 1 == stages ? 0 : get + 1;
    return x;
  }
  // The chunks still in flight, before the CTA's shared memory is left.
  __device__ __forceinline__ void drain() {
    for (int i = 0; i + 1 < stages; ++i) {
      await();
      get = get + 1 == stages ? 0 : get + 1;
    }
  }
};

template <int HB, int ST, int CW, bool ADAPT, bool PIPE>
__global__ void __launch_bounds__(HB * 32)
pdhg_log_utility_cluster_kernel(Args a, AdaptArgs ad, ClusterArgs ca) {
  extern __shared__ float smem[];  // 16-byte aligned
  constexpr bool SCEN = ST != kRegisters;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int span = ca.span;
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x >> 5;  // this warp's row of the CTA's span
  const int H = a.H, N = a.N, K = (N + 31) / 32, KW = K * 32;
  const int t0 = rank * span;
  const int nr = min(span, H - t0);  // rows of this CTA, at least 1
  if (j >= nr) return;  // the last CTA's spare warps: no row, no barrier
  const int t = t0 + j;  // this warp's horizon row
  const int b = blockIdx.x / ca.C;
  const int S = SCEN ? a.S : 0;
  const long long ldr = ca.ldr;
  const ClusterPlan P =
      cluster_plan(S, span, N, ADAPT, ST, ca.stages, SCEN ? CW : 1);
  const Slots s{K, N, lane};
  const int mine = j * KW + lane;  // this lane's slot 0 of its row
  const bool last = t + 1 == H;
  const bool first_row = j == 0, last_row = j + 1 == nr;
  float* const r = smem + P.rs + mine;
  float* const w = smem + P.w + mine;
  float* const p = smem + P.p + mine;
  float* const v = smem + P.v + mine;   // projection input, then dual input
  float* const wb = smem + P.wb + KW + mine;
  float* const sdw = smem + P.dw + mine;
  float* const sdp = smem + P.dp + mine;
  // The neighbour rows: in this CTA, or the last row of the CTA before
  // (wbar at its slot span, dw) and the first of the CTA after (p, dp).
  const float* const wbp =
      !first_row || rank == 0
          ? smem + P.wb + mine
          : cluster.map_shared_rank(smem + P.wb + (size_t)span * KW + lane,
                                    rank - 1);
  const float* const pn =
      last ? nullptr
           : !last_row ? p + KW
                       : cluster.map_shared_rank(smem + P.p + lane, rank + 1);
  const float* const dwp =
      t == 0 ? nullptr
             : !first_row
                   ? sdw - KW
                   : cluster.map_shared_rank(
                         smem + P.dw + (size_t)(span - 1) * KW + lane,
                         rank - 1);
  const float* const dpn =
      last ? nullptr
           : !last_row ? sdp + KW
                       : cluster.map_shared_rank(smem + P.dp + lane, rank + 1);
  // Row u's value of a per-row array (base: this CTA's copy), wherever in
  // the cluster it lies.
  auto row_val = [&](const float* base, int u) {
    return *cluster.map_shared_rank(base + u % span, u / span);
  };
  const float* const rs = smem + P.rs + (size_t)j * S * N + lane;
  TmaRing<CW> ring{smem + P.rs + (size_t)j * ca.stages * CW * KW,
                   a.r + ((size_t)b * S * H + t) * ldr,
                   reinterpret_cast<unsigned long long*>(smem + P.bar) +
                       (size_t)j * ca.stages,
                   (long long)H * ldr, S, K, lane, ca.stages,
                   (S + CW - 1) / CW, (unsigned)(ldr * sizeof(float)),
                   0, 0, 0, 0u};

  // Returns, current weights (CTA 0's warp 0 into wbar's row -1),
  // curvature bounds.
  float Lrow, L;
  if constexpr (SCEN) {
    float* const srat = smem + P.rat;
    float* const slr = smem + P.lr;
    if constexpr (ST == kStreamed) ring.init();
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
              ok ? a.r[(((size_t)b * S + sc) * H + t) * ldr + i] : 0.f;
          if (ST == kResident && ok)
            smem[P.rs + ((size_t)j * S + sc) * N + i] = x;
          n2 += x * x;
          if (ok) mn = jmin(mn, x);
        }
        n2 = lane_sum(n2);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mn = jmin(mn, __shfl_xor_sync(kFull, mn, o));
        const float m = jmax(mn, 1e-12f);
        const float ratio = n2 / (m * m);
        if (lane == 0) srat[(sc - s0) * span + j] = ratio;
        row_sum += ratio;
      }
      if (!a.precond) {
        cluster_sync();
        for (int sc = s0; sc < s1; ++sc) {
          const float* const q = srat + (sc - s0) * span;
          float mx = row_val(q, 0);
          for (int u = 0; u < H; ++u) mx = jmax(mx, row_val(q, u));
          max_sum += mx;
        }
        cluster_sync();
      }
    }
    const float fS = (float)S;
    if (a.precond) {
      Lrow = row_sum / fS + a.ridge;
      if (lane == 0) slr[j] = Lrow;
      cluster_sync();
      L = row_val(slr, 0);
      for (int u = 1; u < H; ++u) L = jmax(L, row_val(slr, u));
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
    if (lane == 0) srat[j] = ratio;
    Lrow = ratio + a.ridge;
    cluster_sync();
    float mx = row_val(srat, 0);
    for (int u = 1; u < H; ++u) mx = jmax(mx, row_val(srat, u));
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
    float x = ok ? a.cw[(size_t)b * N + i] : 0.f;  // the current weights
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
  cluster_arrive();  // B of iteration -1: the start's p

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
    cluster_sync();  // A
#pragma unroll 4
    for (int k = 0; k < K; ++k)
      v[k * 32] = p[k * 32] + sig * (wb[k * 32] - wbp[k * 32]);
  };
  // The smooth term's part of the primal step from the row's own arrays
  // (one forecast: the portfolio reciprocal times `scale`; S scenarios:
  // the scenario mean into v), taken before barrier B's wait.
  auto own_gradient = [&](float scale) {
    if constexpr (!SCEN) {
      return scale / jmax(wide_port(s, w, r), 1e-12f);
    } else {
      wide_scen_returns<CW, ST>(s, w, v, rs, ring, scale, S);
      return 0.f;
    }
  };
  if constexpr (!ADAPT) {
    const bool cond = warm && a.refresh > 1;  // make_body_cond
    const int kp = min(max(a.refresh, 1), 8);
    const int full = PIPE ? a.max_iters / kp * kp : 0;
    float l1s = 0.f;
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
      const float f = own_gradient(tau);
      cluster_wait();  // B: p of the row after
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float g = SCEN ? v[k * 32] : r[k * 32] * f;
        const float nxt = !last ? pn[k * 32] : 0.f;
        const float base = ridge0 ? w[k * 32] : c1 * w[k * 32];
        const float x = base + __fmaf_rn(-tau, p[k * 32] - nxt, g);
        v[k * 32] = s.valid(k) ? x : kNeg;
      }
      thw = wide_threshold(s, at_v, thw, 1.f, !warm, n_sw);
      extrapolate(false);

      // Dual prox on the q scale, clip form.
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
      cluster_arrive();  // B
    }
  } else {
    // body_adaptive. tau and sig are the carried steps from here on (the
    // tail then steps by the last tau); alpha is one scalar per problem.
    float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;
    const int n_sw = warm ? a.warm_iters : a.cold_iters;
    float* const se = smem + P.e;  // [2][span][32] the lanes' residual sums
    bool pending = true;           // barrier B arrived, not yet awaited
    for (int it = 0; it < a.max_iters; ++it) {
      const bool balance = ad.adapt_every <= 1 ||
                           (it % ad.adapt_every) == ad.adapt_every - 1;
      const float f = own_gradient(-1.f);
      if (pending) cluster_wait();  // B
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float gg = SCEN ? v[k * 32] : r[k * 32] * f;
        if (!ridge0) gg = gg + a.ridge * w[k * 32];
        const float nxt = !last ? pn[k * 32] : 0.f;
        const float x = w[k * 32] - tau * (gg + (p[k * 32] - nxt));
        v[k * 32] = s.valid(k) ? x : kNeg;
      }
      thw = wide_threshold(s, at_v, thw, 1.f, !warm, n_sw);
      extrapolate(balance);

      // Dual prox on the a-scale.
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
      cluster_arrive();  // B
      pending = !balance;

      // Residual balancing (ratio 1.5, alpha *= 0.95) over all rows.
      if (balance) {
        cluster_wait();  // B
        float e1s = 0.f, e2s = 0.f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const float dw = sdw[k * 32], dp = sdp[k * 32];
          const float dpnk = !last ? dpn[k * 32] : 0.f;
          const float dwpk = t == 0 ? 0.f : dwp[k * 32];
          const float e1 = dw / tau - (dp - dpnk);
          const float e2 = dp / sig - (dw - dwpk);
          e1s += e1 * e1;
          e2s += e2 * e2;
        }
        se[j * 32 + lane] = e1s;
        se[(span + j) * 32 + lane] = e2s;
        cluster_sync();  // C
        float res0 = 0.f, res1 = 0.f;
        for (int u = 0; u < H; ++u) {
          const float* const q = cluster.map_shared_rank(
              se + (u % span) * 32 + lane, u / span);
          res0 += q[0];
          res1 += q[span * 32];
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
    if (!pending) cluster_arrive();  // the tail's B
  }

  // Extra primal half-step with a cold full-budget projection; the
  // returned iterate is w_last and fp = max |w_last - w| over the problem.
  // The dual written out is the loop's last p.
  {
    const float f = own_gradient(-1.f);
    cluster_wait();  // B
    for (int k = 0; k < K; ++k) {
      float gg = SCEN ? v[k * 32] : r[k * 32] * f;
      if (!ridge0) gg = gg + a.ridge * w[k * 32];
      const float nxt = !last ? pn[k * 32] : 0.f;
      const float x = w[k * 32] - tau * (gg + (p[k * 32] - nxt));
      v[k * 32] = s.valid(k) ? x : kNeg;
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
    if (lane == 0) sfp[j] = fp;
    cluster_sync();
    if (t == 0 && lane == 0) {
      for (int u = 1; u < H; ++u) fp = jmax(fp, row_val(sfp, u));
      a.fp_out[b] = fp;
    }
  }
  if constexpr (ST == kStreamed) ring.drain();  // the chunks in flight
  cluster_sync();  // no CTA leaves while another may read its shared memory
}

// Launch (or, with `clusters`, only ask how many clusters of this shape the
// card runs at once): cudaLaunchKernelEx with the cluster dimension C, after
// cudaOccupancyMaxActiveClusters; a shape no cluster of the card holds
// returns cudaErrorInvalidConfiguration.
template <int HB, int ST, int CW, bool ADAPT, bool PIPE>
cudaError_t cluster_launch(const Args& a, const AdaptArgs& ad,
                           const ClusterArgs& ca, cudaStream_t stream,
                           int* clusters) {
  const ClusterPlan P = cluster_plan(ST == kRegisters ? 0 : a.S, ca.span,
                                     a.N, ADAPT, ST, ca.stages,
                                     ST == kRegisters ? 1 : CW);
  const long long smem = P.total * (long long)sizeof(float);
  if (smem > kSmemPerBlock) return cudaErrorInvalidValue;
  auto kernel = pdhg_log_utility_cluster_kernel<HB, ST, CW, ADAPT, PIPE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ca.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * ca.C), 1, 1);
  cfg.blockDim = dim3((unsigned)(ca.span * 32), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters != nullptr) {
    *clusters = n;
    return cudaSuccess;
  }
  if (n < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, a, ad, ca);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int HB, int ST, int CW, bool ADAPT>
cudaError_t cluster_body(const Args& a, const AdaptArgs& ad,
                         const ClusterArgs& ca, bool pipe, cudaStream_t s,
                         int* clusters) {
  if constexpr (!ADAPT) {
    if (pipe)
      return cluster_launch<HB, ST, CW, ADAPT, true>(a, ad, ca, s, clusters);
  }
  return cluster_launch<HB, ST, CW, ADAPT, false>(a, ad, ca, s, clusters);
}

template <int HB, bool SCEN, bool ADAPT>
cudaError_t cluster_returns(const Args& a, const AdaptArgs& ad,
                            const ClusterArgs& ca, bool pipe, int storage,
                            int chunk, cudaStream_t s, int* clusters) {
  if constexpr (SCEN) {
    if (storage == kResident)
      return cluster_body<HB, kResident, kWideChunk, ADAPT>(a, ad, ca, pipe,
                                                            s, clusters);
    if (storage != kStreamed) return cudaErrorInvalidValue;
    if (chunk == 2)
      return cluster_body<HB, kStreamed, 2, ADAPT>(a, ad, ca, pipe, s,
                                                   clusters);
    if (chunk == 1)
      return cluster_body<HB, kStreamed, 1, ADAPT>(a, ad, ca, pipe, s,
                                                   clusters);
    return cudaErrorInvalidValue;
  } else {
    if (storage != kRegisters) return cudaErrorInvalidValue;
    return cluster_body<HB, kRegisters, 1, ADAPT>(a, ad, ca, pipe, s,
                                                  clusters);
  }
}

// A cluster of C CTAs a problem, each of ceil(H / C) warps (compiled for at
// most 8 or 32), one forecast (storage kRegisters) or S scenarios resident
// or streamed through a ring of `stages` (2 or 3) stages of `chunk` (2 or
// 1) scenarios, the rings routing takes (a deeper chunk only takes more
// CTAs a problem, and ran slower); the returns' rows `ldr` floats apart (N for
// one forecast; for S scenarios a multiple of 4 of at least N). A cluster
// that leaves a CTA without a row, a span past 32 rows or a plan past a
// block's shared memory returns cudaErrorInvalidValue (the wrapper checks
// first). pipe != 0 runs `make_trip_pipe` (never with ADAPT).
template <bool SCEN, bool ADAPT>
int cluster_dispatch(const Args& a, const AdaptArgs& ad, int pipe,
                     int storage, int C, int stages, int chunk, int ldr,
                     void* stream, int* clusters = nullptr) {
  if (a.B <= 0 || a.H <= 0 || a.N <= 0 || (SCEN && a.S <= 0) ||
      (ADAPT && pipe) || C < 1 || C > kClusterMax)
    return (int)cudaErrorInvalidValue;
  const int span = (a.H + C - 1) / C;
  if (span > kWideMaxH || (C - 1) * span >= a.H)
    return (int)cudaErrorInvalidValue;
  if (SCEN && (ldr < a.N || ldr % 4 != 0 ||
               (storage == kStreamed && (stages < 2 || stages > 3))))
    return (int)cudaErrorInvalidValue;
  if (SCEN && storage == kStreamed &&
      (reinterpret_cast<unsigned long long>(a.r) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const ClusterArgs ca{C, span, SCEN && storage == kStreamed ? stages : 0,
                       SCEN ? ldr : a.N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pp = pipe != 0;
  if (span <= 8)
    return (int)cluster_returns<8, SCEN, ADAPT>(a, ad, ca, pp, storage, chunk,
                                                s, clusters);
  return (int)cluster_returns<32, SCEN, ADAPT>(a, ad, ca, pp, storage, chunk,
                                               s, clusters);
}

}  // namespace
