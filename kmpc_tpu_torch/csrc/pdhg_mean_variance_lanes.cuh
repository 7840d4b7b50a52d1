// Kernel C at one horizon row in the lane layout: the fused Condat-Vu PDHG
// solve of the batched mean-variance program (pdhg_mean_variance.cuh) at
// H = 1, N <= 128, redesigned for the H100.
//
// Replaces, at one horizon row, the TPU kernel `_make_packed_mv_kernel`
// (kmpc_tpu/ops/mpc_pallas.py), as the warp layout
// (pdhg_mean_variance.cuh) did before it: the fixed-step body with the
// full warm Michelot budget, the refresh schedule or cold projections,
// over-relaxation, a per-problem or a shared covariance and the extra
// primal half-step; with ADAPT the residual-balancing adaptive body
// (`steps_out`, `adapt_every`).
//
// Design. One warp owns one problem, asset i on lane i % 32, slot i / 32,
// as in the warp layout. What changes is where the data lives:
//
// 1. Sigma's row i lies in lane i's registers where N <= 32 (K = 1): NC
//    floats (N rounded up to 8), loaded once from global memory (L2 for a
//    shared Sigma, which every warp reads). Past 32 assets (K = 2..4)
//    Sigma stays in shared memory column by column ([j][K*32], zero rows
//    past N), per warp or, shared, per CTA, as in the warp layout.
// 2. w is broadcast through a per-warp shared vector: each lane stores
//    w_i, __syncwarp, and every lane reads w whole as float4 broadcast
//    loads. Sigma w is then a row dot product with four independent
//    accumulators (K = 1), or K pairs of them against shared-memory
//    columns, not N shuffles into one dependent chain.
// 3. The simplex threshold's sweeps count the values above theta by one
//    ballot a slot (exact, so the same float as a butterfly of counts) and
//    sum them by the warp butterfly: five shuffles a sweep where the warp
//    layout took ten. With INLANE (compiled at K = 1 only) the sum runs in
//    every lane instead: each
//    lane stages its active value in a per-warp vector, __syncwarp, and
//    every lane sums the vector whole (float4 broadcast loads, four
//    partials in one fixed order, so theta is warp-uniform bit for bit and
//    no butterfly lies on the chain). The wrapper picks the sweep by batch
//    (`mv_lanes_sweep`), as measured.
// 4. A projection's sweeps stop where one returns its input threshold bit
//    for bit (`lanes_settled`), as the row layout's do: every later sweep
//    would return it too, so the bits are those of the full budget.
// 5. The adaptive body's two residual sums go through the existing
//    two-value butterfly (warp_sum<2>) every `adapt_every`-th iteration.
//
// Bound. Per iteration and problem: N^2 multiply-adds for Sigma w and
// about 15 FP32 operations an asset beside 4 an asset per sweep; inputs
// read once (Sigma N^2 floats per problem). At B <= ~1000 one warp's
// dependent chain sets the pace (8 warps an SM at B = 1028, one at B = 1):
// the design takes the shuffles off it. At B = 65536 the issue slots of
// the FP32 and MIO pipes do: 1 + ceil(N/4) shared loads for Sigma w
// instead of 2N shuffles and loads. Plain FP32, no tensor cores (the
// reference pins the product to exact float32).

#pragma once

#include "pdhg_mean_variance.cuh"

namespace {

// Warps a CTA of the lane layout: kMaxWarpsPerBlock, or as many
// per-problem covariances as fit a block's shared memory past 32 assets.
// A warp's vectors (w and the staged v) hold lanes_vec floats each.
__host__ __device__ constexpr int lanes_vec(int K, int N) {
  return K == 1 ? (N + 7) / 8 * 8 : K * 32;
}

struct MvLanesPlan {
  int warps;        // a CTA; 0 where the layout does not take N
  long long bytes;  // dynamic shared memory of a CTA
};

// The plan: two vectors a warp; past 32 assets a Sigma of N columns of
// K*32 floats per warp (per CTA when shared).
inline MvLanesPlan mv_lanes_plan(int N, int shared) {
  const int K = (N + 31) / 32;
  if (N < 1 || K > 4) return {0, -1};
  const long long vec = 2LL * lanes_vec(K, N);
  const long long sig = K == 1 ? 0 : (long long)N * K * 32;
  int warps = kMaxWarpsPerBlock;
  if (!shared && sig > 0) {
    const long long fit = kSmemPerBlock / 4 / (vec + sig);
    warps = fit < warps ? (int)fit : warps;
  }
  const long long bytes = 4 * (warps * vec + (shared ? sig : warps * sig));
  if (warps < 1 || bytes > kSmemPerBlock) return {0, -1};
  return {warps, bytes};
}

// This lane's K values x into the warp's vector `vec` (slot k of lane i at
// k * 32 + i, up to V floats).
template <int K, int V>
__device__ __forceinline__ void lanes_stage(const float (&x)[K], float* vec,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    if (i < V) vec[i] = x[k];
  }
}

// (Sigma w) of this lane's K rows from the staged w (`wv`, after a
// __syncwarp), read whole as float4 broadcast loads: with ROWS (K = 1)
// against Sigma's row in registers, NC floats with four accumulators;
// else against Sigma's N columns of K*32 floats in shared memory (`Sg`,
// entry (i, j) at [j * K*32 + i]), two accumulators a slot.
template <int K, int NC, bool ROWS>
__device__ __forceinline__ void lanes_quad(
    const float* wv, const float (&srow)[ROWS ? NC : 1], const float* Sg,
    int N, int lane, float (&quad)[K]) {
  constexpr int KP = K * 32;
  const float4* w4 = reinterpret_cast<const float4*>(wv);
  if constexpr (ROWS) {
    static_assert(K == 1, "register rows hold one slot");
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      const float4 x = w4[q];
      acc[0] = fmaf(srow[4 * q], x.x, acc[0]);
      acc[1] = fmaf(srow[4 * q + 1], x.y, acc[1]);
      acc[2] = fmaf(srow[4 * q + 2], x.z, acc[2]);
      acc[3] = fmaf(srow[4 * q + 3], x.w, acc[3]);
    }
    quad[0] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  } else if constexpr (K == 1) {
    // One slot: NC known, the columns past N skipped.
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      const float4 x4 = w4[q];
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * q + r;
        if (j < N) acc[r & 1] = fmaf(Sg[(size_t)j * 32 + lane], x[r],
                                     acc[r & 1]);
      }
    }
    quad[0] = acc[0] + acc[1];
  } else {
    float acc[K][2];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k][0] = acc[k][1] = 0.f;
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = w4[q];
      const float* col = Sg + (size_t)(4 * q) * KP + lane;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k][0] = fmaf(col[k * 32], x.x, acc[k][0]);
        acc[k][1] = fmaf(col[KP + k * 32], x.y, acc[k][1]);
        acc[k][0] = fmaf(col[2 * KP + k * 32], x.z, acc[k][0]);
        acc[k][1] = fmaf(col[3 * KP + k * 32], x.w, acc[k][1]);
      }
    }
    for (int j = N / 4 * 4; j < N; ++j) {
      const float x = wv[j];
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k][j & 1] = fmaf(Sg[(size_t)j * KP + k * 32 + lane], x,
                             acc[k][j & 1]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) quad[k] = acc[k][0] + acc[k][1];
  }
}

// v = w - tau * ((2 gamma Sigma w - mu) + p), masked for the threshold (at
// H = 1, D'p = p); w goes through the warp's vector wv.
template <int K, int NC>
__device__ __forceinline__ void lanes_primal(
    const float (&w)[K], const float (&p)[K], const float (&mu)[K],
    const bool (&valid)[K], const float (&srow)[K == 1 ? NC : 1],
    const float* Sg, float* wv, int N, float two_gamma, float tau, int lane,
    float (&vm)[1][K]) {
  lanes_stage<K, lanes_vec(K, NC)>(w, wv, lane);
  __syncwarp();
  float quad[K];
  lanes_quad<K, NC, K == 1>(wv, srow, Sg, N, lane, quad);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float g = two_gamma * quad[k] - mu[k];
    const float v = w[k] - tau * (g + p[k]);
    vm[0][k] = valid[k] ? v : kNeg;
  }
}

// The sum over the warp of the lanes' K values x, in every lane in one
// fixed order: each lane stages its values in the warp's vector `buf` (V
// floats; the lanes past N stage zeros), __syncwarp, and every lane sums
// the whole vector, read as float4 broadcast loads, four partials deep
// (value j into partial j % 4). The caller orders the next store into
// `buf` after every lane's reads.
template <int K, int V>
__device__ __forceinline__ float staged_sum(const float (&x)[K], float* buf,
                                            int lane) {
  lanes_stage<K, V>(x, buf, lane);
  __syncwarp();
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 y = b4[q];
    s[0] += y.x;
    s[1] += y.y;
    s[2] += y.z;
    s[3] += y.w;
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// One butterfly sweep of each of C independent problems a warp (the
// ladder's chains; C = 1 in the solve): the count of the values above
// theta by one ballot a slot (exact, so the same float as a butterfly of
// per-lane counts), their sum by the warp butterfly, the C butterflies
// interleaved level by level.
template <int C, int K>
__device__ __forceinline__ void bfly_sweep(const float (&vm)[C][K],
                                           float (&theta)[C]) {
  float s[C];
  int cnt[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    s[c] = 0.f;
    cnt[c] = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool a = vm[c][k] > theta[c];
      cnt[c] += __popc(__ballot_sync(kFull, a));
      s[c] += a ? vm[c][k] : 0.f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] += __shfl_xor_sync(kFull, s[c], o);
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    theta[c] = (s[c] - 1.f) / jmax((float)cnt[c], 1.f);
}

// Whether a sweep returned its input threshold bit for bit: every later
// sweep of the projection would too (a sweep is a function of the values
// and theta), so the projection stops there with the same bits.
__device__ __forceinline__ bool lanes_settled(float th, float before) {
  return __float_as_uint(th) == __float_as_uint(before);
}

// The simplex threshold of the masked values vm: a cold start (the sum of
// the unmasked values - 1) / N and up to n sweeps, or up to n sweeps from
// the carried theta, stopped where one settles (`lanes_settled`; theta is
// warp-uniform, so the whole warp stops together). Each sweep counts the
// values above theta by one ballot a slot and sums them by the warp
// butterfly (`bfly_sweep`), or with INLANE in every lane (`staged_sum`,
// through the warp's two vectors vv and wv in turns, so that a lane's
// store never meets another's read of the previous sweep; the caller
// puts a __syncwarp before its next store into wv).
template <int K, int NC, bool INLANE>
__device__ __forceinline__ float lanes_threshold(
    const float (&vm)[1][K], float* vv, float* wv, float theta, int N,
    int lane, bool cold, int n) {
  constexpr int V = lanes_vec(K, NC);
  float th[1] = {theta};
  int turn = 0;
  if (cold) {
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[k] = vm[0][k] > 0.5f * kNeg ? vm[0][k] : 0.f;
    float s[1];
    if constexpr (INLANE) {
      s[0] = staged_sum<K, V>(x, vv, lane);
      turn = 1;
    } else {
      s[0] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) s[0] += x[k];
      warp_sum<1>(s, 1);
    }
    th[0] = (s[0] - 1.f) / (float)N;
  }
  for (int i = 0; i < n; ++i) {
    const float before = th[0];
    if constexpr (INLANE) {
      float x[K];
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool a = vm[0][k] > th[0];
        cnt += __popc(__ballot_sync(kFull, a));
        x[k] = a ? vm[0][k] : 0.f;
      }
      const float sum = staged_sum<K, V>(x, (turn & 1) ? wv : vv, lane);
      ++turn;
      th[0] = (sum - 1.f) / jmax((float)cnt, 1.f);
    } else {
      bfly_sweep<1, K>(vm, th);
    }
    if (i + 1 < n && lanes_settled(th[0], before)) break;
  }
  return th[0];
}

template <int K, int NC, bool ADAPT, bool INLANE>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
pdhg_mean_variance_lanes_kernel(MvArgs a, MvAdaptArgs ad) {
  extern __shared__ __align__(16) float lsm[];
  constexpr int KP = K * 32;
  constexpr int V = lanes_vec(K, NC);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.x * warps + warp;
  const int N = a.N;
  const bool live = b < a.B;
  float* const wv = lsm + (size_t)warp * 2 * V;
  float* const vv = wv + V;

  // Past 32 assets Sigma into shared memory, [j][i], zero padding in i;
  // per warp, or once per CTA when shared.
  const float* Sg = nullptr;
  if constexpr (K > 1) {
    float* const base = lsm + (size_t)warps * 2 * V;
    if (a.shared) {
      for (int idx = threadIdx.x; idx < N * KP; idx += blockDim.x) {
        const int j = idx / KP, i = idx % KP;
        base[idx] = i < N ? a.sigma[(size_t)i * N + j] : 0.f;
      }
      __syncthreads();
      Sg = base;
    } else {
      float* mine = base + (size_t)warp * N * KP;
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
  }
  if (!live) return;  // after the block barrier; whole warps leave

  // At K = 1 Sigma's row `lane` in registers, zeros past N.
  float srow[K == 1 ? NC : 1];
  float fro2[1] = {0.f};
  if constexpr (K == 1) {
    const float* src = a.sigma + (a.shared ? 0 : (size_t)b * N * N);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      srow[j] = (lane < N && j < N) ? src[(size_t)lane * N + j] : 0.f;
      fro2[0] += srow[j] * srow[j];
    }
  } else {
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float x = Sg[(size_t)j * KP + k * 32 + lane];
        fro2[0] += x * x;
      }
    }
  }
  warp_sum<1>(fro2, 1);

  bool valid[K];
  float cw[K], w[K], p[K], mu[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * 32 + lane;
    valid[k] = i < N;
    cw[k] = valid[k] ? a.cw[(size_t)b * N + i] : 0.f;
    mu[k] = valid[k] ? a.mu[(size_t)b * N + i] : 0.f;
    p[k] = 0.f;
  }

  // L = max(2 gamma ||Sigma||_F, 1e-6); sigma = sigma_scale sqrt(L + 1) / 2;
  // tau = step_scale / (L/2 + 4 sigma). Under ADAPT sig, tau and alpha are
  // carried through the loop.
  const float two_gamma = 2.f * a.gamma;
  const float L = jmax(two_gamma * sqrtf(fro2[0]), 1e-6f);
  float sig = a.sigma_scale * sqrtf(L + 1.f) / 2.f;
  float tau = a.step_scale / (0.5f * L + sig * 4.f);
  float alpha = 0.5f, pr_last = 0.f, dr_last = 0.f, moved = 0.f;

  // w0 = cold simplex projection of the current weights.
  float vm[1][K];
#pragma unroll
  for (int k = 0; k < K; ++k) vm[0][k] = valid[k] ? cw[k] : kNeg;
  float thw = lanes_threshold<K, NC, INLANE>(vm, vv, wv, 0.f, N, lane,
                                             true, a.cold_iters);
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = jmax(vm[0][k] - thw, 0.f);

  const bool warm = a.warm != 0;
  const bool cond = !ADAPT && warm && a.refresh > 1;
  const bool relax = a.rho != 1.f;
  // Countdowns in place of `it % refresh == 0` (the full budget) and
  // `it % k == k - 1` (a balancing): no integer division an iteration.
  int refresh_in = 0;
  const int every = ADAPT ? max(ad.adapt_every, 1) : 1;
  int balance_in = every - 1;
  for (int it = 0; it < a.max_iters; ++it) {
    int n_sw;
    if (!warm) {
      n_sw = a.cold_iters;
    } else if (cond) {
      n_sw = refresh_in == 0 ? a.warm_iters : 1;
      refresh_in = (refresh_in == 0 ? a.refresh : refresh_in) - 1;
    } else {
      n_sw = a.warm_iters;
    }

    // A lane's last read of wv (by Sigma w, or by an in-lane sweep) before
    // another's next store.
    __syncwarp();
    lanes_primal<K, NC>(w, p, mu, valid, srow, Sg, wv, N, two_gamma, tau,
                        lane, vm);
    thw = lanes_threshold<K, NC, INLANE>(vm, vv, wv, thw, N, lane, !warm,
                                         n_sw);

    float wn[K], pn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wn[k] = jmax(vm[0][k] - thw, 0.f);
      const float wb = 2.f * wn[k] - w[k];
      const float q = p[k] + sig * (wb - cw[k]);
      pn[k] = jmin(jmax(q, -a.c), a.c);
    }
    if constexpr (ADAPT) {
      // Residual balancing (ratio 1.5, alpha *= 0.95), from the moves
      // before over-relaxation: pr = ||dw / tau - dp||,
      // dr = ||dp / sigma - dw|| (one row: no neighbours). A zero move
      // (a weight held at 0, a dual held at the clip, a padded lane) and a
      // zero sum skip the IEEE division and square root, whose checks send
      // a zero operand down their slow path: the same bits, +0.
      const bool balance = balance_in == 0;
      balance_in = balance ? every - 1 : balance_in - 1;
      if (balance) {
        float res[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float dw = w[k] - wn[k];
          const float dp = p[k] - pn[k];
          const float e1 = (dw == 0.f ? 0.f : dw / tau) - dp;
          const float e2 = (dp == 0.f ? 0.f : dp / sig) - dw;
          res[0] += e1 * e1;
          res[1] += e2 * e2;
        }
        warp_sum<2>(res, 2);
        const float pr = res[0] == 0.f ? 0.f : sqrtf(res[0]);
        const float dr = res[1] == 0.f ? 0.f : sqrtf(res[1]);
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
    for (int k = 0; k < K; ++k) {
      if (relax) {
        w[k] = w[k] + a.rho * (wn[k] - w[k]);
        p[k] = p[k] + a.rho * (pn[k] - p[k]);
      } else {
        w[k] = wn[k];
        p[k] = pn[k];
      }
    }
  }

  // Extra primal half-step with a cold full-budget projection: the
  // returned iterate is w_last and fp = max |w_last - w|.
  __syncwarp();
  lanes_primal<K, NC>(w, p, mu, valid, srow, Sg, wv, N, two_gamma, tau,
                      lane, vm);
  thw = lanes_threshold<K, NC, INLANE>(vm, vv, wv, thw, N, lane, true,
                                       a.cold_iters);
  float fp = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (valid[k]) {
      const float wl = jmax(vm[0][k] - thw, 0.f);
      fp = jmax(fp, fabsf(wl - w[k]));
      a.w_out[(size_t)b * N + k * 32 + lane] = wl;
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

template <int K, int NC, bool ADAPT, bool INLANE>
cudaError_t lanes_launch(const MvArgs& a, const MvAdaptArgs& ad,
                         const MvLanesPlan& plan, cudaStream_t stream) {
  auto kernel = pdhg_mean_variance_lanes_kernel<K, NC, ADAPT, INLANE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (a.B + plan.warps - 1) / plan.warps;
  kernel<<<blocks, plan.warps * 32, plan.bytes, stream>>>(a, ad);
  return cudaGetLastError();
}

// H = 1 and K = ceil(N/32) <= 4 are compiled (NC = N rounded up to 8 at
// K = 1); `inlane` picks the sweep, compiled at K = 1 only (past 32 assets
// the butterfly is the routed sweep). Anything else returns
// cudaErrorInvalidValue (the wrapper checks first). `schedule` is
// `refresh` for the fixed-step body and `adapt_every` for the adaptive
// one; `steps_out` may be null.
template <bool ADAPT>
int mv_lanes_dispatch(
    const void* cw, const void* mu, const void* sigma, void* w_out,
    void* fp_out, void* steps_out, int B, int H, int N, int shared,
    int inlane, int max_iters, int schedule, int warm_iters, int cold_iters,
    float c, float gamma, float rho, float step_scale, float sigma_scale,
    int warm, void* stream) {
  if (B <= 0 || H != 1 || N <= 0) return (int)cudaErrorInvalidValue;
  const MvLanesPlan plan = mv_lanes_plan(N, shared);
  if (plan.warps == 0) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (N + 31) / 32;
  const int nc = lanes_vec(K, N);

#define KMPC_CASE1(NC_)                                                 \
  if (K == 1 && nc == NC_)                                              \
    return (int)(inlane ? lanes_launch<1, NC_, ADAPT, true>(a, ad, plan, s) \
                        : lanes_launch<1, NC_, ADAPT, false>(a, ad, plan, s));
#define KMPC_CASE(K_, NC_)                                              \
  if (K == K_ && nc == NC_)                                             \
    return (int)(inlane ? cudaErrorInvalidValue                         \
                        : lanes_launch<K_, NC_, ADAPT, false>(a, ad, plan, s));
  KMPC_CASE1(8) KMPC_CASE1(16) KMPC_CASE1(24) KMPC_CASE1(32)
  KMPC_CASE(2, 64) KMPC_CASE(3, 96) KMPC_CASE(4, 128)
#undef KMPC_CASE1
#undef KMPC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
