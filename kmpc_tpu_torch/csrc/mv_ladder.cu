// Attribution ladder of the mean-variance H=1 PDHG loop: stripped bodies in
// the loop shape of the production kernel (pdhg_mean_variance.cuh), timed
// one against the other to split an iteration's cost.
//
// Replaces the TPU kernels of scripts/mv_ladder.py (`make_kernel` / `run`):
//
//   carry   the loop's floor: one multiply-add per iterate
//           (w2 = w - tau (p - mu), p += sigma (w2 - w)), no reduction;
//   sigma   + the quadratic gradient Sigma w, the projection replaced by a
//           clamp at 0, the dual clipped to [-c, c];
//   proj    + one warm Michelot sweep per iteration from the carried
//           threshold: the production body without its refresh schedule;
//
// each with `unroll` 1 or 4 iterations per loop trip (iters / unroll trips,
// the remainder dropped as there) and `chains` 1, 2 or 4 independent
// problems per warp, their iterations interleaved statement by statement
// so that one chain's arithmetic fills the other's shuffle latency. Same
// constants: steps from sqrt(L + 1), w0 = the current weights, p0 = 0,
// theta0 = 0; the output is the loop's last w, with no final half-step.
// The TPU ladder's tile rungs (128, 256, 512 lanes per block) have no
// meaning here; their counterpart is warps per block, a launch argument.
//
// Design. As the production kernel: one warp per problem (per `chains`
// problems), asset i on lane i % 32, slot i / 32; w, p, mu in registers;
// each problem's Sigma column by column in its warp's slice of shared
// memory, Sigma w by shuffle-broadcast and multiply-add in plain FP32.
// Reductions of the chains go through one butterfly together (the chains
// take the place of the horizon rows of warp_sum).
//
// Bound. N multiply-adds and N shuffles per slot and iteration for Sigma w,
// two butterflies for the sweep; Sigma (N * N floats per problem) is read
// once. Bound by shuffle and FP32 latency, not by HBM; `carry` shows what
// the loop costs with neither.

#include "pdhg_common.cuh"

namespace {

enum Variant { kCarry = 0, kSigma = 1, kProj = 2 };
constexpr int kLadderMaxWarps = 8;

struct LadderArgs {
  const float* cw;     // [B, N] current weights
  const float* mu;     // [B, N] forecast log-returns (H = 1)
  const float* sigma;  // [B, N, N]
  float* w_out;        // [B, N] the loop's last w
  int B, N, iters;
  float gamma, c, sigma_scale;
};

template <int K, int VARIANT, int UNROLL, int CHAINS>
__global__ void __launch_bounds__(kLadderMaxWarps * 32)
mv_ladder_kernel(LadderArgs a) {
  extern __shared__ float smem[];
  constexpr int KP = K * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * (blockDim.x >> 5) + warp) * CHAINS;
  if (first >= a.B) return;  // whole warps leave; no block barriers
  const int N = a.N;

  // A chain past the end of the batch repeats the last problem and is not
  // written out, so every chain of a warp runs the same instructions.
  bool valid[K];
  float cw[CHAINS][K], mu[CHAINS][K], w[CHAINS][K], p[CHAINS][K];
  float th[CHAINS], tau[CHAINS], sg[CHAINS];
  const float* Sg[CHAINS];
#pragma unroll
  for (int k = 0; k < K; ++k) valid[k] = k * 32 + lane < N;
  const float two_gamma = 2.f * a.gamma;
#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch) {
    const int b = min(first + ch, a.B - 1);
    float* mine = smem + (size_t)(warp * CHAINS + ch) * N * KP;
    const float* src = a.sigma + (size_t)b * N * N;
    float fro2[1] = {0.f};
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = k * 32 + lane;
        const float x = i < N ? src[(size_t)i * N + j] : 0.f;
        mine[(size_t)j * KP + i] = x;
        fro2[0] += x * x;
      }
    }
    warp_sum<1>(fro2, 1);
    const float L = jmax(two_gamma * sqrtf(fro2[0]), 1e-6f);
    sg[ch] = a.sigma_scale * sqrtf(L + 1.f) / 2.f;
    tau[ch] = 1.f / (0.5f * L + sg[ch] * 4.f);
    th[ch] = 0.f;
    Sg[ch] = mine;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = k * 32 + lane;
      cw[ch][k] = valid[k] ? a.cw[(size_t)b * N + i] : 0.f;
      mu[ch][k] = valid[k] ? a.mu[(size_t)b * N + i] : 0.f;
      w[ch][k] = cw[ch][k];
      p[ch][k] = 0.f;
    }
  }
  __syncwarp();

  float one[CHAINS];
#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch) one[ch] = 1.f;

  const int n_trips = a.iters / UNROLL;
  for (int trip = 0; trip < n_trips; ++trip) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if constexpr (VARIANT == kCarry) {
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float w2 = w[ch][k] - tau[ch] * (p[ch][k] - mu[ch][k]);
            p[ch][k] = p[ch][k] + sg[ch] * (w2 - w[ch][k]);
            w[ch][k] = w2;
          }
        }
      } else {
        // Sigma w of every chain, column by column.
        float quad[CHAINS][K];
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
#pragma unroll
          for (int k = 0; k < K; ++k) quad[ch][k] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const int jn = min(32, N - kk * 32);
          for (int jj = 0; jj < jn; ++jj) {
            const size_t col = (size_t)(kk * 32 + jj) * KP + lane;
#pragma unroll
            for (int ch = 0; ch < CHAINS; ++ch) {
              const float wj = __shfl_sync(kFull, w[ch][kk], jj);
#pragma unroll
              for (int k = 0; k < K; ++k)
                quad[ch][k] += Sg[ch][col + k * 32] * wj;
            }
          }
        }
        float vm[CHAINS][K];
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float g = two_gamma * quad[ch][k] - mu[ch][k];
            const float v = w[ch][k] - tau[ch] * (g + p[ch][k]);
            vm[ch][k] = valid[k] ? v : kNeg;
          }
        }
        if constexpr (VARIANT == kProj)
          sweep<CHAINS, K>(vm, th, one, CHAINS);
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float wn = VARIANT == kProj ? jmax(vm[ch][k] - th[ch], 0.f)
                                              : jmax(vm[ch][k], 0.f);
            const float wb = 2.f * wn - w[ch][k];
            const float q = p[ch][k] + sg[ch] * (wb - cw[ch][k]);
            p[ch][k] = jmin(jmax(q, -a.c), a.c);
            w[ch][k] = wn;
          }
        }
      }
    }
  }

#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch) {
    if (first + ch < a.B) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (valid[k])
          a.w_out[(size_t)(first + ch) * N + k * 32 + lane] = w[ch][k];
      }
    }
  }
}

template <int K, int VARIANT, int UNROLL, int CHAINS>
cudaError_t launch(const LadderArgs& a, int warps, cudaStream_t stream) {
  const size_t smem =
      (size_t)warps * CHAINS * a.N * (K * 32) * sizeof(float);
  if (smem > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mv_ladder_kernel<K, VARIANT, UNROLL, CHAINS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int per_block = warps * CHAINS;
  const int blocks = (a.B + per_block - 1) / per_block;
  mv_ladder_kernel<K, VARIANT, UNROLL, CHAINS>
      <<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K, int VARIANT>
cudaError_t pick(const LadderArgs& a, int unroll, int chains, int warps,
                 cudaStream_t s) {
#define KMPC_RUNG(U_, C_)             \
  if (unroll == U_ && chains == C_) \
    return launch<K, VARIANT, U_, C_>(a, warps, s);
  KMPC_RUNG(1, 1) KMPC_RUNG(1, 2) KMPC_RUNG(1, 4)
  KMPC_RUNG(4, 1) KMPC_RUNG(4, 2) KMPC_RUNG(4, 4)
#undef KMPC_RUNG
  return cudaErrorInvalidValue;
}

}  // namespace

// variant 0 carry, 1 sigma, 2 proj; unroll 1 or 4; chains 1, 2 or 4; warps
// per block 1..8; N <= 128. Anything else, or more shared memory than a
// block has, returns cudaErrorInvalidValue (the wrapper checks first).
extern "C" int kmpc_mv_ladder(
    const void* cw, const void* mu, const void* sigma, void* w_out, int B,
    int N, int iters, int variant, int unroll, int chains, int warps,
    float gamma, float c, float sigma_scale, void* stream) {
  LadderArgs a;
  a.cw = static_cast<const float*>(cw);
  a.mu = static_cast<const float*>(mu);
  a.sigma = static_cast<const float*>(sigma);
  a.w_out = static_cast<float*>(w_out);
  a.B = B;
  a.N = N;
  a.iters = iters;
  a.gamma = gamma;
  a.c = c;
  a.sigma_scale = sigma_scale;
  if (B <= 0 || N <= 0 || iters < 0 || warps < 1 || warps > kLadderMaxWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (N + 31) / 32;

#define KMPC_CASE(K_, V_)       \
  if (K == K_ && variant == V_) \
    return (int)pick<K_, V_>(a, unroll, chains, warps, s);
  KMPC_CASE(1, kCarry) KMPC_CASE(1, kSigma) KMPC_CASE(1, kProj)
  KMPC_CASE(2, kCarry) KMPC_CASE(2, kSigma) KMPC_CASE(2, kProj)
  KMPC_CASE(3, kCarry) KMPC_CASE(3, kSigma) KMPC_CASE(3, kProj)
  KMPC_CASE(4, kCarry) KMPC_CASE(4, kSigma) KMPC_CASE(4, kProj)
#undef KMPC_CASE
  return (int)cudaErrorInvalidValue;
}
