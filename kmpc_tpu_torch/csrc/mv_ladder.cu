// Attribution ladder of the mean-variance H=1 PDHG loop: stripped bodies in
// the loop shape of the production kernel at one horizon row, the lane
// layout (pdhg_mean_variance_lanes.cuh), timed one against the other to
// split an iteration's cost.
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
// so that one chain's arithmetic fills the other's latency. Same
// constants: steps from sqrt(L + 1), w0 = the current weights, p0 = 0,
// theta0 = 0; the output is the loop's last w, with no final half-step.
// The TPU ladder's tile rungs (128, 256, 512 lanes per block) have no
// meaning here; their counterpart is warps per block, a launch argument.
//
// Design. The lane layout's body: one warp per problem (per `chains`
// problems), asset i on lane i % 32, slot i / 32; w, p, mu in registers;
// w broadcast through a per-warp shared vector for each chain and Sigma w
// formed as the lane layout forms it (`lanes_quad`): Sigma's row in the
// lane's registers where N <= 32 and the chains' rows take at most 64
// floats (`ladder_rows`: one chain or two), else Sigma's columns in the
// warp's slice of shared memory (four chains, every rung past 32 assets).
// One slot's rows are compiled 24 and 32 floats wide (N <= 24, N <= 32;
// the lane layout rounds N up to 8). `proj`'s sweep is the lane layout's,
// as the wrapper routes it at the ladder's batch (`inlane`): the count by
// one ballot, the sum by the butterfly (`bfly_sweep`, the chains'
// butterflies interleaved) or, up to 32 assets, in every lane (each
// chain's active values staged in its second vector, one __syncwarp for
// all chains, `staged_sum`).
//
// Bound. N^2 multiply-adds per problem and iteration for Sigma w, 4N for
// the sweep; Sigma (N * N floats per problem) is read once. Bound by FP32
// and shared-memory latency (issue slots at a large batch), not by HBM;
// `carry` shows what the loop costs with neither.

#include "pdhg_mean_variance_lanes.cuh"

namespace {

enum Variant { kCarry = 0, kSigma = 1, kProj = 2, kProjInLane = 3 };
constexpr int kLadderMaxWarps = 8;

// A chain's vector: one slot's row 24 or 32 floats wide, else K * 32.
__host__ __device__ constexpr int ladder_vec(int K, int N) {
  return K == 1 ? (N <= 24 ? 24 : 32) : K * 32;
}

// Whether a warp of `chains` problems keeps Sigma's rows in registers.
__host__ __device__ constexpr bool ladder_rows(int K, int NC, int chains) {
  return K == 1 && chains * NC <= 64;
}

// Shared memory of a block: each chain's two vectors (w, and the in-lane
// sweep's staged values), and its Sigma's N columns of K*32 floats where
// the rows are not in registers.
inline size_t ladder_smem(int N, int chains, int warps) {
  const int K = (N + 31) / 32;
  const int V = ladder_vec(K, N);
  const size_t sig = ladder_rows(K, V, chains) ? 0 : (size_t)N * K * 32;
  return (size_t)warps * chains * (2 * V + sig) * sizeof(float);
}

struct LadderArgs {
  const float* cw;     // [B, N] current weights
  const float* mu;     // [B, N] forecast log-returns (H = 1)
  const float* sigma;  // [B, N, N]
  float* w_out;        // [B, N] the loop's last w
  int B, N, iters;
  float gamma, c, sigma_scale;
};

template <int K, int NC, int VARIANT, int UNROLL, int CHAINS>
__global__ void __launch_bounds__(kLadderMaxWarps * 32)
mv_ladder_kernel(LadderArgs a) {
  extern __shared__ __align__(16) float lsm[];
  constexpr int KP = K * 32;
  constexpr int V = NC;
  constexpr bool ROWS = ladder_rows(K, NC, CHAINS);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int first = (blockIdx.x * warps + warp) * CHAINS;
  if (first >= a.B) return;  // whole warps leave; no block barriers
  const int N = a.N;
  // [CHAINS][2][V]: each chain's w vector and projection-input vector.
  float* const vecs = lsm + (size_t)warp * CHAINS * 2 * V;
  float* const cols = lsm + (size_t)warps * CHAINS * 2 * V
                      + (size_t)warp * CHAINS * N * KP;

  // A chain past the end of the batch repeats the last problem and is not
  // written out, so every chain of a warp runs the same instructions.
  bool valid[K];
  float cw[CHAINS][K], mu[CHAINS][K], w[CHAINS][K], p[CHAINS][K];
  float th[CHAINS], tau[CHAINS], sg[CHAINS];
  float srow[CHAINS][ROWS ? NC : 1];
  const float* Sg[CHAINS];
#pragma unroll
  for (int k = 0; k < K; ++k) valid[k] = k * 32 + lane < N;
  const float two_gamma = 2.f * a.gamma;
#pragma unroll
  for (int ch = 0; ch < CHAINS; ++ch) {
    const int b = min(first + ch, a.B - 1);
    const float* src = a.sigma + (size_t)b * N * N;
    float fro2[1] = {0.f};
    Sg[ch] = nullptr;
    if constexpr (VARIANT == kCarry) {
      // The steps alone: Sigma's Frobenius norm from global memory.
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          const float x = i < N ? src[(size_t)i * N + j] : 0.f;
          fro2[0] += x * x;
        }
      }
    } else if constexpr (ROWS) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        srow[ch][j] = (lane < N && j < N) ? src[(size_t)lane * N + j] : 0.f;
        fro2[0] += srow[ch][j] * srow[ch][j];
      }
    } else {
      float* mine = cols + (size_t)ch * N * KP;
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = k * 32 + lane;
          const float x = i < N ? src[(size_t)i * N + j] : 0.f;
          mine[(size_t)j * KP + i] = x;
          fro2[0] += x * x;
        }
      }
      Sg[ch] = mine;
    }
    warp_sum<1>(fro2, 1);
    const float L = jmax(two_gamma * sqrtf(fro2[0]), 1e-6f);
    sg[ch] = a.sigma_scale * sqrtf(L + 1.f) / 2.f;
    tau[ch] = 1.f / (0.5f * L + sg[ch] * 4.f);
    th[ch] = 0.f;
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
        // Sigma w of every chain through its broadcast vector; the first
        // barrier orders a lane's last read of a vector before another
        // lane's next store.
        __syncwarp();
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch)
          lanes_stage<K, V>(w[ch], vecs + (size_t)ch * 2 * V, lane);
        __syncwarp();
        float vm[CHAINS][K];
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
          float quad[K];
          lanes_quad<K, NC, ROWS>(vecs + (size_t)ch * 2 * V, srow[ch],
                                  Sg[ch], N, lane, quad);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float g = two_gamma * quad[k] - mu[ch][k];
            const float v = w[ch][k] - tau[ch] * (g + p[ch][k]);
            vm[ch][k] = valid[k] ? v : kNeg;
          }
        }
        if constexpr (VARIANT == kProj) bfly_sweep<CHAINS, K>(vm, th);
        if constexpr (VARIANT == kProjInLane) {
          // Each chain's active values staged, then summed in every lane;
          // the next iteration's first barrier orders these reads before
          // the next stores.
          float x[CHAINS][K];
          int cnt[CHAINS];
#pragma unroll
          for (int ch = 0; ch < CHAINS; ++ch) {
            cnt[ch] = 0;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const bool act = vm[ch][k] > th[ch];
              cnt[ch] += __popc(__ballot_sync(kFull, act));
              x[ch][k] = act ? vm[ch][k] : 0.f;
            }
            lanes_stage<K, V>(x[ch], vecs + (size_t)ch * 2 * V + V, lane);
          }
          __syncwarp();
#pragma unroll
          for (int ch = 0; ch < CHAINS; ++ch) {
            const float4* b4 = reinterpret_cast<const float4*>(
                vecs + (size_t)ch * 2 * V + V);
            float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int q = 0; q < V / 4; ++q) {
              const float4 y = b4[q];
              s4[0] += y.x;
              s4[1] += y.y;
              s4[2] += y.z;
              s4[3] += y.w;
            }
            const float sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
            th[ch] = (sum - 1.f) / jmax((float)cnt[ch], 1.f);
          }
        }
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float wn = VARIANT >= kProj ? jmax(vm[ch][k] - th[ch], 0.f)
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

template <int K, int NC, int VARIANT, int UNROLL, int CHAINS>
cudaError_t launch(const LadderArgs& a, int warps, cudaStream_t stream) {
  const size_t smem = ladder_smem(a.N, CHAINS, warps);
  if (smem > (size_t)kSmemPerBlock) return cudaErrorInvalidValue;
  auto kernel = mv_ladder_kernel<K, NC, VARIANT, UNROLL, CHAINS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int per_block = warps * CHAINS;
  const int blocks = (a.B + per_block - 1) / per_block;
  kernel<<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K, int NC, int VARIANT>
cudaError_t pick(const LadderArgs& a, int unroll, int chains, int warps,
                 cudaStream_t s) {
#define KMPC_RUNG(U_, C_)             \
  if (unroll == U_ && chains == C_) \
    return launch<K, NC, VARIANT, U_, C_>(a, warps, s);
  KMPC_RUNG(1, 1) KMPC_RUNG(1, 2) KMPC_RUNG(1, 4)
  KMPC_RUNG(4, 1) KMPC_RUNG(4, 2) KMPC_RUNG(4, 4)
#undef KMPC_RUNG
  return cudaErrorInvalidValue;
}

}  // namespace

// variant 0 carry, 1 sigma, 2 proj (`inlane` 1: its sweep summed in every
// lane, up to 32 assets; 0: by the butterfly); unroll 1 or 4; chains 1, 2
// or 4; warps per block 1..8; N <= 128. Anything else, or more shared
// memory than a block has, returns cudaErrorInvalidValue (the wrapper
// checks first).
extern "C" int kmpc_mv_ladder(
    const void* cw, const void* mu, const void* sigma, void* w_out, int B,
    int N, int iters, int variant, int inlane, int unroll, int chains,
    int warps, float gamma, float c, float sigma_scale, void* stream) {
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
  if (B <= 0 || N <= 0 || iters < 0 || warps < 1 ||
      warps > kLadderMaxWarps || variant < kCarry || variant > kProj ||
      (inlane && N > 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = (N + 31) / 32;
  const int nc = ladder_vec(K, N);

  // The carry rung reads no Sigma: one instantiation a K; the in-lane
  // sweep one slot only.
#define KMPC_CASE(K_, NC_, PROJ_IN_LANE_)                                   \
  if (K == K_ && nc == NC_) {                                               \
    if (variant == kCarry)                                                  \
      return (int)pick<K_, K_ * 32, kCarry>(a, unroll, chains, warps, s);   \
    if (variant == kSigma)                                                  \
      return (int)pick<K_, NC_, kSigma>(a, unroll, chains, warps, s);       \
    if (inlane)                                                             \
      return (int)pick<K_, NC_, PROJ_IN_LANE_>(a, unroll, chains, warps, s);\
    return (int)pick<K_, NC_, kProj>(a, unroll, chains, warps, s);          \
  }
  KMPC_CASE(1, 24, kProjInLane) KMPC_CASE(1, 32, kProjInLane)
  KMPC_CASE(2, 64, kProj) KMPC_CASE(3, 96, kProj) KMPC_CASE(4, 128, kProj)
#undef KMPC_CASE
  return (int)cudaErrorInvalidValue;
}

// The ladder's plan, for the wrapper's copy to be checked against: the
// bytes of shared memory a block of `warps` warps of `chains` chains takes
// at N assets, and whether Sigma's rows lie in registers (1) or its
// columns in shared memory (0).
extern "C" long long kmpc_mv_ladder_smem_bytes(int N, int chains,
                                               int warps) {
  return (long long)ladder_smem(N, chains, warps);
}

extern "C" int kmpc_mv_ladder_rows(int N, int chains) {
  const int K = (N + 31) / 32;
  return ladder_rows(K, ladder_vec(K, N), chains) ? 1 : 0;
}
