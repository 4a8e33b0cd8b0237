// K-D and K-E: backward of the fused sampled GEMM (K-B,
// sampled_matmul.cu) with its lane axis, the sampled weight regenerated,
// never stored. For lanes s < S, W_s = mu + sigma * eps(seed, s, n, k):
//
//   K-D: dx[s] = g[s] @ W_s                       (S, M, K)
//   K-E: dmu = sum_s g[s]^T @ x[s];  dsigma = sum_s (g[s]^T @ x[s]) * eps_s
//
// Replace the Pallas kernels _dx_kernel and _dw_kernel (_dx_unbatched,
// _dw_unbatched: the VJP of sampled_matmul_pallas, S = 1) and
// _dx_kernel_s and _dw_kernel_s (_dx_s, _dw_s: the S-batched VJP that the
// vmap emission dispatches) of bayesian_torch_tpu/ops/pallas/
// sampled_matmul.py. JAX's _dw_s writes per-lane (S, N, K) outputs, which
// vmap's transpose then sums over the lanes, because mu and sigma are
// shared by them; K-E returns those sums directly. eps of lane s, weight
// (n, k) is the hash at counter n*K + k under btt_draw_salt(seed, s,
// N*K), as K-B drew it: it depends on (seed, s, n, k) only, never on the
// tiling. Lane 0 of each is the single-draw kernel, bit for bit.
//
// What bounds them on an H100: at the ResNet-50 head (M=128, K=2048,
// N=1000) each lane draws one hash normal per weight element (2.05 M, the
// bound) and multiplies 0.5 GFLOP (the TPU kernels ran at
// Precision.HIGHEST); mu, sigma, dmu and dsigma are 8 MB each.
//
// Design. K-D is the body of sampled_gemm.cuh (K-B's): split-TF32 products
// on the tensor cores, producer warps that draw W's tiles while consumer
// warps multiply, and the reduction over N split over a thread-block
// cluster and summed in rank order; W never reaches device memory and each
// weight element is drawn once per lane when M <= 128. K-E is a
// shared-memory tiled GEMM, f32 FMA with f32 accumulation, 256 threads each
// owning a 4x4 patch of the output tile, ragged edges masked. It walks the
// lanes in order inside the block: it accumulates g[s]^T x[s] over M in
// registers, then draws that lane's eps once per output element and adds
// the lane's dmu and dmu * eps to register sums. The lane sum is
// deterministic, needs no atomics, and no (S, N, K) array reaches device
// memory. x may be shared by the lanes (a lane stride of 0). K-E has 512
// blocks at the head whatever S is, and each walks the lanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sampled_gemm.cuh"

namespace {

constexpr int kThreads = 256;

// K-D: the body of sampled_gemm.cuh with W's (n, k) tile read as the
// reduction's (n) by the output's (k); the reduction over N is split over a
// cluster of up to eight blocks (four at the head: 256 blocks a lane).
__global__ void __launch_bounds__(btt_sg::kThreads, 2)
    sampled_matmul_dx_kernel(const float* __restrict__ g, int64_t g_lane,
                             const float* __restrict__ mu,
                             const float* __restrict__ sigma,
                             float* __restrict__ dx, int M, int N, int K,
                             int chunk, int m_tiles, uint32_t seed_lo,
                             uint32_t seed_hi, int vec_a) {
  btt_sg::sampled_gemm<true>(g, g_lane, mu, sigma, dx, M, N, K, chunk,
                             m_tiles, seed_lo, seed_hi, vec_a);
}

// K-E. Output tile 64 (n) x 64 (k); reduction over m in steps of 16,
// then over the lanes.
constexpr int kDwBN = 64;
constexpr int kDwBK = 64;
constexpr int kDwBM = 16;

__global__ void __launch_bounds__(kThreads)
    sampled_matmul_dw_kernel(const float* __restrict__ g,
                             const float* __restrict__ x, int64_t x_lane,
                             float* __restrict__ dmu,
                             float* __restrict__ dsigma, int S, int M, int N,
                             int K, uint32_t seed_lo, uint32_t seed_hi) {
  __shared__ float gs[kDwBM][kDwBN + 4];  // g tile (m, n)
  __shared__ float xs[kDwBM][kDwBK + 4];  // x tile (m, k)
  const int tid = threadIdx.x;
  const int tx = tid % (kDwBK / 4);
  const int ty = tid / (kDwBK / 4);
  const int n0 = blockIdx.y * kDwBN;
  const int k0 = blockIdx.x * kDwBK;

  float mu_sum[4][4] = {}, sig_sum[4][4] = {};
  for (int s = 0; s < S; ++s) {
    const float* gl = g + (int64_t)s * M * N;
    const float* xl = x + (int64_t)s * x_lane;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int m0 = 0; m0 < M; m0 += kDwBM) {
      for (int e = tid; e < kDwBM * kDwBN; e += kThreads) {
        const int r = e / kDwBN, c = e % kDwBN;
        const int gm = m0 + r, gn = n0 + c;
        gs[r][c] = (gm < M && gn < N) ? gl[(int64_t)gm * N + gn] : 0.f;
      }
      for (int e = tid; e < kDwBM * kDwBK; e += kThreads) {
        const int r = e / kDwBK, c = e % kDwBK;
        const int gm = m0 + r, gk = k0 + c;
        xs[r][c] = (gm < M && gk < K) ? xl[(int64_t)gm * K + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int mm = 0; mm < kDwBM; ++mm) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = gs[mm][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[mm][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // this lane's dmu and dmu * eps join the sums in lane order; lane 0
    // is stored as it is, so S = 1 is the single-draw kernel bit for bit
    const uint32_t salt = btt_draw_salt(seed_lo, seed_hi, (uint32_t)s,
                                            (uint32_t)N * (uint32_t)K);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t idx = (int64_t)(n0 + ty * 4 + i) * K + k0 + tx * 4 + j;
        const float d = __fmul_rn(acc[i][j],
                                  btt_hash_normal(salt, (uint32_t)idx));
        mu_sum[i][j] = s == 0 ? acc[i][j] : __fadd_rn(mu_sum[i][j], acc[i][j]);
        sig_sum[i][j] = s == 0 ? d : __fadd_rn(sig_sum[i][j], d);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gn = n0 + ty * 4 + i;
    if (gn >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + tx * 4 + j;
      if (gk >= K) continue;
      const int64_t idx = (int64_t)gn * K + gk;
      dmu[idx] = mu_sum[i][j];
      dsigma[idx] = sig_sum[i][j];
    }
  }
}

}  // namespace

extern "C" {

// g (S, M, N), mu and sigma (N, K), dx (S, M, K); all float32, row-major.
// Returns the launch's cudaError_t.
int btt_sampled_matmul_dx(const float* g, const float* mu,
                          const float* sigma, float* dx, int S, int M, int N,
                          int K, uint64_t seed, cudaStream_t stream) {
  return btt_sg::launch(sampled_matmul_dx_kernel, true, g, (int64_t)M * N,
                        mu, sigma, dx, S, M, N, K, seed, stream);
}

// g (S, M, N), x (S, M, K) with lane stride x_lane (M*K, or 0 for one x
// shared by the lanes), dmu and dsigma (N, K): sums over the lanes; all
// float32, row-major. Returns the launch's cudaGetLastError().
int btt_sampled_matmul_dw(const float* g, const float* x, int64_t x_lane,
                          float* dmu, float* dsigma, int S, int M, int N,
                          int K, uint64_t seed, cudaStream_t stream) {
  if (S <= 0 || N <= 0 || K <= 0) return (int)cudaSuccess;
  const dim3 grid((K + kDwBK - 1) / kDwBK, (N + kDwBN - 1) / kDwBN);
  sampled_matmul_dw_kernel<<<grid, kThreads, 0, stream>>>(
      g, x, x_lane, dmu, dsigma, S, M, N, K, (uint32_t)(seed & 0xFFFFFFFFull),
      (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

}  // extern "C"
