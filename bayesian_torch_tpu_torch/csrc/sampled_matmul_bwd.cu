// K-D and K-E: backward of the fused sampled GEMM (K-B,
// sampled_matmul.cu), with the sampled weight regenerated, never stored.
//
//   K-D: dx[M, K] = g[M, N] @ W[N, K],  W = mu + sigma * eps(seed, n, k)
//   K-E: dmu[N, K] = g^T @ x;  dsigma[N, K] = dmu * eps(seed, n, k)
//
// Replace the Pallas kernels _dx_kernel and _dw_kernel of
// bayesian_torch_tpu/ops/pallas/sampled_matmul.py (_dx_unbatched,
// _dw_unbatched), the VJP of sampled_matmul_pallas. eps of weight (n, k) is
// the hash at counter n*K + k under the salt of draw 0 of the seed, as K-B
// drew it: it depends on (seed, n, k) only, never on the tiling.
//
// What bounds them on an H100: at the ResNet-50 head (M=128, K=2048,
// N=1000) each is 0.5 GFLOP in f32 on CUDA cores (the TPU kernels ran at
// Precision.HIGHEST), plus one hash normal per weight element; mu, sigma,
// dmu and dsigma are 8 MB each. Few blocks at that shape, so both are
// latency-bound, like K-B.
//
// Design: K-B's shared-memory tiled GEMM, f32 FMA with f32 accumulation,
// 256 threads each owning a 4x4 patch of the output tile, ragged edges
// masked. K-D builds each (16, 32) weight tile in shared memory from mu,
// sigma and the hash, K-B's indexing read transposed, so W never reaches
// device memory; with BM = 128 the head has one M tile and each weight
// element is generated once. K-E accumulates g^T x over M in registers
// and draws eps only in the epilogue, once per output element, where it
// writes dmu and dsigma side by side. No wgmma or TMA yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sampled_weight(const float* mu,
                                                const float* sigma,
                                                uint32_t salt, int64_t idx) {
  // no contraction: rounds as K-B and the plain mu + sigma * eps
  return __fadd_rn(mu[idx],
                   __fmul_rn(sigma[idx], btt_hash_normal(salt, (uint32_t)idx)));
}

// K-D. Output tile 128 (m) x 32 (k); reduction over n in steps of 16.
constexpr int kDxBM = 128;
constexpr int kDxBK = 32;
constexpr int kDxBN = 16;

__global__ void __launch_bounds__(kThreads)
    sampled_matmul_dx_kernel(const float* __restrict__ g,
                             const float* __restrict__ mu,
                             const float* __restrict__ sigma,
                             float* __restrict__ dx, int M, int N, int K,
                             uint32_t salt) {
  __shared__ float gs[kDxBN][kDxBM + 4];  // g tile, n-major
  __shared__ float ws[kDxBN][kDxBK + 4];  // sampled weight tile (n, k)
  const int tid = threadIdx.x;
  const int tx = tid % (kDxBK / 4);
  const int ty = tid / (kDxBK / 4);
  const int m0 = blockIdx.y * kDxBM;
  const int k0 = blockIdx.x * kDxBK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kDxBN) {
    for (int e = tid; e < kDxBM * kDxBN; e += kThreads) {
      const int r = e / kDxBN, c = e % kDxBN;
      const int gm = m0 + r, gn = n0 + c;
      gs[c][r] = (gm < M && gn < N) ? g[(int64_t)gm * N + gn] : 0.f;
    }
    for (int e = tid; e < kDxBN * kDxBK; e += kThreads) {
      const int r = e / kDxBK, c = e % kDxBK;
      const int gn = n0 + r, gk = k0 + c;
      ws[r][c] = (gn < N && gk < K)
                     ? sampled_weight(mu, sigma, salt, (int64_t)gn * K + gk)
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kDxBN; ++nn) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = gs[nn][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[nn][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + tx * 4 + j;
      if (gk < K) dx[(int64_t)gm * K + gk] = acc[i][j];
    }
  }
}

// K-E. Output tile 64 (n) x 64 (k); reduction over m in steps of 16.
constexpr int kDwBN = 64;
constexpr int kDwBK = 64;
constexpr int kDwBM = 16;

__global__ void __launch_bounds__(kThreads)
    sampled_matmul_dw_kernel(const float* __restrict__ g,
                             const float* __restrict__ x,
                             float* __restrict__ dmu,
                             float* __restrict__ dsigma, int M, int N, int K,
                             uint32_t salt) {
  __shared__ float gs[kDwBM][kDwBN + 4];  // g tile (m, n)
  __shared__ float xs[kDwBM][kDwBK + 4];  // x tile (m, k)
  const int tid = threadIdx.x;
  const int tx = tid % (kDwBK / 4);
  const int ty = tid / (kDwBK / 4);
  const int n0 = blockIdx.y * kDwBN;
  const int k0 = blockIdx.x * kDwBK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += kDwBM) {
    for (int e = tid; e < kDwBM * kDwBN; e += kThreads) {
      const int r = e / kDwBN, c = e % kDwBN;
      const int gm = m0 + r, gn = n0 + c;
      gs[r][c] = (gm < M && gn < N) ? g[(int64_t)gm * N + gn] : 0.f;
    }
    for (int e = tid; e < kDwBM * kDwBK; e += kThreads) {
      const int r = e / kDwBK, c = e % kDwBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? x[(int64_t)gm * K + gk] : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gn = n0 + ty * 4 + i;
    if (gn >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + tx * 4 + j;
      if (gk >= K) continue;
      const int64_t idx = (int64_t)gn * K + gk;
      dmu[idx] = acc[i][j];
      dsigma[idx] = __fmul_rn(acc[i][j], btt_hash_normal(salt, (uint32_t)idx));
    }
  }
}

uint32_t draw0_salt(uint64_t seed) {
  return btt_draw_salt((uint32_t)(seed & 0xFFFFFFFFull),
                       (uint32_t)(seed >> 32), 0u);
}

}  // namespace

extern "C" {

// g (M, N), mu and sigma (N, K), dx (M, K); all float32, row-major.
// Returns the launch's cudaGetLastError().
int btt_sampled_matmul_dx(const float* g, const float* mu,
                          const float* sigma, float* dx, int M, int N, int K,
                          uint64_t seed, cudaStream_t stream) {
  if (M <= 0 || K <= 0) return (int)cudaSuccess;
  const dim3 grid((K + kDxBK - 1) / kDxBK, (M + kDxBM - 1) / kDxBM);
  sampled_matmul_dx_kernel<<<grid, kThreads, 0, stream>>>(
      g, mu, sigma, dx, M, N, K, draw0_salt(seed));
  return (int)cudaGetLastError();
}

// g (M, N), x (M, K), dmu and dsigma (N, K); all float32, row-major.
// Returns the launch's cudaGetLastError().
int btt_sampled_matmul_dw(const float* g, const float* x, float* dmu,
                          float* dsigma, int M, int N, int K, uint64_t seed,
                          cudaStream_t stream) {
  if (N <= 0 || K <= 0) return (int)cudaSuccess;
  const dim3 grid((K + kDwBK - 1) / kDwBK, (N + kDwBN - 1) / kDwBN);
  sampled_matmul_dw_kernel<<<grid, kThreads, 0, stream>>>(
      g, x, dmu, dsigma, M, N, K, draw0_salt(seed));
  return (int)cudaGetLastError();
}

}  // extern "C"
