// K-B: fused sampled GEMM with a lane axis,
//   out[s] = x[s] @ (mu + sigma * eps(seed, s, n, k))^T  for s < S.
//
// Replaces the Pallas kernels _fwd_kernel (sampled_matmul_pallas, S = 1)
// and _fwd_kernel_s (_forward_s, the S-batched kernel that the vmap
// emission dispatches) of bayesian_torch_tpu/ops/pallas/sampled_matmul.py,
// which draw the weight tile inside the K loop so the sampled weight never
// reaches device memory. Lane s draws eps under the salt of lane s of the
// seed (btt_draw_salt: the window [s*N*K, (s+1)*N*K) of one counter
// stream); lane 0 is the single-draw kernel, bit for bit. x may be shared by
// all lanes (a lane stride of 0), as the JAX vmap rule broadcasts it.
//
// What bounds it on an H100: at the ResNet-50 head (M=128, K=2048,
// N=1000) each lane is 0.5 GFLOP in f32 on CUDA cores plus a log, a sqrt
// and a cos per weight element; mu and sigma (16 MB) are read by every
// lane, mostly from L2. At S = 10 (MC-10 inference) that is 5.2 GFLOP,
// 0.078 ms at 67 TFLOP/s; at S = 4 (MC-4 training) 2.1 GFLOP, 0.031 ms.
// One lane has 32 blocks at that shape, too few to fill the card: it is
// latency-bound. The lane axis multiplies the blocks (320 at S = 10), so
// one launch keeps every SM busy where S launches ran one after another.
//
// Design: a shared-memory tiled GEMM with f32 FMA and f32 accumulation
// (the TPU kernel ran at Precision.HIGHEST). Each block owns a 128 x 32
// output tile of one lane (blockIdx.z); for each 16-deep K step it stages
// x in shared memory and builds its (32, 16) weight tile there from mu,
// sigma and the hash, so W exists only in shared memory. With BM = 128
// the head has one M tile and every weight element of a lane is generated
// once. eps depends on (seed, s, n, k) only, never on the tiling. Ragged
// edges are masked. No wgmma or TMA yet: a simple kernel that is right
// comes first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 32;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 8 column groups x 32 row groups, 4x4 each

__global__ void __launch_bounds__(kThreads)
    sampled_matmul_kernel(const float* __restrict__ x, int64_t x_lane,
                          const float* __restrict__ mu,
                          const float* __restrict__ sigma,
                          float* __restrict__ out, int M, int N, int K,
                          uint32_t seed_lo, uint32_t seed_hi) {
  __shared__ float xs[kBK][kBM + 4];  // x tile, k-major
  __shared__ float ws[kBK][kBN + 4];  // sampled weight tile, k-major
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / 4);
  const int ty = tid / (kBN / 4);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const uint32_t salt = btt_draw_salt(seed_lo, seed_hi, blockIdx.z,
                                      (uint32_t)N * (uint32_t)K);
  x += (int64_t)blockIdx.z * x_lane;
  out += (int64_t)blockIdx.z * M * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[(int64_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gn = n0 + r, gk = k0 + c;
      float w = 0.f;
      if (gn < N && gk < K) {
        const int64_t idx = (int64_t)gn * K + gk;
        w = __fadd_rn(mu[idx], __fmul_rn(sigma[idx],
                                         btt_hash_normal(salt, (uint32_t)idx)));
      }
      ws[c][r] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
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
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(int64_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x (S, M, K) with lane stride x_lane (M*K, or 0 for one x shared by the
// lanes), mu and sigma (N, K), out (S, M, N); all float32, row-major.
// eps of lane s, weight (n, k) is the hash at counter n*K + k under
// btt_draw_salt(seed, s, N*K). Returns the launch's cudaGetLastError().
int btt_sampled_matmul(const float* x, int64_t x_lane, const float* mu,
                       const float* sigma, float* out, int S, int M, int N,
                       int K, uint64_t seed, cudaStream_t stream) {
  if (S <= 0 || M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, S);
  sampled_matmul_kernel<<<grid, kThreads, 0, stream>>>(
      x, x_lane, mu, sigma, out, M, N, K, (uint32_t)(seed & 0xFFFFFFFFull),
      (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

}  // extern "C"
