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
// all lanes (a lane stride of 0), as the JAX vmap rule broadcasts it. A
// launch may be a counter window of a larger one (sampled_gemm.cuh): a
// rank's lanes or a shard's rows of the one-process launch.
//
// What bounds it on an H100, and the design: sampled_gemm.cuh. At the
// ResNet-50 head (M=128, K=2048, N=1000) each lane draws 2.05 M normals
// (the bound) and multiplies 0.5 GFLOP in split TF32 on the tensor cores
// (the TPU kernel ran at Precision.HIGHEST); K is split over a cluster of
// eight blocks, 256 blocks a lane.

#include "sampled_gemm.cuh"

namespace {

__global__ void __launch_bounds__(btt_sg::kThreads, 2)
    sampled_matmul_kernel(const float* __restrict__ x, int64_t x_lane,
                          const float* __restrict__ mu,
                          const float* __restrict__ sigma,
                          float* __restrict__ out, int M, int N, int K,
                          int chunk, int m_tiles, uint32_t salt0,
                          uint32_t salt_step, uint32_t ctr0, int vec_a) {
  btt_sg::sampled_gemm<false>(x, x_lane, mu, sigma, out, M, N, K, chunk,
                              m_tiles, salt0, salt_step, ctr0, vec_a);
}

}  // namespace

extern "C" {

// x (S, M, K) with lane stride x_lane (M*K, or 0 for one x shared by the
// lanes), mu and sigma (N, K), out (S, M, N); all float32, row-major.
// eps of lane s, weight (n, k) is the hash at counter offset + n*K + k
// under btt_draw_salt(seed, lane0 + s, lane_stride); (lane0, lane_stride,
// offset) = (0, N*K, 0) is the whole launch. Returns the launch's
// cudaError_t.
int btt_sampled_matmul(const float* x, int64_t x_lane, const float* mu,
                       const float* sigma, float* out, int S, int M, int N,
                       int K, uint64_t seed, int64_t lane0,
                       int64_t lane_stride, int64_t offset,
                       cudaStream_t stream) {
  return btt_sg::launch(sampled_matmul_kernel, false, x, x_lane, mu, sigma,
                        out, S, M, N, K,
                        btt_ew::salts(seed, lane0, lane_stride, offset),
                        stream);
}

}  // extern "C"
