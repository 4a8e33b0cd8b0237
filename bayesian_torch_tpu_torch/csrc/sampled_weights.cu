// K-A: batch weight sampler, out[s, i] = mu[i] + sigma[i] * eps(seed, s, i).
//
// Replaces the Pallas kernel _batch_sample_kernel of
// bayesian_torch_tpu/ops/pallas/sampled_weights.py
// (sample_scaled_normals_batch), which draws all S weight sets of every
// Bayesian layer in one launch, and, in its rho mode with S = 1, the
// single-draw _sample_kernel (sample_gaussian_pallas), which reads rho and
// takes sigma = softplus(rho) inside the kernel.
//
// What bounds it on an H100: issuing the hash's instructions, then memory.
// At ResNet-50 with 10 draws it reads 25.5 M f32 mu and sigma once (204
// MB) and writes 10 draws in bf16 (510 MB); every element also costs two
// hashes, a log, a sqrt and a cos, about 90 issued instructions.
//
// Design (the launch shape and the loads: elementwise.cuh). The TPU kernel
// kept a (1024, 128) tile resident in VMEM while a sequential grid axis
// streamed the S draws out. Blocks here run in no order, so the S loop
// moves inside the thread: it holds its elements' mu and sigma (or rho) in
// registers, reads them once, before the first normal, and writes every
// draw's values with one vector store each.
// - The draw count is a template argument for S in {1, 4} (the training
//   paths' single draw and vmap MC-4 step; unrolled), a runtime loop
//   otherwise (the S = 10 presample).
// - The normals of a group (a draw's four elements, or a narrow thread's
//   draws) run each Box-Muller step over all of them (btt_hash_normals),
//   so their chains interleave; the bits of eps are btt_hash_normal's.
// - The seed comes by value, its salts derived on the host, or from device
//   memory, each thread adding its part of the salts (btt_ew::seed_salt) to
//   the window's: a launch captured into a CUDA graph keeps its arguments,
//   so a replay reads that batch's seed from a buffer written before it.
// No shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace {

using btt_ew::Pack;


__device__ __forceinline__ float sample(float mu, float sigma, float eps) {
  // no contraction: rounds like the plain torch mu + sigma * eps
  return __fadd_rn(mu, __fmul_rn(sigma, eps));
}

// torch's F.softplus (beta 1, threshold 20) in f32
__device__ __forceinline__ float softplus(float rho) {
  return rho > 20.f ? rho : log1pf(expf(rho));
}

// T: the draws' type; U: mu's and sigma's (f32 or bf16, read as f32).
// kRho: `sigma` holds rho, and sigma = softplus(rho) is taken here. kS > 0:
// S = kS draws, unrolled; kS == 0: num_samples draws in a loop.
template <typename T, typename U, int kS, int kVec, bool kRho>
__global__ void __launch_bounds__(btt_ew::threads<kVec>(),
                                  kVec == 1 ? 1 : btt_ew::kWideBlocks)
    batch_sample_kernel(const U* __restrict__ mu, const U* __restrict__ sigma,
                        T* __restrict__ out, int64_t n, int num_samples,
                        btt_ew::Salts salts, const uint64_t* seed,
                        bool vector_ok) {
  const int64_t i =
      ((int64_t)blockIdx.x * btt_ew::threads<kVec>() + threadIdx.x) * kVec;
  if (i >= n) return;
  // seed: in device memory, the salts given less its part; else NULL
  const uint32_t salt0 =
      salts.salt0 + (seed != nullptr ? btt_ew::seed_salt(*seed) : 0u);
  const uint32_t step = salts.step, ctr0 = salts.ctr0;
  const bool full = vector_ok && i + kVec <= n;
  Pack<U, kVec> mp, sp;
  mp.load(mu, i, n, full);
  sp.load(sigma, i, n, full);
  float m[kVec], sg[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    m[j] = mp.at(j);
    sg[j] = kRho ? softplus(sp.at(j)) : sp.at(j);
  }
  auto put = [&](int s, const float(&eps)[kVec]) {
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = sample(m[j], sg[j], eps[j]);
    btt_ew::store(out + s * n, i, n, full, v);
  };
  if constexpr (kS > 0) {
    btt_ew::for_draws<kS, kVec>(salt0, step, (uint32_t)i + ctr0, put);
  } else {
    for (int s = 0; s < num_samples; ++s)
      btt_ew::for_draws<1, kVec>(
          salt0 + (uint32_t)s * step, step, (uint32_t)i + ctr0,
          [&](int, const float(&eps)[kVec]) { put(s, eps); });
  }
}

template <typename T, typename U, int kVec, bool kRho>
void launch(const U* mu, const U* sigma, T* out, int64_t n, int S,
            btt_ew::Salts salts, const uint64_t* seed, bool vector_ok,
            unsigned blocks, cudaStream_t stream) {
  const dim3 grid(blocks), block(btt_ew::threads<kVec>());
  if (S == 1)
    batch_sample_kernel<T, U, 1, kVec, kRho><<<grid, block, 0, stream>>>(
        mu, sigma, out, n, S, salts, seed, vector_ok);
  else if (S == 4)
    batch_sample_kernel<T, U, 4, kVec, kRho><<<grid, block, 0, stream>>>(
        mu, sigma, out, n, S, salts, seed, vector_ok);
  else
    batch_sample_kernel<T, U, 0, kVec, kRho><<<grid, block, 0, stream>>>(
        mu, sigma, out, n, S, salts, seed, vector_ok);
}

template <typename T, typename U>
void launch(const void* mu_v, const void* sigma_v, void* out_v, int64_t n,
            int S, btt_ew::Salts salts, const uint64_t* seed, bool vector_ok,
            bool rho_mode, btt_ew::Shape shape, cudaStream_t stream) {
  const U* mu = static_cast<const U*>(mu_v);
  const U* sigma = static_cast<const U*>(sigma_v);
  T* out = static_cast<T*>(out_v);
  const unsigned blocks = shape.blocks;
  if (shape.vec == 1) {
    if (rho_mode) launch<T, U, 1, true>(mu, sigma, out, n, S, salts, seed, false, blocks, stream);
    else launch<T, U, 1, false>(mu, sigma, out, n, S, salts, seed, false, blocks, stream);
  } else {
    if (rho_mode) launch<T, U, 4, true>(mu, sigma, out, n, S, salts, seed, vector_ok, blocks, stream);
    else launch<T, U, 4, false>(mu, sigma, out, n, S, salts, seed, vector_ok, blocks, stream);
  }
}

}  // namespace

extern "C" {

// mu and sigma: (n,), float32 when in_bf16 == 0, bfloat16 otherwise (read
// as float32). out: (num_samples, n), float32 when out_bf16 == 0, bfloat16
// otherwise. With rho_mode != 0, `sigma` holds rho and sigma =
// softplus(rho) is taken in the kernel. Lane s, element i is lane lane0 +
// s, element offset + i of a launch over lane_stride elements a lane
// (btt_ew::salts): lane0 = offset = 0 and lane_stride = n is the whole
// launch, others a window of a larger one. The launch shape comes from n and the current device
// (btt_ew::launch_shape). seed_ptr NULL takes `seed`; else the seed is the
// uint64 at seed_ptr, which the kernel reads when it runs. Returns the
// launch's cudaGetLastError(), or the error that kept it from launching.
int btt_sample_scaled_normals_batch(const void* mu, const void* sigma,
                                    int in_bf16, void* out, int64_t n,
                                    int num_samples, uint64_t seed,
                                    const void* seed_ptr, int out_bf16,
                                    int rho_mode, int64_t lane0,
                                    int64_t lane_stride, int64_t offset,
                                    cudaStream_t stream) {
  if (n <= 0 || num_samples <= 0) return (int)cudaSuccess;
  btt_ew::Shape shape;
  const cudaError_t e = btt_ew::launch_shape(n, &shape);
  if (e != cudaSuccess) return (int)e;
  const uintptr_t in_align = in_bf16 ? 8 : 16;
  const bool vector_ok = btt_ew::aligned4(n, mu, in_align) &&
                         btt_ew::aligned4(n, sigma, in_align) &&
                         btt_ew::aligned4(n, out, out_bf16 ? 8 : 16);
  const uint64_t* dev = static_cast<const uint64_t*>(seed_ptr);
  const btt_ew::Salts salts =
      dev != nullptr ? btt_ew::window_salts(lane0, lane_stride, offset)
                     : btt_ew::salts(seed, lane0, lane_stride, offset);
  const bool rho = rho_mode != 0;
  if (out_bf16 && in_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(mu, sigma, out, n, num_samples,
                                         salts, dev, vector_ok, rho, shape,
                                         stream);
  else if (out_bf16)
    launch<__nv_bfloat16, float>(mu, sigma, out, n, num_samples, salts, dev,
                                 vector_ok, rho, shape, stream);
  else if (in_bf16)
    launch<float, __nv_bfloat16>(mu, sigma, out, n, num_samples, salts, dev,
                                 vector_ok, rho, shape, stream);
  else
    launch<float, float>(mu, sigma, out, n, num_samples, salts, dev,
                         vector_ok, rho, shape, stream);
  return (int)cudaGetLastError();
}

const char* btt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
