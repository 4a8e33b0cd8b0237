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
// Design: the TPU kernel kept a (1024, 128) tile resident in VMEM while a
// sequential grid axis streamed the S draws out. Blocks here run in no
// order, so the S loop moves inside the thread: each thread loads four
// consecutive mu and sigma into registers once (16-byte loads) and writes
// its four outputs of every draw with one vector store each, so the
// reads happen once and the writes are coalesced. No shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ float sample(float mu, float sigma, uint32_t salt,
                                        int64_t i) {
  // no contraction: rounds like the plain torch mu + sigma * eps
  return __fadd_rn(mu, __fmul_rn(sigma, btt_hash_normal(salt, (uint32_t)i)));
}

// torch's F.softplus (beta 1, threshold 20) in f32
__device__ __forceinline__ float softplus(float rho) {
  return rho > 20.f ? rho : log1pf(expf(rho));
}

__device__ __forceinline__ void store4(float* out, const float v[kVec]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out,
                                       const float v[kVec]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&a);
  packed.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(out) = packed;
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

// kRho: `sigma` holds rho, and sigma = softplus(rho) is taken here
template <typename T, bool kRho>
__global__ void __launch_bounds__(kThreads)
    batch_sample_kernel(const float* __restrict__ mu,
                        const float* __restrict__ sigma, T* __restrict__ out,
                        int64_t n, int num_samples, uint32_t seed_lo,
                        uint32_t seed_hi, bool vector_ok) {
  const int64_t stride = (int64_t)gridDim.x * kThreads * kVec;
  for (int64_t base = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kVec;
       base < n; base += stride) {
    float m[kVec], sg[kVec];
    const bool full = vector_ok && base + kVec <= n;
    if (full) {
      const float4 a = *reinterpret_cast<const float4*>(mu + base);
      const float4 b = *reinterpret_cast<const float4*>(sigma + base);
      m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
      sg[0] = b.x; sg[1] = b.y; sg[2] = b.z; sg[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool in = base + j < n;
        m[j] = in ? mu[base + j] : 0.f;
        sg[j] = in ? sigma[base + j] : 0.f;
      }
    }
    if (kRho) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) sg[j] = softplus(sg[j]);
    }
    for (int s = 0; s < num_samples; ++s) {
      const uint32_t salt = btt_draw_salt(seed_lo, seed_hi, (uint32_t)s,
                                          (uint32_t)n);
      T* row = out + (int64_t)s * n;
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = sample(m[j], sg[j], salt, base + j);
      if (full) {
        store4(row + base, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (base + j < n) store1(row + base + j, v[j]);
      }
    }
  }
}

}  // namespace

extern "C" {

// out: (num_samples, n), float32 when out_bf16 == 0, bfloat16 otherwise.
// With rho_mode != 0, `sigma` holds rho and sigma = softplus(rho) is taken
// in the kernel. Returns the launch's cudaGetLastError().
int btt_sample_scaled_normals_batch(const float* mu, const float* sigma,
                                    void* out, int64_t n, int num_samples,
                                    uint64_t seed, int out_bf16, int rho_mode,
                                    cudaStream_t stream) {
  if (n <= 0 || num_samples <= 0) return (int)cudaSuccess;
  const bool vector_ok = n % kVec == 0 &&
                         reinterpret_cast<uintptr_t>(mu) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(sigma) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t per_block = (int64_t)kThreads * kVec;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the rest by grid stride
  const uint32_t lo = (uint32_t)(seed & 0xFFFFFFFFull);
  const uint32_t hi = (uint32_t)(seed >> 32);
  const dim3 grid((unsigned)blocks);
  if (out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (rho_mode)
      batch_sample_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, stream>>>(
          mu, sigma, o, n, num_samples, lo, hi, vector_ok);
    else
      batch_sample_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, stream>>>(
          mu, sigma, o, n, num_samples, lo, hi, vector_ok);
  } else {
    float* o = static_cast<float*>(out);
    if (rho_mode)
      batch_sample_kernel<float, true><<<grid, kThreads, 0, stream>>>(
          mu, sigma, o, n, num_samples, lo, hi, vector_ok);
    else
      batch_sample_kernel<float, false><<<grid, kThreads, 0, stream>>>(
          mu, sigma, o, n, num_samples, lo, hi, vector_ok);
  }
  return (int)cudaGetLastError();
}

const char* btt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
