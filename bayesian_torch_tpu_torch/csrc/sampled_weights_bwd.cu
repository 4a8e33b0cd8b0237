// K-C: backward of the weight samplers, eps regenerated from the seed.
//
//   dsigma mode: out[i] = sum_s g[s, i] * eps(seed, s, i)
//   rho mode:    out[i] = (sum_s g[s, i] * eps(seed, s, i)) * sigmoid(rho[i])
//
// Replaces two Pallas kernels of
// bayesian_torch_tpu/ops/pallas/sampled_weights.py: _batch_dsigma_kernel
// (the VJP of sample_scaled_normals_batch, S draws) and _drho_kernel (the
// VJP of the single-draw sample_gaussian_pallas, which multiplies by
// sigmoid(rho)). Neither saves eps: the forward (K-A, sampled_weights.cu)
// drew it from the counter hash, so the backward draws it again.
//
// What bounds it on an H100: the hash. Every element of every draw costs
// two splitmix hashes, a log, a sqrt and a cos (as in K-A), while the
// bytes are few: g is read once (bf16 or f32), rho once in rho mode, and
// out written once in f32.
//
// Design: K-A's, read backwards. The TPU kernel accumulated over a
// sequential S grid axis into a resident output tile; blocks here run in
// no order, so the S loop moves inside the thread. Each thread owns four
// consecutive elements, keeps their sums in registers across the draws and
// stores them once (16-byte stores; 16-byte f32 or 8-byte bf16 loads of
// g). Sums run in f32 in draw order, with no FMA contraction, as the plain
// torch version sums. No shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ void load4(const float* p, float v[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float v[kVec]) {
  const uint2 packed = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&packed.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&packed.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sigmoid(float r) {
  // as torch.sigmoid: 1 / (1 + exp(-r)), IEEE division
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-r)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    noise_grad_kernel(const T* __restrict__ g, const float* __restrict__ rho,
                      float* __restrict__ out, int64_t n, int num_samples,
                      uint32_t seed_lo, uint32_t seed_hi, bool vector_ok) {
  const int64_t stride = (int64_t)gridDim.x * kThreads * kVec;
  for (int64_t base = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kVec;
       base < n; base += stride) {
    const bool full = vector_ok && base + kVec <= n;
    float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < num_samples; ++s) {
      const uint32_t salt = btt_draw_salt(seed_lo, seed_hi, (uint32_t)s,
                                          (uint32_t)n);
      const T* row = g + (int64_t)s * n;
      float gv[kVec];
      if (full) {
        load4(row + base, gv);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          gv[j] = base + j < n ? load1(row + base + j) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(gv[j], btt_hash_normal(
                                                        salt,
                                                        (uint32_t)(base + j))));
    }
    if (rho != nullptr) {
      float r[kVec];
      if (full) {
        load4(rho + base, r);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) r[j] = base + j < n ? rho[base + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = __fmul_rn(acc[j], sigmoid(r[j]));
    }
    if (full) {
      *reinterpret_cast<float4*>(out + base) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (base + j < n) out[base + j] = acc[j];
    }
  }
}

}  // namespace

extern "C" {

// g: (num_samples, n), float32 when g_bf16 == 0, bfloat16 otherwise.
// rho: (n,) float32 for rho mode, or NULL for dsigma mode. out: (n,)
// float32. eps of draw s at element i is the hash at counter i under
// btt_draw_salt(seed, s, n), as K-A drew it. Returns cudaGetLastError().
int btt_sampled_weights_bwd(const void* g, int g_bf16, const float* rho,
                            float* out, int64_t n, int num_samples,
                            uint64_t seed, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const uintptr_t g_align = g_bf16 ? 8 : 16;
  const bool vector_ok =
      n % kVec == 0 && reinterpret_cast<uintptr_t>(g) % g_align == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
      (rho == nullptr || reinterpret_cast<uintptr_t>(rho) % 16 == 0);
  const int64_t per_block = (int64_t)kThreads * kVec;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the rest by grid stride
  const uint32_t lo = (uint32_t)(seed & 0xFFFFFFFFull);
  const uint32_t hi = (uint32_t)(seed >> 32);
  if (g_bf16) {
    noise_grad_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0,
                                       stream>>>(
        static_cast<const __nv_bfloat16*>(g), rho, out, n, num_samples, lo,
        hi, vector_ok);
  } else {
    noise_grad_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(g), rho, out, n, num_samples, lo, hi,
        vector_ok);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
