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
// What bounds it on an H100: with S = 4 draws the hash (two splitmix
// hashes, a log, a sqrt and a cos per element and draw, about 90 issued
// instructions); with one draw and f32 g the bytes (g and rho read, out
// written, 12 bytes an element) and the hash nearly alike. On the training
// paths it runs once per layer: 54 launches of 1,000 to 2.36 M elements,
// 22 of them too small to fill the card, where its latency decides.
//
// Design (the launch shape and the loads: elementwise.cuh). The TPU
// kernel accumulated over a sequential S grid axis into a resident output
// tile; blocks here run in no order, so the S loop moves inside the thread,
// which owns its elements' sums in registers and stores them once.
// - The draw count is a template argument for S in {1, 4} (the training
//   paths' counts; the S loop unrolled), and every draw's g (and rho) of a
//   thread's elements is loaded before its first normal: no load waits in
//   front of a hash. Other counts loop at run time, loading draw s's g and
//   then hashing it, as K-A's loop does.
// - The normals of a group (a draw's four elements, or a narrow thread's
//   draws) run each Box-Muller step over all of them (btt_hash_normals),
//   so their chains interleave; the bits of eps are btt_hash_normal's.
// Sums run in f32 in draw order with no FMA contraction, as the plain
// torch version sums; no atomics, no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace {

using btt_ew::Pack;

__device__ __forceinline__ float sigmoid(float r) {
  // as torch.sigmoid: 1 / (1 + exp(-r)), IEEE division
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-r)));
}

// T: g's type; U: rho's (f32 or bf16, read as f32). kS > 0: S = kS draws,
// unrolled; kS == 0: num_samples draws in a loop.
template <typename T, typename U, int kS, int kVec, bool kRho>
__global__ void __launch_bounds__(btt_ew::threads<kVec>(),
                                  kVec == 1 ? 1 : btt_ew::kWideBlocks)
    noise_grad_kernel(const T* __restrict__ g, const U* __restrict__ rho,
                      float* __restrict__ out, int64_t n, int num_samples,
                      uint32_t salt0, uint32_t step, bool vector_ok) {
  constexpr int kRows = kS > 0 ? kS : 1;  // rows of g loaded at a time
  const int64_t i =
      ((int64_t)blockIdx.x * btt_ew::threads<kVec>() + threadIdx.x) * kVec;
  if (i >= n) return;
  const bool full = vector_ok && i + kVec <= n;
  Pack<T, kVec> gv[kRows];
#pragma unroll
  for (int s = 0; s < kRows; ++s) gv[s].load(g + s * n, i, n, full);
  Pack<U, kVec> r;
  if (kRho) r.load(rho, i, n, full);

  float acc[kVec];
  if constexpr (kS > 0) {
    btt_ew::for_draws<kS, kVec>(
        salt0, step, (uint32_t)i, [&](int s, const float(&eps)[kVec]) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float d = __fmul_rn(gv[s].at(j), eps[j]);
            acc[j] = s == 0 ? d : __fadd_rn(acc[j], d);
          }
        });
  } else {
    for (int s = 0; s < num_samples; ++s) {
      if (s > 0) gv[0].load(g + s * n, i, n, full);
      btt_ew::for_draws<1, kVec>(
          salt0 + (uint32_t)s * step, step, (uint32_t)i,
          [&](int, const float(&eps)[kVec]) {
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              const float d = __fmul_rn(gv[0].at(j), eps[j]);
              acc[j] = s == 0 ? d : __fadd_rn(acc[j], d);
            }
          });
    }
  }
  if (kRho) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = __fmul_rn(acc[j], sigmoid(r.at(j)));
  }
  btt_ew::store(out, i, n, full, acc);
}

template <typename T, typename U, int kVec, bool kRho>
void launch(const T* g, const U* rho, float* out, int64_t n, int S,
            btt_ew::Salts salts, bool vector_ok, unsigned blocks,
            cudaStream_t stream) {
  const dim3 grid(blocks), block(btt_ew::threads<kVec>());
  if (S == 1)
    noise_grad_kernel<T, U, 1, kVec, kRho><<<grid, block, 0, stream>>>(
        g, rho, out, n, S, salts.salt0, salts.step, vector_ok);
  else if (S == 4)
    noise_grad_kernel<T, U, 4, kVec, kRho><<<grid, block, 0, stream>>>(
        g, rho, out, n, S, salts.salt0, salts.step, vector_ok);
  else
    noise_grad_kernel<T, U, 0, kVec, kRho><<<grid, block, 0, stream>>>(
        g, rho, out, n, S, salts.salt0, salts.step, vector_ok);
}

template <typename T, typename U, bool kRho>
void launch(const T* g, const void* rho, float* out, int64_t n, int S,
            btt_ew::Salts salts, bool vector_ok, btt_ew::Shape shape,
            cudaStream_t stream) {
  const U* r = static_cast<const U*>(rho);
  if (shape.vec == 1)
    launch<T, U, 1, kRho>(g, r, out, n, S, salts, false, shape.blocks,
                          stream);
  else
    launch<T, U, 4, kRho>(g, r, out, n, S, salts, vector_ok, shape.blocks,
                          stream);
}

template <typename T>
void launch(const void* g_v, const void* rho, int rho_bf16, float* out,
            int64_t n, int S, btt_ew::Salts salts, bool vector_ok,
            btt_ew::Shape shape, cudaStream_t stream) {
  const T* g = static_cast<const T*>(g_v);
  if (rho == nullptr)
    launch<T, float, false>(g, rho, out, n, S, salts, vector_ok, shape,
                            stream);
  else if (rho_bf16)
    launch<T, __nv_bfloat16, true>(g, rho, out, n, S, salts, vector_ok,
                                   shape, stream);
  else
    launch<T, float, true>(g, rho, out, n, S, salts, vector_ok, shape,
                           stream);
}

}  // namespace

extern "C" {

// g: (num_samples, n), float32 when g_bf16 == 0, bfloat16 otherwise.
// rho: (n,) for rho mode, float32 when rho_bf16 == 0, bfloat16 otherwise
// (read as float32), or NULL for dsigma mode. out: (n,) float32. eps of
// draw s at element i is the hash at counter i under btt_draw_salt(seed,
// s, n), as K-A drew it. The launch shape comes from n and the current
// device (btt_ew::launch_shape). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for num_samples < 1, or the error that kept the
// kernel from launching.
int btt_sampled_weights_bwd(const void* g, int g_bf16, const void* rho,
                            int rho_bf16, float* out, int64_t n,
                            int num_samples, uint64_t seed,
                            cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (num_samples < 1) return (int)cudaErrorInvalidValue;
  btt_ew::Shape shape;
  const cudaError_t e = btt_ew::launch_shape(n, &shape);
  if (e != cudaSuccess) return (int)e;
  const bool vector_ok =
      btt_ew::aligned4(n, g, g_bf16 ? 8 : 16) &&
      btt_ew::aligned4(n, out, 16) &&
      (rho == nullptr || btt_ew::aligned4(n, rho, rho_bf16 ? 8 : 16));
  const btt_ew::Salts salts = btt_ew::salts(seed, n);
  if (g_bf16)
    launch<__nv_bfloat16>(g, rho, rho_bf16, out, n, num_samples, salts,
                          vector_ok, shape, stream);
  else
    launch<float>(g, rho, rho_bf16, out, n, num_samples, salts, vector_ok,
                  shape, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
