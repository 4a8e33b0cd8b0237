// Counter-hash normal generator shared by the kernels.
//
// The TPU kernels drew eps from the chip's hardware PRNG, whose bits no
// other machine reproduces. Here eps is a pure function of integers: the
// splitmix32 Box-Muller of the JAX package's normal_fused
// (bayesian_torch_tpu/ops/sampling.py), salted per draw from a 64-bit
// seed. bayesian_torch_tpu_torch/ops/sampling.py computes the same values
// in torch, which is what each kernel's plain version uses.
#pragma once

#include <stdint.h>

#define BTT_GOLDEN 0x9E3779B9u

__host__ __device__ __forceinline__ uint32_t btt_splitmix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Salt of lane s of a launch drawing n counters per lane under seed =
// (hi << 32) | lo: lane 0's salt advanced by s * n counters, so the lanes
// read consecutive, disjoint windows of one stream; sampling.py draw_salt.
__host__ __device__ __forceinline__ uint32_t btt_draw_salt(uint32_t lo,
                                                          uint32_t hi,
                                                          uint32_t s,
                                                          uint32_t n) {
  return btt_splitmix32(lo ^ btt_splitmix32(hi + BTT_GOLDEN)) +
         s * n * BTT_GOLDEN;
}

// The two 24-bit uniforms of counter i: u1 in (0, 1], u2 in [0, 1).
__device__ __forceinline__ void btt_hash_uniforms(uint32_t salt, uint32_t i,
                                                  float& u1, float& u2) {
  const uint32_t c = (i + 1u) * BTT_GOLDEN;
  const uint32_t h1 = btt_splitmix32(salt + c);
  const uint32_t h2 = btt_splitmix32((salt ^ 0xDEADBEEFu) + c);
  // The products are exact (power-of-two scale), so a contracted FMA
  // rounds as the plain version.
  u1 = (float)(h1 >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
  u2 = (float)(h2 >> 8) * 5.9604644775390625e-08f;
}

// Box-Muller on those uniforms in steps: -2 log u1 (straight-line code),
// then its square root and the cosine (each with a branch to a slow path
// that these arguments never take). A caller drawing several normals takes
// each step over all of them, so the compiler can interleave their chains.
__device__ __forceinline__ float btt_box_muller_log(float u1) {
  return -2.0f * logf(u1);
}

__device__ __forceinline__ float btt_box_muller_cos(float u2) {
  return cosf(6.283185307179586f * u2);
}

// N(0,1) at flat counter i; sampling.py normal_fused.
__device__ __forceinline__ float btt_hash_normal(uint32_t salt, uint32_t i) {
  float u1, u2;
  btt_hash_uniforms(salt, i, u1, u2);
  const float r = sqrtf(btt_box_muller_log(u1));
  return r * btt_box_muller_cos(u2);
}

// kN normals at once: eps[j] = btt_hash_normal(salt[j], ctr[j]) bit for
// bit, each Box-Muller step taken over all of them before the next.
template <int kN>
__device__ __forceinline__ void btt_hash_normals(const uint32_t (&salt)[kN],
                                                 const uint32_t (&ctr)[kN],
                                                 float (&eps)[kN]) {
  float u1[kN], u2[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) btt_hash_uniforms(salt[j], ctr[j], u1[j], u2[j]);
#pragma unroll
  for (int j = 0; j < kN; ++j) u1[j] = btt_box_muller_log(u1[j]);
#pragma unroll
  for (int j = 0; j < kN; ++j) u1[j] = sqrtf(u1[j]);
#pragma unroll
  for (int j = 0; j < kN; ++j) eps[j] = u1[j] * btt_box_muller_cos(u2[j]);
}
