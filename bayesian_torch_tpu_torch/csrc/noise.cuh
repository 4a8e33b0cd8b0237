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

// N(0,1) at flat counter i; sampling.py normal_fused.
__device__ __forceinline__ float btt_hash_normal(uint32_t salt, uint32_t i) {
  const uint32_t c = (i + 1u) * BTT_GOLDEN;
  const uint32_t h1 = btt_splitmix32(salt + c);
  const uint32_t h2 = btt_splitmix32((salt ^ 0xDEADBEEFu) + c);
  // 24-bit uniforms: u1 in (0, 1], u2 in [0, 1). The products are exact
  // (power-of-two scale), so a contracted FMA rounds as the plain version.
  const float u1 = (float)(h1 >> 8) * 5.9604644775390625e-08f +
                   2.98023223876953125e-08f;
  const float u2 = (float)(h2 >> 8) * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.283185307179586f * u2);
}
