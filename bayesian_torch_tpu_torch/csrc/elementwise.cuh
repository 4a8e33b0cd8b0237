// What the weight sampler K-A (sampled_weights.cu) and its backward K-C
// (sampled_weights_bwd.cu) share: one elementwise pass over n weights with
// a short loop over the draws, every element's eps drawn in the thread
// that owns it.
//
// Launch shape, chosen by launch_shape below from n and the card's SM
// count; each thread takes one chunk, in one pass, and the grid covers n:
// - narrow (kVec = 1), below four waves (n < 4 x SMs x 1,024): one element
//   a thread, 128 threads a block. A small layer's launch spreads over the
//   SMs, and a thread's draws make one short interleaved chain instead of
//   four serial ones.
// - wide (kVec = 4): four consecutive elements a thread (16-byte f32 or
//   8-byte bf16 accesses), 256 threads a block, registers capped so that
//   kWideBlocks blocks (48 warps) share an SM.
// Measured on the H100 at ResNet-50's layer sizes: a grid of a few
// resident blocks an SM whose grid-stride loop loaded the next chunk ahead
// of the hash was slower than this at every size, and so was four
// elements a thread below four waves (PERF.md, section 6). Every element's
// value depends on its index alone, never on the shape.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

namespace btt_ew {

constexpr int kNarrowThreads = 128;
constexpr int kWideThreads = 256;
constexpr int kWideBlocks = 6;  // resident blocks an SM: at most 40 registers
constexpr int kNarrowWaves = 4;  // narrow below this many waves of 1,024

template <int kVec>
__host__ __device__ constexpr int threads() {
  return kVec == 1 ? kNarrowThreads : kWideThreads;
}

// Elements a thread (1 or 4) and blocks of a launch over n > 0 elements
// on the current device: thread t of the grid takes [vec t, vec t + vec).
struct Shape {
  int vec;
  unsigned blocks;
};

inline cudaError_t launch_shape(int64_t n, Shape* shape) {
  int device, sms;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int vec =
      n < (int64_t)kNarrowWaves * sms * kWideThreads * 4 ? 1 : 4;
  const int64_t chunk = (int64_t)vec * (vec == 1 ? threads<1>() : threads<4>());
  const int64_t blocks = (n + chunk - 1) / chunk;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  *shape = Shape{vec, (unsigned)blocks};
  return cudaSuccess;
}

// kVec consecutive values of an array at element i, as loaded (bf16 stays
// packed until it is read); elements at n and beyond read as 0. `full`:
// all kVec lie below n and the vector access is aligned.
template <typename T, int kVec>
struct Pack;

template <>
struct Pack<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p, int64_t i, int64_t n,
                                       bool) {
    v = i < n ? __ldg(p + i) : 0.f;
  }
  __device__ __forceinline__ float at(int) const { return v; }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  uint32_t v;  // the bf16 bits in the high half: the f32 of equal value
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int64_t i,
                                       int64_t n, bool) {
    v = i < n ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p) +
                                i)
                    << 16
              : 0u;
  }
  __device__ __forceinline__ float at(int) const { return __uint_as_float(v); }
};

template <>
struct Pack<float, 4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p, int64_t i, int64_t n,
                                       bool full) {
    if (full) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i + j < n ? __ldg(p + i + j) : 0.f;
    }
  }
  __device__ __forceinline__ float at(int j) const { return v[j]; }
};

template <>
struct Pack<__nv_bfloat16, 4> {
  uint32_t w[2];  // elements 2q (low half) and 2q + 1 (high half) in w[q]
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int64_t i,
                                       int64_t n, bool full) {
    if (full) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p + i));
      w[0] = a.x;
      w[1] = a.y;
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      uint32_t h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = i + j < n ? __ldg(q + i + j) : 0u;
      w[0] = h[0] | h[1] << 16;
      w[1] = h[2] | h[3] << 16;
    }
  }
  __device__ __forceinline__ float at(int j) const {
    const uint32_t x = w[j / 2];
    return __uint_as_float(j % 2 ? x & 0xFFFF0000u : x << 16);
  }
};

__device__ __forceinline__ void store(float* out, int64_t i, int64_t n,
                                      bool full, const float (&v)[1]) {
  if (i < n) out[i] = v[0];
}

__device__ __forceinline__ void store(__nv_bfloat16* out, int64_t i,
                                      int64_t n, bool full,
                                      const float (&v)[1]) {
  if (i < n) out[i] = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ void store(float* out, int64_t i, int64_t n,
                                      bool full, const float (&v)[4]) {
  if (full) {
    *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) out[i + j] = v[j];
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* out, int64_t i,
                                      int64_t n, bool full,
                                      const float (&v)[4]) {
  if (full) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&a);
    packed.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(out + i) = packed;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) out[i + j] = __float2bfloat16_rn(v[j]);
  }
}

// fn(s, eps) for the kS draws s in order, eps the kVec normals of draw s
// at elements i .. i + kVec - 1, whose salts are salt0 + s * step
// (btt_draw_salt's lanes). A narrow thread draws its element's kS normals
// as one interleaved group first; a wide one takes one draw's kVec normals
// at a time, its neighbour warps supplying the rest of the parallelism.
template <int kS, int kVec, typename Fn>
__device__ __forceinline__ void for_draws(uint32_t salt0, uint32_t step,
                                          uint32_t i, Fn&& fn) {
  constexpr int kGroup = kVec == 1 ? kS : kVec;
  uint32_t salt[kGroup], ctr[kGroup];
  float eps[kGroup];
  if constexpr (kVec == 1) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      salt[s] = salt0 + (uint32_t)s * step;
      ctr[s] = i;
    }
    btt_hash_normals<kGroup>(salt, ctr, eps);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const float e[1] = {eps[s]};
      fn(s, e);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        salt[j] = salt0 + (uint32_t)s * step;
        ctr[j] = i + (uint32_t)j;
      }
      btt_hash_normals<kGroup>(salt, ctr, eps);
      fn(s, eps);
    }
  }
}

// A sampler's seed as the salt of draw 0, the step between draws
// (btt_draw_salt(seed, s, n) == salt0 + s * step, mod 2^32) and the
// counter of element 0 (ctr0).
struct Salts {
  uint32_t salt0, step, ctr0;
};

inline Salts salts(uint64_t seed, int64_t n) {
  const uint32_t lo = (uint32_t)(seed & 0xFFFFFFFFull);
  const uint32_t hi = (uint32_t)(seed >> 32);
  return Salts{btt_draw_salt(lo, hi, 0u, (uint32_t)n),
               (uint32_t)n * BTT_GOLDEN, 0u};
}

// A window of a larger launch: lane s of this launch is lane lane0 + s of
// a launch over lane_stride elements a lane, and its element i is that
// lane's element offset + i. A rank's block of draws [s0, s1) takes
// lane0 = s0; a dim-0 shard r of n_r elements takes offset = r * n_r.
inline Salts salts(uint64_t seed, int64_t lane0, int64_t lane_stride,
                   int64_t offset) {
  const Salts full = salts(seed, lane_stride);
  return Salts{full.salt0 + (uint32_t)lane0 * full.step, full.step,
               (uint32_t)offset};
}

// The vector path's alignment: n a multiple of 4 and every pointer
// aligned to its 4-element access (`bytes` each).
inline bool aligned4(int64_t n, const void* p, uintptr_t bytes) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace btt_ew
