// K-H: the Flipout signs, hashed inside the product that uses them.
//
// Replaces no Pallas kernel. The JAX package's rademacher_fused
// (bayesian_torch_tpu/ops/sampling.py:104) is an iota and a splitmix32 mix
// that XLA fuses into the multiply consuming the signs, so the signs never
// reach memory. Eager torch fuses nothing: the same hash in torch took about
// 15 int64 passes over every sign tensor, and stored each one. Here the sign
// of an element with counter c is bit 31 of splitmix32(salt + (c+1)*GOLDEN)
// (noise.cuh), drawn in the thread that reads and writes the element:
// - K-H1 btt_sign_flip: y = x * sign, a flip of x's sign bit (any float
//   width, bit for bit torch's multiply by +-1), or, without x, the signs;
// - K-H2 btt_sign_combine: y = mean + pert * sign, the sum in f32 (f64 for
//   f64) rounded once to the output type, as torch adds;
// - K-H3 btt_qsign_mul: the INT8 Flipout product qmul(a, quantize_uint8(
//   sign)) of ops/int8.py: the sign picks one of the two centred uint8
//   values of +-1, then qmul's f32 multiply, round half to even, zero point
//   and clamp to [0, 255].
//
// What bounds it on an H100: memory. Each operand element is read once and
// each output element written once; the hash is about ten integer
// instructions an element. K-H3 moves two bytes a sign, half of K-H1's, and
// runs at half its bound's rate (PERF.md, section 6).
//
// Design. One index mapping covers every form the callers take (a whole
// tensor, a DrawWindow's rows, a tensor-parallel shard's channels, the
// LSTM's blocks, lanes at any axis, an operand shared across the lanes):
// the host describes the output as up to BTT_SIGN_DIMS dims, innermost
// first, ordered by the output's memory layout, with dims that step alike
// merged. Each dim has a counter stride (the element's step in the flat
// index of the whole tensor whose block this is), a lane stride (1 on the
// dim that holds the lanes, each lane with its own salt) and an element
// stride for the output and each operand (0 where an operand is shared).
// A thread takes a chunk of consecutive elements of that walk (16; K-H3's
// 32 bytes, since its reads in flight bound it): it splits the first one's
// index into coordinates once (in 32 bits below 2^31 elements); where the
// chunk stays on one row of the innermost dim it steps the counter (in 32
// bits) and the offsets by that dim's strides, with 16-byte accesses where
// an operand is contiguous and aligned; elsewhere it steps an odometer
// element by element. A grid-stride loop over one wave of blocks. No shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"

#define BTT_SIGN_DIMS 8
#define BTT_SIGN_LANES 256

extern "C" {

// Mirrored by ops/cuda/flipout_signs.py::_Geometry. Dim 0 is the
// innermost; offsets and strides count elements.
struct BttSignGeom {
  int64_t numel;
  int64_t base;  // counter of the walk's first element
  int64_t size[BTT_SIGN_DIMS];
  int64_t ctr[BTT_SIGN_DIMS];
  int64_t lane[BTT_SIGN_DIMS];
  int64_t y[BTT_SIGN_DIMS];
  int64_t a[BTT_SIGN_DIMS];
  int64_t b[BTT_SIGN_DIMS];
  int32_t nd;
  int32_t lanes;
  uint32_t salts[BTT_SIGN_LANES];
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
// elements a thread takes at once: 16 floats, 32 bytes for K-H3
constexpr int kChunk = 16;
constexpr int kQChunk = 32;
constexpr int kBlocksPerSM = 2048 / kThreads;

__device__ __forceinline__ uint32_t neg_bit(uint32_t salt, int64_t c) {
  return btt_splitmix32(salt + ((uint32_t)c + 1u) * BTT_GOLDEN) >> 31;
}

// A chunk of U as 16-byte pieces.
template <int kBytes>
struct Piece {
  using T = uint4;
  static constexpr int n = kBytes / 16;
};

template <typename U, int N>
__device__ __forceinline__ void load_chunk(const U* base, int64_t off,
                                           int64_t stride, U (&v)[N]) {
  using P = Piece<N * sizeof(U)>;
  const U* p = base + off;
  if (stride == 1 &&
      reinterpret_cast<uintptr_t>(p) % sizeof(typename P::T) == 0) {
    union {
      typename P::T q[P::n];
      U v[N];
    } u;
    const typename P::T* src = reinterpret_cast<const typename P::T*>(p);
#pragma unroll
    for (int i = 0; i < P::n; ++i) u.q[i] = src[i];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = u.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j * stride];
  }
}

template <typename U, int N>
__device__ __forceinline__ void store_chunk(U* base, int64_t off,
                                            int64_t stride, const U (&v)[N]) {
  using P = Piece<N * sizeof(U)>;
  U* p = base + off;
  if (stride == 1 &&
      reinterpret_cast<uintptr_t>(p) % sizeof(typename P::T) == 0) {
    union {
      typename P::T q[P::n];
      U v[N];
    } u;
#pragma unroll
    for (int j = 0; j < N; ++j) u.v[j] = v[j];
    typename P::T* dst = reinterpret_cast<typename P::T*>(p);
#pragma unroll
    for (int i = 0; i < P::n; ++i) dst[i] = u.q[i];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j * stride] = v[j];
  }
}

// K-H1 on the raw bits U of the float type: y = x with its sign bit
// flipped where the sign is -1; without x, the bits of +-1.
template <typename U>
struct FlipOp {
  const U* x;
  U* y;
  U one;
  static constexpr int kTop = 8 * sizeof(U) - 1;
  static constexpr int kN = kChunk;

  __device__ __forceinline__ void run_chunk(int64_t yo, int64_t ys, int64_t ao,
                                       int64_t as, int64_t, int64_t,
                                       uint32_t negs) const {
    U v[kN];
    if (x != nullptr) {
      load_chunk(x, ao, as, v);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] = one;
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
      v[j] = (U)(v[j] ^ ((U)((negs >> j) & 1u) << kTop));
    store_chunk(y, yo, ys, v);
  }

  __device__ __forceinline__ void run1(int64_t yo, int64_t ao, int64_t,
                                       uint32_t neg) const {
    const U v = x != nullptr ? x[ao] : one;
    y[yo] = (U)(v ^ ((U)neg << kTop));
  }
};

// The float types of K-H2: their raw bits, the type the sum is taken in,
// and the conversions (round to nearest even back to the storage type).
struct F32 {
  using U = uint32_t;
  using A = float;
  static __device__ __forceinline__ A get(U u) { return __uint_as_float(u); }
  static __device__ __forceinline__ U put(A a) { return __float_as_uint(a); }
  static __device__ __forceinline__ A add(A m, A p) { return __fadd_rn(m, p); }
};
struct F64 {
  using U = unsigned long long;
  using A = double;
  static __device__ __forceinline__ A get(U u) {
    return __longlong_as_double((long long)u);
  }
  static __device__ __forceinline__ U put(A a) {
    return (U)__double_as_longlong(a);
  }
  static __device__ __forceinline__ A add(A m, A p) { return __dadd_rn(m, p); }
};
struct BF16 {
  using U = uint16_t;
  using A = float;
  static __device__ __forceinline__ A get(U u) {
    return __uint_as_float((uint32_t)u << 16);
  }
  static __device__ __forceinline__ U put(A a) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(a));
  }
  static __device__ __forceinline__ A add(A m, A p) { return __fadd_rn(m, p); }
};
struct F16 {
  using U = uint16_t;
  using A = float;
  static __device__ __forceinline__ A get(U u) {
    return __half2float(__ushort_as_half(u));
  }
  static __device__ __forceinline__ U put(A a) {
    return __half_as_ushort(__float2half_rn(a));
  }
  static __device__ __forceinline__ A add(A m, A p) { return __fadd_rn(m, p); }
};

// K-H2: y = mean + (sign < 0 ? -pert : pert), one rounding.
template <class F>
struct CombineOp {
  using U = typename F::U;
  static constexpr int kN = kChunk;
  const U* mean;
  const U* pert;
  U* y;

  __device__ __forceinline__ U one(U m, U p, uint32_t neg) const {
    const typename F::A pv = F::get(p);
    return F::put(F::add(F::get(m), neg ? -pv : pv));
  }

  __device__ __forceinline__ void run_chunk(int64_t yo, int64_t ys, int64_t ao,
                                       int64_t as, int64_t bo, int64_t bs,
                                       uint32_t negs) const {
    U m[kN], p[kN], v[kN];
    load_chunk(mean, ao, as, m);
    load_chunk(pert, bo, bs, p);
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = one(m[j], p[j], (negs >> j) & 1u);
    store_chunk(y, yo, ys, v);
  }

  __device__ __forceinline__ void run1(int64_t yo, int64_t ao, int64_t bo,
                                       uint32_t neg) const {
    y[yo] = one(mean[ao], pert[bo], neg);
  }
};

// K-H3: clamp(round(f32((a - a_zp) * b) * mult) + out_zp, 0, 255) with b
// the centred uint8 value of +1 or -1.
struct QSignOp {
  static constexpr int kN = kQChunk;
  const uint8_t* a;
  uint8_t* y;
  int a_zp, pos, neg;
  float mult, out_zp;

  __device__ __forceinline__ uint8_t one(uint8_t av, uint32_t n) const {
    const int prod = ((int)av - a_zp) * (n ? neg : pos);
    float q = __fadd_rn(rintf(__fmul_rn((float)prod, mult)), out_zp);
    q = fminf(fmaxf(q, 0.f), 255.f);
    return (uint8_t)q;
  }

  __device__ __forceinline__ void run_chunk(int64_t yo, int64_t ys,
                                            int64_t ao, int64_t as, int64_t,
                                            int64_t, uint32_t negs) const {
    uint8_t v[kN];
    load_chunk(a, ao, as, v);
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = one(v[j], (negs >> j) & 1u);
    store_chunk(y, yo, ys, v);
  }

  __device__ __forceinline__ void run1(int64_t yo, int64_t ao, int64_t,
                                       uint32_t neg) const {
    y[yo] = one(a[ao], neg);
  }
};

// I: the index type of the coordinate split (uint32_t below 2^31
// elements).
template <typename I, class Op>
__global__ void __launch_bounds__(kThreads)
    sign_kernel(const BttSignGeom g, const Op op) {
  const int64_t chunks = (g.numel + Op::kN - 1) / Op::kN;
  const int nd = g.nd;
  for (int64_t ch = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       ch < chunks; ch += (int64_t)gridDim.x * kThreads) {
    const int64_t w0 = ch * Op::kN;
    I coord[BTT_SIGN_DIMS];
    int64_t c = g.base, lane = 0, yo = 0, ao = 0, bo = 0;
    I rem = (I)w0;
#pragma unroll
    for (int k = 0; k < BTT_SIGN_DIMS; ++k) {
      coord[k] = 0;
      if (k < nd) {
        const I n = (I)g.size[k];
        const I q = rem / n;
        coord[k] = rem - q * n;
        rem = q;
        const int64_t i = (int64_t)coord[k];
        c += i * g.ctr[k];
        lane += i * g.lane[k];
        yo += i * g.y[k];
        ao += i * g.a[k];
        bo += i * g.b[k];
      }
    }
    if ((int64_t)coord[0] + Op::kN <= g.size[0]) {
      // the chunk's hashes' inputs in 32 bits: (c + j*ctr + 1) * GOLDEN + salt
      const uint32_t h0 = ((uint32_t)c + 1u) * BTT_GOLDEN;
      const uint32_t hs = (uint32_t)g.ctr[0] * BTT_GOLDEN;
      uint32_t negs = 0;
      if (g.lane[0] == 0) {
        const uint32_t base = g.salts[lane] + h0;
#pragma unroll
        for (int j = 0; j < Op::kN; ++j)
          negs |= (btt_splitmix32(base + j * hs) >> 31) << j;
      } else {
#pragma unroll
        for (int j = 0; j < Op::kN; ++j)
          negs |= (btt_splitmix32(g.salts[lane + j * g.lane[0]] + h0 + j * hs)
                   >> 31) << j;
      }
      op.run_chunk(yo, g.y[0], ao, g.a[0], bo, g.b[0], negs);
      continue;
    }
    for (int j = 0; j < Op::kN && w0 + j < g.numel; ++j) {
      op.run1(yo, ao, bo, neg_bit(g.salts[lane], c));
#pragma unroll
      for (int k = 0; k < BTT_SIGN_DIMS; ++k) {
        if (k >= nd) break;
        c += g.ctr[k];
        lane += g.lane[k];
        yo += g.y[k];
        ao += g.a[k];
        bo += g.b[k];
        if ((int64_t)++coord[k] < g.size[k]) break;
        coord[k] = 0;
        c -= g.size[k] * g.ctr[k];
        lane -= g.size[k] * g.lane[k];
        yo -= g.size[k] * g.y[k];
        ao -= g.size[k] * g.a[k];
        bo -= g.size[k] * g.b[k];
      }
    }
  }
}

template <class Op>
int launch(const BttSignGeom* g, const Op& op, void* stream) {
  if (g->nd < 1 || g->nd > BTT_SIGN_DIMS || g->lanes < 1 ||
      g->lanes > BTT_SIGN_LANES || g->numel < 0)
    return (int)cudaErrorInvalidValue;
  if (g->numel == 0) return (int)cudaSuccess;
  int device, sms;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int64_t chunks = (g->numel + Op::kN - 1) / Op::kN;
  int64_t blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > (int64_t)sms * kBlocksPerSM) blocks = (int64_t)sms * kBlocksPerSM;
  cudaStream_t s = (cudaStream_t)stream;
  if (g->numel < (int64_t(1) << 31))
    sign_kernel<uint32_t, Op><<<(unsigned)blocks, kThreads, 0, s>>>(*g, op);
  else
    sign_kernel<uint64_t, Op><<<(unsigned)blocks, kThreads, 0, s>>>(*g, op);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K-H1. x (NULL: write the signs) and y hold floats of `bits` bits;
// `one` is the bits of 1.0 in that type.
int btt_sign_flip(const void* x, void* y, int bits, uint64_t one,
                  const BttSignGeom* g, void* stream) {
  switch (bits) {
    case 16:
      return launch(g, FlipOp<uint16_t>{(const uint16_t*)x, (uint16_t*)y,
                                        (uint16_t)one}, stream);
    case 32:
      return launch(g, FlipOp<uint32_t>{(const uint32_t*)x, (uint32_t*)y,
                                        (uint32_t)one}, stream);
    case 64:
      return launch(g, FlipOp<unsigned long long>{
                           (const unsigned long long*)x,
                           (unsigned long long*)y, (unsigned long long)one},
                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K-H2. mean, pert and y of one type: 0 f32, 1 bf16, 2 f16, 3 f64.
int btt_sign_combine(const void* mean, const void* pert, void* y, int dtype,
                     const BttSignGeom* g, void* stream) {
  switch (dtype) {
    case 0:
      return launch(g, CombineOp<F32>{(const uint32_t*)mean,
                                      (const uint32_t*)pert, (uint32_t*)y},
                    stream);
    case 1:
      return launch(g, CombineOp<BF16>{(const uint16_t*)mean,
                                       (const uint16_t*)pert, (uint16_t*)y},
                    stream);
    case 2:
      return launch(g, CombineOp<F16>{(const uint16_t*)mean,
                                      (const uint16_t*)pert, (uint16_t*)y},
                    stream);
    case 3:
      return launch(g, CombineOp<F64>{(const unsigned long long*)mean,
                                      (const unsigned long long*)pert,
                                      (unsigned long long*)y},
                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K-H3. a and y uint8; pos and neg the centred uint8 values of +1 and -1.
int btt_qsign_mul(const void* a, void* y, int a_zp, int pos, int neg,
                  float mult, float out_zp, const BttSignGeom* g,
                  void* stream) {
  return launch(g, QSignOp{(const uint8_t*)a, (uint8_t*)y, a_zp, pos, neg,
                           mult, out_zp},
                stream);
}

}  // extern "C"
