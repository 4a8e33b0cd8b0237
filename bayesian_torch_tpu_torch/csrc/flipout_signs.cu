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
// - K-H3 btt_qsign_mul: the INT8 Flipout layer's input pass. The product
//   qmul(a, quantize_uint8(sign)) of ops/int8.py: the sign picks one of the
//   two centred uint8 values of +-1, then qmul's f32 multiply, round half
//   to even, zero point and clamp to [0, 255]. Given a second output, a is
//   a QTensor's payload, first requantized as QTensor.requantize does
//   (ops/qtensor.py); the pass writes that x_q beside the product, from
//   the same registers, so the payload is read once. (The output side's
//   sign product runs in K-F's Flipout epilogue, qmatmul.cu.)
//
// What bounds it on an H100: memory for K-H1 and K-H2. Each operand
// element is read once and each output element written once; the hash is
// about ten integer instructions an element. K-H3 moves two bytes a sign
// (three with the requantize), a third or less of K-H2's, and its
// arithmetic weighs more: run with three conversions an element (I2F,
// FRND, F2I: 16 a clock on an SM, so 0.19 clocks an element against the
// 0.16 that its two bytes take at 3.35 TB/s) it reached half its bytes
// bound. Its f32 steps avoid the conversion unit (uint8_ops.cuh); what is
// left is the hash's and the clamps' integer instructions, which issue at
// half the FMA rate and bind it (PERF.md, section 6).
//
// Design. One index mapping covers every form the callers take (a whole
// tensor, a DrawWindow's rows, a tensor-parallel shard's channels, the
// LSTM's blocks, lanes at any axis, an operand shared across the lanes):
// the host describes the output as up to BTT_SIGN_DIMS dims, innermost
// first, ordered by the output's memory layout, with dims that step alike
// merged. Each dim has a counter stride (the element's step in the flat
// index of the whole tensor whose block this is), a lane stride (1 on the
// dim that holds the lanes, each lane with its own salt) and an element
// stride for the output and each operand (0 where an operand is shared;
// K-H3's input pass writes its second output, x_q, at the second operand's
// strides). A thread takes a chunk of consecutive elements of that walk
// (16; K-H3's 32 bytes, two 16-byte accesses an operand): it splits the
// first one's
// index into coordinates once (in 32 bits below 2^31 elements); where the
// chunk stays on one row of the innermost dim it steps the counter (in 32
// bits) and the offsets by that dim's strides, with 16-byte accesses where
// an operand is contiguous and aligned; elsewhere it steps an odometer
// element by element. A grid-stride loop over one wave of blocks. No shared memory.
//
// The lanes' salts come in the geometry, or, where lane_salts is set, from
// device memory (int64 a lane, lane_salt_stride apart): a launch captured
// into a CUDA graph keeps its geometry, so a replay reads that batch's
// salts from a buffer written before it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "noise.cuh"
#include "uint8_ops.cuh"

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
  const int64_t* lane_salts;  // NULL: `salts` holds them
  int64_t lane_salt_stride;
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

// A lane's salt: from device memory where the geometry points there, else
// the one it holds (`held`). Scalars only: a reference to the geometry, a
// kernel parameter, would copy it to local memory.
__device__ __forceinline__ uint32_t lane_salt(const int64_t* dev,
                                              int64_t stride, int64_t lane,
                                              uint32_t held) {
  return dev != nullptr ? (uint32_t)dev[lane * stride] : held;
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

// 32 bytes as eight words: 16-byte loads where contiguous and aligned,
// else byte by byte at the element stride.
__device__ __forceinline__ void load_words(const uint8_t* base, int64_t off,
                                           int64_t stride, uint32_t (&w)[8]) {
  const uint8_t* p = base + off;
  if (stride == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 t = src[i];
      w[4 * i] = t.x, w[4 * i + 1] = t.y, w[4 * i + 2] = t.z,
      w[4 * i + 3] = t.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    w[j / 4] |= (uint32_t)p[j * stride] << (8 * (j % 4));
}

__device__ __forceinline__ void store_words(uint8_t* base, int64_t off,
                                            int64_t stride,
                                            const uint32_t (&w)[8]) {
  uint8_t* p = base + off;
  if (stride == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    uint4* dst = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      dst[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    p[j * stride] = (uint8_t)(w[j / 4] >> (8 * (j % 4)));
}

// K-H3: y = clamp(round(f32((a - a_zp) * b) * mult) + out_zp, 0, 255),
// b the centred uint8 value of +1 or -1; with kRequant, a is first
// clamp(round((q - in_zp) * rq) + rq_zp, 0, 255) of the payload q, written
// to xq (at the geometry's second operand strides). Conversion-free
// (uint8_ops.cuh).
template <bool kRequant>
struct QSignOp {
  static constexpr int kN = kQChunk;
  const uint8_t* a;
  uint8_t* y;
  uint8_t* xq;
  float a_zp, pos, neg, mult, out_zp;
  float in_zp, rq, rq_zp;

  // one element: the byte's f32 value in, the product's biased word out
  // (and, with kRequant, x_q's biased word in xb)
  __device__ __forceinline__ uint32_t one(float av, uint32_t n,
                                          uint32_t& xb) const {
    using namespace btt_u8;
    if constexpr (kRequant) {
      xb = to_u8(clamp255(__fadd_rn(
          round_even(__fmul_rn(__fsub_rn(av, in_zp), rq)), rq_zp)));
      av = u8_value(xb);
    }
    return to_u8(qmul_sign(av, a_zp, n ? neg : pos, mult, out_zp));
  }

  __device__ __forceinline__ void run_chunk(int64_t yo, int64_t ys,
                                            int64_t ao, int64_t as,
                                            int64_t bo, int64_t bs,
                                            uint32_t negs) const {
    uint32_t w[8], yw[8], xw[8];
    load_words(a, ao, as, w);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t o[4], x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = one(btt_u8::byte_f32(w[q], i), (negs >> (4 * q + i)) & 1u,
                   x[i]);
      yw[q] = btt_u8::pack4(o[0], o[1], o[2], o[3]);
      if constexpr (kRequant) xw[q] = btt_u8::pack4(x[0], x[1], x[2], x[3]);
    }
    if constexpr (kRequant) store_words(xq, bo, bs, xw);
    store_words(y, yo, ys, yw);
  }

  __device__ __forceinline__ void run1(int64_t yo, int64_t ao, int64_t bo,
                                       uint32_t neg_) const {
    uint32_t xb = 0u;
    const uint32_t o = one((float)a[ao], neg_, xb);
    if constexpr (kRequant) xq[bo] = (uint8_t)xb;
    y[yo] = (uint8_t)o;
  }
};

// I: the index type of the coordinate split (uint32_t below 2^31
// elements).
template <typename I, class Op>
__global__ void __launch_bounds__(kThreads)
    sign_kernel(const BttSignGeom g, const Op op) {
  const int64_t chunks = (g.numel + Op::kN - 1) / Op::kN;
  const int nd = g.nd;
  const int64_t* const dev = g.lane_salts;
  const int64_t dstride = g.lane_salt_stride;
  // one lane (a draw of the loop): its salt read once, before the walk
  const bool one = g.lanes == 1;
  const uint32_t salt1 = one ? lane_salt(dev, dstride, 0, g.salts[0]) : 0u;
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
        const uint32_t base =
            (one ? salt1 : lane_salt(dev, dstride, lane, g.salts[lane])) + h0;
#pragma unroll
        for (int j = 0; j < Op::kN; ++j)
          negs |= (btt_splitmix32(base + j * hs) >> 31) << j;
      } else {
#pragma unroll
        for (int j = 0; j < Op::kN; ++j)
          negs |= (btt_splitmix32(
                       lane_salt(dev, dstride, lane + j * g.lane[0],
                                 g.salts[lane + j * g.lane[0]]) +
                       h0 + j * hs) >> 31) << j;
      }
      op.run_chunk(yo, g.y[0], ao, g.a[0], bo, g.b[0], negs);
      continue;
    }
    for (int j = 0; j < Op::kN && w0 + j < g.numel; ++j) {
      op.run1(yo, ao, bo,
              neg_bit(one ? salt1 : lane_salt(dev, dstride, lane,
                                              g.salts[lane]), c));
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
// xq NULL: a is the product's operand. Else a is a payload at zero point
// in_zp, requantized by rq onto zero point rq_zp into xq (the geometry's
// second operand), which is the product's operand.
int btt_qsign_mul(const void* a, void* y, int a_zp, int pos, int neg,
                  float mult, float out_zp, void* xq, int in_zp, float rq,
                  float rq_zp, const BttSignGeom* g, void* stream) {
  if (xq == nullptr)
    return launch(g, QSignOp<false>{(const uint8_t*)a, (uint8_t*)y, nullptr,
                                    (float)a_zp, (float)pos, (float)neg, mult,
                                    out_zp, 0.f, 0.f, 0.f},
                  stream);
  return launch(g, QSignOp<true>{(const uint8_t*)a, (uint8_t*)y, (uint8_t*)xq,
                                 (float)a_zp, (float)pos, (float)neg, mult,
                                 out_zp, (float)in_zp, rq, rq_zp},
                stream);
}

}  // extern "C"
