// K-F: fused int8 GEMM + requantize epilogue,
//   acc[m, n] = sum_k x[m, k] * w[n, k]                    (s32, exact)
//   out[m, n] = clamp(rint(f32(acc + corr[n]) * mult + bias[n]) + out_zp,
//                     0, 255)                              (uint8)
// with x uint8 (M, K), w int8 (N, K), corr = -x_zp * colsum(w) or NULL,
// bias = bias_f32 / out_scale or NULL (the wrapper computes both).
//
// Replaces the Pallas kernel _kernel of
// bayesian_torch_tpu/ops/pallas/qmatmul.py (qmatmul_requant), which keeps
// the s32 accumulator in VMEM and writes the requantized uint8 tile. The
// epilogue here is the one of the JAX XLA route (ops/int8.py qlinear:
// integer correction, then one f32 multiply, one f32 add, round half to
// even), not the TPU kernel's folded beta, so kernel, plain torch version
// and the JAX default route agree bit for bit. __fmul_rn / __fadd_rn keep
// the multiply and add from contracting into an FMA. |acc + corr| <=
// 2 * 255 * 128 * K < 2^31 for K <= 32,000: exact in s32.
//
// What bounds it on an H100: at Bayesian ResNet-50's shapes (batch 128)
// the stem and layer1-2 launches move more bytes than the int8 tensor
// cores need time for (the stem's im2col patches are 236 MB of uint8 for
// 30 G int8 operations); the wide layer3-4 GEMMs (M <= 25,088 rows, K and
// N of 512 or more) are bound by operations. One forward's 54 launches:
// 4.2 GB and 1.05 T operations, a 1.3 ms bound, bytes the larger part.
//
// Design, for Hopper: a block owns a 128 (M) x BN (N; 128, or 64 when N
// <= 64) output tile and walks K in steps of 128 bytes through a ring of
// up to three shared-memory stages under mbarriers (sized to K, so that
// two or three blocks share an SM: most launches walk K in 1-4 steps, and
// one block's loads then overlap another's epilogue). One producer thread
// keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle) of both
// operands in flight; two consumer warpgroups each run
// wgmma.m64nBNk32.s32.u8.s8 on their 64 rows, both operands K-major as
// they lie in memory. wgmma takes
// x as u8, so x needs no centring pass (the first kernel flipped each byte
// through registers): sum_k x*w differs from sum_k (x - x_zp)*w by
// x_zp * colsum(w), which the wrapper folds into corr. Rows past M,
// columns past N and K past its end load as 0 (TMA's zero fill; a zero
// weight adds nothing); the wrapper pads K to a multiple of 16, which the
// tensor maps need, with zero weight columns (the stem's im2col builds its
// patches that wide). The s32 accumulator never reaches device memory: the
// epilogue requantizes from registers into shared memory, whence rows leave
// in 16-byte stores. The TPU kernel's sequential K grid axis is the
// in-block K loop.
//
// The Flipout epilogue (the kernel's second instantiation, its epilogue
// argument a BttFlipEpilogue in place of the plain BttNoEpilogue; no TPU
// kernel: the JAX package's INT8 Flipout layer leaves the chain after the
// perturbation's product, layers/quantized_base.py:381-391, to one XLA
// fusion). The perturbation's requantized uint8 p goes on through the rest
// of that chain before it leaves:
//   p2  = qmul(p, sign): clamp(round(f32((p - p_zp) * sgn) * m_sign)
//                              + prod_zp, 0, 255)
//   out = qadd(mean, p2): clamp(round((f32(mean) - mean_zp) * a_mean
//                               + (f32(p2) - prod_zp) * a_prod) + out_zp,
//                               0, 255)
// with sgn the centred uint8 value of the element's sign (+1 or -1) and
// mean the matching element of the mean product's output (the layer's
// other GEMM). The sign of element (m, n), m = b * R + r, is bit 31 of
// splitmix32(salt + (c + 1) * GOLDEN), c = c0 + b*cb + r*cr + n*cn mod
// 2^32: one affine counter map covers NCHW and NHWC outputs, a linear
// layer (R = 1), a window's rows and a shard's or a group's channels
// (ops/cuda/flipout_signs.py::SignMap). It runs in the store loop, where a
// thread holds 16 consecutive bytes of one row: it reads the mean's 16
// bytes (coalesced, as the stores), hashes 16 signs and stores out in
// place of p, so p, the signed p and the f32 passes of torch's qadd never
// reach device memory: the 540 perturbation GEMMs of an INT8 Flipout
// MC-10 bs128 batch read 14.2 G bytes of the mean more and write nothing
// more, where the torch chain moved about 83 bytes an element.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "noise.cuh"
#include "uint8_ops.cuh"

extern "C" {

// The Flipout epilogue's arguments, mirrored by
// ops/cuda/qmatmul.py::_Epilogue.
struct BttFlipEpilogue {
  const uint8_t* mean;  // uint8 (M, N), rows ld_mean apart
  int64_t ld_mean;
  uint32_t salt, c0, cb, cr, cn;  // the sign map (mod 2^32)
  int32_t R;
  int32_t p_zp;      // p's zero point as qmul takes it (an int)
  int32_t pos, neg;  // the centred uint8 values of +1 and -1
  float m_sign;      // qmul's multiplier
  float prod_zp;     // p2's zero point
  float mean_zp;
  float a_mean, a_prod;  // qadd's multipliers
  float out_zp;
};

// The plain instantiation's (empty) epilogue argument.
struct BttNoEpilogue {};

}  // extern "C"

namespace {

constexpr int kBM = 128;
constexpr int kMaxStages = 3;
constexpr int kAtile = kBM * 128;  // 128 rows of 128 bytes
constexpr int kThreads = 288;  // two consumer warpgroups, a producer warp

// Two blocks share an SM (three with 64-wide tiles), so one block's loads
// overlap another's epilogue.
template <int kBN>
struct Tile {
  static constexpr int kWtile = kBN * 128;
  static constexpr int kStage = kAtile + kWtile;
  static constexpr int kOutLd = kBN + 16;  // output staging row, padded
  static constexpr int kMinBlocks = kBN == 128 ? 2 : 3;
  // the ring (the output staging, 128 rows of kOutLd, fits in one stage),
  // 1024 bytes to align it, the full and empty barriers
  static int smem(int stages) { return stages * kStage + 1024 + 16 * stages; }
};

// The instantiation with the Flipout epilogue.
template <class Epi>
constexpr bool kFlip = std::is_same<Epi, BttFlipEpilogue>::value;

template <int kBN>
__device__ __forceinline__ void mma_step(int (&acc)[kBN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (kBN == 128) {
    btt::wgmma_u8s8_n128(acc, a, b);
  } else {
    btt::wgmma_u8s8_n64(acc, a, b);
  }
}

__device__ __forceinline__ uint8_t requant(int acc, int corr, float mult,
                                           float bias, bool has_bias,
                                           float out_zp) {
  float v = __fmul_rn(__int2float_rn(acc + corr), mult);
  if (has_bias) v = __fadd_rn(v, bias);
  v = __fadd_rn(rintf(v), out_zp);
  return (uint8_t)fminf(fmaxf(v, 0.f), 255.f);
}

// The Flipout epilogue on the 16 requantized bytes v of row m, columns
// [n, n + 16) (those at N and past it are never stored).
__device__ __forceinline__ uint4 flipout16(const BttFlipEpilogue& e, uint4 v,
                                          int m, int n, int N) {
  using namespace btt_u8;
  const uint8_t* src = e.mean + (int64_t)m * e.ld_mean + n;
  uint32_t mw[4] = {0u, 0u, 0u, 0u};
  if (n + 16 <= N && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4 t = *reinterpret_cast<const uint4*>(src);
    mw[0] = t.x, mw[1] = t.y, mw[2] = t.z, mw[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (n + j < N) mw[j / 4] |= (uint32_t)src[j] << (8 * (j % 4));
  }
  const uint32_t b = (uint32_t)m / (uint32_t)e.R;
  const uint32_t r = (uint32_t)m - b * (uint32_t)e.R;
  const uint32_t c = e.c0 + b * e.cb + r * e.cr + (uint32_t)n * e.cn;
  const uint32_t h0 = e.salt + (c + 1u) * BTT_GOLDEN;
  const uint32_t hs = e.cn * BTT_GOLDEN;
  const float p_zp = (float)e.p_zp;
  const float pos = (float)e.pos, neg = (float)e.neg;
  const uint32_t pw[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      const float sgn =
          (int32_t)btt_splitmix32(h0 + (uint32_t)j * hs) < 0 ? neg : pos;
      const float p2 = u8_value(to_u8(
          qmul_sign(byte_f32(pw[q], i), p_zp, sgn, e.m_sign, e.prod_zp)));
      const float s = __fadd_rn(
          __fmul_rn(__fsub_rn(byte_f32(mw[q], i), e.mean_zp), e.a_mean),
          __fmul_rn(__fsub_rn(p2, e.prod_zp), e.a_prod));
      o[i] = to_u8(clamp255(__fadd_rn(round_even(s), e.out_zp)));
    }
    out[q] = pack4(o[0], o[1], o[2], o[3]);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

template <int kBN, class Epi>
__global__ void __launch_bounds__(kThreads, Tile<kBN>::kMinBlocks)
    qmatmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const int32_t* __restrict__ corr,
                         const float* __restrict__ bias,
                         uint8_t* __restrict__ out, int M, int N, int K,
                         float mult, float out_zp, int stages,
                         const Epi flip) {
  using T = Tile<kBN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = btt::smem_addr(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = btt::smem_addr(ring + stages * T::kStage);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // N tiles are the fastest grid axis: the blocks that share an x tile
  // run together and read it from L2
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int nk = (K + 127) / 128;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      btt::mbar_init(bars + 8 * i, 1);
      btt::mbar_init(bars + 8 * (stages + i), 2 * 128);
    }
    btt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread issues every copy
    if (tid != 256) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % stages;
      const uint32_t full = bars + 8 * st;
      const uint32_t stage = btt::smem_addr(ring + st * T::kStage);
      btt::mbar_wait(bars + 8 * (stages + st), ((kt / stages) & 1) ^ 1);
      btt::mbar_expect_tx(full, T::kStage);
      btt::tma_load_2d(stage, &xmap, full, kt * 128, m0);
      btt::tma_load_2d(stage + kAtile, &wmap, full, kt * 128, n0);
    }
    return;
  }

  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % stages;
    const uint32_t stage = btt::smem_addr(ring + st * T::kStage);
    btt::mbar_wait(bars + 8 * st, (kt / stages) & 1);
    btt::wgmma_fence();
    btt::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // 32 bytes of K each
      const uint64_t da =
          btt::desc_sw128(stage + wg * 64 * 128 + ks * 32, 16, 1024);
      const uint64_t db = btt::desc_sw128(stage + kAtile + ks * 32, 16, 1024);
      mma_step<kBN>(acc, da, db);
    }
    btt::wgmma_commit();
    btt::fence_regs(acc);
    btt::wgmma_wait<1>();
    btt::fence_regs(acc);
    if (kt > 0) btt::mbar_arrive(bars + 8 * (stages + (kt - 1) % stages));
  }
  btt::wgmma_wait<0>();
  btt::fence_regs(acc);

  // epilogue: requantize into shared memory (the ring, now free), then
  // store each warpgroup's 64 rows
  btt::named_sync(1, 256);
  uint8_t* stg = ring + wg * 64 * T::kOutLd;
  const int lt = tid % 128;
  const int warp = lt / 32;
  const int lane = lt % 32;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + (lane % 4) * 2 + c;
      const int n = n0 + col;
      const int cn = corr != nullptr && n < N ? corr[n] : 0;
      const bool has_bias = bias != nullptr && n < N;
      const float bn = has_bias ? bias[n] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h;
        stg[r * T::kOutLd + col] =
            requant(acc[4 * j + 2 * h + c], cn, mult, bn, has_bias, out_zp);
      }
    }
  }
  btt::named_sync(2 + wg, 128);
  constexpr int kChunks = kBN / 16;
  for (int q = lt; q < 64 * kChunks; q += 128) {
    const int r = q / kChunks;
    const int cc = q % kChunks;
    const int m = m0 + wg * 64 + r;
    const int n = n0 + cc * 16;
    if (m >= M || n >= N) continue;
    uint4 v = *reinterpret_cast<const uint4*>(stg + r * T::kOutLd + cc * 16);
    if constexpr (kFlip<Epi>) v = flipout16(flip, v, m, n, N);
    uint8_t* dst = out + (int64_t)m * N + n;
    if (n + 16 <= N && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
      continue;
    }
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (n + e < N) dst[e] = (uint8_t)(w4[e / 4] >> (8 * (e % 4)));
  }
}

template <int kBN, class Epi>
int launch(const uint8_t* x, const int8_t* w, const int32_t* corr,
           const float* bias, uint8_t* out, int M, int N, int K, float mult,
           float out_zp, const Epi& flip, cudaStream_t stream) {
  using T = Tile<kBN>;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint32_t xbox[2] = {128, kBM};
  const cuuint32_t wbox[2] = {128, kBN};
  int err = btt::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, xdims,
                          stride, xbox);
  if (err == 0)
    err = btt::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims,
                        stride, wbox);
  if (err != 0) return err;
  const int64_t mtiles = ((int64_t)M + kBM - 1) / kBM;
  if (mtiles > 65535) return (int)cudaErrorInvalidValue;
  const int nk = (K + 127) / 128;
  const int stages = nk < kMaxStages ? nk : kMaxStages;
  static int allowed = -1;
  if (allowed != 0)
    allowed = btt::allow_smem(qmatmul_wgmma_kernel<kBN, Epi>,
                              T::smem(kMaxStages));
  if (allowed != 0) return allowed;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)mtiles);
  qmatmul_wgmma_kernel<kBN, Epi>
      <<<grid, kThreads, T::smem(stages), stream>>>(
          xmap, wmap, corr, bias, out, M, N, K, mult, out_zp, stages, flip);
  return (int)cudaGetLastError();
}

template <class Epi>
int dispatch(const uint8_t* x, const int8_t* w, const int32_t* corr,
             const float* bias, uint8_t* out, int M, int N, int K, float mult,
             float out_zp, const Epi& flip, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || K % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return N <= 64 ? launch<64>(x, w, corr, bias, out, M, N, K, mult, out_zp,
                              flip, stream)
                 : launch<128>(x, w, corr, bias, out, M, N, K, mult, out_zp,
                               flip, stream);
}

}  // namespace

extern "C" {

// x uint8 (M, K) and w int8 (N, K) row-major, K a multiple of 16 and both
// 16-byte aligned (the tensor maps need it); corr int32 (N,) or NULL; bias
// float32 (N,) or NULL; out uint8 (M, N). Returns the launch's
// cudaGetLastError() (or the error of a refused tensor map).
int btt_qmatmul_requant(const uint8_t* x, const int8_t* w,
                        const int32_t* corr, const float* bias, uint8_t* out,
                        int M, int N, int K, float mult, float out_zp,
                        cudaStream_t stream) {
  return dispatch(x, w, corr, bias, out, M, N, K, mult, out_zp,
                  BttNoEpilogue{}, stream);
}

// The same with the Flipout epilogue: out is qadd(mean, qmul(p, sign)) of
// the requantized product p; e->mean uint8 with rows e->ld_mean apart.
int btt_qmatmul_requant_flipout(const uint8_t* x, const int8_t* w,
                                const int32_t* corr, const float* bias,
                                uint8_t* out, int M, int N, int K, float mult,
                                float out_zp, const BttFlipEpilogue* e,
                                cudaStream_t stream) {
  if (e == nullptr || e->mean == nullptr || e->R < 1 || e->ld_mean < N)
    return (int)cudaErrorInvalidValue;
  return dispatch(x, w, corr, bias, out, M, N, K, mult, out_zp, *e, stream);
}

}  // extern "C"
