// K-F: fused int8 GEMM + requantize epilogue,
//   acc[m, n] = sum_k (x[m, k] - 128) * w[n, k]          (s32, exact)
//   out[m, n] = clamp(rint(f32(acc + corr[n]) * mult + bias[n]) + out_zp,
//                     0, 255)                              (uint8)
// with x uint8 (M, K), w int8 (N, K), corr = (128 - x_zp) * colsum(w) or
// NULL, bias = bias_f32 / out_scale or NULL (the wrapper computes both).
//
// Replaces the Pallas kernel _kernel of
// bayesian_torch_tpu/ops/pallas/qmatmul.py (qmatmul_requant), which keeps
// the s32 accumulator in VMEM and writes the requantized uint8 tile. The
// epilogue here is the one of the JAX XLA route (ops/int8.py qlinear:
// integer correction, then one f32 multiply, one f32 add, round half to
// even), not the TPU kernel's folded beta, so kernel, plain torch version
// and the JAX default route agree bit for bit. __fmul_rn / __fadd_rn keep
// the multiply and add from contracting into an FMA.
//
// What bounds it on an H100: at Bayesian ResNet-50's shapes (batch 128)
// the stem and layer1-2 launches move more bytes than the int8 tensor
// cores need time for (the stem's im2col patches are 236 MB of uint8 for
// 30 G int8 operations); the wide layer3-4 GEMMs (M <= 25,088 rows, K and
// N of 512 or more) are bound by operations. One forward's 54 launches:
// 4.2 GB and 1.05 T operations, a 1.3 ms bound, bytes the larger part.
//
// Design (a first kernel, right and simple): each block owns a 128 x 64
// output tile and walks K in steps of 32 through shared memory. x is
// centred to s8 while it is loaded (x ^ 0x80 == x - 128 as s8). Eight
// warps, 4 along M and 2 along N, each compute 32 x 32 with
// mma.sync.m16n8k32 s8 x s8 -> s32 in registers. Rows past M, columns
// past N and K past its end load as 0 (a zero weight adds nothing, whatever
// x holds). The s32 accumulator never reaches device memory: the epilogue
// writes uint8 from registers. The TPU kernel's sequential K grid axis is
// the in-block K loop. No cp.async, TMA or wgmma yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
// a shared row of 48 bytes (12 words) puts the 8 rows x 4 words of one
// fragment load on 32 distinct banks
constexpr int kLd = kBK + 16;
constexpr int kThreads = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of row `row` from column `col` of a (rows, K) byte matrix into
// shared memory, bytes XOR `flip`; out-of-range bytes are 0. `vec`: K is a
// multiple of 16 and the base 16-byte aligned, so one vector load does.
__device__ __forceinline__ void load16(const uint8_t* __restrict__ src,
                                       int rows, int K, int row, int col,
                                       uint32_t flip, bool vec,
                                       uint8_t* dst) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows) {
    const uint8_t* p = src + (int64_t)row * K + col;
    if (vec) {
      if (col < K) {
        v = *reinterpret_cast<const uint4*>(p);
        v.x ^= flip;
        v.y ^= flip;
        v.z ^= flip;
        v.w ^= flip;
      }
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (col + j < K)
          w[j / 4] |= (uint32_t)(p[j] ^ (uint8_t)flip) << (8 * (j % 4));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

__global__ void __launch_bounds__(kThreads)
    qmatmul_requant_kernel(const uint8_t* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const int32_t* __restrict__ corr,
                           const float* __restrict__ bias,
                           uint8_t* __restrict__ out, int M, int N, int K,
                           float mult, float out_zp, bool vec) {
  __shared__ __align__(16) uint8_t xs[kBM][kLd];
  __shared__ __align__(16) uint8_t ws[kBN][kLd];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int lrow = tid / 2;         // 0..127
  const int lcol = (tid % 2) * 16;  // 0 or 16
  for (int k0 = 0; k0 < K; k0 += kBK) {
    load16(x, M, K, m0 + lrow, k0 + lcol, 0x80808080u, vec,
           &xs[lrow][lcol]);
    if (lrow < kBN)
      load16(wb, N, K, n0 + lrow, k0 + lcol, 0u, vec, &ws[lrow][lcol]);
    __syncthreads();
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + i * 16 + g;
      a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][t * 4]);
      a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][t * 4]);
      a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][16 + t * 4]);
      a[i][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + j * 8 + g;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ws[c][t * 4]);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(&ws[c][16 + t * 4]);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn + j * 8 + t * 2 + h;
      if (n >= N) continue;
      const int cn = corr != nullptr ? corr[n] : 0;
      const float bn = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wm + i * 16 + g + half * 8;
          if (m >= M) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][half * 2 + h] + cn),
                              mult);
          if (bias != nullptr) v = __fadd_rn(v, bn);
          v = __fadd_rn(rintf(v), out_zp);
          v = fminf(fmaxf(v, 0.f), 255.f);
          out[(int64_t)m * N + n] = (uint8_t)v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x uint8 (M, K) and w int8 (N, K) row-major; corr int32 (N,) or NULL;
// bias float32 (N,) or NULL; out uint8 (M, N). `vec` asks for 16-byte
// loads: K % 16 == 0 and x, w 16-byte aligned. Returns the launch's
// cudaGetLastError().
int btt_qmatmul_requant(const uint8_t* x, const int8_t* w,
                        const int32_t* corr, const float* bias, uint8_t* out,
                        int M, int N, int K, float mult, float out_zp,
                        int vec, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  qmatmul_requant_kernel<<<grid, kThreads, 0, stream>>>(
      x, w, corr, bias, out, M, N, K, mult, out_zp, vec != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
