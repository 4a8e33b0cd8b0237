// K-G: the per-draw GEMM behind a pointwise (1x1, stride 1) convolution,
//   y[b, s, o, p] = sum_c w[s, o, c] * x[b, s, c, p]   (+ bias[s, o])
// with x (B, S, C, P), P = H*W contiguous (the NC* activations of the
// draw-axis emission: draw s in channel block s, so neither side is
// relaid), w (S, O, C) and y (B, S, O, P). A shared input (one x for all
// draws) and a shared weight (one w for all draws) are the same kernel
// with a lane stride of 0. Element types: bf16 -> bf16 and f32 -> f32 with
// f32 accumulation, s8 x s8 -> s32. The bias is added in the output type
// after the cast, as the convolution op adds it.
//
// Replaces two Pallas kernels: _gemm_kernel of benchmarks/bench_1x1_mc.py
// (pallas_mc_gemm: x (M, S, C) . w (S, C, O) -> (M, S, O), the draw axis
// riding whole inside each block) and _mm_kernel of
// benchmarks/bench_mosaic_matmul.py (pallas_matmul: a plain tiled GEMM in
// bf16 and s8), which is this kernel at S = 1, B = 1: (M, K) @ (K, N) is
// w (1, M, K), x (1, 1, K, N).
//
// What bounds it on an H100: at Bayesian ResNet-50's 1x1 sites (batch 128,
// 10 draws, bf16) every site but three moves more bytes than the tensor
// cores need time for (64 -> 256 channels at 56x56: 2.6 GB for 0.13 TFLOP);
// 1024 -> 512 at 14x14 and both 7x7 sites are bound by operations, as are
// the square GEMMs of the matmul probe.
//
// Design (a first kernel, right and simple): a block owns a 64 (O) x 64 (P)
// output tile of one (b, s) and walks C in steps of 64 bytes through shared
// memory, the next step's global loads held in registers while the tensor
// cores work on the current one. Four warps, 2 x 2, each 32 x 32, with
// mma.sync m16n8k16 (bf16, f32 accumulators) or m16n8k32 (s8, s32). w
// tiles are (O, C) with C contiguous, the row-major A operand as it is. x
// tiles are (C, P) with P contiguous, a row-major K x N operand where the
// instruction wants K contiguous per column: bf16 tiles stay (C, P) in
// shared memory and ldmatrix.trans hands each thread its transposed
// fragment; s8 tiles are transposed in registers (4 x 4 byte blocks,
// __byte_perm) on their way into an (P, C) shared tile. Output tiles along
// O are the fastest grid axis, so the blocks that share an activation tile
// run together and re-read it from L2, not from device memory. Rows of x
// at 7x7 are 98 bytes: loads fall back from 16 to 8, 4, 2 or single bytes
// by what the row length and the base pointer allow, out-of-range elements
// load as 0 and stores are masked. The f32 lane runs on the CUDA cores (a
// 64 x 64 tile, 4 x 4 outputs a thread): full f32 products, which TF32
// would not give. The TPU kernels' sequential C grid axis is the in-block
// loop. No cp.async, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output channels per block
constexpr int kBN = 64;       // positions per block
constexpr int kKBytes = 64;   // bytes of C per step, two mma k-steps
constexpr int kThreads = 128;
// w tile and the s8 x tile: 64 rows of 64 bytes, padded to 80 (20 words):
// the 8 rows x 4 words of one fragment load fall on 32 distinct banks
constexpr int kLdA = kKBytes + 16;
// bf16 x tile: 32 rows (C) of 64 elements (P), padded to 144 bytes: rows
// stay 16-byte aligned for ldmatrix and 8 rows fall on distinct banks
constexpr int kLdB = kBN * 2 + 16;

struct Geom {
  int S, O, C, P;
  int64_t x_batch, x_lane, w_lane, b_lane;  // strides in elements
};

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  using Out = __nv_bfloat16;
  static constexpr int kBBytes = (kKBytes / 2) * kLdB;
};
template <>
struct Elem<int8_t> {
  using Acc = int;
  using Out = int;
  static constexpr int kBBytes = kBN * kLdA;
};

// Up to 16 bytes from p, of which `avail` lie inside the row (<= 0: none);
// the rest are 0. `vec` is the widest load the row length and the base
// pointer allow: 16, 8, 4, 2 or 1 bytes.
__device__ __forceinline__ uint4 load_bytes16(const uint8_t* __restrict__ p,
                                              int avail, int vec) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (avail > 0) {
    if (vec == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      return q;
    } else if (vec == 8) {
      const uint2 lo = *reinterpret_cast<const uint2*>(p);
      v[0] = lo.x;
      v[1] = lo.y;
      if (avail > 8) {
        const uint2 hi = *reinterpret_cast<const uint2*>(p + 8);
        v[2] = hi.x;
        v[3] = hi.y;
      }
    } else if (vec == 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (avail > 4 * j)
          v[j] = *reinterpret_cast<const uint32_t*>(p + 4 * j);
    } else if (vec == 2) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (avail > 2 * j)
          v[j / 2] |=
              (uint32_t)(*reinterpret_cast<const uint16_t*>(p + 2 * j))
              << (16 * (j % 2));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < avail) v[j / 4] |= (uint32_t)p[j] << (8 * (j % 4));
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Four bytes of row `k` from byte column `n` of a (rows, row_bytes) matrix.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ m,
                                              int rows, int row_bytes, int k,
                                              int n, int vec) {
  if (k >= rows || n >= row_bytes) return 0u;
  const uint8_t* p = m + (int64_t)k * row_bytes + n;
  if (vec >= 4) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < row_bytes) v |= (uint32_t)p[j] << (8 * j);
  return v;
}

__device__ __forceinline__ void mma_tile(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tile(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ __nv_bfloat16 finish(float acc,
                                                const __nv_bfloat16* bias) {
  __nv_bfloat16 r = __float2bfloat16(acc);
  if (bias != nullptr)
    r = __float2bfloat16(__fadd_rn(__bfloat162float(r),
                                   __bfloat162float(*bias)));
  return r;
}

__device__ __forceinline__ int finish(int acc, const int*) { return acc; }

// Two neighbouring outputs in one store; dst is aligned to the pair.
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst,
                                           __nv_bfloat16 v0,
                                           __nv_bfloat16 v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(v0, v1);
}

__device__ __forceinline__ void store_pair(int* dst, int v0, int v1) {
  *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mc_gemm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const typename Elem<T>::Out* __restrict__ bias,
                       typename Elem<T>::Out* __restrict__ y, Geom g,
                       int xvec, int wvec) {
  using Acc = typename Elem<T>::Acc;
  using Out = typename Elem<T>::Out;
  constexpr bool kIsS8 = sizeof(T) == 1;
  constexpr int kBK = kKBytes / (int)sizeof(T);  // elements of C per step
  __shared__ __align__(16) uint8_t As[kBM * kLdA];
  __shared__ __align__(16) uint8_t Bs[Elem<T>::kBBytes];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gid = lane / 4;  // fragment row group
  const int t = lane % 4;    // thread in group
  const int wm = (warp % 2) * 32;
  const int wn = (warp / 2) * 32;
  const int o0 = blockIdx.x * kBM;
  const int p0 = blockIdx.y * kBN;
  const int bs = blockIdx.z;
  const int b = bs / g.S;
  const int s = bs % g.S;
  const uint8_t* wp = reinterpret_cast<const uint8_t*>(w + s * g.w_lane);
  const uint8_t* xp =
      reinterpret_cast<const uint8_t*>(x + b * g.x_batch + s * g.x_lane);
  const int w_row = g.C * (int)sizeof(T);  // bytes in a row of w
  const int x_row = g.P * (int)sizeof(T);  // bytes in a row of x

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  uint4 ra[2];
  uint4 rb[2];

  // the step's global loads, into registers
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kThreads;
      const int row = o0 + chunk / 4;
      const int col = k0 * (int)sizeof(T) + (chunk % 4) * 16;
      ra[i] = load_bytes16(wp + (int64_t)row * w_row + col,
                           row < g.O ? w_row - col : 0, wvec);
    }
    if constexpr (kIsS8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int blk = tid + i * kThreads;
        const int n = p0 + (blk % 16) * 4;
        const int k = k0 + (blk / 16) * 4;
        rb[i].x = load_word(xp, g.C, x_row, k, n, xvec);
        rb[i].y = load_word(xp, g.C, x_row, k + 1, n, xvec);
        rb[i].z = load_word(xp, g.C, x_row, k + 2, n, xvec);
        rb[i].w = load_word(xp, g.C, x_row, k + 3, n, xvec);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int chunk = tid + i * kThreads;
        const int row = k0 + chunk / 8;
        const int col = p0 * 2 + (chunk % 8) * 16;
        rb[i] = load_bytes16(xp + (int64_t)row * x_row + col,
                             row < g.C ? x_row - col : 0, xvec);
      }
    }
  };

  // registers -> shared memory
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[(chunk / 4) * kLdA + (chunk % 4) * 16]) =
          ra[i];
    }
    if constexpr (kIsS8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int blk = tid + i * kThreads;
        const int n = (blk % 16) * 4;
        const int k = (blk / 16) * 4;
        // rb holds 4 rows (k) of 4 bytes (n): transpose the 4 x 4 block
        const uint32_t t0 = __byte_perm(rb[i].x, rb[i].y, 0x5140);
        const uint32_t t1 = __byte_perm(rb[i].z, rb[i].w, 0x5140);
        const uint32_t t2 = __byte_perm(rb[i].x, rb[i].y, 0x7362);
        const uint32_t t3 = __byte_perm(rb[i].z, rb[i].w, 0x7362);
        *reinterpret_cast<uint32_t*>(&Bs[(n + 0) * kLdA + k]) =
            __byte_perm(t0, t1, 0x5410);
        *reinterpret_cast<uint32_t*>(&Bs[(n + 1) * kLdA + k]) =
            __byte_perm(t0, t1, 0x7632);
        *reinterpret_cast<uint32_t*>(&Bs[(n + 2) * kLdA + k]) =
            __byte_perm(t2, t3, 0x5410);
        *reinterpret_cast<uint32_t*>(&Bs[(n + 3) * kLdA + k]) =
            __byte_perm(t2, t3, 0x7632);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int chunk = tid + i * kThreads;
        *reinterpret_cast<uint4*>(
            &Bs[(chunk / 8) * kLdB + (chunk % 8) * 16]) = rb[i];
      }
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < g.C; k0 += kBK) {
    stage();
    __syncthreads();
    if (k0 + kBK < g.C) fetch(k0 + kBK);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kb = ks * 32;  // byte offset of this k-step in a tile row
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* r0 = &As[(wm + i * 16 + gid) * kLdA + kb + t * 4];
        const uint8_t* r8 = r0 + 8 * kLdA;
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
      uint32_t bf[4][2];
      if constexpr (kIsS8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint8_t* c = &Bs[(wn + j * 8 + gid) * kLdA + kb + t * 4];
          bf[j][0] = *reinterpret_cast<const uint32_t*>(c);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(c + 16);
        }
      } else {
        // four 8 x 8 matrices per load: (k 0-7, n), (k 8-15, n),
        // (k 0-7, n + 8), (k 8-15, n + 8); .trans gives each thread
        // k = 2t, 2t+1 of column gid, the B fragment
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int row = ks * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
          const int col = wn + jp * 16 + 8 * (lane / 16);
          const uint32_t addr = (uint32_t)__cvta_generic_to_shared(
              &Bs[row * kLdB + col * 2]);
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0, %1, %2, %3}, [%4];\n"
              : "=r"(bf[2 * jp][0]), "=r"(bf[2 * jp][1]),
                "=r"(bf[2 * jp + 1][0]), "=r"(bf[2 * jp + 1][1])
              : "r"(addr));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_tile(acc[i][j], a[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();
  }

  const Out* brow = bias != nullptr ? bias + s * g.b_lane : nullptr;
  Out* yb = y + (int64_t)bs * g.O * g.P;
  // with P even every (p, p + 1) pair of a fragment starts at an even
  // element of y: one store for both
  const bool pairs = g.P % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = o0 + wm + i * 16 + gid + half * 8;
      if (o >= g.O) continue;
      const Out* bo = brow != nullptr ? brow + o : nullptr;
      Out* yrow = yb + (int64_t)o * g.P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + wn + j * 8 + t * 2;
        if (p >= g.P) continue;
        const Out v0 = finish(acc[i][j][half * 2], bo);
        const Out v1 = finish(acc[i][j][half * 2 + 1], bo);
        if (pairs && p + 1 < g.P) {
          store_pair(yrow + p, v0, v1);
        } else {
          yrow[p] = v0;
          if (p + 1 < g.P) yrow[p + 1] = v1;
        }
      }
    }
  }
}

// The f32 lane, on the CUDA cores: full f32 products and sums.
constexpr int kFK = 16;
constexpr int kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    mc_gemm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y,
                       Geom g) {
  __shared__ float As[kFK][kBM + 4];  // (c, o)
  __shared__ float Bs[kFK][kBN + 4];  // (c, p)
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int o0 = blockIdx.x * kBM;
  const int p0 = blockIdx.y * kBN;
  const int bs = blockIdx.z;
  const int b = bs / g.S;
  const int s = bs % g.S;
  const float* wp = w + s * g.w_lane;
  const float* xp = x + b * g.x_batch + s * g.x_lane;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.C; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kFThreads;
      const int m = e / kFK, k = e % kFK;
      As[k][m] = (o0 + m < g.O && k0 + k < g.C)
                     ? wp[(int64_t)(o0 + m) * g.C + k0 + k]
                     : 0.f;
      const int kk = e / kBN, n = e % kBN;
      Bs[kk][n] = (k0 + kk < g.C && p0 + n < g.P)
                      ? xp[(int64_t)(k0 + kk) * g.P + p0 + n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float* brow = bias != nullptr ? bias + s * g.b_lane : nullptr;
  float* yb = y + (int64_t)bs * g.O * g.P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty * 4 + i;
    if (o >= g.O) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      if (p >= g.P) continue;
      float v = acc[i][j];
      if (brow != nullptr) v = __fadd_rn(v, brow[o]);
      yb[(int64_t)o * g.P + p] = v;
    }
  }
}

}  // namespace

extern "C" {

// x (B, S or 1, C, P), w (S or 1, O, C), bias (S or 1, O) or NULL, y
// (B, S, O, P), all row-major; dtype 0: bf16 -> bf16, 1: f32 -> f32, 2: s8
// -> s32 (no bias). Strides are in elements; a lane stride of 0 shares the
// operand between the draws. xvec / wvec: the widest load in bytes (16, 8,
// 4, 2 or 1) that the rows of x / w allow (row length and base pointer both
// multiples of it). Returns the launch's cudaGetLastError().
int btt_mc_gemm(const void* x, const void* w, const void* bias, void* y,
                int dtype, int B, int S, int O, int C, int P,
                int64_t x_batch, int64_t x_lane, int64_t w_lane,
                int64_t b_lane, int xvec, int wvec, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || O <= 0 || P <= 0) return (int)cudaSuccess;
  const int64_t lanes = (int64_t)B * S;
  const int ptiles = (P + kBN - 1) / kBN;
  if (lanes > 65535 || ptiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((O + kBM - 1) / kBM, ptiles, (unsigned)lanes);
  const Geom g = {S, O, C, P, x_batch, x_lane, w_lane, b_lane};
  if (dtype == 0) {
    mc_gemm_mma_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(y), g, xvec, wvec);
  } else if (dtype == 1) {
    mc_gemm_f32_kernel<<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), g);
  } else if (dtype == 2) {
    mc_gemm_mma_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        nullptr, static_cast<int*>(y), g, xvec, wvec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
