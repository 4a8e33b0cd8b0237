// The body shared by K-B (sampled_matmul.cu) and K-D's dx kernel
// (sampled_matmul_bwd.cu): a GEMM whose weight operand is drawn inside the
// kernel, lane by lane, W_s = mu + sigma * eps(seed, s, n, k), (N, K):
//
//   forward (kDx false): out[s] = A[s] @ W_s^T   A = x (S, M, K),  out (S, M, N)
//   dx      (kDx true):  out[s] = A[s] @ W_s     A = g (S, M, N),  out (S, M, K)
//
// Below, R is the reduction length (K forward, N for dx) and J the output
// width (N forward, K for dx). eps of weight (n, k) is the hash at counter
// n*K + k under btt_draw_salt(seed, s, N*K): it depends on (seed, s, n, k)
// only, never on the tiling.
//
// A launch may be a window of a larger one (btt_ew::salts): lane s is lane
// lane0 + s of a launch over lane_stride counters a lane, and weight (n, k)
// is that lane's counter offset + n*K + k. A rank's lanes [s0, s1) of an
// S-lane launch take lane0 = s0; a shard of rows [n0, n0 + N) of a weight
// of N_whole rows takes lane_stride = N_whole*K and offset = n0*K. The
// whole launch is the window (0, N*K, 0).
//
// What bounds it on an H100: issuing instructions. At the ResNet-50 head
// (M = 128, K = 2048, N = 1000) one lane draws 2.05 M normals, each two
// hashes, a log, a sqrt and a cos (90 issued instructions), against 0.5
// GFLOP of product that the tensor cores take in a fraction of that time
// even as three TF32 products. The kernel therefore keeps the FP32/INT pipes
// busy with the hash while the tensor cores multiply, and spreads one lane
// over enough blocks to fill the card.
//
// Design:
// - Product: split TF32 on the tensor cores (mma.sync m16n8k8 .tf32, HMMA).
//   Each f32 operand a is split into hi = a with its low 13 mantissa bits
//   cleared and lo = (a - hi), cleared the same way; the sum hi*hi + hi*lo
//   + lo*hi, accumulated in f32, stays within about 2^-20 of the f32
//   product, where one TF32 product misses the port's 1e-4 gate. mma.sync
//   rather than wgmma: its fragments read plain padded row-major tiles that
//   the generator and a cp.async ring write without a swizzle, and the
//   product is not what bounds the kernel. (TMA loads of x, mu and sigma
//   into 128-byte-swizzled tiles, W drawn in place over them, measured
//   slower on the H100 at the head than these copies.)
// - Roles: warps 0-7 produce, warps 8-11 multiply (32 rows x 32 columns
//   each). A producer thread starts the cp.async copies of its share of the
//   A tile (128 x 32) into a ring slot, then draws its 4 weight elements of
//   the slot's (J 32 x R 32) tile from mu and sigma already in registers
//   (the next stage's are loaded meanwhile), and stores W's hi and lo
//   parts. The hash is a long chain of dependent integer and float steps,
//   so many producer warps, each with few elements, keep the pipes issuing.
//   A full barrier per slot completes when every producer has arrived and
//   its copies have landed (cp.async.mbarrier.arrive); the consumers
//   multiply the slot and release it on an empty barrier. Three slots of
//   28 KB: two blocks share an SM.
// - Reduction split over a thread-block cluster: the R axis is cut into
//   `split` slices of whole 32-deep stages, split = min(8, ceil(R / 256)),
//   a function of R alone. The blocks of one cluster take the slices of one
//   (lane, M tile, J tile); each draws its slice of W once. The partial
//   tiles meet in shared memory and each block sums a band of rows over the
//   cluster's ranks in rank order through distributed shared memory, then
//   stores it. The order of every sum is fixed: a call gives the same bits
//   every time, and lane 0 of a launch with lanes is the single-draw
//   launch. At the head forward: 32 J tiles x 8 slices = 256 blocks a lane;
//   dx: 64 x 4 = 256, two for each of the 132 SMs.
// - Ragged edges: out-of-range rows and columns of W are drawn as 0 and
//   their A elements copied as 0 (cp.async zero fill). A is copied in
//   16-byte chunks when its rows are 16-byte aligned (R % 4 == 0, aligned
//   base and lane stride), else element by element (4-byte cp.async).
// - One element of W is drawn once per lane when M <= 128 (one M tile).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"
#include "hopper.cuh"
#include "noise.cuh"

namespace btt_sg {

namespace cg = cooperative_groups;

constexpr int kBM = 128;       // rows of A per block
constexpr int kBJ = 32;        // output columns per block
constexpr int kBR = 32;        // reduction depth of one stage
constexpr int kStages = 3;     // ring slots
constexpr int kMaxSplit = 8;   // blocks of a cluster (the portable maximum)
constexpr int kSliceMin = 256; // reduction elements a slice takes at least
constexpr int kProdWarps = 8;
constexpr int kMmaWarps = 4;
constexpr int kProdThreads = 32 * kProdWarps;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kThreads = kProdThreads + kMmaThreads;

// Shared-memory pitches (floats), chosen so that the mma fragment loads
// hit 32 distinct banks: A and the forward W tile are read at (row g, col
// t) for lane = 4g + t, the dx W tile at (row t, col g).
constexpr int kAPitch = kBR + 4;        // A tile [m][r]
constexpr int kWPitchFwd = kBR + 4;     // forward W tile [j = n][r = k]
constexpr int kWPitchDx = kBJ + 8;      // dx W tile [r = n][j = k]
constexpr int kPPitch = kBJ + 4;        // partial tile [m][j]
constexpr int kAFloats = kBM * kAPitch;                       // 4608
constexpr int kWFloats = kBR * kWPitchDx;                     // 1280
constexpr int kSlotFloats = kAFloats + 2 * kWFloats;          // 7168
constexpr int kPerProd = kBJ * kBR / kProdThreads;            // 4
constexpr int kSmemBytes =
    kStages * kSlotFloats * 4 + 2 * kStages * 8;              // 86064
static_assert(kWFloats >= kBJ * kWPitchFwd, "W slot too small");
static_assert(kBM * kBR % (4 * kProdThreads) == 0, "A copy share");
static_assert(kBM * kPPitch <= kStages * kSlotFloats, "partial tile");
static_assert(kBJ * kBR % kProdThreads == 0, "producer share");

constexpr uint32_t kTf32Mask = 0xFFFFE000u;

__device__ __forceinline__ float tf32_hi(float a) {
  return __uint_as_float(__float_as_uint(a) & kTf32Mask);
}

// a = hi + lo + (what neither keeps), hi and lo exact TF32 values
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32_hi(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(a - h) & kTf32Mask;  // a - h is exact
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// The barrier's phase waits, besides this thread's arrival, for every
// cp.async this thread started before.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Producer thread pt draws the elements at row pt / 32 + 8 i, column
// pt % 32 of its W tile, i < kPerProd: n by k forward ([j][r]) and for dx
// ([r][j]) alike, so a warp reads 32 consecutive k of one row of mu and
// sigma. Out-of-range elements load mu = sigma = 0 and so draw w = 0.
static_assert(kBJ == 32 && kBR == 32, "producer map");
constexpr int kRowStep = kProdThreads / 32;

template <bool kDx>
__device__ __forceinline__ void w_coord(int pt, int i, int j0, int r0, int& n,
                                        int& k) {
  const int row = pt / 32 + kRowStep * i, col = pt % 32;
  n = (kDx ? r0 : j0) + row;
  k = (kDx ? j0 : r0) + col;
}

template <bool kDx>
__device__ __forceinline__ void load_posterior(const float* __restrict__ mu,
                                               const float* __restrict__ sigma,
                                               int N, int K, int pt, int j0,
                                               int r0, float (&m)[kPerProd],
                                               float (&s)[kPerProd]) {
#pragma unroll
  for (int i = 0; i < kPerProd; ++i) {
    int n, k;
    w_coord<kDx>(pt, i, j0, r0, n, k);
    const bool in = n < N && k < K;
    const int64_t idx = in ? (int64_t)n * K + k : 0;
    m[i] = in ? __ldg(mu + idx) : 0.f;
    s[i] = in ? __ldg(sigma + idx) : 0.f;
  }
}

// Draw the producer's elements of one stage and store W's hi and lo parts.
// Each Box-Muller step runs over all elements before the next, with no
// branch on the elements, so their dependent chains interleave.
template <bool kDx>
__device__ __forceinline__ void draw_tile(uint32_t salt, uint32_t ctr0,
                                          int K, int pt, int j0, int r0,
                                          const float (&m)[kPerProd],
                                          const float (&s)[kPerProd],
                                          float* w_hi, float* w_lo) {
  float u1[kPerProd], u2[kPerProd], r[kPerProd];
#pragma unroll
  for (int i = 0; i < kPerProd; ++i) {
    int n, k;
    w_coord<kDx>(pt, i, j0, r0, n, k);
    btt_hash_uniforms(salt, ctr0 + (uint32_t)n * (uint32_t)K + (uint32_t)k,
                      u1[i], u2[i]);
  }
#pragma unroll
  for (int i = 0; i < kPerProd; ++i) r[i] = btt_box_muller_log(u1[i]);
#pragma unroll
  for (int i = 0; i < kPerProd; ++i) r[i] = sqrtf(r[i]);
  const int off = (pt / 32) * (kDx ? kWPitchDx : kWPitchFwd) + pt % 32;
#pragma unroll
  for (int i = 0; i < kPerProd; ++i) {
    const float eps = r[i] * btt_box_muller_cos(u2[i]);
    // no contraction: rounds as the plain mu + sigma * eps
    const float w = __fadd_rn(m[i], __fmul_rn(s[i], eps));
    uint32_t hi, lo;
    split_tf32(w, hi, lo);
    const int o = off + i * kRowStep * (kDx ? kWPitchDx : kWPitchFwd);
    w_hi[o] = __uint_as_float(hi);
    w_lo[o] = __uint_as_float(lo);
  }
}

template <bool kDx>
__device__ __forceinline__ void sampled_gemm(
    const float* __restrict__ a, int64_t a_lane, const float* __restrict__ mu,
    const float* __restrict__ sigma, float* __restrict__ out, int M, int N,
    int K, int chunk, int m_tiles, uint32_t salt0, uint32_t salt_step,
    uint32_t ctr0, int vec_a) {
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = kDx ? N : K;
  const int J = kDx ? K : N;
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane_s = blockIdx.z / m_tiles;
  const int m0 = (blockIdx.z - lane_s * m_tiles) * kBM;
  const int j0 = blockIdx.y * kBJ;
  const int r_begin = min(R, rank * chunk);
  const int r_end = min(R, r_begin + chunk);
  const int n_stages = (r_end - r_begin + kBR - 1) / kBR;
  a += (int64_t)lane_s * a_lane;
  out += (int64_t)lane_s * M * J;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kSlotFloats);
  const uint32_t full0 = btt::smem_addr(bars);
  const uint32_t empty0 = btt::smem_addr(bars + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      btt::mbar_init(full0 + 8 * s, kProdThreads);
      btt::mbar_init(empty0 + 8 * s, kMmaThreads);
    }
    btt::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp < kProdWarps) {
    // --- producers: A by cp.async, W drawn into hi and lo parts ---------
    const int pt = threadIdx.x;
    const uint32_t salt = salt0 + (uint32_t)lane_s * salt_step;
    const int a_row4 = pt / 8, a_col4 = 4 * (pt % 8);
    const int a_row = pt / 32, a_col = pt % 32;
    const float* a_src4 = a + (int64_t)(m0 + a_row4) * R + a_col4;
    const float* a_src = a + (int64_t)(m0 + a_row) * R + a_col;
    float mc[kPerProd], sc[kPerProd], mn[kPerProd], sn[kPerProd];
    if (n_stages > 0)
      load_posterior<kDx>(mu, sigma, N, K, pt, j0, r_begin, mc, sc);
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kStages;
      const uint32_t phase = (st / kStages) & 1;
      const int r0 = r_begin + st * kBR;
      float* as = smem + slot * kSlotFloats;
      float* w_hi = as + kAFloats;
      float* w_lo = w_hi + kWFloats;
      btt::mbar_wait(empty0 + 8 * slot, phase ^ 1);
      const uint32_t dst = btt::smem_addr(as);
      if (vec_a) {
        // chunk pt + 256 i: row pt / 8 + 32 i, columns 4 (pt % 8) + 0..3
        const bool col_in = r0 + a_col4 < R;
#pragma unroll
        for (int i = 0; i < kBM * kBR / 4 / kProdThreads; ++i) {
          const bool in = col_in && a_row4 + 32 * i < M - m0;
          cp_async16(dst + 4 * ((a_row4 + 32 * i) * kAPitch + a_col4),
                     in ? a_src4 + i * 32 * (int64_t)R + r0 : a, in);
        }
      } else {
        // element pt + 256 i: row pt / 32 + 8 i, column pt % 32
        const bool col_in = r0 + a_col < R;
#pragma unroll 8
        for (int i = 0; i < kBM * kBR / kProdThreads; ++i) {
          const bool in = col_in && a_row + 8 * i < M - m0;
          cp_async4(dst + 4 * ((a_row + 8 * i) * kAPitch + a_col),
                    in ? a_src + i * 8 * (int64_t)R + r0 : a, in);
        }
      }
      cp_async_arrive(full0 + 8 * slot);
      if (st + 1 < n_stages)
        load_posterior<kDx>(mu, sigma, N, K, pt, j0, r0 + kBR, mn, sn);
      draw_tile<kDx>(salt, ctr0, K, pt, j0, r0, mc, sc, w_hi, w_lo);
      btt::mbar_arrive(full0 + 8 * slot);
#pragma unroll
      for (int i = 0; i < kPerProd; ++i) {
        mc[i] = mn[i];
        sc[i] = sn[i];
      }
    }
  } else {
    // --- consumers: 32 rows x 32 columns each, three TF32 products -----
    const int wm = warp - kProdWarps;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    float acc[2][kBJ / 8][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int jf = 0; jf < kBJ / 8; ++jf)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mf][jf][q] = 0.f;
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % kStages;
      btt::mbar_wait(full0 + 8 * slot, (st / kStages) & 1);
      const float* as = smem + slot * kSlotFloats;
      const float* w_hi = as + kAFloats;
      const float* w_lo = w_hi + kWFloats;
#pragma unroll
      for (int kk = 0; kk < kBR; kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = as + (wm * 32 + mf * 16 + g) * kAPitch + kk + t;
          split_tf32(p[0], ahi[mf][0], alo[mf][0]);
          split_tf32(p[8 * kAPitch], ahi[mf][1], alo[mf][1]);
          split_tf32(p[4], ahi[mf][2], alo[mf][2]);
          split_tf32(p[8 * kAPitch + 4], ahi[mf][3], alo[mf][3]);
        }
#pragma unroll
        for (int jf = 0; jf < kBJ / 8; ++jf) {
          const int o0 = kDx ? (kk + t) * kWPitchDx + jf * 8 + g
                             : (jf * 8 + g) * kWPitchFwd + kk + t;
          const int o1 = kDx ? o0 + 4 * kWPitchDx : o0 + 4;
          const uint32_t bh0 = __float_as_uint(w_hi[o0]);
          const uint32_t bh1 = __float_as_uint(w_hi[o1]);
          const uint32_t bl0 = __float_as_uint(w_lo[o0]);
          const uint32_t bl1 = __float_as_uint(w_lo[o1]);
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) {
            // the small terms first, then hi * hi
            mma_tf32(acc[mf][jf], alo[mf], bh0, bh1);
            mma_tf32(acc[mf][jf], ahi[mf], bl0, bl1);
            mma_tf32(acc[mf][jf], ahi[mf], bh0, bh1);
          }
        }
      }
      btt::mbar_arrive(empty0 + 8 * slot);
    }
    // every slot has been consumed: wait for the other consumers before the
    // ring's first slots take the partial tile
    btt::named_sync(1, kMmaThreads);
    float* part = smem;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int jf = 0; jf < kBJ / 8; ++jf) {
        float* p = part + (wm * 32 + mf * 16 + g) * kPPitch + jf * 8 + 2 * t;
        p[0] = acc[mf][jf][0];
        p[1] = acc[mf][jf][1];
        p[8 * kPPitch] = acc[mf][jf][2];
        p[8 * kPPitch + 1] = acc[mf][jf][3];
      }
  }

  // --- the split's partial tiles summed in rank order ---------------------
  cluster.sync();
  const int band = (kBM + split - 1) / split;
  const int row_lo = rank * band;
  const int rows = max(0, min(min(kBM, M - m0), row_lo + band) - row_lo);
  for (int e = threadIdx.x; e < rows * kBJ; e += kThreads) {
    const int row = row_lo + e / kBJ, col = e % kBJ;
    if (j0 + col >= J) continue;
    const int off = row * kPPitch + col;
    float v = cluster.map_shared_rank(smem, 0)[off];
    for (int q = 1; q < split; ++q)
      v = __fadd_rn(v, cluster.map_shared_rank(smem, q)[off]);
    out[(int64_t)(m0 + row) * J + j0 + col] = v;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// One launch of the kernel `kernel` (a __global__ wrapper of sampled_gemm)
// over S lanes, in the counter window `salts`; returns a cudaError_t code.
template <typename Kernel>
inline int launch(Kernel kernel, bool dx, const float* a, int64_t a_lane,
                  const float* mu, const float* sigma, float* out, int S,
                  int M, int N, int K, btt_ew::Salts salts,
                  cudaStream_t stream) {
  const int R = dx ? N : K;
  const int J = dx ? K : N;
  if (S <= 0 || M <= 0 || J <= 0) return (int)cudaSuccess;
  const int want = (R + kSliceMin - 1) / kSliceMin;
  const int split = want < 1 ? 1 : want > kMaxSplit ? kMaxSplit : want;
  const int per = (R + split - 1) / split;
  const int chunk = (per + kBR - 1) / kBR * kBR;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int vec_a = R % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    a_lane % 4 == 0;
  // once per kernel: above 48 KB of dynamic shared memory must be asked for
  static int allowed[2] = {-1, -1};
  if (allowed[dx] != (int)cudaSuccess)
    allowed[dx] = btt::allow_smem(kernel, kSmemBytes);
  if (allowed[dx] != (int)cudaSuccess) return allowed[dx];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (J + kBJ - 1) / kBJ, S * m_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(
      &cfg, kernel, a, a_lane, mu, sigma, out, M, N, K, chunk, m_tiles,
      salts.salt0, salts.step, salts.ctr0, vec_a);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaGetLastError();
}

}  // namespace btt_sg
