// K-D and K-E: backward of the fused sampled GEMM (K-B,
// sampled_matmul.cu) with its lane axis, the sampled weight regenerated,
// never stored. For lanes s < S, W_s = mu + sigma * eps(seed, s, n, k):
//
//   K-D: dx[s] = g[s] @ W_s                       (S, M, K)
//   K-E: dmu = sum_s g[s]^T @ x[s];  dsigma = sum_s (g[s]^T @ x[s]) * eps_s
//
// Replace the Pallas kernels _dx_kernel and _dw_kernel (_dx_unbatched,
// _dw_unbatched: the VJP of sampled_matmul_pallas, S = 1) and
// _dx_kernel_s and _dw_kernel_s (_dx_s, _dw_s: the S-batched VJP that the
// vmap emission dispatches) of bayesian_torch_tpu/ops/pallas/
// sampled_matmul.py. JAX's _dw_s writes per-lane (S, N, K) outputs, which
// vmap's transpose then sums over the lanes, because mu and sigma are
// shared by them; K-E returns those sums directly. eps of lane s, weight
// (n, k) is the hash at counter n*K + k under btt_draw_salt(seed, s,
// N*K), as K-B drew it: it depends on (seed, s, n, k) only, never on the
// tiling. Lane 0 of each is the single-draw kernel, bit for bit. Both take
// K-B's counter window (sampled_gemm.cuh): a rank's lanes or a shard's rows
// of the one-process launch draw that launch's eps.
//
// What bounds them on an H100: at the ResNet-50 head (M=128, K=2048,
// N=1000) each lane draws one hash normal per weight element (2.05 M,
// about 90 issued instructions each) and multiplies 0.5 GFLOP (the TPU
// kernels ran at Precision.HIGHEST); mu, sigma, dmu and dsigma are 8 MB
// each. The normals' generation is the bound (5.5 us a lane); the split
// product is 3.2 us at the TF32 peak, the outputs' bytes 4.9 us.
//
// Design. K-D is the body of sampled_gemm.cuh (K-B's): split-TF32 products
// on the tensor cores, producer warps that draw W's tiles while consumer
// warps multiply, and the reduction over N split over a thread-block
// cluster and summed in rank order; W never reaches device memory and each
// weight element is drawn once per lane when M <= 128.
//
// K-E multiplies on the tensor cores with wgmma, asynchronously, in three
// TF32 products (hi*hi + hi*lo + lo*hi, as sampled_gemm.cuh's mma.sync
// products). wgmma takes 32-bit operands K-major only, and gT and x arrive
// with m, the reduction, outermost: the block's threads load each 32-row
// chunk of g and x (a warp reads 32 consecutive columns of a row), split
// every value into its TF32 hi and lo parts and store them transposed,
// [n][m] and [k][m], in the 128-byte swizzled layout that the wgmma
// descriptors read. A block of four warpgroups owns a 128 (n) x 128 (k)
// output tile, one 64 x 64 wgmma tile each: 128 blocks at the head, one
// wave of one block an SM. At S = 1 the next chunk's loads are in flight
// while the tensor cores multiply the current one, and two operand
// buffers let a chunk be split while the last one is multiplied. Then
// each thread draws the eps of the 32 accumulator elements it holds, eight
// normals at a time (btt_hash_normals), and stores dmu and dmu * eps, a
// quad's two adjacent columns as one 8-byte store, so each group's stores
// drain while the next is drawn. With lanes the block walks them in order and adds each lane's
// dmu and dmu * eps to sums in its own shared memory (thread-private, so
// no barrier), lane 0 stored as it is: the lane sum is deterministic,
// needs no atomics, and no (S, N, K) array reaches device memory. x may be
// shared by the lanes (a lane stride of 0), and bf16 (the draw loop's head
// input): read as it is, its TF32 split is exact and the product with its
// lo part is skipped, which gives the bits of its f32 copy. Loads are
// element-wise, at any alignment; ragged edges are zero-filled and not
// stored.
//
// Measured on the H100 (PERF.md, section 6): drawing eps while the tensor
// cores multiply (in registers, or in shared memory) was slower than
// drawing it after the product; so were 64 x 128 tiles (256 blocks) and
// eight warpgroups with half the accumulators each. The hash runs below
// the issue rate on the pipes its conversions, MUFU ops and integer
// multiplies take, not for want of warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sampled_gemm.cuh"

namespace {

// K-D: the body of sampled_gemm.cuh with W's (n, k) tile read as the
// reduction's (n) by the output's (k); the reduction over N is split over a
// cluster of up to eight blocks (four at the head: 256 blocks a lane).
__global__ void __launch_bounds__(btt_sg::kThreads, 2)
    sampled_matmul_dx_kernel(const float* __restrict__ g, int64_t g_lane,
                             const float* __restrict__ mu,
                             const float* __restrict__ sigma,
                             float* __restrict__ dx, int M, int N, int K,
                             int chunk, int m_tiles, uint32_t salt0,
                             uint32_t salt_step, uint32_t ctr0, int vec_a) {
  btt_sg::sampled_gemm<true>(g, g_lane, mu, sigma, dx, M, N, K, chunk,
                             m_tiles, salt0, salt_step, ctr0, vec_a);
}

// K-E. A block of four warpgroups owns a 128 (n) x 128 (k) output tile;
// each multiplies one 64 x 64 quarter with wgmma m64n64k8. The reduction
// over m runs in chunks of 32 rows, one 128-byte swizzle row of TF32
// operands.
namespace dw {

constexpr int kBN = 128;
constexpr int kBK = 128;
constexpr int kThreads = 512;  // a warpgroup per 64 x 64 quarter
constexpr int kChunk = 32;
constexpr int kElems = 32;  // accumulator elements a thread: 64 x 64 / 128
constexpr int kGroup = 8;  // normals drawn at once
// whether the next chunk is loaded a chunk ahead: at S = 1; with lanes its
// registers spill
template <bool kLanes>
constexpr bool kPrefetch = !kLanes;
// shared memory: A = gT [n][m] and B = xT [k][m], K-major, 128-byte
// swizzled (16-byte piece c of row r at piece c ^ (r % 8)), hi and lo
// parts each; then with lanes the lane sums of dmu and dsigma (pair p of
// thread tid at p kThreads + tid: each thread reads back only what it
// wrote)
constexpr int kATile = kBN * 128;
constexpr int kBTile = kBK * 128;
constexpr int kOpBytes = 2 * (kATile + kBTile);  // 64 KB
constexpr int kSumBytes = 8 * kElems * kThreads;  // 128 KB
// S = 1: two operand buffers, so that a chunk is split while the last one
// is multiplied; with lanes one, and the sums
template <bool kLanes>
constexpr int kBuffers = kLanes ? 1 : 2;
constexpr int kPerA = kBN * 8 / kThreads;  // 16-byte pieces a thread: 2
constexpr int kPerB = kBK * 8 / kThreads;  // 2
static_assert(kBN * kBK == kElems * kThreads && kBN * kBK == 64 * 64 * 4,
              "a warpgroup per quarter");
static_assert(1024 + kOpBytes + kSumBytes <= 232448, "one block an SM");

template <bool kLanes>
constexpr int smem_bytes() {
  return 1024 + kBuffers<kLanes> * kOpBytes + (kLanes ? kSumBytes : 0);
}

// A thread's share of one chunk, as loaded: piece i of A is row tid %
// kBN, piece tid / kBN + kThreads / kBN i (m = 4 piece .. + 3); B's alike
// with kBK. A warp reads 32 consecutive n (or k) of one row of g (or x):
// coalesced, at any alignment.
struct Raw {
  float a[kPerA][4];
  float b[kPerB][4];
};

// x is f32, or bf16 read as the f32 of equal value (its TF32 split exact)
__device__ __forceinline__ float x_at(const float* x, int64_t i) {
  return __ldg(x + i);
}
__device__ __forceinline__ float x_at(const __nv_bfloat16* x, int64_t i) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(x) + i) << 16);
}

template <typename XT>
__device__ __forceinline__ void load_raw(const float* __restrict__ g,
                                         const XT* __restrict__ x,
                                         int64_t x_lane, int s, int m0,
                                         int M, int N, int K, int n0, int k0,
                                         int tid, Raw& raw) {
  const float* gl = g + (int64_t)s * M * N;
  const XT* xl = x + (int64_t)s * x_lane;
#pragma unroll
  for (int i = 0; i < kPerA; ++i) {
    const int n = n0 + tid % kBN,
              m = m0 + 4 * (tid / kBN + kThreads / kBN * i);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      raw.a[i][j] =
          m + j < M && n < N ? __ldg(gl + (int64_t)(m + j) * N + n) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPerB; ++i) {
    const int k = k0 + tid % kBK,
              m = m0 + 4 * (tid / kBK + kThreads / kBK * i);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      raw.b[i][j] =
          m + j < M && k < K ? x_at(xl, (int64_t)(m + j) * K + k) : 0.f;
  }
}

// the hi part, and the lo part unless it is 0 (kLo false: bf16 x)
template <bool kLo>
__device__ __forceinline__ void store_piece(uint8_t* hi, uint8_t* lo, int row,
                                            int piece, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) btt_sg::split_tf32(v[j], h[j], l[j]);
  const int off = row * 128 + ((piece ^ (row % 8)) * 16);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  if (kLo)
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

template <bool kXLo>
__device__ __forceinline__ void store_split(uint8_t* ops, int tid,
                                            const Raw& raw) {
#pragma unroll
  for (int i = 0; i < kPerA; ++i)
    store_piece<true>(ops, ops + kATile, tid % kBN,
                      tid / kBN + kThreads / kBN * i, raw.a[i]);
#pragma unroll
  for (int i = 0; i < kPerB; ++i)
    store_piece<kXLo>(ops + 2 * kATile, ops + 2 * kATile + kBTile, tid % kBK,
                      tid / kBK + kThreads / kBK * i, raw.b[i]);
}

// acc += A B over one chunk: four k8 steps of three TF32 products, the
// small terms first (as sampled_gemm.cuh); two when B's lo part is 0
// (bf16 x), which adds the same exact zeros
template <bool kXLo>
__device__ __forceinline__ void mma_chunk(uint32_t ops, int wn, int wk,
                                          float (&acc)[kElems]) {
  const uint32_t a_hi = ops + wn * 128, a_lo = a_hi + kATile;
  const uint32_t b_hi = ops + 2 * kATile + wk * 128;
  const uint32_t b_lo = b_hi + kBTile;
#pragma unroll
  for (int ks = 0; ks < kChunk / 8; ++ks) {
    const uint64_t ah = btt::desc_sw128(a_hi + ks * 32, 16, 1024);
    const uint64_t al = btt::desc_sw128(a_lo + ks * 32, 16, 1024);
    const uint64_t bh = btt::desc_sw128(b_hi + ks * 32, 16, 1024);
    const uint64_t bl = btt::desc_sw128(b_lo + ks * 32, 16, 1024);
    btt::wgmma_tf32_n64(acc, al, bh);
    if (kXLo) btt::wgmma_tf32_n64(acc, ah, bl);
    btt::wgmma_tf32_n64(acc, ah, bh);
  }
}

// Two adjacent columns k, k + 1 (k even) of row n.
__device__ __forceinline__ void store_pair(float* __restrict__ out, int n,
                                           int k, int N, int K, int vec_out,
                                           float a, float b) {
  if (n >= N || k >= K) return;
  const int64_t idx = (int64_t)n * K + k;
  if (vec_out) {
    *reinterpret_cast<float2*>(out + idx) = make_float2(a, b);
  } else {
    out[idx] = a;
    if (k + 1 < K) out[idx + 1] = b;
  }
}

}  // namespace dw

// Accumulator element i = 4 j + q of lane (gq, t) of warp w of the
// warpgroup at (wn, wk) is output (n0 + wn + 16 w + gq + 8 (q / 2), k0 +
// wk + 8 j + 2 t + q % 2): a quad holds 8 adjacent columns of a row.
template <bool kLanes, typename XT>
__global__ void __launch_bounds__(dw::kThreads, 1)
    sampled_matmul_dw_kernel(const float* __restrict__ g,
                             const XT* __restrict__ x, int64_t x_lane,
                             float* __restrict__ dmu,
                             float* __restrict__ dsigma, int S, int M, int N,
                             int K, uint32_t salt0, uint32_t salt_step,
                             uint32_t ctr0, int vec_out) {
  using namespace dw;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = btt::smem_addr(smem_raw);
  uint8_t* ops = smem_raw + ((1024 - (base & 1023)) & 1023);
  const uint32_t ops_addr = btt::smem_addr(ops);
  constexpr int kBufs = kBuffers<kLanes>;
  float2* mu_sum = reinterpret_cast<float2*>(ops + kBufs * kOpBytes);
  float2* sig_sum = mu_sum + kElems / 2 * kThreads;
  const int tid = threadIdx.x;
  // the warpgroup's quarter of the tile: rows wn.., columns wk..
  const int wn = tid / 256 * 64, wk = tid / 128 % 2 * 64;
  const int w = tid / 32 % 4, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int n0 = blockIdx.y * kBN, k0 = blockIdx.x * kBK;
  const int nc = (M + kChunk - 1) / kChunk;
  constexpr int G = kGroup;
  constexpr bool kXLo = std::is_same<XT, float>::value;

  // G normals of a lane at once under its salt, counters from the window's
  // base c0: accumulator elements i0 .. i0 + G - 1
  auto draw = [&](uint32_t salt, uint32_t c0, int i0, float (&e)[G]) {
    uint32_t ctr[G], salts[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int i = i0 + j;
      salts[j] = salt;
      ctr[j] = c0 + (uint32_t)(n0 + wn + 16 * w + gq + 8 * (i % 4 / 2)) *
                   (uint32_t)K +
               (uint32_t)(k0 + wk + 8 * (i / 4) + 2 * t + i % 2);
    }
    btt_hash_normals<G>(salts, ctr, e);
  };

  Raw raw;
  if (kPrefetch<kLanes> && nc > 0)
    load_raw(g, x, x_lane, 0, 0, M, N, K, n0, k0, tid, raw);
  for (int s = 0; s < S; ++s) {
    float acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      if (!kPrefetch<kLanes>)
        load_raw(g, x, x_lane, s, c * kChunk, M, N, K, n0, k0, tid, raw);
      if (c >= kBufs) {
        // this warpgroup's product of chunk c - kBufs, whose buffer this
        // chunk takes, is done
        btt::wgmma_wait<kBufs - 1>();
        btt::fence_regs(acc);
      }
      __syncthreads();  // every warpgroup is done with the buffer
      uint8_t* buf = ops + c % kBufs * kOpBytes;
      store_split<kXLo>(buf, tid, raw);
      btt::fence_async_smem();
      __syncthreads();
      // the next chunk's operands, this lane's or the next lane's first
      const int q = s * nc + c + 1;
      if (kPrefetch<kLanes> && q < S * nc)
        load_raw(g, x, x_lane, q / nc, q % nc * kChunk, M, N, K, n0, k0, tid,
                 raw);
      btt::wgmma_fence();
      btt::fence_regs(acc);
      mma_chunk<kXLo>(ops_addr + c % kBufs * kOpBytes, wn, wk, acc);
      btt::wgmma_commit();
      btt::fence_regs(acc);
    }
    btt::wgmma_wait<0>();
    btt::fence_regs(acc);
    // the lane's salt and the window's counter base, taken here: the empty
    // asm keeps the compiler from holding them, or values it derives from
    // them, in registers across the product, where the kernel's 128 run
    // out (without it every instantiation spills, the lane one 80 bytes;
    // with it none does)
    uint32_t lane_salt = salt0 + (uint32_t)s * salt_step, lane_ctr0 = ctr0;
    asm volatile("" : "+r"(lane_salt), "+r"(lane_ctr0));

    // this lane's eps, G normals at a time, each group's stores draining
    // while the next is drawn; dmu_s and dmu_s * eps_s join the sums in
    // lane order, lane 0 kept as it is, so one lane is the single-draw
    // kernel bit for bit
    float e[G];
#pragma unroll
    for (int i = 0; i < kElems; i += 2) {
      if (i % G == 0) draw(lane_salt, lane_ctr0, i, e);
      float m0 = acc[i], m1 = acc[i + 1];
      // no contraction: rounds as the plain d * eps
      float s0 = __fmul_rn(m0, e[i % G]), s1 = __fmul_rn(m1, e[i % G + 1]);
      if (kLanes) {
        const int p = i / 2 * kThreads + tid;
        if (s > 0) {
          const float2 a = mu_sum[p], b = sig_sum[p];
          m0 = __fadd_rn(a.x, m0);
          m1 = __fadd_rn(a.y, m1);
          s0 = __fadd_rn(b.x, s0);
          s1 = __fadd_rn(b.y, s1);
        }
        if (s + 1 < S) {
          mu_sum[p] = make_float2(m0, m1);
          sig_sum[p] = make_float2(s0, s1);
          continue;
        }
      }
      const int n = n0 + wn + 16 * w + gq + 8 * (i % 4 / 2);
      const int k = k0 + wk + 8 * (i / 4) + 2 * t;
      store_pair(dmu, n, k, N, K, vec_out, m0, m1);
      store_pair(dsigma, n, k, N, K, vec_out, s0, s1);
    }
  }
}

template <bool kLanes, typename XT>
int launch_dw_kernel(const float* g, const XT* x, int64_t x_lane,
                     float* dmu, float* dsigma, int S, int M, int N, int K,
                     btt_ew::Salts salts, cudaStream_t stream) {
  constexpr int bytes = dw::smem_bytes<kLanes>();
  auto kernel = sampled_matmul_dw_kernel<kLanes, XT>;
  // once per instantiation: above 48 KB of dynamic shared memory must be
  // asked for
  static int allowed = -1;
  if (allowed != (int)cudaSuccess) allowed = btt::allow_smem(kernel, bytes);
  if (allowed != (int)cudaSuccess) return allowed;
  const int vec_out = K % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(dmu) % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(dsigma) % 8 == 0;
  const dim3 grid((K + dw::kBK - 1) / dw::kBK, (N + dw::kBN - 1) / dw::kBN);
  kernel<<<grid, dw::kThreads, bytes, stream>>>(
      g, x, x_lane, dmu, dsigma, S, M, N, K, salts.salt0, salts.step,
      salts.ctr0, vec_out);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_dw(const float* g, const XT* x, int64_t x_lane, float* dmu,
              float* dsigma, int S, int M, int N, int K, btt_ew::Salts salts,
              cudaStream_t stream) {
  return S == 1 ? launch_dw_kernel<false>(g, x, x_lane, dmu, dsigma, S, M, N,
                                          K, salts, stream)
                : launch_dw_kernel<true>(g, x, x_lane, dmu, dsigma, S, M, N,
                                         K, salts, stream);
}

}  // namespace

extern "C" {

// g (S, M, N), mu and sigma (N, K), dx (S, M, K); all float32, row-major.
// (lane0, lane_stride, offset): K-B's counter window, (0, N*K, 0) for the
// whole launch. Returns the launch's cudaError_t.
int btt_sampled_matmul_dx(const float* g, const float* mu,
                          const float* sigma, float* dx, int S, int M, int N,
                          int K, uint64_t seed, int64_t lane0,
                          int64_t lane_stride, int64_t offset,
                          cudaStream_t stream) {
  return btt_sg::launch(sampled_matmul_dx_kernel, true, g, (int64_t)M * N,
                        mu, sigma, dx, S, M, N, K,
                        btt_ew::salts(seed, lane0, lane_stride, offset),
                        stream);
}

// g (S, M, N), x (S, M, K) with lane stride x_lane (M*K, or 0 for one x
// shared by the lanes), dmu and dsigma (N, K): sums over the lanes; x f32,
// or bf16 (x_bf16 1), all else float32, row-major. (lane0, lane_stride,
// offset): K-B's counter window, (0, N*K, 0) for the whole launch. Returns
// the launch's cudaGetLastError().
int btt_sampled_matmul_dw(const float* g, const void* x, int64_t x_lane,
                          int x_bf16, float* dmu, float* dsigma, int S, int M,
                          int N, int K, uint64_t seed, int64_t lane0,
                          int64_t lane_stride, int64_t offset,
                          cudaStream_t stream) {
  if (S <= 0 || N <= 0 || K <= 0) return (int)cudaSuccess;
  const btt_ew::Salts salts = btt_ew::salts(seed, lane0, lane_stride, offset);
  if (x_bf16)
    return launch_dw(g, static_cast<const __nv_bfloat16*>(x), x_lane, dmu,
                     dsigma, S, M, N, K, salts, stream);
  return launch_dw(g, static_cast<const float*>(x), x_lane, dmu, dsigma, S,
                   M, N, K, salts, stream);
}

}  // extern "C"
