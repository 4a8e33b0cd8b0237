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
// w (1, M, K), x (1, 1, K, N). The backward's input gradient (dx = w^T g)
// is this kernel on the transposed weight.
//
// What bounds it on an H100: at Bayesian ResNet-50's 1x1 sites (batch 128,
// 10 draws, bf16) every site but three moves more bytes than the tensor
// cores need time for (64 -> 256 channels at 56x56: 2.6 GB for 0.13 TFLOP);
// 1024 -> 512 at 14x14 and both 7x7 sites are bound by operations, as are
// the square GEMMs of the matmul probe.
//
// The bf16 lane (every model path) is built for Hopper. A block owns a
// 64*WG (O) x 128 (positions) output tile and walks C in stages of 64
// through a ring of up to three shared-memory stages under mbarriers: a
// producer fills it, WG consumer warpgroups (2, or 1 when O <= 64) each
// run wgmma.m64n128k16 on their 64 rows with f32 accumulators in
// registers, releasing a stage once the wgmma that read it has retired.
// The weight tile (O, C) is K-major, as wgmma wants A, and comes by TMA
// (cp.async.bulk.tensor, 128-byte swizzle; the wrapper pads C to a
// multiple of 8 with zeros so the tensor map can describe it). The
// activation tile (C, P) is MN-major, P contiguous: wgmma reads it through
// the transpose bit of B, so x needs no relayout (the first kernel's
// ldmatrix.trans goes). Rows past O, C and P load as 0 (TMA's zero fill,
// or the masks). Output goes through shared memory (the ring, once the
// consumers are done with it) and leaves in coalesced, masked stores.
// Three ways to bring x, by what its layout allows:
// - TMA (P a multiple of 8: 56x56, 28x28, the probe): two 64-column atoms
//   a stage, the block's 128 positions in one image, one producer warp.
//   Every 56x56 and 28x28 site is bound by bytes, and a block there walks
//   only 1-8 stages, so its load, product and store barely overlap within
//   the block: the ring is sized to C (at most three stages) so that two
//   blocks share an SM and one's loads overlap the other's epilogue.
// - At 14x14 and 7x7 rows are 392 and 98 bytes, which no tensor map
//   takes: a block's 128 positions run across the images of one draw (no
//   column of the tile is wasted, where a 64-wide tile per image wasted
//   23 % at 7x7). Where C <= 512 and O > 128 (256 -> 1024 @ 14x14,
//   512 -> 2048 @ 7x7), every O tile would gather the same x tile again:
//   mc_gemm_xres_kernel gathers the whole (C, 128) tile into shared memory
//   once and walks all O tiles over it, the weight streaming by TMA.
// - Otherwise a producer warpgroup refills the ring: at 7x7 from slabs
//   (for one (b, s) the 64 rows of a stage are one contiguous, aligned
//   run of 64 * P elements, brought by one bulk copy per image, then moved
//   through shared memory into the swizzled layout), at 14x14 and for
//   ragged shapes with the widest global loads P allows (8, 4 or 2
//   bytes), issued before the wait for a free stage.
// What holds it back at 14x14 and 7x7 is the gather: register loads of 98-
// and 392-byte rows, or slabs carrying 1.5x the tile's positions; a
// relayout of x by the layer that writes it would make every site a TMA
// site.
//
// The int8 lane (the matmul probe only, no model path) and the f32 lane
// keep the first kernel's code: the s8 wgmma wants both operands K-major,
// so the MN-major x would need the transpose that lane does in registers
// (a 64 x 64 tile, mma.sync m16n8k32, register-staged loads); the f32 lane
// runs on the CUDA cores (full f32 products, which TF32 would not give).
//
// K-G channels-last (namespace cl, entry btt_mc_gemm_cl) is the same
// product on channels-last activations x (M, S, C), the layout the TPU
// kernels read: see its own notes below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Geom {
  int B, S, O, C, P;
  int64_t x_batch, x_lane, w_lane, b_lane;  // strides in elements
};

// --- the bf16 lane: TMA + mbarrier ring + wgmma -------------------------------

constexpr int kTN = 128;        // positions per block
constexpr int kMaxStages = 3;   // ring depth; a stage holds 64 of C
constexpr int kAtom = 8192;     // 64 rows of 128 bytes
constexpr int kXTile = 2 * kAtom;
constexpr int kOutLd = kTN * 2 + 16;  // output staging row, padded
constexpr int kSmemMax = 232448;      // dynamic shared memory of a block

// kWG consumer warpgroups; the producer is one warp when TMA brings x, a
// warpgroup when it gathers x. Where TMA brings x, two blocks share an SM
// (three with one consumer warpgroup), so one block's loads overlap
// another's epilogue; the gathering block's 384 threads leave registers
// for one (a wgmma of 128 columns needs more than 80 a thread).
template <int kWG, bool kGather>
struct Tile {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kWTile = kWG * kAtom;
  static constexpr int kStage = kWTile + kXTile;
  static constexpr int kThreads = 128 * kWG + (kGather ? 128 : 32);
  static constexpr int kMinBlocks = (kWG == 2 ? 2 : 3) - (kGather ? 1 : 0);
  // the ring (which then stages the output tile) and its barriers
  __host__ __device__ static int ring_bytes(int stages) {
    return stages * kStage > kBM * kOutLd ? stages * kStage : kBM * kOutLd;
  }
  // the ring, the raw ring of the slab producer (raw_stage bytes a
  // stage, or none), 1024 bytes to align them, three barriers a stage
  static int smem(int stages, int raw_stage) {
    return ring_bytes(stages) + stages * raw_stage + 1024 + 24 * stages;
  }
};

// Eight bf16 of one row of x (bits), at element offsets off[e] + row for
// the columns e whose bit is set in `valid`; the rest 0. V: elements per
// load (a run of V columns never crosses an image: V divides P).
template <int V>
__device__ __forceinline__ uint4 gather8(const uint16_t* __restrict__ x,
                                         const int64_t (&off)[8],
                                         unsigned valid, int64_t row) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; e += V) {
    if (!((valid >> e) & 1u)) continue;
    const uint16_t* p = x + off[e] + row;
    if constexpr (V == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else if constexpr (V == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      v[e / 2] = q.x;
      v[e / 2 + 1] = q.y;
    } else if constexpr (V == 2) {
      v[e / 2] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      v[e / 2] |= (uint32_t)*p << (16 * (e % 2));
    }
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The offsets in x (row 0 of draw s) of the 8 positions j, j + 1, ...
// of the flat (b, p) index, and a mask of those before jend.
__device__ __forceinline__ unsigned chunk_offsets(int64_t (&off)[8],
                                                  const Geom& g, int s,
                                                  int64_t j, int64_t jend) {
  unsigned valid = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    off[e] = 0;
    if (j + e < jend) {
      const int64_t b = (j + e) / g.P;
      off[e] = b * g.x_batch + (int64_t)s * g.x_lane + (j + e - b * g.P);
      valid |= 1u << e;
    }
  }
  return valid;
}

// The gathering producer: every thread of the warpgroup fills the x tile's
// 16-byte chunk `cc` (8 positions) in rows kr, kr + 8, ..., kr + 56 of
// each stage, thread 0 also brings the weight tile by TMA.
template <int V, int kWG>
__device__ __forceinline__ void produce_gathered(
    const CUtensorMap* wmap, const uint16_t* __restrict__ x, const Geom& g,
    uint8_t* ring, uint32_t bars, int stages, int nk, int o0, int sw, int s,
    int64_t j0, int64_t jend, int t) {
  using T = Tile<kWG, true>;
  const int cc = t % 16;
  const int kr = t / 16;
  int64_t off[8];
  const unsigned valid = chunk_offsets(off, g, s, j0 + cc * 8, jend);
  // chunk cc of row k lands at chunk (cc % 8) ^ (k % 8) of its atom row
  const int dst = (cc / 8) * kAtom + kr * 128 + (((cc % 8) ^ kr) * 16);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % stages;
    const uint32_t full = bars + 8 * st;
    const uint32_t empty = bars + 8 * (stages + st);
    uint8_t* stage = ring + st * T::kStage;
    // the loads go out before the wait: they touch no shared memory
    uint4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = kt * 64 + kr + 8 * i;
      v[i] = c < g.C ? gather8<V>(x, off, valid, (int64_t)c * g.P)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    btt::mbar_wait(empty, ((kt / stages) & 1) ^ 1);
    if (t == 0) {
      btt::mbar_expect_tx(full, T::kWTile);
      btt::tma_load_3d(btt::smem_addr(stage), wmap, full, kt * 64, o0, sw);
    }
    uint8_t* xs = stage + T::kWTile + dst;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint4*>(xs + i * 8 * 128) = v[i];
    btt::fence_async_smem();
    btt::mbar_arrive(full);
  }
}

// The slab producer, where no tensor map describes x (rows of 98 or 392
// bytes at 7x7 and 14x14) but C is a multiple of 8: for one (b, s) the 64
// rows of a stage are one contiguous, 16-byte aligned slab of 64 * P
// elements, so thread 0 brings the slab of every image the tile touches by
// one bulk copy each (cp.async.bulk), `stages` chunks ahead, into a raw
// ring. Every thread then copies its chunk `cc` (8 positions) of rows kr,
// kr + 8, ..., kr + 56 from the raw slab into the swizzled x tile: the
// global loads are the copy engine's, the threads only move shared memory.
template <int kWG>
__device__ __forceinline__ void produce_slabs(
    const CUtensorMap* wmap, const uint16_t* __restrict__ x, const Geom& g,
    uint8_t* ring, uint8_t* raw, int raw_stage, uint32_t bars, int stages,
    int nk, int o0, int sw, int s, int64_t j0, int64_t jend, int t) {
  using T = Tile<kWG, true>;
  const uint32_t rawbars = bars + 16 * stages;
  const int64_t b_first = j0 / g.P;
  const int64_t tile_end = j0 + kTN < jend ? j0 + kTN : jend;
  const int nimg = (int)((tile_end - 1) / g.P - b_first + 1);
  const int slab = 64 * g.P;  // elements of one image's slab
  auto issue = [&](int kt) {
    const int st = kt % stages;
    const int rows = g.C - kt * 64 < 64 ? g.C - kt * 64 : 64;
    const uint32_t bytes = (uint32_t)rows * g.P * 2;
    const uint32_t bar = rawbars + 8 * st;
    btt::mbar_expect_tx(bar, bytes * nimg);
    for (int i = 0; i < nimg; ++i)
      btt::bulk_load(
          btt::smem_addr(raw + st * raw_stage + i * slab * 2),
          x + (b_first + i) * g.x_batch + (int64_t)s * g.x_lane +
              (int64_t)kt * slab,
          bytes, bar);
  };
  if (t == 0)
    for (int kt = 0; kt < stages && kt < nk; ++kt) issue(kt);
  const int cc = t % 16;
  const int kr = t / 16;
  int src[8];
  unsigned valid = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int64_t j = j0 + cc * 8 + e;
    src[e] = 0;
    if (j < jend) {
      const int64_t b = j / g.P;
      src[e] = (int)(b - b_first) * slab + (int)(j - b * g.P);
      valid |= 1u << e;
    }
  }
  const int dst = (cc / 8) * kAtom + kr * 128 + (((cc % 8) ^ kr) * 16);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % stages;
    const uint32_t full = bars + 8 * st;
    uint8_t* stage = ring + st * T::kStage;
    btt::mbar_wait(bars + 8 * (stages + st), ((kt / stages) & 1) ^ 1);
    if (t == 0) {
      btt::mbar_expect_tx(full, T::kWTile);
      btt::tma_load_3d(btt::smem_addr(stage), wmap, full, kt * 64, o0, sw);
    }
    btt::mbar_wait(rawbars + 8 * st, (kt / stages) & 1);
    const uint16_t* r16 =
        reinterpret_cast<const uint16_t*>(raw + st * raw_stage);
    const int rows = g.C - kt * 64;
    uint8_t* xs = stage + T::kWTile + dst;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = kr + 8 * i;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (c < rows) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if ((valid >> e) & 1u)
            v[e / 2] |= (uint32_t)r16[src[e] + c * g.P] << (16 * (e % 2));
      }
      *reinterpret_cast<uint4*>(xs + i * 8 * 128) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    btt::fence_async_smem();
    btt::mbar_arrive(full);
    // the raw stage is free once every thread has read it
    btt::named_sync(4, 128);
    if (t == 0 && kt + stages < nk) issue(kt + stages);
  }
}

__device__ __forceinline__ __nv_bfloat16 finish_bf16(float acc, float bias,
                                                     bool has_bias) {
  __nv_bfloat16 r = __float2bfloat16(acc);
  if (has_bias) r = __float2bfloat16(__fadd_rn(__bfloat162float(r), bias));
  return r;
}

// A consumer warpgroup's 64 x 128 accumulators (rows o_base.., the
// m64n128 fragment layout) as bf16, the bias added after the cast, into
// the staging rows `out` (kOutLd bytes apart).
__device__ __forceinline__ void stage_rows(const float (&acc)[64],
                                           uint8_t* out,
                                           const __nv_bfloat16* bias,
                                           const Geom& g, int s, int o_base,
                                           int lt) {
  const int warp = lt / 32;
  const int lane = lt % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    const int o = o_base + r;
    const bool has_bias = bias != nullptr && o < g.O;
    const float bo =
        has_bias ? __bfloat162float(bias[(int64_t)s * g.b_lane + o]) : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(out + r * kOutLd + col * 2) =
          __halves2bfloat162(finish_bf16(acc[4 * j + 2 * h], bo, has_bias),
                             finish_bf16(acc[4 * j + 2 * h + 1], bo,
                                         has_bias));
    }
  }
}

// The staged 64 rows (o_base..) of positions j0.. (flat (b, p) of draw s)
// to y (B, S, O, P), masked at O, at jend and at image edges.
__device__ __forceinline__ void store_rows(const uint8_t* out,
                                           __nv_bfloat16* y, const Geom& g,
                                           int s, int o_base, int64_t j0,
                                           int64_t jend, int lt) {
  if (g.P % 8 == 0) {
    // 8 positions never cross an image: 16-byte stores, 16 lanes a row
    for (int q = lt; q < 64 * 16; q += 128) {
      const int r = q / 16;
      const int cc = q % 16;
      const int o = o_base + r;
      const int64_t j = j0 + cc * 8;
      if (o >= g.O || j >= jend) continue;
      const int64_t b = j / g.P;
      const int64_t p = j - b * g.P;
      *reinterpret_cast<uint4*>(y + ((b * g.S + s) * g.O + o) * g.P + p) =
          *reinterpret_cast<const uint4*>(out + r * kOutLd + cc * 16);
    }
    return;
  }
  // the positions run across images: a warp stores a row's positions in
  // order, two at a time where P is even (a pair at an even position
  // never crosses an image and is 4-byte aligned), else one
  const int warp = lt / 32;
  const int lane = lt % 32;
  const int64_t b0 = j0 / g.P;
  const int p0 = (int)(j0 - b0 * g.P);
  const int step = g.P % 2 == 0 ? 2 : 1;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int o = o_base + r;
    if (o >= g.O) break;
    const uint8_t* src = out + r * kOutLd;
    for (int col = lane * step; col < kTN; col += 32 * step) {
      if (j0 + col >= jend) break;
      int64_t b = b0;
      int p = p0 + col;
      while (p >= g.P) {
        p -= g.P;
        ++b;
      }
      uint16_t* dst =
          reinterpret_cast<uint16_t*>(y) + ((b * g.S + s) * g.O + o) * g.P + p;
      if (step == 2) {
        *reinterpret_cast<uint32_t*>(dst) =
            *reinterpret_cast<const uint32_t*>(src + col * 2);
      } else {
        *dst = *reinterpret_cast<const uint16_t*>(src + col * 2);
      }
    }
  }
}

// xvec: 0 when x comes by TMA (kGather false), else the gather's elements
// per load; raw_stage > 0: x comes in slabs (produce_slabs), raw_stage
// bytes of raw ring a stage.
template <int kWG, bool kGather>
__global__ void __launch_bounds__(Tile<kWG, kGather>::kThreads,
                                  Tile<kWG, kGather>::kMinBlocks)
    mc_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap xmap,
                         const uint16_t* __restrict__ x,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, Geom g, int xvec,
                         int stages, int raw_stage) {
  using T = Tile<kWG, kGather>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = btt::smem_addr(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* raw = ring + T::ring_bytes(stages);
  const uint32_t bars = btt::smem_addr(raw + stages * raw_stage);
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  // tile: O rows o0.., and 128 positions j0.. of the flat (b, p) index of
  // draw s; by TMA they lie in one image b, gathered they run across them
  const int o0 = blockIdx.x * T::kBM;
  int s, zx = 0;
  int64_t j0, jend;
  if (!kGather) {
    const int b = blockIdx.z / g.S;
    s = blockIdx.z % g.S;
    zx = g.x_lane ? b * g.S + s : b;
    j0 = (int64_t)b * g.P + (int64_t)blockIdx.y * kTN;
    jend = (int64_t)(b + 1) * g.P;
  } else {
    s = blockIdx.z;
    j0 = (int64_t)blockIdx.y * kTN;
    jend = (int64_t)g.B * g.P;
  }
  const int sw = g.w_lane ? s : 0;
  const int nk = (g.C + 63) / 64;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      btt::mbar_init(bars + 8 * i, kGather ? 129 : 1);
      btt::mbar_init(bars + 8 * (stages + i), kWG * 128);
      btt::mbar_init(bars + 8 * (2 * stages + i), 1);  // the raw ring's
    }
    btt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == kWG) {  // the producer
    const int t = tid - kWG * 128;
    if (!kGather) {
      if (t != 0) return;
      const int p0 = blockIdx.y * kTN;
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % stages;
        const uint32_t full = bars + 8 * st;
        const uint32_t stage = btt::smem_addr(ring + st * T::kStage);
        btt::mbar_wait(bars + 8 * (stages + st), ((kt / stages) & 1) ^ 1);
        btt::mbar_expect_tx(full, T::kStage);
        btt::tma_load_3d(stage, &wmap, full, kt * 64, o0, sw);
        btt::tma_load_3d(stage + T::kWTile, &xmap, full, p0, kt * 64, zx);
        btt::tma_load_3d(stage + T::kWTile + kAtom, &xmap, full, p0 + 64,
                         kt * 64, zx);
      }
    } else if (raw_stage > 0) {
      produce_slabs<kWG>(&wmap, x, g, ring, raw, raw_stage, bars, stages, nk,
                         o0, sw, s, j0, jend, t);
    } else if (xvec == 1) {
      produce_gathered<1, kWG>(&wmap, x, g, ring, bars, stages, nk, o0, sw,
                               s, j0, jend, t);
    } else if (xvec == 2) {
      produce_gathered<2, kWG>(&wmap, x, g, ring, bars, stages, nk, o0, sw,
                               s, j0, jend, t);
    } else if (xvec == 4) {
      produce_gathered<4, kWG>(&wmap, x, g, ring, bars, stages, nk, o0, sw,
                               s, j0, jend, t);
    } else {
      produce_gathered<8, kWG>(&wmap, x, g, ring, bars, stages, nk, o0, sw,
                               s, j0, jend, t);
    }
    return;
  }

  // a consumer warpgroup: rows wg*64 .. wg*64 + 63 of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % stages;
    const uint32_t stage = btt::smem_addr(ring + st * T::kStage);
    btt::mbar_wait(bars + 8 * st, (kt / stages) & 1);
    btt::wgmma_fence();
    btt::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // 16 of C: 32 bytes along the weight's rows, 16 rows of the x atoms
      const uint64_t da =
          btt::desc_sw128(stage + wg * kAtom + ks * 32, 16, 1024);
      const uint64_t db =
          btt::desc_sw128(stage + T::kWTile + ks * 2048, kAtom, 1024);
      btt::wgmma_bf16_n128(acc, da, db);
    }
    btt::wgmma_commit();
    btt::fence_regs(acc);
    btt::wgmma_wait<1>();
    btt::fence_regs(acc);
    if (kt > 0) btt::mbar_arrive(bars + 8 * (stages + (kt - 1) % stages));
  }
  btt::wgmma_wait<0>();
  btt::fence_regs(acc);

  // epilogue: every consumer is done with the ring, which now stages the
  // output; each warpgroup writes its 64 rows, then stores them
  btt::named_sync(1, kWG * 128);
  uint8_t* out = ring + wg * 64 * kOutLd;
  stage_rows(acc, out, bias, g, s, o0 + wg * 64, tid % 128);
  btt::named_sync(2 + wg, 128);
  store_rows(out, y, g, s, o0 + wg * 64, j0, jend, tid % 128);
}

template <int kWG, bool kGather>
int launch_bf16(const void* x, const void* w, const void* bias, void* y,
                const Geom& g, int w_row, int xvec_bytes,
                cudaStream_t stream) {
  using T = Tile<kWG, kGather>;
  const int Sx = g.x_lane ? g.S : 1;
  const int Sw = g.w_lane ? g.S : 1;
  CUtensorMap wmap, xmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)w_row, (cuuint64_t)g.O,
                                (cuuint64_t)Sw};
    const cuuint64_t strides[2] = {(cuuint64_t)w_row * 2,
                                   (cuuint64_t)w_row * 2 * g.O};
    const cuuint32_t box[3] = {64, (cuuint32_t)T::kBM, 1};
    const int err = btt::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                  w, dims, strides, box);
    if (err != 0) return err;
  }
  xmap = wmap;
  if (!kGather) {
    const cuuint64_t dims[3] = {(cuuint64_t)g.P, (cuuint64_t)g.C,
                                (cuuint64_t)g.B * Sx};
    const cuuint64_t strides[2] = {(cuuint64_t)g.P * 2,
                                   (cuuint64_t)g.P * 2 * g.C};
    const cuuint32_t box[3] = {64, 64, 1};
    const int err = btt::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                  x, dims, strides, box);
    if (err != 0) return err;
  }
  const int64_t ytiles = kGather ? ((int64_t)g.B * g.P + kTN - 1) / kTN
                                 : (g.P + kTN - 1) / kTN;
  const int64_t lanes = kGather ? g.S : (int64_t)g.B * g.S;
  if (ytiles > 65535 || lanes > 65535) return (int)cudaErrorInvalidValue;
  const int nk = (g.C + 63) / 64;
  int stages = nk < kMaxStages ? nk : kMaxStages;
  // slabs: C a multiple of 8 and x 16-byte aligned make every (b, s)
  // slab a legal bulk copy; the tile touches at most `imgs` images. Take
  // them when they carry at most twice the tile's positions (7x7: 4
  // images, 196 positions; 14x14 would bring 392) and a ring of at least
  // two stages (one where C <= 64) fits.
  int raw_stage = 0;
  const int imgs = (g.P + kTN - 2) / g.P + 1;
  if (kGather && g.C % 8 == 0 && imgs * g.P <= 2 * kTN &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int64_t bytes = (int64_t)imgs * 64 * g.P * 2;
    int st = stages;
    while (st > 1 && T::smem(st, 0) + st * bytes > kSmemMax) --st;
    if (T::smem(st, 0) + st * bytes <= kSmemMax && (st >= 2 || nk == 1)) {
      raw_stage = (int)bytes;
      stages = st;
    }
  }
  static int allowed = -1;
  if (allowed != 0)
    allowed = btt::allow_smem(mc_gemm_wgmma_kernel<kWG, kGather>, kSmemMax);
  if (allowed != 0) return allowed;
  const dim3 grid((g.O + T::kBM - 1) / T::kBM, (unsigned)ytiles,
                  (unsigned)lanes);
  mc_gemm_wgmma_kernel<kWG, kGather>
      <<<grid, T::kThreads, T::smem(stages, raw_stage), stream>>>(
          wmap, xmap, static_cast<const uint16_t*>(x),
          static_cast<const __nv_bfloat16*>(bias),
          static_cast<__nv_bfloat16*>(y), g, kGather ? xvec_bytes / 2 : 0,
          stages, raw_stage);
  return (int)cudaGetLastError();
}

// --- x resident: the gathered shapes whose C fits in shared memory --------
//
// Where no tensor map describes x, every O tile of a block would gather
// the same x tile again (16 times at 512 -> 2048 @ 7x7). With C <= 512 the
// whole (C, 128 positions) tile fits in shared memory (128 KB): the two
// consumer warpgroups gather it once into the swizzled layout, then walk
// every O tile of the draw over it while the producer warp streams the
// weight tiles by TMA through a ring of three stages; each O tile leaves
// through its own staging rows, masked as in store_rows.
constexpr int kResMaxC = 512;
constexpr int kResStages = 3;
constexpr int kResThreads = 288;  // two consumer warpgroups, a producer warp

__host__ __device__ constexpr int res_smem(int nk) {
  // x tile, weight ring, output staging, 1024 to align, the barriers
  return nk * kXTile + kResStages * 2 * kAtom + 128 * kOutLd + 1024 +
         16 * kResStages;
}

// Consumer thread t (of 256) gathers chunk cc (8 positions) of rows kr,
// kr + 16, kr + 32, kr + 48 of every 64-row block of C.
template <int V>
__device__ __forceinline__ void gather_resident(
    const uint16_t* __restrict__ x, const Geom& g, uint8_t* xres, int nk,
    int s, int64_t j0, int64_t jend, int t) {
  const int cc = t % 16;
  const int kr = t / 16;
  int64_t off[8];
  const unsigned valid = chunk_offsets(off, g, s, j0 + cc * 8, jend);
  for (int kt = 0; kt < nk; ++kt) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = kt * 64 + kr + 16 * i;
      v[i] = c < g.C ? gather8<V>(x, off, valid, (int64_t)c * g.P)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kr + 16 * i;  // row in the 64-row block
      *reinterpret_cast<uint4*>(xres + kt * kXTile + (cc / 8) * kAtom +
                                k * 128 + (((cc % 8) ^ (k % 8)) * 16)) = v[i];
    }
  }
}

__global__ void __launch_bounds__(kResThreads, 1)
    mc_gemm_xres_kernel(const __grid_constant__ CUtensorMap wmap,
                        const uint16_t* __restrict__ x,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y, Geom g, int xvec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = btt::smem_addr(smem_raw);
  const int nk = (g.C + 63) / 64;
  uint8_t* xres = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* wring = xres + nk * kXTile;
  uint8_t* stg = wring + kResStages * 2 * kAtom;
  const uint32_t bars = btt::smem_addr(stg + 128 * kOutLd);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int s = blockIdx.z;
  const int64_t j0 = (int64_t)blockIdx.y * kTN;
  const int64_t jend = (int64_t)g.B * g.P;
  const int sw = g.w_lane ? s : 0;
  const int n_o = (g.O + 127) / 128;

  if (tid == 0) {
    for (int i = 0; i < kResStages; ++i) {
      btt::mbar_init(bars + 8 * i, 1);
      btt::mbar_init(bars + 8 * (kResStages + i), 256);
    }
    btt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: weight tiles (O tile, 64 of C)
    if (tid != 256) return;
    for (int i = 0; i < n_o * nk; ++i) {
      const int st = i % kResStages;
      const uint32_t full = bars + 8 * st;
      btt::mbar_wait(bars + 8 * (kResStages + st),
                     ((i / kResStages) & 1) ^ 1);
      btt::mbar_expect_tx(full, 2 * kAtom);
      btt::tma_load_3d(btt::smem_addr(wring + st * 2 * kAtom), &wmap, full,
                       (i % nk) * 64, (i / nk) * 128, sw);
    }
    return;
  }

  if (xvec == 1) {
    gather_resident<1>(x, g, xres, nk, s, j0, jend, tid);
  } else if (xvec == 2) {
    gather_resident<2>(x, g, xres, nk, s, j0, jend, tid);
  } else if (xvec == 4) {
    gather_resident<4>(x, g, xres, nk, s, j0, jend, tid);
  } else {
    gather_resident<8>(x, g, xres, nk, s, j0, jend, tid);
  }
  btt::fence_async_smem();
  btt::named_sync(1, 256);

  uint8_t* out = stg + wg * 64 * kOutLd;
  const uint32_t xaddr = btt::smem_addr(xres);
  int i = 0;
  for (int ot = 0; ot < n_o; ++ot) {
    float acc[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++i) {
      const int st = i % kResStages;
      const uint32_t wst = btt::smem_addr(wring + st * 2 * kAtom);
      btt::mbar_wait(bars + 8 * st, (i / kResStages) & 1);
      btt::wgmma_fence();
      btt::fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = btt::desc_sw128(wst + wg * kAtom + ks * 32, 16,
                                            1024);
        const uint64_t db = btt::desc_sw128(
            xaddr + kt * kXTile + ks * 2048, kAtom, 1024);
        btt::wgmma_bf16_n128(acc, da, db);
      }
      btt::wgmma_commit();
      btt::fence_regs(acc);
      btt::wgmma_wait<1>();
      btt::fence_regs(acc);
      // the previous product has retired: its weight stage is free
      if (i > 0)
        btt::mbar_arrive(bars + 8 * (kResStages + (i - 1) % kResStages));
    }
    btt::wgmma_wait<0>();
    btt::fence_regs(acc);
    stage_rows(acc, out, bias, g, s, ot * 128 + wg * 64, tid % 128);
    btt::named_sync(2 + wg, 128);
    store_rows(out, y, g, s, ot * 128 + wg * 64, j0, jend, tid % 128);
    btt::named_sync(2 + wg, 128);  // the staging rows are free again
  }
}

int launch_xres(const void* x, const void* w, const void* bias, void* y,
                const Geom& g, int w_row, int xvec_bytes,
                cudaStream_t stream) {
  CUtensorMap wmap;
  const cuuint64_t dims[3] = {(cuuint64_t)w_row, (cuuint64_t)g.O,
                              (cuuint64_t)(g.w_lane ? g.S : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)w_row * 2,
                                 (cuuint64_t)w_row * 2 * g.O};
  const cuuint32_t box[3] = {64, 128, 1};
  const int err = btt::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                w, dims, strides, box);
  if (err != 0) return err;
  const int64_t ytiles = ((int64_t)g.B * g.P + kTN - 1) / kTN;
  if (ytiles > 65535 || g.S > 65535) return (int)cudaErrorInvalidValue;
  static int allowed = -1;
  if (allowed != 0)
    allowed = btt::allow_smem(mc_gemm_xres_kernel, res_smem(kResMaxC / 64));
  if (allowed != 0) return allowed;
  const dim3 grid(1, (unsigned)ytiles, (unsigned)g.S);
  mc_gemm_xres_kernel<<<grid, kResThreads, res_smem((g.C + 63) / 64),
                        stream>>>(wmap, static_cast<const uint16_t*>(x),
                                  static_cast<const __nv_bfloat16*>(bias),
                                  static_cast<__nv_bfloat16*>(y), g,
                                  xvec_bytes / 2);
  return (int)cudaGetLastError();
}

// xvec_bytes: 16 when a tensor map can describe x (TMA), else the widest
// load its rows allow (8, 4 or 2 bytes; bf16 has no odd byte count).
int launch_bf16_any(const void* x, const void* w, const void* bias, void* y,
                    const Geom& g, int w_row, int xvec_bytes,
                    cudaStream_t stream) {
  if (xvec_bytes < 2) return (int)cudaErrorInvalidValue;
  if (xvec_bytes == 16)
    return g.O <= 64
               ? launch_bf16<1, false>(x, w, bias, y, g, w_row, 16, stream)
               : launch_bf16<2, false>(x, w, bias, y, g, w_row, 16, stream);
  if (g.O <= 64)
    return launch_bf16<1, true>(x, w, bias, y, g, w_row, xvec_bytes, stream);
  // x resident where it fits and more than one O tile reads it
  if (g.C <= kResMaxC && g.O > 128)
    return launch_xres(x, w, bias, y, g, w_row, xvec_bytes, stream);
  return launch_bf16<2, true>(x, w, bias, y, g, w_row, xvec_bytes, stream);
}

// --- the int8 lane: mma.sync, register-staged -------------------------------

constexpr int kBM = 64;       // output channels per block
constexpr int kBN = 64;       // positions per block
constexpr int kKBytes = 64;   // bytes of C per step, two mma k-steps
constexpr int kThreads = 128;
// w and x tiles: 64 rows of 64 bytes, padded to 80 (20 words): the 8 rows
// x 4 words of one fragment load fall on 32 distinct banks
constexpr int kLdA = kKBytes + 16;

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 64 (O) x 64 (P) output tile of one (b, s), C in steps of 64 bytes, the
// next step's loads held in registers while the tensor cores work. Four
// warps, 2 x 2, each 32 x 32. x tiles are transposed 4 x 4 bytes at a time
// (__byte_perm) on their way into an (P, C) shared tile.
__global__ void __launch_bounds__(kThreads)
    mc_gemm_s8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w, int* __restrict__ y,
                      Geom g, int xvec, int wvec) {
  __shared__ __align__(16) uint8_t As[kBM * kLdA];
  __shared__ __align__(16) uint8_t Bs[kBN * kLdA];

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
  const int w_row = g.C;  // bytes in a row of w
  const int x_row = g.P;  // bytes in a row of x

  int acc[2][4][4];
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
      const int col = k0 + (chunk % 4) * 16;
      ra[i] = load_bytes16(wp + (int64_t)row * w_row + col,
                           row < g.O ? w_row - col : 0, wvec);
    }
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
  };

  // registers -> shared memory
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[(chunk / 4) * kLdA + (chunk % 4) * 16]) =
          ra[i];
    }
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
  };

  fetch(0);
  for (int k0 = 0; k0 < g.C; k0 += kKBytes) {
    stage();
    __syncthreads();
    if (k0 + kKBytes < g.C) fetch(k0 + kKBytes);
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* c = &Bs[(wn + j * 8 + gid) * kLdA + kb + t * 4];
        bf[j][0] = *reinterpret_cast<const uint32_t*>(c);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(c + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_s8(acc[i][j], a[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();
  }

  int* yb = y + (int64_t)bs * g.O * g.P;
  // with P even every (p, p + 1) pair of a fragment starts at an even
  // element of y: one store for both
  const bool pairs = g.P % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = o0 + wm + i * 16 + gid + half * 8;
      if (o >= g.O) continue;
      int* yrow = yb + (int64_t)o * g.P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + wn + j * 8 + t * 2;
        if (p >= g.P) continue;
        const int v0 = acc[i][j][half * 2];
        const int v1 = acc[i][j][half * 2 + 1];
        if (pairs && p + 1 < g.P) {
          *reinterpret_cast<int2*>(yrow + p) = make_int2(v0, v1);
        } else {
          yrow[p] = v0;
          if (p + 1 < g.P) yrow[p + 1] = v1;
        }
      }
    }
  }
}

// --- the f32 lane, on the CUDA cores: full f32 products and sums -------------

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

// --- K-G channels-last ------------------------------------------------------
//
// The per-draw GEMM behind a pointwise (1x1, stride 1) convolution on
// channels-last activations,
//   y[m, s, o] = sum_c x[m, s, c] * w[s, o, c]   (+ bias[s, o])
// with x (M, S, C), M = B*H*W, draw s in the last axis's block s (the
// draw-axis layout of an NHWC model), w (S, O, C) and y (M, S, O): C and O
// contiguous, rows of x S*C apart (any row and lane strides, multiples of
// 8 elements). S = 1 is the plain GEMM (M, C) . (O, C)^T. Element types:
// bf16 -> bf16 and f32 -> f32 with f32 accumulation. The bias is added in
// the output type after the cast, as the convolution op adds it.
//
// Replaces _gemm_kernel of benchmarks/bench_1x1_mc.py (pallas_mc_gemm: x
// (M, S, C) . w (S, C, O) -> (M, S, O), the activations of the vmapped
// path in the layout the TPU feeds them) and, at S = 1, _mm_kernel of
// benchmarks/bench_mosaic_matmul.py ((M, K) @ (K, N)). The backward's
// input gradient (dx[m, s] = g[m, s] . w[s]) is this kernel on the
// transposed weight (S, C, O).
//
// The bf16 lane: both operands are K-major (C contiguous), the layout
// wgmma takes from shared memory with no transpose, so nothing is relaid.
// Every 56x56 and 28x28 site moves more bytes than its products need time
// for, and a site's C is 64 to 2048, so a tile walks 1 to 32 stages of 64
// channels: the load, the product and the store of one tile must overlap
// those of others, which a block that owns one tile and exits cannot do.
// So the kernel is persistent, one block an SM, each block walking the
// (row tile, s, O tile) tiles t = blockIdx.x + j * gridDim.x, O tiles
// fastest: the O tiles of one x tile are in flight together on
// neighbouring blocks, so x is read from memory about once, and the tiles
// in flight cover whole rows of x and y. A tile is 128 rows of M by
// kTN = 128 output channels (64 where O <= 64, wgmma.m64n64k16, so no
// half-empty tile at 64 -> 64 and 256 -> 64). Warp roles:
// - one producer thread walks the block's tiles and their C stages in
//   order, bringing x through a 3-D tensor map over (C, S, M) (box 64, 1,
//   128: lane s) and w through one over (C, O, S), 128-byte swizzled, into
//   a ring of kStages stages (5 of 32 KiB at kTN = 128, 6 of 24 KiB at
//   64) under full / empty mbarriers; it never waits for an epilogue, only
//   for a free stage;
// - two consumer warpgroups in ping-pong: warpgroup j % 2 owns the block's
//   tile j whole (two wgmma rows of 64, f32 sums in registers). Their main
//   loops take turns (a named-barrier handshake: a warpgroup starts tile j's
//   loop once tile j - 1's has ended), which keeps each waiter within one
//   phase of the ring's barriers, and one warpgroup's epilogue runs under
//   the other's products;
// - the epilogue casts to bf16, adds the bias in bf16 (as the convolution
//   op adds it) and, 64 output channels at a time, writes them into the
//   warpgroup's own 128-byte-swizzled 16 KiB staging buffer (apart from the
//   ring, and half a tile wide, so the ring keeps five stages under 200 KB
//   of shared memory), which one thread stores by TMA (cp.async.bulk.tensor
//   over a 3-D map of y as (O, S, M); the hardware clips rows past M and
//   O); the buffer is written again once that store has read it. Where y's
//   rows are not 16-byte aligned (O not a multiple of 8) no tensor map
//   takes them, and the warpgroup stores each staged half with masked
//   2-byte stores instead.
// Rows past M, O and C load as 0 (TMA's zero fill).
// What holds it back (measured on the H100): at the 14x14 and 7x7 sites a
// 128 x 128 tile brings 32 KiB from L2 for every 64 channels, which at the
// tensor cores' rate would be about 15 TB/s across the card, so those
// sites run below the tensor rate; a deeper ring helps (3, 4, 5 stages)
// while shared memory stays under about 200 KB, and a ring that took more,
// a 256-row tile shared by both warpgroups and a pair of blocks
// multicasting x (a cluster of two) were each slower (PERF.md, §6).
//
// The f32 lane runs on the CUDA cores (full f32 products, which TF32 would
// not give), 64 x 64 tiles.

namespace cl {

struct GeomCL {
  int M, S, O, C;
  // strides in elements: x rows and lanes, w lanes, y rows and lanes,
  // bias lanes (0: shared by the draws)
  int64_t x_row, x_lane, w_lane, y_row, y_lane, b_lane;
};

constexpr int kTM = 128;        // rows of M a tile
constexpr int kXTile = 16384;   // 128 rows of 64 C (128 bytes)
constexpr int kHalf = 16384;    // 128 rows of 64 output channels, staged
constexpr int kThreads = 288;   // two consumer warpgroups, a producer warp

template <int kTN>
struct Ring {
  static constexpr int kWTile = kTN * 128;  // kTN rows of 64 C
  static constexpr int kStage = kXTile + kWTile;
  static constexpr int kStages = kTN == 128 ? 5 : 6;
  static constexpr int kOut = kHalf;  // one warpgroup's staging: 64 columns
  // the ring, two staging buffers, 1024 bytes to align them, two
  // barriers a stage
  static constexpr int kSmem = kStages * kStage + 2 * kOut + 1024 +
                               16 * kStages;
};

__device__ __forceinline__ __nv_bfloat16 finish_bf16(float acc, float bias,
                                                     bool has_bias) {
  __nv_bfloat16 r = __float2bfloat16(acc);
  if (has_bias) r = __float2bfloat16(__fadd_rn(__bfloat162float(r), bias));
  return r;
}

template <int kTN>
__device__ __forceinline__ void mma_k16(float (&d)[kTN / 2], uint64_t a,
                                        uint64_t b);
template <>
__device__ __forceinline__ void mma_k16<128>(float (&d)[64], uint64_t a,
                                             uint64_t b) {
  btt::wgmma_bf16_n128<0>(d, a, b);
}
template <>
__device__ __forceinline__ void mma_k16<64>(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  btt::wgmma_bf16_n64<0>(d, a, b);
}

// Tile t of the walk: O tiles fastest, then draws, then row tiles, so the
// tiles in flight together cover whole rows of x and y (all S*C and S*O
// of each row, contiguous in memory) and every lane's w stays in L2.
__device__ __forceinline__ void tile_at(int64_t t, int otiles, int S,
                                        int kTN, int& o0, int& m0, int& s) {
  o0 = (int)(t % otiles) * kTN;
  const int64_t rest = t / otiles;
  s = (int)(rest % S);
  m0 = (int)(rest / S) * kTM;
}

template <int kTN>
__global__ void __launch_bounds__(kThreads, 1)
    mc_gemm_cl_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap ymap,
                            const __nv_bfloat16* __restrict__ bias,
                            __nv_bfloat16* __restrict__ y, GeomCL g,
                            int tma_store) {
  using R = Ring<kTN>;
  constexpr int kS = R::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = btt::smem_addr(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* outs = ring + kS * R::kStage;
  const uint32_t bars = btt::smem_addr(outs + 2 * R::kOut);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int nk = (g.C + 63) / 64;
  const int otiles = (g.O + kTN - 1) / kTN;
  const int mtiles = (g.M + kTM - 1) / kTM;
  const int64_t tiles = (int64_t)otiles * mtiles * g.S;

  if (tid == 0) {
    for (int i = 0; i < kS; ++i) {
      btt::mbar_init(bars + 8 * i, 1);           // full: the producer
      btt::mbar_init(bars + 8 * (kS + i), 128);  // empty: one warpgroup
    }
    btt::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread brings both tiles of a stage
    if (tid != 256) return;
    uint32_t p = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      int o0, m0, s;
      tile_at(t, otiles, g.S, kTN, o0, m0, s);
      const int sx = g.x_lane ? s : 0;
      const int sw = g.w_lane ? s : 0;
      for (int kt = 0; kt < nk; ++kt, ++p) {
        const int st = p % kS;
        const uint32_t full = bars + 8 * st;
        const uint32_t stage = btt::smem_addr(ring + st * R::kStage);
        btt::mbar_wait(bars + 8 * (kS + st), ((p / kS) & 1) ^ 1);
        btt::mbar_expect_tx(full, R::kStage);
        btt::tma_load_3d(stage, &xmap, full, kt * 64, sx, m0);
        btt::tma_load_3d(stage + kXTile, &wmap, full, kt * 64, o0, sw);
      }
    }
    return;
  }

  // a consumer warpgroup: the block's tiles j = wg, wg + 2, ...
  const int lt = tid % 128;
  const int warp = lt / 32;
  const int lane = lt % 32;
  uint8_t* out = outs + wg * R::kOut;
  const uint32_t out_addr = btt::smem_addr(out);
  for (int64_t j = wg;; j += 2) {
    const int64_t t = blockIdx.x + j * (int64_t)gridDim.x;
    if (t >= tiles) break;
    int o0, m0, s;
    tile_at(t, otiles, g.S, kTN, o0, m0, s);
    float acc[2][kTN / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kTN / 2; ++i) acc[h][i] = 0.f;
    // tile j's loop starts once tile j - 1's has ended
    if (j > 0) btt::named_sync(3 + wg, 256);
    const uint32_t p0 = (uint32_t)(j * nk);
    for (int kt = 0; kt < nk; ++kt) {
      const uint32_t p = p0 + kt;
      const int st = p % kS;
      const uint32_t stage = btt::smem_addr(ring + st * R::kStage);
      btt::mbar_wait(bars + 8 * st, (p / kS) & 1);
      btt::wgmma_fence();
      btt::fence_regs(acc[0]);
      btt::fence_regs(acc[1]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // 16 of C: 32 bytes along the rows of both tiles
        const uint64_t db =
            btt::desc_sw128(stage + kXTile + ks * 32, 16, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma_k16<kTN>(acc[h],
                       btt::desc_sw128(stage + h * 8192 + ks * 32, 16, 1024),
                       db);
      }
      btt::wgmma_commit();
      btt::fence_regs(acc[0]);
      btt::fence_regs(acc[1]);
      btt::wgmma_wait<1>();
      btt::fence_regs(acc[0]);
      btt::fence_regs(acc[1]);
      if (kt > 0) btt::mbar_arrive(bars + 8 * (kS + (p - 1) % kS));
    }
    btt::wgmma_wait<0>();
    btt::fence_regs(acc[0]);
    btt::fence_regs(acc[1]);
    btt::mbar_arrive(bars + 8 * (kS + (p0 + nk - 1) % kS));
    if (t + gridDim.x < tiles) btt::named_arrive(3 + (wg ^ 1), 256);

    // epilogue, 64 columns at a time: the staging buffer is free once
    // this warpgroup's last store has read it
    const __nv_bfloat16* brow =
        bias != nullptr ? bias + (int64_t)s * g.b_lane : nullptr;
#pragma unroll
    for (int hf = 0; hf < kTN / 64; ++hf) {
      if (lt == 0) btt::bulk_wait_read<0>();
      btt::named_sync(1 + wg, 128);
      // the m64nN fragment: row warp*16 + lane/4 + 8q, columns 8c +
      // 2(lane%4) + {0, 1}; staged as 128 swizzled rows of 64 columns
#pragma unroll
      for (int c = hf * 8; c < hf * 8 + 8; ++c) {
        const int col = 8 * c + (lane % 4) * 2;
        float b0 = 0.f, b1 = 0.f;
        if (brow != nullptr) {
          if (o0 + col < g.O) b0 = __bfloat162float(brow[o0 + col]);
          if (o0 + col + 1 < g.O) b1 = __bfloat162float(brow[o0 + col + 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int r = h * 64 + warp * 16 + lane / 4 + 8 * q;
            *reinterpret_cast<__nv_bfloat162*>(
                out + r * 128 + (((c % 8) ^ (r % 8)) * 16) +
                (lane % 4) * 4) =
                __halves2bfloat162(
                    finish_bf16(acc[h][4 * c + 2 * q], b0, brow != nullptr),
                    finish_bf16(acc[h][4 * c + 2 * q + 1], b1,
                                brow != nullptr));
          }
      }
      btt::fence_async_smem();
      btt::named_sync(1 + wg, 128);
      if (tma_store) {
        if (lt == 0) {
          btt::tma_store_3d(&ymap, out_addr, o0 + 64 * hf, s, m0);
          btt::bulk_commit();
        }
        continue;
      }
      for (int e = lt; e < kTM * 64; e += 128) {
        const int r = e / 64;
        const int cc = e % 64;
        if (m0 + r >= g.M || o0 + 64 * hf + cc >= g.O) continue;
        reinterpret_cast<uint16_t*>(y)[(int64_t)(m0 + r) * g.y_row +
                                       (int64_t)s * g.y_lane + o0 +
                                       64 * hf + cc] =
            *reinterpret_cast<const uint16_t*>(
                out + r * 128 + ((((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2));
      }
    }
  }
  if (lt == 0) btt::bulk_wait<0>();
}

template <int kTN>
int launch_tiles(const CUtensorMap& xmap, const void* w, const void* bias,
                 void* y, const GeomCL& g, int w_row, int yvec,
                 cudaStream_t stream) {
  const int Sw = g.w_lane ? g.S : 1;
  CUtensorMap wmap, ymap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)w_row, (cuuint64_t)g.O,
                                (cuuint64_t)Sw};
    const cuuint64_t strides[2] = {(cuuint64_t)w_row * 2,
                                   (cuuint64_t)w_row * 2 * g.O};
    const cuuint32_t box[3] = {64, (cuuint32_t)kTN, 1};
    const int err = btt::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                  w, dims, strides, box);
    if (err != 0) return err;
  }
  if (yvec) {
    const cuuint64_t dims[3] = {(cuuint64_t)g.O, (cuuint64_t)g.S,
                                (cuuint64_t)g.M};
    // one lane (y_lane 0): its stride is never stepped, but must be legal
    const cuuint64_t strides[2] = {
        (cuuint64_t)(g.y_lane ? g.y_lane : g.y_row) * 2,
        (cuuint64_t)g.y_row * 2};
    const cuuint32_t box[3] = {64, 1, (cuuint32_t)kTM};
    const int err = btt::make_map(&ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                  y, dims, strides, box);
    if (err != 0) return err;
  } else {
    ymap = xmap;  // not read
  }
  static int allowed = -1;
  if (allowed != 0)
    allowed = btt::allow_smem(mc_gemm_cl_wgmma_kernel<kTN>, Ring<kTN>::kSmem);
  if (allowed != 0) return allowed;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t tiles = (int64_t)((g.O + kTN - 1) / kTN) *
                        ((g.M + kTM - 1) / kTM) * g.S;
  const int grid = tiles < sms ? (int)tiles : sms;
  mc_gemm_cl_wgmma_kernel<kTN>
      <<<grid, kThreads, Ring<kTN>::kSmem, stream>>>(
          xmap, wmap, ymap, static_cast<const __nv_bfloat16*>(bias),
          static_cast<__nv_bfloat16*>(y), g, yvec);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, const void* bias, void* y,
                const GeomCL& g, int w_row, int yvec, cudaStream_t stream) {
  const int Sx = g.x_lane ? g.S : 1;
  CUtensorMap xmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)g.C, (cuuint64_t)Sx,
                                (cuuint64_t)g.M};
    // one lane (x_lane 0): its stride is never stepped, but must be legal
    const cuuint64_t strides[2] = {
        (cuuint64_t)(g.x_lane ? g.x_lane : g.x_row) * 2,
        (cuuint64_t)g.x_row * 2};
    const cuuint32_t box[3] = {64, 1, (cuuint32_t)kTM};
    const int err = btt::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                  x, dims, strides, box);
    if (err != 0) return err;
  }
  if (g.O <= 64)
    return launch_tiles<64>(xmap, w, bias, y, g, w_row, yvec, stream);
  return launch_tiles<128>(xmap, w, bias, y, g, w_row, yvec, stream);
}

// --- the f32 lane, on the CUDA cores: full f32 products and sums -------------

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    mc_gemm_cl_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          float* __restrict__ y, GeomCL g) {
  __shared__ float As[kFK][kFM + 4];  // (c, m)
  __shared__ float Bs[kFK][kFN + 4];  // (c, o)
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int o0 = blockIdx.x * kFN;
  const int64_t m0 = (int64_t)blockIdx.y * kFM;
  const int s = blockIdx.z;
  const float* xp = x + (int64_t)s * g.x_lane;
  const float* wp = w + (int64_t)s * g.w_lane;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.C; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // 16 consecutive threads read 16 consecutive elements of a row
      const int e = tid + i * kFThreads;
      const int r = e / kFK, k = e % kFK;
      As[k][r] = (m0 + r < g.M && k0 + k < g.C)
                     ? xp[(m0 + r) * g.x_row + k0 + k]
                     : 0.f;
      Bs[k][r] = (o0 + r < g.O && k0 + k < g.C)
                     ? wp[(int64_t)(o0 + r) * g.C + k0 + k]
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

  const float* brow = bias != nullptr ? bias + (int64_t)s * g.b_lane : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
    float* yrow = y + m * g.y_row + (int64_t)s * g.y_lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o >= g.O) continue;
      float v = acc[i][j];
      if (brow != nullptr) v = __fadd_rn(v, brow[o]);
      yrow[o] = v;
    }
  }
}

}  // namespace cl

}  // namespace

extern "C" {

// x (B, S or 1, C, P), w (S or 1, O, w_row) with C <= w_row (bf16: w_row a
// multiple of 8, the columns past C zero, 16-byte aligned; int8 and f32:
// w_row = C), bias (S or 1, O) or NULL, y (B, S, O, P), all row-major;
// dtype 0: bf16 -> bf16, 1: f32 -> f32, 2: s8 -> s32 (no bias). Strides are
// in elements; a lane stride of 0 shares the operand between the draws.
// xvec / wvec: the widest load in bytes (16, 8, 4, 2 or 1) that the rows of
// x / w allow (row length and base pointer both multiples of it); a bf16 x
// with xvec 16 comes by TMA. Returns the launch's cudaGetLastError() (or
// the error of a refused tensor map).
int btt_mc_gemm(const void* x, const void* w, const void* bias, void* y,
                int dtype, int B, int S, int O, int C, int P, int w_row,
                int64_t x_batch, int64_t x_lane, int64_t w_lane,
                int64_t b_lane, int xvec, int wvec, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || O <= 0 || P <= 0) return (int)cudaSuccess;
  const Geom g = {B, S, O, C, P, x_batch, x_lane, w_lane, b_lane};
  if (dtype == 0) {
    if (C <= 0) return (int)cudaErrorInvalidValue;
    return launch_bf16_any(x, w, bias, y, g, w_row, xvec, stream);
  }
  const int64_t lanes = (int64_t)B * S;
  const int ptiles = (P + kBN - 1) / kBN;
  if (lanes > 65535 || ptiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((O + kBM - 1) / kBM, ptiles, (unsigned)lanes);
  if (dtype == 1) {
    mc_gemm_f32_kernel<<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), g);
  } else if (dtype == 2) {
    mc_gemm_s8_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<int*>(y), g, xvec, wvec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: element (m, s, c) at m * x_row + s * x_lane + c; w (S or 1, O, w_row)
// with C <= w_row (bf16: w_row a multiple of 8, the columns past C zero,
// 16-byte aligned; f32: w_row = C); bias (S or 1, O) or NULL; y: element
// (m, s, o) at m * y_row + s * y_lane + o. dtype 0: bf16 -> bf16 (x_row and
// x_lane multiples of 8, x 16-byte aligned: the tensor map's terms), 1: f32
// -> f32. A lane stride of 0 shares the operand between the draws. yvec:
// O, y_row, y_lane and y's base all multiples of 8 elements (16-byte
// stores). Returns the launch's cudaGetLastError() (or the error of a
// refused tensor map).
int btt_mc_gemm_cl(const void* x, const void* w, const void* bias, void* y,
                   int dtype, int M, int S, int O, int C, int w_row,
                   int64_t x_row, int64_t x_lane, int64_t w_lane,
                   int64_t y_row, int64_t y_lane, int64_t b_lane, int yvec,
                   cudaStream_t stream) {
  if (M <= 0 || S <= 0 || O <= 0) return (int)cudaSuccess;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  const cl::GeomCL g = {M,      S,      O,      C,      x_row,
                        x_lane, w_lane, y_row,  y_lane, b_lane};
  if (dtype == 0)
    return cl::launch_bf16(x, w, bias, y, g, w_row, yvec, stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int64_t mtiles = ((int64_t)M + cl::kFM - 1) / cl::kFM;
  if (mtiles > 65535 || S > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((O + cl::kFN - 1) / cl::kFN, (unsigned)mtiles,
                  (unsigned)S);
  cl::mc_gemm_cl_f32_kernel<<<grid, cl::kFThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), g);
  return (int)cudaGetLastError();
}

}  // extern "C"
