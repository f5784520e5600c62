// The tiles body of the dequantize-matmul: y = bf16(x) @ bf16(q * s) above
// 16 rows of x, on TMA and wgmma. Kernel K3's "tiles" route (qmm.cu), both
// halves of kernel K5 above 16 rows (ffn_int8.cu: the prompt ingest) and
// kernel K4 above 16 rows (int4 planes, qmm4.cu) run it; their decode rows
// run qmm_rows.cuh.
//
// Contract (the TPU kernels' _qmm_kernel, _ffn_kernel and _qmm4 kernel): x
// (M, K) bf16; qs (K, Np) int8, or (K/2, Np) uint8 split-half nibbles
// (packed row p: the low nibble is K row 2p, the high nibble 2p + 1, each
// value nibble - 8), and scales (K/32, Np) f32; each weight is q * s in f32,
// rounded to bf16 once (the TPU kernels' rounding point); the products sum
// in f32. K % 32 == 0, Np % 128 == 0.
//
// Four things are template parameters, so that each kernel has its own
// instantiation and K3's is the one it always was (the same bits, the same
// grid): the build (kIngest, below), the plane loader (Int8Planes,
// Int4Planes: the TMA box of a step's values and how the dequantizers read
// it), the epilogue that stores a pair of sums (StoreF32: K3, K4, K5's
// second half; BiasGeluBf16: bias + gelu_tanh rounded to bf16, K5's first
// half, the bias read in f32 or bf16 as the model keeps it), and the
// launch's place in a programmatic-dependent-launch pair (kPdl: none for K3
// and K4; K5's first half lets its dependent start, its second half issues
// its first weight stages before it waits for h). The split of K is a
// launch argument.
//
// What bounds it on the H100: at the encoder's 1536 rows the tensor cores
// (2 M FLOP a weight byte, far past the ~295 FLOP/byte ridge); at a prompt
// ingest's 17-227 rows the weight planes' bytes (K5 at 227 rows: 16.5 MB,
// 4.9 us at 3.35 TB/s, beside 5.95 GFLOP, 6.0 us at 989 TFLOP/s) - but a
// block walks its K steps one after another, about 0.6 us a 64-row step,
// and a launch costs about 8 us besides (its start, the rings' fill, the
// epilogue), so with few output tiles the time is the longest walk, not the
// bytes: K5's second half has 10 column tiles, its first half 40 a row
// tile. A step is bound by the SM's shared memory, which its TMA writes,
// the dequantizers' round trip and the products' reads share: with the
// products and the dequantizing cut out the same walk takes 0.27 us a step,
// and each of the two adds its part (kernel_times.py --only k5split on such
// trees, H100 80GB HBM3).
//
// Two builds (kIngest): K3 above 64 rows runs the split-free body its tiles
// route always ran; K4, K5 and K3 up to 64 rows the ingest build, which
// splits K over a cluster, loads 64 rows of x where the grid has at most
// 64, and has the dequantizers read a value tile before they wait for its
// B tile's slot.
//
// Design:
//  * One block per 128 x 128 output tile and split of K, five warpgroups, one
//    block per SM; K steps by 64 rows (two scale blocks). The grid is
//    (Np / 128 column tiles, ceil(M / 128) row tiles, splits).
//  * A producer warpgroup (one thread) issues the TMA loads: the x tile (128
//    x 64 bf16, 128-byte swizzle: wgmma's K-major A operand) into a ring of
//    six, and the value tile (64 x 128 int8, or 32 x 128 packed int4) with
//    its two rows of scales into another ring of six. Rows of x past M and K
//    rows past K load as zero, so M is free and K % 64 == 32 needs no pad.
//    A dependent launch (K5's second half) issues its first six value tiles
//    before griddepcontrol.wait, and only then reads x (h).
//  * Two dequantizing warpgroups turn each value tile into a bf16 B tile, q *
//    s in f32 rounded to bf16 (q leaves int8 through a byte permute into a
//    float's mantissa, not the slower int-to-float unit; a nibble + 120 as a
//    byte is its value - 8 + 128, the same permute), in the MN-major
//    128-byte-swizzled layout that wgmma reads with its transpose bit (two
//    64-column blocks, 8 KB apart), fence the async proxy and hand it over
//    through a ring of three.
//  * Two consumer warpgroups (64 rows each) wait for an x tile and a B tile
//    and run four wgmma m64n128k16 on them, keeping one step in flight.
//    A grid of at most 64 rows (a prompt ingest of 17-64) loads x's 64 rows
//    only, and the second warpgroup, all of whose rows are past M, passes
//    the slots back without a product: each step then moves 32 KB less
//    through shared memory (K4 at 17 and 64 rows: 68 -> 59-61 us).
//  * Each ring has full / empty mbarriers.
//  * Split K: split s of `splits` takes the runs of `unit` steps [s U /
//    splits, (s + 1) U / splits) of the U = ceil(K / 64 / unit) runs (K5's
//    second half: unit 8, its 512-row hidden tiles, the TPU kernel's grid
//    order). The splits of a tile are one thread-block cluster (at most 8,
//    the portable size; the wrapper's plan counts its waves in the clusters
//    the card holds: 39 of three on the H100). When every thread of the
//    cluster is past the rings,
//    each block sends each other block the sums of that block's share of the
//    tile's columns (st.async into its x ring, counted on an mbarrier there);
//    each block then adds its share in split order, its own sums in their
//    place, and stores it. No float atomics and no workspace: the same bits
//    from run to run, and the outer order of the TPU kernel's sum over its
//    hidden tiles.
//  * The epilogue stores each pair of sums from the accumulators, rows >= M
//    dropped.
// What holds it above torch.matmul on the dequantized weight at the encoder:
// shared memory. Both consumer warpgroups read the whole B tile, so a step's
// products read 48 KB (96 bytes a clock at the full tensor rate, of the SM's
// 128), and the step's TMA writes (25 KB) and the dequantizing round trip (9
// KB read, 16 KB written) come on top; the x tile is also fetched again by
// every column tile (240 MB through L2 at mlp0 and mlp1).
//
// The host side (launch_tiles) encodes the three tensor maps per call and
// launches on the caller's stream.

#pragma once

#include "sm90.cuh"

namespace owk_qwg {

using namespace owk_sm90;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kXStages = 6;     // x tiles
constexpr int kWStages = 6;     // value tiles with their scales
constexpr int kBStages = 3;     // dequantized bf16 B tiles
constexpr int kMaxSplits = 8;   // the portable cluster size
// warpgroups: 0 producer (one thread issues the loads), 1-2 dequantizers, 3-4
// consumers; setmaxnreg takes registers from the producer and the dequantizers
// and gives them to the consumers, within the block's launch allocation of
// 640 x 96 (a consumer that asks for more than is freed waits for ever)
constexpr int kThreads = 640;
constexpr int kProducerRegs = 40, kDequantRegs = 80, kConsumerRegs = 136;
static_assert(kProducerRegs + 2 * kDequantRegs + 2 * kConsumerRegs <= 5 * 96,
              "setmaxnreg: more registers asked for than the block holds");
constexpr int kConsumerThreads = 256;
constexpr uint32_t kXBytes = kBM * kBK * 2;         // 16 KB
constexpr uint32_t kScaleBytes = (kBK / 32) * kBN * 4;   // 1 KB
constexpr uint32_t kBBytes = kBK * kBN * 2;         // 16 KB

// a launch's place in a programmatic-dependent-launch pair
constexpr int kPdlNone = 0;        // an ordinary launch (K3, K4)
constexpr int kPdlPrimary = 1;     // lets its dependent launch start (K5's first half)
constexpr int kPdlSecondary = 2;   // a dependent launch: reads x only after its wait

// row r's 8 columns at chunk nc of the B tile from four biased int8 values
// each of lo (columns 0-3) and hi (4-7), times their scales: bf16 at `dst`,
// MN-major, 128-byte swizzle
__device__ __forceinline__ void put_row(uint8_t* dst, int r, int nc, uint32_t lo, uint32_t hi,
                                        const float* sv) {
  uint4 v;
  v.x = pack_bf16(q_at(lo, 0) * sv[0], q_at(lo, 1) * sv[1]);
  v.y = pack_bf16(q_at(lo, 2) * sv[2], q_at(lo, 3) * sv[3]);
  v.z = pack_bf16(q_at(hi, 0) * sv[4], q_at(hi, 1) * sv[5]);
  v.w = pack_bf16(q_at(hi, 2) * sv[6], q_at(hi, 3) * sv[7]);
  const int chunk = (nc & 7) ^ (r & 7);   // the 128-byte swizzle
  *reinterpret_cast<uint4*>(dst + (nc >> 3) * 8192 + r * 128 + chunk * 16) = v;
}

// the two scale rows of a step (32 K rows each) for the 8 columns at chunk nc
__device__ __forceinline__ void load_scales(const uint8_t* sc_bytes, int nc, float (&s)[2][8]) {
  const float* sc = reinterpret_cast<const float*>(sc_bytes) + nc * 8;
#pragma unroll
  for (int b = 0; b < 2; ++b) {   // scale block b: K rows 32 b .. + 31
    *reinterpret_cast<float4*>(&s[b][0]) = *reinterpret_cast<const float4*>(sc + b * kBN);
    *reinterpret_cast<float4*>(&s[b][4]) = *reinterpret_cast<const float4*>(sc + b * kBN + 4);
  }
}

// int8 planes: a step's value tile is 64 K rows x 128 columns (8 KB,
// row-major), then its two rows of scales
struct Int8Planes {
  static constexpr int kBits = 8;
  static constexpr uint32_t kQBytes = kBK * kBN;
  // the value tile at `w` -> bf16 B tile at `dst`. 256 threads; thread t
  // takes the 8-column chunk t % 16 of rows t / 16 + 16 u (u < 4), so it needs
  // two scale vectors a step; every load is issued before the arithmetic,
  // and ready() (the wait for the B tile's slot) comes between the two
  template <class Ready>
  static __device__ __forceinline__ void dequantize(const uint8_t* w, uint8_t* dst, int t,
                                                    Ready ready) {
    const int nc = t % 16, r0 = t / 16;
    float s[2][8];
    load_scales(w + kQBytes, nc, s);
    uint2 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      q[u] = *reinterpret_cast<const uint2*>(w + (r0 + 16 * u) * kBN + nc * 8);
    ready();
#pragma unroll
    for (int u = 0; u < 4; ++u)
      put_row(dst, r0 + 16 * u, nc, q[u].x ^ 0x80808080u, q[u].y ^ 0x80808080u, s[u / 2]);
  }
};

// split-half int4 planes: a step's value tile is 32 packed rows x 128 columns
// (4 KB), packed row p holding K rows 2p (low nibble) and 2p + 1 (high)
struct Int4Planes {
  static constexpr int kBits = 4;
  static constexpr uint32_t kQBytes = kBK / 2 * kBN;
  // thread t takes the 8-column chunk t % 16 of packed rows t / 16 + 16 u (u
  // < 2): K rows 2p and 2p + 1, both in scale block u
  template <class Ready>
  static __device__ __forceinline__ void dequantize(const uint8_t* w, uint8_t* dst, int t,
                                                    Ready ready) {
    const int nc = t % 16, p0 = t / 16;
    float s[2][8];
    load_scales(w + kQBytes, nc, s);
    uint2 q[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      q[u] = *reinterpret_cast<const uint2*>(w + (p0 + 16 * u) * kBN + nc * 8);
    ready();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = p0 + 16 * u;
      // each nibble + 120 as a byte: its value - 8, biased by 128 as q_at reads it
      put_row(dst, 2 * p, nc, (q[u].x & 0x0F0F0F0Fu) + 0x78787878u,
              (q[u].y & 0x0F0F0F0Fu) + 0x78787878u, s[u]);
      put_row(dst, 2 * p + 1, nc, ((q[u].x >> 4) & 0x0F0F0F0Fu) + 0x78787878u,
              ((q[u].y >> 4) & 0x0F0F0F0Fu) + 0x78787878u, s[u]);
    }
  }
};

// the epilogue's store of two sums of one row at an even column: f32 as
// they are (K3, K4, K5's second half)
struct StoreF32 {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float a, float b) const {
    *reinterpret_cast<float2*>(out + (size_t)row * ld + col) = make_float2(a, b);
  }
};

// gelu_tanh, the formula of jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh(float u) {
  return u * (0.5f * (1.0f + tanhf(0.7978845608028654f * (u + 0.044715f * (u * u * u)))));
}

// h = bf16(gelu_tanh(v + b)), the bias b in f32 or bf16 (TB) widened to f32
// (K5's first half)
template <typename TB>
struct BiasGeluBf16 {
  __nv_bfloat16* h;
  const TB* b;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float a, float c) const {
    float2 bb;
    if constexpr (sizeof(TB) == 4) {
      bb = *reinterpret_cast<const float2*>(b + col);
    } else {
      bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + col));
    }
    *reinterpret_cast<uint32_t*>(h + (size_t)row * ld + col) =
        pack_bf16(gelu_tanh(a + bb.x), gelu_tanh(c + bb.y));
  }
};

template <class Planes>
struct Layout {
  static constexpr uint32_t kWBytes = Planes::kQBytes + kScaleBytes;
  static constexpr uint32_t kXRing = 0;
  static constexpr uint32_t kWRing = kXRing + kXStages * kXBytes;
  static constexpr uint32_t kBRing = kWRing + kWStages * kWBytes;   // every tile 1024-aligned
  static constexpr uint32_t kBars = kBRing + kBStages * kBBytes;
  static constexpr uint32_t kGatherBar = kBars + 16 * (kXStages + kWStages + kBStages);
  static constexpr size_t kSmemBytes = 1024 + kGatherBar + 8;
  static_assert(kBRing % 1024 == 0, "B tiles must start on 1024-byte boundaries");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block can have");
};

// the 16 column chunks of 8 (an accumulator's j) a cluster shares out: chunk
// j's sums are added in block j * splits / 16
__device__ __forceinline__ int chunk_owner(int j, int splits) { return j * splits / 16; }
__device__ __forceinline__ int first_chunk(int r, int splits) {
  return (16 * r + splits - 1) / splits;
}

// kIngest: the build for a prompt ingest's rows (K4, K5; K3 at M <= 64),
// which splits K over a cluster, loads x's 64 rows only in a grid of one row
// tile of at most 64 rows, and has the dequantizers read a value tile before
// they wait for the B tile's slot. Without it (K3 above 64 rows) the body is
// the one K3's tiles route always ran, split-free.
template <class Planes, class Epilogue, int kPdl, bool kIngest>
__global__ void __launch_bounds__(kThreads, 1)
tiles_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_s, const Epilogue ep, int M, int K,
             int splits, int unit, int x_rows) {
  using L = Layout<Planes>;
  if constexpr (kPdl == kPdlPrimary) pdl_trigger();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles: 1024-aligned
  uint8_t* const gbase = smem_raw + (base - raw);
  const StageRing<kXStages> xr{base + L::kBars};
  const StageRing<kWStages> wr{xr.bars + 16 * kXStages};
  const StageRing<kBStages> br{wr.bars + 16 * kWStages};

  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;   // a cluster: the splits of one tile, rank = split
  // this split's K steps: runs [split U / splits, (split + 1) U / splits) of `unit`
  const int all_steps = (K + kBK - 1) / kBK;
  const int runs = (all_steps + unit - 1) / unit;
  const int s0 = kIngest ? split * runs / splits * unit : 0;
  const int n_steps = kIngest ? min((split + 1) * runs / splits * unit, all_steps) - s0 : all_steps;
  // consumer threads whose rows hold a row < M: both warpgroups, or the first
  const int live = m0 + 64 < M ? kConsumerThreads : kConsumerThreads / 2;
  // the 16-byte slots of another block's sums a block receives, per sender
  // and consumer thread: its share of the 16 column chunks, at most
  const int slot_chunks = (16 + splits - 1) / splits;

  if (threadIdx.x == 0) {   // expected arrivals: producer 1, consumer warps 8, dequantizers 8
    if constexpr (kIngest) {
      prefetch_map(&tm_x);
      prefetch_map(&tm_q);
      prefetch_map(&tm_s);
    }
    for (int s = 0; s < kXStages; ++s) mbar_init(xr.full(s), 1), mbar_init(xr.empty(s), 8);
    for (int s = 0; s < kWStages; ++s) mbar_init(wr.full(s), 1), mbar_init(wr.empty(s), 8);
    for (int s = 0; s < kBStages; ++s) mbar_init(br.full(s), 8), mbar_init(br.empty(s), 8);
    if constexpr (kIngest) mbar_init(base + L::kGatherBar, 1);
    fence_barrier_init();
    if (kIngest && splits > 1) {   // the other splits' sums of this block's column chunks
      const int mine = first_chunk(split + 1, splits) - first_chunk(split, splits);
      mbar_expect_tx(base + L::kGatherBar, (uint32_t)((splits - 1) * live * mine * 16));
    }
  }
  __syncthreads();

  if (warp < 4) {   // producer
    regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      auto load_w = [&](int i) {
        wr.wait_empty(i);
        const uint32_t w = base + L::kWRing + (i % kWStages) * L::kWBytes;
        mbar_expect_tx(wr.full(i), L::kWBytes);
        tma_load_2d(w, &tm_q, wr.full(i), n0, (s0 + i) * (kBK * Planes::kBits / 8));
        tma_load_2d(w + Planes::kQBytes, &tm_s, wr.full(i), n0, (s0 + i) * (kBK / 32));
      };
      // a dependent launch fills its ring of value tiles before the wait:
      // the planes are nobody's output
      const int primed = kPdl == kPdlSecondary ? min(kWStages, n_steps) : 0;
      for (int i = 0; i < primed; ++i) load_w(i);
      if constexpr (kPdl == kPdlSecondary) pdl_sync();
      for (int i = 0; i < n_steps; ++i) {
        xr.wait_empty(i);
        mbar_expect_tx(xr.full(i), kIngest ? (uint32_t)x_rows * kBK * 2 : kXBytes);
        tma_load_2d(base + L::kXRing + (i % kXStages) * kXBytes, &tm_x, xr.full(i),
                    (s0 + i) * kBK, m0);
        if (i >= primed) load_w(i);
      }
    }
    if (kIngest && splits > 1) cluster_arrive(), cluster_wait();
    return;
  }

  if (warp < 12) {   // dequantizers
    regs_release<kDequantRegs>();
    for (int i = 0; i < n_steps; ++i) {
      wr.wait_full(i);
      if constexpr (!kIngest) br.wait_empty(i);
      Planes::dequantize(gbase + L::kWRing + (i % kWStages) * L::kWBytes,
                         gbase + L::kBRing + (i % kBStages) * kBBytes, threadIdx.x - 128,
                         [&] {
                           if constexpr (kIngest) br.wait_empty(i);
                         });
      fence_proxy_async();   // the B tile is read by wgmma (the async proxy)
      br.arrive_warp(br.full(i));
      wr.arrive_warp(wr.empty(i));
    }
    if (kIngest && splits > 1) cluster_arrive(), cluster_wait();
    return;
  }

  // consumers: warpgroup wg computes rows wg * 64 .. + 63 of the tile; with
  // x_rows 64 (a grid of one row tile, M <= 64) the second warpgroup's rows
  // are past M and never loaded: it only passes the slots back
  regs_claim<kConsumerRegs>();
  const int wg = warp / 4 - 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  if (kIngest && wg * 64 >= x_rows) {
    for (int i = 0; i < n_steps; ++i) {
      xr.wait_full(i);
      br.wait_full(i);
      xr.arrive_warp(xr.empty(i));
      br.arrive_warp(br.empty(i));
    }
    if (splits > 1) cluster_arrive(), cluster_wait();
    return;
  }
  for (int i = 0; i < n_steps; ++i) {
    xr.wait_full(i);
    br.wait_full(i);
    const uint32_t x = base + L::kXRing + (i % kXStages) * kXBytes + wg * 64 * 128;
    const uint32_t bt = base + L::kBRing + (i % kBStages) * kBBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss<1>(acc, desc_sw128(x + 32 * kk, 16, 1024),
                             desc_sw128(bt + 2048 * kk, 8192, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();   // step i - 1 has retired: its x and B tiles are free
    fence_regs(acc);
    if (i >= 1) {
      xr.arrive_warp(xr.empty(i - 1));
      br.arrive_warp(br.empty(i - 1));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int lane = threadIdx.x % 32;
  const int ct = threadIdx.x - 384;   // consumer thread 0-255
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col = n0 + 2 * (lane % 4);   // chunk j's first column: col + 8 j
  if (!kIngest || splits == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (row < M) ep(row, col + 8 * j, acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < M) ep(row + 8, col + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }

  // every thread of the cluster is past its rings: send each other block the
  // sums of its column chunks, into its x ring, slot (sender, ct, chunk)
  cluster_arrive();
  cluster_wait();
  if (ct >= live) return;   // rows past M: nothing to send or store
  const uint32_t slots = base + L::kXRing;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = chunk_owner(j, splits);
    if (r != split) {
      const uint32_t at = slots + (uint32_t)(((split * kConsumerThreads + ct) * slot_chunks +
                                              j - first_chunk(r, splits)) * 16);
      st_async(map_rank(at, r),
               make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]),
               map_rank(base + L::kGatherBar, r));
    }
  }
  mbar_wait_cluster(base + L::kGatherBar, 0);
  const float4* got = reinterpret_cast<const float4*>(gbase + L::kXRing);
  const int j0 = first_chunk(split, splits);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (chunk_owner(j, splits) != split) continue;
    const float4 own = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    float4 v = split == 0 ? own : got[ct * slot_chunks + j - j0];
    for (int s = 1; s < splits; ++s) {   // in split order
      const float4 p = s == split ? own : got[(s * kConsumerThreads + ct) * slot_chunks + j - j0];
      v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
    }
    if (row < M) ep(row, col + 8 * j, v.x, v.y);
    if (row + 8 < M) ep(row + 8, col + 8 * j, v.z, v.w);
  }
}

// host: launch the tiles body on `stream` over x (M, K) bf16 and the planes
// (qs: K x Np int8 or K/2 x Np packed int4; scales K/32 x Np f32), `splits`
// splits of K in runs of `unit` 64-row steps, one cluster a tile; a
// kPdlSecondary launch with the programmatic-dependent-launch attribute.
// Returns 0 or a cudaError_t.
template <class Planes, class Epilogue, int kPdl, bool kIngest>
static int launch_tiles(const void* x, const void* qs, const void* scales, const Epilogue& ep,
                        int M, int K, int Np, int splits, int unit, cudaStream_t stream,
                        unsigned long long& smem_allowed) {
  using L = Layout<Planes>;
  const int runs = unit > 0 ? ((K + kBK - 1) / kBK + unit - 1) / unit : 0;
  if (M <= 0 || K <= 0 || K % 32 || Np <= 0 || Np % kBN || splits < 1 ||
      splits > (kIngest ? kMaxSplits : 1) || splits > runs)
    return (int)cudaErrorInvalidValue;
  // a grid of one row tile holding at most 64 rows loads x's 64 rows only
  const int x_rows = kIngest && M <= 64 ? 64 : kBM;
  CUtensorMap maps[3];
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {kBK, (cuuint32_t)x_rows};
  const cuuint64_t q_dims[2] = {(cuuint64_t)Np, (cuuint64_t)(K * Planes::kBits / 8)};
  const cuuint64_t q_stride[1] = {(cuuint64_t)Np};
  const cuuint32_t q_box[2] = {kBN, kBK * Planes::kBits / 8};
  const cuuint64_t s_dims[2] = {(cuuint64_t)Np, (cuuint64_t)(K / 32)};
  const cuuint64_t s_stride[1] = {(cuuint64_t)Np * 4};
  const cuuint32_t s_box[2] = {kBN, kBK / 32};
  int rc = encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_stride,
                      x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qs, q_dims, q_stride, q_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = encode_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, s_dims, s_stride,
                    s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  rc = allow_smem(tiles_kernel<Planes, Epilogue, kPdl, kIngest>, (int)L::kSmemBytes, smem_allowed);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Np / kBN, (M + kBM - 1) / kBM, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (splits > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = 1;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = splits;
    ++n;
  }
  if (kPdl == kPdlSecondary) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, tiles_kernel<Planes, Epilogue, kPdl, kIngest>, maps[0], maps[1],
                         maps[2], ep, M, K, splits, unit, x_rows);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// host: how many clusters of `splits` tiles blocks (one block an SM) the
// current device holds at once (cudaOccupancyMaxActiveClusters), or minus a
// cudaError_t: what the wrapper's plan counts waves in
template <class Planes, class Epilogue, int kPdl, bool kIngest>
static int max_clusters(int splits, unsigned long long& smem_allowed) {
  using L = Layout<Planes>;
  if (splits < 1 || splits > kMaxSplits) return -(int)cudaErrorInvalidValue;
  const int rc = allow_smem(tiles_kernel<Planes, Epilogue, kPdl, kIngest>, (int)L::kSmemBytes,
                            smem_allowed);
  if (rc != 0) return -rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmemBytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = splits;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(tiles_kernel<Planes, Epilogue, kPdl, kIngest>), &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace owk_qwg
