// The decode-row body of the int8 dequantize-matmul: y = bf16(x) @ bf16(q * s)
// for M <= 16 rows of x. Kernel K3's "rows" route (entry in qmm_rows.cu) and
// both halves of kernel K5 at M <= 16 (ffn_int8.cu) run it; K4 (int4
// planes) still runs the older qmm_tile.cuh body. The stage is one 32-row
// scale block of a 128-column tile, and only the TMA boxes and the
// dequantizing step know the plane's format. Three things are template
// parameters, so that each kernel has its own instantiation and K3's is the
// one it always was: the ring's depth (K3: 4 stages), the epilogue that
// stores the first split's sums (K3 and K5's second half: f32, StoreF32Rows;
// K5's first half: bias + gelu_tanh rounded to bf16, BiasGeluBf16Rows), and
// the launch's place in a programmatic-dependent-launch pair (kPdl: none for
// K3; K5's first half signals its dependents at its start, its second half
// issues its weight stages at once and waits for the first half only
// before it reads x, which is h).
//
// Contract (the TPU kernel's _qmm_kernel): x (M, K) bf16; qs (K, Np) int8 and
// scales (K/32, Np) f32; each weight is q * s in f32, rounded to bf16 once;
// the products sum in f32; out (M, Np) f32. K % 32 == 0, Np % 128 == 0.
//
// What bounds it: bytes, and at the decoder's small planes the latency of
// one launch. At M <= 16 a weight byte feeds at most 32 FLOP, a tenth of the
// H100's ~295 FLOP/byte ridge, so the floor is the plane stream (K * Np
// values + K/32 * Np * 4 of scales) at 3.35 TB/s: 0.55 us for a 1280 x 1280
// plane, 1.7 us for qkv's 1280 x 3840, 22 us for the W8 logits. A 1.8 MB
// plane is all in flight at once when ~100 blocks each ask for their share,
// so there the time is one HBM round trip, the math of a block's share and
// the combine of the splits, on top of the launch.
//
// Design:
//  * The grid is (Np / 128 column tiles) x (splits of K), and the splits of
//    a column tile are one thread-block cluster. The wrapper's plan
//    (ops/quant_matmul.py::qmm_rows_plan) aims at about 100 blocks, with at
//    most 8 splits (the portable cluster size): 1280 -> 1280 at 10 tiles x
//    8 splits, 1280 -> 3840 at 30 x 4; the W8 logits have 406 tiles and one
//    split (no cluster). More splits cost more in the combine than they
//    gain (kernel_times.py times the rows route over a range of splits). Split s takes the scale blocks [s * nkb / splits,
//    (s + 1) * nkb / splits): whole 32-row blocks, one more or less a split.
//  * One producer thread issues the TMA loads of a stage (the 32 x 128 int8
//    tile, 128-byte swizzle, 4 KB; its 128 scales, 512 bytes) into a ring of
//    kStages stages on full / empty mbarriers (K3: four, 18 KB in flight per
//    block, four blocks per SM; K5's halves: 14 and 20, as deep as their
//    splits at whisper-large). It issues the first stages right after
//    initialising the barriers, before the block synchronises.
//  * x's rows of the split are loaded once per block into shared memory (8
//    or 16 rows, rows >= M as zeros) by the four consumer warps while the
//    first stages arrive.
//  * The math is mma.sync m16n8k16 (bf16 -> f32), not wgmma and not FMAs:
//    at M <= 16 the stream bounds the kernel, and a 16-row A fragment from
//    shared memory costs 4 loads a step; FMAs would cost M per weight, which
//    at M = 16 outruns the SM's FMA rate at the stream's pace. Consumer warp
//    w takes rows 16 (w % 2) .. + 15 of every stage and columns 64 (w / 2)
//    .. + 63: lane (g, q) reads rows 2q, 2q + 1, 2q + 8, 2q + 9 (the B
//    fragment's own k) at columns 8g .. 8g + 7 as four 8-byte words (the
//    swizzle makes them conflict-free), releases the stage, then dequantizes
//    in registers (q at the byte permute of q_at, times its scale in f32,
//    rounded to bf16: the TPU kernel's rounding point) and runs eight
//    products, one per byte j: product j's column g is column 8g + j.
//  * The two warps of a column half add their sums in shared memory in a
//    fixed order (the stage's rows 0-15 first). With one split the block
//    stores its 128 columns. Otherwise every split but the first sends its
//    M x 128 partial sums into the first split's shared memory (st.async
//    over the cluster, counted on an mbarrier there), and the first split
//    adds them to its own in split order and stores the tile. No float
//    atomics and no global workspace: the result is the same bits from run
//    to run. The cluster barrier that makes the first split's mbarrier ready
//    is split in two: a relaxed arrive at the start (the init is released
//    by its own fence), a wait just before sending. (A
//    combine through global memory, partials and a ticket for the last
//    block of the tile to arrive, puts a fence, an atomic and the loads, three
//    trips through L2, after the last split's sums; this puts one transfer
//    inside the GPC there. `kernel_times.py --ablate` times the kernel
//    without its combine and without clusters.)
//
// The caller gives the tensor maps of qs and scales, encoded once per plane
// by encode_rows_maps (owk_qmm_rows_maps, owk_ffn_int8_maps).

#pragma once

#include "sm90.cuh"

namespace owk_qrows {

using namespace owk_sm90;

constexpr int kBN = 128;          // output columns of a block: one 128-byte int8 TMA row
constexpr int kQK = 32;           // K rows a stage: one scale block
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (1 + kConsumerWarps);   // warp 0 the producer
constexpr int kMaxSplits = 8;                         // the portable cluster size
constexpr uint32_t kQBytes = kQK * kBN;               // 4 KB of values a stage
constexpr uint32_t kSBytes = kBN * 4;                 // 512 bytes of scales a stage
// caps of the plans: x's rows (ROWS_X_SMEM, plus 16 bytes of padding a row,
// 16 rows) and the gathered partials (K3: ROWS_GATHER; K5: FFN_GATHER, the
// sums of 7 other splits at 16 rows, so that its splits never depend on M)
constexpr uint32_t kXCap = 40 * 1024 + 16 * 16;
constexpr uint32_t kGatherCap = 24 * 1024;
constexpr uint32_t kFfnGatherCap = 7 * 16 * kBN * 4;

// Shared memory of a ring of kStages stages, from a 1024-aligned base: the
// value tiles (each 1024-aligned, as the 128-byte swizzle needs; after the
// loop they hold the half sums), the scale rows, the ring's barriers, the
// gather barrier, then x's rows and (first split only) the other splits'
// partial sums.
template <int kStages>
struct Layout {
  static constexpr uint32_t kQRing = 0;
  static constexpr uint32_t kSRing = kQRing + kStages * kQBytes;
  static constexpr uint32_t kBars = kSRing + kStages * kSBytes;
  static constexpr uint32_t kGatherBar = kBars + 16 * kStages;
  static constexpr uint32_t kXs = kGatherBar + 16;
  // the most a block may ask for, with gathered partials of at most kGather bytes
  template <uint32_t kGather>
  static constexpr int max_smem() { return 1024 + kXs + kXCap + kGather; }
  static_assert(kStages * kQBytes >= 2 * 8 * 32 * 16, "the half sums must fit the value tiles");
};

// bf16 x to keep per x row in shared memory: the longest split, + 8 so that
// the eight rows a fragment load touches fall in distinct banks
__host__ __device__ inline int x_stride(int K, int splits) {
  const int nkb = K / kQK;
  return (nkb + splits - 1) / splits * kQK + 8;
}

__host__ __device__ inline int x_bytes(int M, int K, int splits) {
  return (M <= 8 ? 8 : 16) * x_stride(K, splits) * 2;
}

template <int kStages>
__host__ __device__ inline int smem_bytes(int M, int K, int splits) {
  return 1024 + Layout<kStages>::kXs + x_bytes(M, K, splits) + (splits - 1) * M * kBN * 4;
}

// the first split's store of four consecutive sums of one row (col a
// multiple of 4): f32 as they are (K3; K5's second half)
struct StoreF32Rows {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int row, int col, float4 v) const {
    *reinterpret_cast<float4*>(out + (size_t)row * ld + col) = v;
  }
};

// h = bf16(gelu_tanh(v + b)), the formula of jax.nn.gelu(approximate=True)
// and of qmm_tile.cuh's BiasGeluBf16, with the bias b in f32 or bf16 (TB),
// widened to f32 (K5's first half)
template <typename TB>
struct BiasGeluBf16Rows {
  __nv_bfloat16* h;
  const TB* b;
  int ld;
  static __device__ __forceinline__ float gelu(float u) {
    return u * (0.5f * (1.0f + tanhf(0.7978845608028654f * (u + 0.044715f * (u * u * u)))));
  }
  __device__ __forceinline__ void operator()(int row, int col, float4 v) const {
    float4 bb;
    if constexpr (sizeof(TB) == 4) {
      bb = *reinterpret_cast<const float4*>(b + col);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(b + col);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      bb = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    uint2 w;
    w.x = pack_bf16(gelu(v.x + bb.x), gelu(v.y + bb.y));
    w.y = pack_bf16(gelu(v.z + bb.z), gelu(v.w + bb.w));
    *reinterpret_cast<uint2*>(h + (size_t)row * ld + col) = w;
  }
};

// a launch's place in a programmatic-dependent-launch pair
constexpr int kPdlNone = 0;        // an ordinary launch (K3)
constexpr int kPdlPrimary = 1;     // lets its dependent launch start at once (K5's first half)
constexpr int kPdlSecondary = 2;   // a dependent launch: reads x only after its wait

// D (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A lane's 16 sums of one row, columns 16q .. 16q + 15 of its column half:
// column 16q + j is acc[j][e], column 16q + 8 + j is acc[j][e + 1] (e = 0:
// row g, e = 2: row g + 8); as four float4 in column order.
__device__ __forceinline__ float4 sums4(const float (&acc)[8][4], int e, int u) {
  const int j = 4 * (u & 1), c = e + (u >> 1);
  return make_float4(acc[j][c], acc[j + 1][c], acc[j + 2][c], acc[j + 3][c]);
}

__device__ __forceinline__ void add4(float (&acc)[8][4], int e, int u, float4 v) {
  const int j = 4 * (u & 1), c = e + (u >> 1);
  acc[j][c] += v.x, acc[j + 1][c] += v.y, acc[j + 2][c] += v.z, acc[j + 3][c] += v.w;
}

template <int kStages, class Epilogue, int kPdl>
__global__ void __launch_bounds__(kThreads, 4)
qmm_rows_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_s,
                const __nv_bfloat16* __restrict__ x, const Epilogue ep, int M, int K, int splits) {
  using L = Layout<kStages>;
  constexpr uint32_t kQRing = L::kQRing, kSRing = L::kSRing, kXs = L::kXs;
  if constexpr (kPdl == kPdlPrimary) pdl_trigger();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const StageRing<kStages> ring{base + L::kBars};

  const int tile = blockIdx.x, split = blockIdx.y;   // a cluster: the splits of one tile
  const int n0 = tile * kBN;
  const int nkb = K / kQK;
  const int kb0 = split * nkb / splits;
  const int n_steps = (split + 1) * nkb / splits - kb0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gather_bytes = (splits - 1) * M * kBN * 4;

  // the producer thread: barriers, then the first stages, before the sync
  auto issue = [&](int i) {
    mbar_expect_tx(ring.full(i), kQBytes + kSBytes);
    tma_load_2d(base + kQRing + (i % kStages) * kQBytes, &tm_q, ring.full(i), n0,
                (kb0 + i) * kQK);
    tma_load_2d(base + kSRing + (i % kStages) * kSBytes, &tm_s, ring.full(i), n0, kb0 + i);
  };
  const int primed = n_steps < kStages ? n_steps : kStages;
  if (threadIdx.x == 0) {
    prefetch_map(&tm_q);
    prefetch_map(&tm_s);
    for (int s = 0; s < kStages; ++s)
      mbar_init(ring.full(s), 1), mbar_init(ring.empty(s), kConsumerWarps);
    mbar_init(base + L::kGatherBar, 1);
    fence_barrier_init();
    for (int i = 0; i < primed; ++i) issue(i);
    if (split == 0 && splits > 1) mbar_expect_tx(base + L::kGatherBar, gather_bytes);
  }
  // the first split's gather barrier must be ready before the others send:
  // every thread arrives on the cluster barrier now and waits before it
  // sends or exits
  if (splits > 1) cluster_arrive_relaxed();
  __syncthreads();

  if (warp == 0) {   // producer
    if (lane == 0) {
      for (int i = primed; i < n_steps; ++i) {
        ring.wait_empty(i);
        issue(i);
      }
    }
    if (splits > 1) cluster_wait();
    return;
  }

  // x's rows of this split -> shared memory, rows past M as zeros
  const int cw = warp - 1;                 // consumer warp
  const int ct = threadIdx.x - 32;         // consumer thread 0-127
  const int xs_ld = x_stride(K, splits);
  const bool rows16 = M > 8;
  __nv_bfloat16* const xs = reinterpret_cast<__nv_bfloat16*>(gbase + kXs);
  {
    // a dependent launch's x is its primary's output: read it after the
    // wait, through L2 (not the read-only path)
    if constexpr (kPdl == kPdlSecondary) pdl_sync();
    const int chunks = n_steps * kQK / 8;   // 16-byte chunks a row
    const __nv_bfloat16* src = x + kb0 * kQK;
    for (int c = ct; c < (rows16 ? 16 : 8) * chunks; c += 32 * kConsumerWarps) {
      const int m = c / chunks, k = (c % chunks) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const uint4* p = reinterpret_cast<const uint4*>(src + (size_t)m * K + k);
        v = kPdl == kPdlSecondary ? __ldcg(p) : __ldg(p);
      }
      *reinterpret_cast<uint4*>(xs + m * xs_ld + k) = v;
    }
    bar_sync(1, 32 * kConsumerWarps);
  }

  const int g = lane / 4, q = lane % 4;
  // warp cw takes rows 16 slice .. + 15 and columns 64 h .. + 63 of a stage
  const int slice = cw & 1, h = cw >> 1;
  // the byte offsets of this lane's four 8-byte words in a swizzled value tile
  uint32_t woff[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = slice * 16 + 2 * q + (r & 1) + 8 * (r >> 1);
    woff[r] = row * 128 + (((h * 4 + (g >> 1)) ^ (row & 7)) << 4) + (g & 1) * 8;
  }
  const uint32_t* const xw = reinterpret_cast<const uint32_t*>(xs);
  const int xa = (g * xs_ld + slice * 16 + 2 * q) / 2;       // word of row g
  const int xb = xa + 4 * xs_ld;                             // row g + 8

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int i = 0; i < n_steps; ++i) {
    ring.wait_full(i);
    const uint8_t* qt = gbase + kQRing + (i % kStages) * kQBytes;
    const float* st =
        reinterpret_cast<const float*>(gbase + kSRing + (i % kStages) * kSBytes) + h * 64 + 8 * g;
    uint2 w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = *reinterpret_cast<const uint2*>(qt + woff[r]);
    float s[8];
    *reinterpret_cast<float4*>(&s[0]) = *reinterpret_cast<const float4*>(st);
    *reinterpret_cast<float4*>(&s[4]) = *reinterpret_cast<const float4*>(st + 4);
    ring.arrive_warp(ring.empty(i));   // the stage is in registers: the producer may refill it

    const int xk = i * (kQK / 2);      // 16 words of x a stage
    const uint32_t a0 = xw[xa + xk], a2 = xw[xa + xk + 4];
    const uint32_t a1 = rows16 ? xw[xb + xk] : 0u;
    const uint32_t a3 = rows16 ? xw[xb + xk + 4] : 0u;
    uint32_t v[2][4];   // [columns 0-3, 4-7][row], each byte + 128
#pragma unroll
    for (int r = 0; r < 4; ++r) v[0][r] = w[r].x ^ 0x80808080u, v[1][r] = w[r].y ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* vj = v[j >> 2];
      const float sj = s[j];
      const uint32_t b0 = pack_bf16(q_at(vj[0], j & 3) * sj, q_at(vj[1], j & 3) * sj);
      const uint32_t b1 = pack_bf16(q_at(vj[2], j & 3) * sj, q_at(vj[3], j & 3) * sj);
      mma_16816(acc[j], a0, a1, a2, a3, b0, b1);
    }
  }

  // the two 16-row slices of a column half meet in shared memory: warp 2h +
  // 1's sums are added to warp 2h's, in that order
  float4* const red = reinterpret_cast<float4*>(gbase + kQRing) + h * 8 * 32 + lane;
  bar_sync(1, 32 * kConsumerWarps);   // every warp is past the ring
  if (slice == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[j * 32] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  bar_sync(1, 32 * kConsumerWarps);
  if (slice == 1) {
    if (splits > 1) cluster_wait();
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = red[j * 32];
    acc[j][0] += v.x, acc[j][1] += v.y, acc[j][2] += v.z, acc[j][3] += v.w;
  }

  const int col = h * 64 + 16 * q;   // this lane's first column in the tile
  if (splits > 1) cluster_wait();
  if (split > 0) {   // send the partial sums to the first split: slot split - 1
    const uint32_t bar = map_rank(base + L::kGatherBar, 0);
    const uint32_t slot =
        base + kXs + x_bytes(M, K, splits) + (uint32_t)((split - 1) * M) * kBN * 4 + col * 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = g + 8 * half;
      if (row < M) {
        const uint32_t dst = map_rank(slot + row * kBN * 4, 0);
#pragma unroll
        for (int u = 0; u < 4; ++u) st_async(dst + 16 * u, sums4(acc, 2 * half, u), bar);
      }
    }
    return;
  }
  if (splits > 1) {   // the first split adds the others' sums, in split order
    mbar_wait_cluster(base + L::kGatherBar, 0);
    const float* parts =
        reinterpret_cast<const float*>(gbase + kXs + x_bytes(M, K, splits)) + col;
    for (int p = 0; p < splits - 1; ++p)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        if (row < M) {
          const float* src = parts + (size_t)(p * M + row) * kBN;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            add4(acc, 2 * half, u, *reinterpret_cast<const float4*>(src + 4 * u));
        }
      }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (row < M) {
#pragma unroll
      for (int u = 0; u < 4; ++u) ep(row, n0 + col + 4 * u, sums4(acc, 2 * half, u));
    }
  }
}

// host: the two tensor maps of one plane, qs (K, Np) int8 and scales
// (K / 32, Np) f32, for the stage's boxes (128 columns by 32 rows, 128-byte
// swizzle; 128 scales). Returns 0 or a cudaError_t.
static int encode_rows_maps(const void* qs, const void* scales, int K, int Np, CUtensorMap* maps) {
  if (K <= 0 || K % kQK || Np <= 0 || Np % kBN) return (int)cudaErrorInvalidValue;
  const cuuint64_t q_dims[2] = {(cuuint64_t)Np, (cuuint64_t)K};
  const cuuint64_t q_stride[1] = {(cuuint64_t)Np};
  const cuuint32_t q_box[2] = {kBN, kQK};
  const cuuint64_t s_dims[2] = {(cuuint64_t)Np, (cuuint64_t)(K / kQK)};
  const cuuint64_t s_stride[1] = {(cuuint64_t)Np * 4};
  const cuuint32_t s_box[2] = {kBN, 1};
  const int rc = encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qs, q_dims, q_stride,
                            q_box, CU_TENSOR_MAP_SWIZZLE_128B);
  return rc != 0 ? rc
                 : encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, s_dims,
                              s_stride, s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// host: launch one rows-body kernel on `stream`, a cluster of `splits`
// blocks per column tile, a kPdlSecondary launch with the
// programmatic-dependent-launch attribute; a block's gathered partials may
// take at most kGather bytes. Returns 0 or a cudaError_t.
template <int kStages, uint32_t kGather, class Epilogue, int kPdl>
static int launch_rows(const CUtensorMap (&maps)[2], const void* x, const Epilogue& ep, int M,
                       int K, int Np, int splits, cudaStream_t stream,
                       unsigned long long& smem_allowed) {
  if (M < 1 || M > 16 || K <= 0 || K % kQK || Np <= 0 || Np % kBN || splits < 1 ||
      splits > kMaxSplits || splits > K / kQK)
    return (int)cudaErrorInvalidValue;
  constexpr int kMax = Layout<kStages>::template max_smem<kGather>();
  const int smem = smem_bytes<kStages>(M, K, splits);
  if (smem > kMax) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(qmm_rows_kernel<kStages, Epilogue, kPdl>, kMax, smem_allowed);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Np / kBN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (splits > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = 1;
    attrs[n].val.clusterDim.y = splits;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (kPdl == kPdlSecondary) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, qmm_rows_kernel<kStages, Epilogue, kPdl>,
                                            maps[0], maps[1],
                                            static_cast<const __nv_bfloat16*>(x), ep, M, K,
                                            splits);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace owk_qrows
