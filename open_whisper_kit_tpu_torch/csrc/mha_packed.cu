// Kernel K1: encoder self-attention on the packed (B, T, S = H*64) layout.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/attention.py::_mha_packed
// (kernel body _packed_kernel). Same contract: non-causal multi-head
// attention read and written in the natural (B, T, S) layout with no head
// transposes; scores q.k in f32 times `scale`; keys at or past `n_valid` are
// -inf; softmax over the whole row in f32; probabilities normalised, then
// cast to the input type before P.V, which accumulates in f32; output in the
// input type.
//
// What bounds it on the H100: at whisper's T = 1536, d = 64, H = 20 and 1500
// live keys, QK^T and PV are 2 * 2 * 20 * 1536 * 1500 * 64 = 11.8 GFLOP per
// window against 16 MB of q/k/v reads and output: about 740 FLOP per byte,
// far above the card's ~295 bf16 FLOP/byte ridge, so the tensor cores bound
// it (11.9 us at 989 TFLOP/s for one window; the two passes below do 1.5x
// that tensor work). The exponentials are next: two per score, 92 M for one
// window, about 25 us of the SFUs' 16 a clock per SM.
//
// Design (bf16; Hopper: TMA, mbarriers, wgmma):
//  * One block per (128-query tile, head, batch element): a producer
//    warpgroup (one thread issues every load; setmaxnreg leaves it 40
//    registers a thread) and two consumer warpgroups of 64 query rows each
//    (232 registers a thread). 384 threads, one block per SM. At T = 1536
//    that is 12 x 20 x B blocks: 240 (1.8 waves of 132 SMs, the second 82 %
//    full) for one window, 1920 (14.5 waves) for a batched round of eight.
//  * The producer issues TMA loads of the block's Q tile (128 x 64 bf16,
//    16 KB) once and then of 128-key x 64-dim tiles, straight from the
//    (B, T, S) tensors at column head * 64 through 3-D tensor maps (rows
//    past T load as zero, so T need not be padded), into a ring of eight
//    16 KB stages with full / empty mbarriers: K tiles for pass 1, then K
//    and V tiles in turn for pass 2. Key tiles wholly past n_valid are not
//    loaded.
//  * Pass 1 (the TPU kernel's full-row softmax statistics): per key tile,
//    S = Q K^T by four wgmma m64n128k16 (both operands in shared memory,
//    128-byte swizzle), keys >= n_valid set to -inf, the row max and the
//    running sum of exp in registers; each row lives on one quad of the
//    accumulator layout (shfl_xor 1, 2). The next tile's S is in flight
//    while this tile's statistics are taken (two score buffers).
//  * Pass 2: S is recomputed (bit for bit the pass-1 scores), p = exp(s -
//    max) / sum in f32 is rounded to bf16 exactly where the TPU kernel
//    rounds it, packed from the accumulator registers into wgmma A
//    fragments, and O += P V by eight wgmma m64n64k16 with P in registers
//    and the V tile read MN-major (the descriptor's transpose bit). The next
//    tile's S is issued with this tile's P V, and its exponentials run while
//    P V does. A one-pass online softmax would normalise after the bf16
//    rounding; the second QK^T is the price of the TPU kernel's rounding
//    point.
//  * Scores are taken in base 2 (scale * log2 e folded into one multiply)
//    and normalised by a multiply with 1 / sum.
//  * What holds it back: the special-function unit. Each score takes two
//    exponentials on the SFU's 16 lanes an SM a clock, against 4096 tensor
//    FLOP a clock: per 128-key tile a warpgroup's 8192 + 8192 exponentials
//    take 1024 SFU clocks, its three products 768 tensor clocks.
//
// Design (f32; mma.sync in 3xTF32, thread-block clusters):
//  * The function at f32: the cast of p to the input type is the identity,
//    so there is no rounding point between the row sums and P V, and a
//    one-pass online softmax (a running max m, sum l and output o, rescaled
//    by exp(m_old - m_new) as the keys come) computes the same function up
//    to the order of its f32 sums. The second Q K^T pass that the bf16 body
//    pays for its rounding point is not needed here.
//  * The grid is (key chunks, 64-query tiles, heads x batch); a query
//    tile's chunks are one thread-block cluster of 1, 2, 4 or 8. The number
//    of chunks comes from the wrapper's plan (ops/attention.py::
//    mha_f32_plan) so that the grid fills the card, two blocks of 128
//    threads a multiprocessor: at the narrow models' two heads, 24 query
//    tiles x 2 heads x 4 chunks = 192 blocks (the first f32 body had 96
//    blocks and walked all 1500 keys twice in each); at large-v3-turbo's
//    20 heads, 480 blocks of one chunk.
//  * Each block streams its chunk's K and V in 64-key tiles through a
//    double-buffered cp.async ring (rows past the chunk load as zero, keys
//    past n_valid score -inf; query rows past T load as zero and are not
//    written: no padding copy), and keeps m, l and o in f32 registers.
//  * Q K^T and P V run on the tensor cores as mma.sync m16n8k8 in TF32,
//    split for f32 accuracy: each operand a = hi + lo (hi a TF32 value,
//    lo = a - hi), and d += lo * hi' + hi * lo' + hi * hi' ("3xTF32"),
//    which leaves out only lo * lo' and lo's last bits, each under 2^-20 of
//    a product (one TF32 product alone errs by about 1e-3). P's fragments are the score
//    registers as they lie: the k index of a P V step is permuted so that
//    key 2t and 2t + 1 of an 8-key tile feed k indices t and t + 4, and V's
//    rows are read in the same order. 272-byte rows keep every fragment
//    load free of bank conflicts.
//  * The chunks meet over distributed shared memory: each block leaves its
//    partial (m, l, o) in its shared memory, the cluster barrier publishes
//    them, and block r combines rows r * ceil(64 / chunks) .. + of every
//    chunk's partial in chunk order (w = exp(m_c - max_c m_c), o = sum
//    o_c w, l = sum l_c w) and writes o / l.
//  * What bounds it: the f32 products, 4 * T * n_valid * 64 FLOP a head
//    (17.6 us at narrow width against the f32 peak of 67 TFLOP/s; in
//    3xTF32 on the tensor cores they are three times that work at the TF32
//    rate of 495 TFLOP/s, 7.2 us).
//
// Requires head dim 64 and q/k/v on 16-byte boundaries; 1 <= n_valid <= T.
// The Python wrapper checks. Launches on the caller's stream and returns
// the cudaError_t of the launch (or of the tensor-map encoding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

using namespace owk_sm90;

constexpr int kHeadDim = 64;
constexpr int kBQ = 128;                 // bf16: queries per block
constexpr int kBKey = 128;               // bf16: keys per tile
constexpr int kStages = 8;               // bf16: K / V ring depth
constexpr int kThreads = 384;            // a producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168,   // the launch allocation, 384 x 168
              "setmaxnreg: more registers asked for than the block holds");
constexpr uint32_t kTileBytes = kBQ * kHeadDim * 2;   // 16 KB, Q and K / V tiles alike
constexpr size_t kSmemBytes = 1024 + (1 + kStages) * kTileBytes + 8 * (2 * kStages + 1);

// S = Q K^T for one warpgroup's 64 rows against one 128-key tile, issued
// and committed as one wgmma group; the caller waits for it
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t q_rows, uint32_t k_tile) {
  wgmma_fence();
  wgmma_m64n128k16_ss_first<0>(s, desc_sw128(q_rows, 16, 1024), desc_sw128(k_tile, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma_m64n128k16_ss<0>(s, desc_sw128(q_rows + 32 * kk, 16, 1024),
                           desc_sw128(k_tile + 32 * kk, 16, 1024), 1);
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// scores in base 2 (times scale * log2 e), keys >= n_valid at -inf
__device__ __forceinline__ void scale_and_mask(float (&s)[64], int key0, int n_valid,
                                               float scale_log2) {
  if (key0 + kBKey <= n_valid) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
    return;
  }
  const int c = key0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = c + 8 * j + e < n_valid;
      s[4 * j + e] = live ? s[4 * j + e] * scale_log2 : -INFINITY;
      s[4 * j + 2 + e] = live ? s[4 * j + 2 + e] * scale_log2 : -INFINITY;
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the K / V ring as the consumers see it: tile `idx` of the producer's order
struct Ring {
  uint32_t tiles, bars;
  __device__ __forceinline__ uint32_t acquire(int idx) const {
    mbar_wait(bars + 8 * (idx % kStages), (idx / kStages) & 1);
    return tiles + (idx % kStages) * kTileBytes;
  }
  // after this warpgroup's products on tile idx have retired
  __device__ __forceinline__ void release(int idx) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(bars + 8 * (kStages + idx % kStages));
  }
};

// row statistics for pass 1
struct Stats {
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
};

// pass 1, tile t: fold S(t), retired and in `cur`, into the running row
// max and sum of exp2(s - max)
__device__ __forceinline__ void row_stats(float (&cur)[64], int t, int n_valid,
                                          float scale_log2, Stats& st) {
  scale_and_mask(cur, t * kBKey, n_valid, scale_log2);
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    x0 = fmaxf(x0, fmaxf(cur[4 * j], cur[4 * j + 1]));
    x1 = fmaxf(x1, fmaxf(cur[4 * j + 2], cur[4 * j + 3]));
  }
  const float n0 = fmaxf(st.m0, quad_max(x0)), n1 = fmaxf(st.m1, quad_max(x1));
  float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    p0 += ex2(cur[4 * j] - n0) + ex2(cur[4 * j + 1] - n0);
    p1 += ex2(cur[4 * j + 2] - n1) + ex2(cur[4 * j + 3] - n1);
  }
  st.l0 = st.l0 * ex2(st.m0 - n0) + p0;   // m finite after tile 0: key 0 is live
  st.l1 = st.l1 * ex2(st.m1 - n1) + p1;
  st.m0 = n0;
  st.m1 = n1;
}

// pass 1, tile t < n_tiles - 1: S(t) is in flight in `cur`; issue S(t + 1)
// into `nxt`, then fold S(t) in. No wgmma is issued under a condition: a
// register array written by a wgmma on one path only is merged by moves that
// ptxas sees as writes into a running wgmma, and it then serialises them all.
__device__ __forceinline__ void pass1_step(float (&cur)[64], float (&nxt)[64], int t,
                                           const Ring& ring, uint32_t q_rows, int n_valid,
                                           float scale_log2, Stats& st) {
  issue_scores(nxt, q_rows, ring.acquire(t + 1));
  wgmma_wait<1>();
  fence_regs(cur);
  ring.release(t);
  row_stats(cur, t, n_valid, scale_log2, st);
}

// pass 1, the last tile
__device__ __forceinline__ void pass1_last(float (&cur)[64], int t, const Ring& ring,
                                           int n_valid, float scale_log2, Stats& st) {
  wgmma_wait<0>();
  fence_regs(cur);
  ring.release(t);
  row_stats(cur, t, n_valid, scale_log2, st);
}

// s -> exp2(s - m) / l in f32, in place
__device__ __forceinline__ void normalise(float (&s)[64], float m0, float m1, float r0,
                                          float r1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[4 * j] = ex2(s[4 * j] - m0) * r0;
    s[4 * j + 1] = ex2(s[4 * j + 1] - m0) * r0;
    s[4 * j + 2] = ex2(s[4 * j + 2] - m1) * r1;
    s[4 * j + 3] = ex2(s[4 * j + 3] - m1) * r1;
  }
}

// the probabilities rounded to bf16 (the TPU kernel's rounding point) and
// packed as the A fragments of P V: p[kk] holds keys 16 kk .. + 15
__device__ __forceinline__ void pack(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // h: keys + 8 h
      const int j = 8 * kk + 4 * h;
      p[kk][2 * h] = pack_bf16(s[j], s[j + 1]);
      p[kk][2 * h + 1] = pack_bf16(s[j + 2], s[j + 3]);
    }
}

// O += P V(tile at v_tile), issued as one wgmma group; the caller waits
__device__ __forceinline__ void issue_pv(float (&acc)[32], const uint32_t (&p)[8][4],
                                         uint32_t v_tile) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)   // keys 16 kk .. + 15: 16 rows of 128 bytes
    wgmma_m64n64k16_rs<1>(acc, p[kk], desc_sw128(v_tile + 2048 * kk, 16, 1024), 1);
  wgmma_commit();
}

// pass 2, tile t < n_tiles - 1 (ring tiles K(t) = n_tiles + 2t, V(t) = that
// + 1): P(t) is in `p`; issue S(t + 1), then O += P(t) V(t); while the
// second runs, turn S(t + 1) into probabilities, and pack them into `p` once
// P(t) is no longer read
__device__ __forceinline__ void pass2_step(uint32_t (&p)[8][4], float (&s)[64],
                                           float (&acc)[32], int t, int n_tiles,
                                           const Ring& ring, uint32_t q_rows, int n_valid,
                                           float scale_log2, const Stats& st, float r0,
                                           float r1) {
  const int v_idx = n_tiles + 2 * t + 1;
  const uint32_t v_tile = ring.acquire(v_idx);
  issue_scores(s, q_rows, ring.acquire(v_idx + 1));
  issue_pv(acc, p, v_tile);
  wgmma_wait<1>();   // S(t + 1) is in; P(t) V(t) may still run
  fence_regs(s);
  ring.release(v_idx + 1);
  scale_and_mask(s, (t + 1) * kBKey, n_valid, scale_log2);
  normalise(s, st.m0, st.m1, r0, r1);
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(v_idx);
  pack(s, p);
}

__global__ void __launch_bounds__(kThreads, 1)
mha_packed_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int T, int S, int n_valid,
                       float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // swizzled tiles: 1024-aligned
  const uint32_t q_tile = base;
  const Ring ring{base + kTileBytes, base + (1 + kStages) * kTileBytes};   // full[s], empty[s]
  const uint32_t q_bar = ring.bars + 16 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int head = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * kBQ;
  const int n_tiles = (n_valid + kBKey - 1) / kBKey;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.bars + 8 * s, 1);                  // the producer's expect-tx arrival
      mbar_init(ring.bars + 8 * (kStages + s), 8);      // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {   // producer: Q once, then K tiles (pass 1), then K, V in turn (pass 2)
    regs_release<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_bar, kTileBytes);
      tma_load_3d(q_tile, &tm_q, q_bar, head * kHeadDim, q0, b);
      for (int i = 0; i < 3 * n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(ring.bars + 8 * (kStages + s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(ring.bars + 8 * s, kTileBytes);
        const bool is_v = i >= n_tiles && ((i - n_tiles) & 1);
        const int tile = i < n_tiles ? i : (i - n_tiles) >> 1;
        tma_load_3d(ring.tiles + s * kTileBytes, is_v ? &tm_v : &tm_k, ring.bars + 8 * s,
                    head * kHeadDim, tile * kBKey, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg holds query rows wg * 64 .. + 63 of the tile
  regs_claim<kConsumerRegs>();
  const int wg = warp / 4 - 1;
  const uint32_t q_rows = q_tile + wg * 64 * 128;
  mbar_wait(q_bar, 0);

  // pass 1: row max m and row sum l of exp2(s - m), per thread, then per row
  Stats st;
  {
    float sa[64], sb[64];   // two score buffers, named: the register arrays need fixed indices
    issue_scores(sa, q_rows, ring.acquire(0));
    int t = 0;
    for (; t + 2 < n_tiles; t += 2) {
      pass1_step(sa, sb, t, ring, q_rows, n_valid, scale_log2, st);
      pass1_step(sb, sa, t + 1, ring, q_rows, n_valid, scale_log2, st);
    }
    if (t + 1 < n_tiles) {
      pass1_step(sa, sb, t, ring, q_rows, n_valid, scale_log2, st);
      pass1_last(sb, t + 1, ring, n_valid, scale_log2, st);
    } else {
      pass1_last(sa, t, ring, n_valid, scale_log2, st);
    }
  }
  const float r0 = 1.0f / quad_sum(st.l0), r1 = 1.0f / quad_sum(st.l1);

  // pass 2: p = bf16(exp2(s - m) / l), O += P V
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  {
    float s[64];
    uint32_t p[8][4];
    issue_scores(s, q_rows, ring.acquire(n_tiles));
    wgmma_wait<0>();
    fence_regs(s);
    ring.release(n_tiles);
    scale_and_mask(s, 0, n_valid, scale_log2);
    normalise(s, st.m0, st.m1, r0, r1);
    pack(s, p);
    for (int t = 0; t + 1 < n_tiles; ++t)
      pass2_step(p, s, acc, t, n_tiles, ring, q_rows, n_valid, scale_log2, st, r0, r1);
    const int v_last = 3 * n_tiles - 1;
    issue_pv(acc, p, ring.acquire(v_last));
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(v_last);
  }

  // epilogue: bf16 pairs straight to the (B, T, S) output, rows past T dropped
  const int row = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  __nv_bfloat16* out = o + (size_t)b * T * S + head * kHeadDim + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (row < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * S + 8 * j) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * S + 8 * j) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- f32: one pass, the live keys split over a cluster ----

constexpr int kFQ = 64;                 // f32: queries per block (a warp 16 rows)
constexpr int kFKeys = 64;              // f32: keys per tile
constexpr int kFLd = kHeadDim + 4;      // f32 a K / V row in shared memory (272 bytes)
constexpr int kFThreads = 128;
constexpr int kFMaxCluster = 8;         // the portable cluster size
constexpr uint32_t kFTileBytes = kFKeys * kFLd * 4;
// two K and two V tiles (double-buffered); after the loop the first two
// hold the block's partial: o (64 x 64), the row maxima and sums
constexpr int kFSmemBytes = 4 * kFTileBytes;
static_assert(kFQ * kHeadDim * 4 + 2 * kFQ * 4 <= 2 * kFTileBytes, "the partial must fit");

// x = hi + lo for the tensor cores' TF32 (which read a register's sign,
// exponent and top 10 mantissa bits): hi is x with its low 13 mantissa bits
// cleared, lo = x - hi (exact in f32), of which the product reads the top
// 11 significant bits. hi * hi' + hi * lo' + lo * hi' then leaves out only
// lo * lo' and lo's cut bits, each under 2^-20 of the product: f32 accuracy
// for two integer operations an operand (a rounding cvt.rna.tf32 for each
// part measured 25-30 % slower on the H100, PERF.md)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D (16 x 8, f32) += A (16 x 8, tf32) * B (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: the two small products first, then the large one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// One block per (key chunk, 64-query tile, head x batch element); a query
// tile's chunks are one cluster (rank = blockIdx.x). Four warps, warp w the
// query rows 16 w .. + 15 of the tile. Each block runs an online softmax
// over its chunk's keys (64-key tiles through a double-buffered cp.async
// ring) and leaves its partial (row max m, row sum l, unnormalised o) in
// shared memory; then block r combines rows r * ceil(64 / chunks) .. of
// every chunk's partial, in chunk order, and writes o / l.
__global__ void __launch_bounds__(kFThreads, 2)
mha_packed_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int T, int S,
                      int n_valid, int chunk_keys, float scale_log2) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int chunks = gridDim.x, c = blockIdx.x, q0 = blockIdx.y * kFQ;
  const int H = S / kHeadDim, head = blockIdx.z % H, b = blockIdx.z / H;
  const size_t base = (size_t)b * T * S + (size_t)head * kHeadDim;
  const int key_lo = c * chunk_keys, key_hi = min(key_lo + chunk_keys, n_valid);
  const int n_tiles = max(key_hi - key_lo + kFKeys - 1, 0) / kFKeys;

  // K and V tile `t` of this chunk into buffer `buf`: 16 pieces of 16 bytes a
  // row, rows past the chunk zero
  auto load = [&](int t, int buf) {
    const int key0 = key_lo + t * kFKeys;
    const uint32_t ks = smem_u32(fsm) + buf * kFTileBytes;
    const uint32_t vs = ks + 2 * kFTileBytes;
#pragma unroll
    for (int i = tid; i < kFKeys * 16; i += kFThreads) {
      const int r = i / 16, pc = i % 16;
      const bool live = key0 + r < key_hi;
      const size_t at = base + (size_t)(live ? key0 + r : key_lo) * S + pc * 4;
      cp_async16_zfill(ks + (r * kFLd + pc * 4) * 4, k + at, live);
      cp_async16_zfill(vs + (r * kFLd + pc * 4) * 4, v + at, live);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (n_tiles > 0) load(0, 0);

  // this warp's query rows as A fragments: qf[kk] = rows g and g + 8, dims
  // 8 kk + t4 and + 4 (rows past T zero)
  const int row0 = q0 + warp * 16 + g;
  float qf[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e & 1), dim = 8 * kk + t4 + 4 * (e >> 1);
      qf[kk][e] = row < T ? q[base + (size_t)row * S + dim] : 0.0f;
    }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};   // rows g, g + 8
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(t + 1, (t + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* ks = fsm + (t & 1) * (kFTileBytes / 4);
    const float* vs = ks + 2 * (kFTileBytes / 4);

    // S = Q K^T: keys 8 j .. + 7 in s[j] (rows g / g + 8, keys 8 j + 2 t4, + 1)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(qf[kk][e], ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* kr = ks + (8 * j + g) * kFLd + 8 * kk + t4;
        mma_3xtf32(s[j], ah, al, kr[0], kr[4]);
      }
    }

    // scores in base 2, keys past the chunk -inf; the running max and sum
    const int key0 = key_lo + t * kFKeys;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = key0 + 8 * j + 2 * t4 + (e & 1) < key_hi;
        s[j][e] = live ? s[j][e] * scale_log2 : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    float alpha[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(tmax[h]));
      mu[h] = mn == -INFINITY ? 0.0f : mn;   // a row with no live key yet: exp2(-inf) = 0
      alpha[h] = ex2(m[h] - mu[h]);
      m[h] = mn;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - mu[e >> 1]);
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: the k-step j takes keys 8 j .. + 7, k index t4 being key
    // 8 j + 2 t4 and t4 + 4 key 8 j + 2 t4 + 1, so P's fragments are the
    // score registers as they lie
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(pa[e], ah[e], al[e]);
      const float* vr = vs + (8 * j + 2 * t4) * kFLd + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) mma_3xtf32(acc[n], ah, al, vr[8 * n], vr[kFLd + 8 * n]);
    }
    __syncthreads();   // the buffer is free for the load two tiles on
  }

  // this block's partial: o (64 x 64), then m and l of the 64 rows
  float* po = fsm;
  float* pm = fsm + kFQ * kHeadDim;
  float* pl = pm + kFQ;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<float2*>(po + r0 * kHeadDim + 8 * n + 2 * t4) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(po + (r0 + 8) * kHeadDim + 8 * n + 2 * t4) =
        make_float2(acc[n][2], acc[n][3]);
  }
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  if (t4 == 0) {
    pm[r0] = m[0], pm[r0 + 8] = m[1];
    pl[r0] = l0, pl[r0 + 8] = l1;
  }
  cluster_arrive();   // release: every block's partial is written past the barrier
  cluster_wait();

  // block c combines its rows of the tile over the chunks, in chunk order
  const int per = (kFQ + chunks - 1) / chunks, rb = c * per, re = min(rb + per, kFQ);
  for (int i = tid; i < (re - rb) * kHeadDim; i += kFThreads) {
    const int r = rb + i / kHeadDim, col = i % kHeadDim;
    float mx = -INFINITY;
    for (int cc = 0; cc < chunks; ++cc) mx = fmaxf(mx, ld_cluster(map_rank(smem_u32(pm + r), cc)));
    float lsum = 0.0f, osum = 0.0f;
    for (int cc = 0; cc < chunks; ++cc) {
      const float w = ex2(ld_cluster(map_rank(smem_u32(pm + r), cc)) - mx);
      lsum += ld_cluster(map_rank(smem_u32(pl + r), cc)) * w;
      osum += ld_cluster(map_rank(smem_u32(po + r * kHeadDim + col), cc)) * w;
    }
    if (q0 + r < T) o[base + (size_t)(q0 + r) * S + col] = osum / lsum;
  }
  cluster_arrive();   // no block leaves while another still reads its partial
  cluster_wait();
}

}  // namespace

extern "C" int owk_mha_packed_bf16(const void* q, const void* k, const void* v,
                                   void* o, int B, int T, int S, int n_valid,
                                   float scale, void* stream) {
  // (B, T, S) as 3-D maps, innermost first; a box is 128 rows of one head
  const cuuint64_t dims[3] = {(cuuint64_t)S, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)S * 2, (cuuint64_t)T * S * 2};
  const cuuint32_t box[3] = {kHeadDim, kBQ, 1};
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = encode_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, src[i], dims,
                              strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  static unsigned long long smem_allowed = 0;
  const int rc = allow_smem(mha_packed_bf16_kernel, (int)kSmemBytes, smem_allowed);
  if (rc != 0) return rc;
  const dim3 grid((T + kBQ - 1) / kBQ, S / kHeadDim, B);
  mha_packed_bf16_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)o, T, S, n_valid,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// f32: grid (chunks, query tiles of 64, heads x B), a query tile's chunks one
// cluster; chunk_keys a multiple of 64 with chunks = ceil(n_valid /
// chunk_keys) <= 8 (ops/attention.py::mha_f32_plan); q/k/v/o on 16-byte
// boundaries. Any T (rows past T neither read nor written).
extern "C" int owk_mha_packed_f32(const void* q, const void* k, const void* v,
                                  void* o, int B, int T, int S, int n_valid, int chunks,
                                  int chunk_keys, float scale, void* stream) {
  if (chunks < 1 || chunks > kFMaxCluster || chunk_keys % kFKeys ||
      (long long)chunks * chunk_keys < n_valid || (chunks - 1) * chunk_keys >= n_valid)
    return (int)cudaErrorInvalidValue;
  static unsigned long long smem_allowed = 0;
  const int rc = allow_smem(mha_packed_f32_kernel, kFSmemBytes, smem_allowed);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, (T + kFQ - 1) / kFQ, (S / kHeadDim) * B);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = kFSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = chunks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mha_packed_f32_kernel, (const float*)q,
                                           (const float*)k, (const float*)v, (float*)o, T, S,
                                           n_valid, chunk_keys, scale * 1.4426950408889634f);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
