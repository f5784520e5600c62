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
//  * f32: the same two passes with plain FMA (no tf32, so the result holds
//    the plain version to 1e-4), 32 queries per block, 4 threads per row;
//    it serves narrow f32 models only and is not redesigned.
//
// Requires head dim 64; bf16: q/k/v on 16-byte boundaries; f32: T % 64 ==
// 0; 1 <= n_valid <= T. The Python wrapper checks and pads the f32 path.
// Launches on the caller's stream and returns the cudaError_t of the launch
// (or of the tensor-map encoding).

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

constexpr int kQ32 = 32;   // f32: queries per block
constexpr int kK32 = 32;   // f32: keys per tile

__global__ void __launch_bounds__(128)
mha_packed_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int T, int S, int n_valid, float scale) {
  __shared__ float q_sh[kQ32][kHeadDim + 1];
  __shared__ float k_sh[kK32][kHeadDim + 1];
  __shared__ float v_sh[kK32][kHeadDim];
  __shared__ float p_sh[kQ32][kK32 + 1];

  const int tid = threadIdx.x;
  const int row = tid >> 2;   // 4 consecutive lanes per query row
  const int sub = tid & 3;
  const int q0 = blockIdx.x * kQ32;
  const size_t base = (size_t)blockIdx.z * T * S + (size_t)blockIdx.y * kHeadDim;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int i = tid; i < kQ32 * kHeadDim; i += 128)
    q_sh[i / kHeadDim][i % kHeadDim] = qb[(size_t)(q0 + i / kHeadDim) * S + i % kHeadDim];

  const int n_tiles = (n_valid + kK32 - 1) / kK32;
  auto load_tile = [&](const float* src, int t0, bool to_k) {
    for (int i = tid; i < kK32 * kHeadDim; i += 128) {
      const float x = src[(size_t)(t0 + i / kHeadDim) * S + i % kHeadDim];
      if (to_k) k_sh[i / kHeadDim][i % kHeadDim] = x;
      else v_sh[i / kHeadDim][i % kHeadDim] = x;
    }
  };
  auto score = [&](int t0, int c) {
    float acc = 0.0f;
#pragma unroll 16
    for (int d = 0; d < kHeadDim; ++d) acc = fmaf(q_sh[row][d], k_sh[c][d], acc);
    return (t0 + c < n_valid) ? acc * scale : -INFINITY;
  };

  float m = -INFINITY, l = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kK32;
    __syncthreads();
    load_tile(kb, t0, true);
    __syncthreads();
    float sv[8];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sv[j] = score(t0, sub * 8 + j);
      tmax = fmaxf(tmax, sv[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) part += expf(sv[j] - m_new);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    l = l * expf(m - m_new) + part;
    m = m_new;
  }

  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kK32;
    __syncthreads();
    load_tile(kb, t0, true);
    load_tile(vb, t0, false);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = sub * 8 + j;
      p_sh[row][c] = expf(score(t0, c) - m) / l;
    }
    __syncthreads();
    for (int c = 0; c < kK32; ++c) {
      const float pc = p_sh[row][c];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(pc, v_sh[c][sub * 16 + j], acc[j]);
    }
  }
  float* ob = o + base + (size_t)(q0 + row) * S + sub * 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) ob[j] = acc[j];
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

extern "C" int owk_mha_packed_f32(const void* q, const void* k, const void* v,
                                  void* o, int B, int T, int S, int n_valid,
                                  float scale, void* stream) {
  const dim3 grid(T / kQ32, S / kHeadDim, B);
  mha_packed_f32_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, T, S,
      n_valid, scale);
  return (int)cudaGetLastError();
}
