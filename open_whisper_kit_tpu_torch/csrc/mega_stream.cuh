// The body of kernels K2 (mega_step.cu), K7 (mega_beam.cu) and K8
// (mega_batch.cu): one decoder step for R <= 8 rows (K2: consecutive tokens
// of one stream; K7: one token of each of B beams; K8: one token of each of
// B independent streams) as a chain of launches whose weight streams run
// ahead of their dependencies.
//
// Two kernels, each launched once per stage of a K2 step (K7 and K8 launch
// the GEMV and, for the attention over their row-flat caches, the block
// attention kernel of mega_blocks.cuh):
//
// gemv_kernel<kind>: Y = stage-in(X) @ W for the R rows, W a dense bf16, int8
// (per-32-row f32 scales) or split-half int4 (per-32-row bf16 scales) plane
// of one layer; a layernorm prologue and QKV, residual, bias, GELU and f32
// logits epilogues, at the TPU kernel's rounding points.
//  * The grid is (Np / 128 column tiles) x (splits of K); the splits of a
//    column tile are one thread-block cluster (at most 8, the portable size).
//    The plan (ops/decode_megakernel.py::mega_step_plan) depends on the
//    field's format, K and N only, never on R.
//  * One producer thread streams the plane through a TMA ring of `depth`
//    stages (the plan's: as many as the split has where shared memory
//    allows, so the whole split is in flight before the wait): a
//    stage is 32 rows x 128 columns and its scales (int8: 4 KB + 128 f32;
//    dense: two 64-wide 4 KB boxes, 128-byte swizzle; int4: 32 packed rows,
//    whose low nibbles are K rows p and high nibbles K rows p + K/2, + the
//    128 bf16 scales of both halves). The planes are (L, K, N) stacks read
//    through 3-D tensor maps (the layer the third coordinate; the logits
//    plane a stack of one).
//  * Programmatic dependent launch: every thread signals
//    griddepcontrol.launch_dependents first, and the producer issues the
//    ring's stages before the consumers' griddepcontrol.wait, so the next
//    stage's blocks (launched as soon as this one's are all resident) have
//    their weight tiles in flight while this stage computes. The consumers
//    fetch their constants then too (the split's layernorm weights, the
//    epilogue's biases) and zero x's rows past R. Nothing the step produces
//    (x0, head, the residual rows, q, the new K/V rows) is read before the
//    wait, and nothing global is written before it: a chain may start
//    while the one before it is still running.
//  * After the wait the four consumer warps load the split's R x rows into
//    shared memory, layernormed where the stage has a layernorm (the R rows
//    come in whole, one trip; a warp a row takes their statistics from
//    registers, the same order for every R), and the epilogue lanes read
//    the residual values they will add to. The math is mma.sync m16n8k16
//    (bf16 -> f32) on rows 0-7, with each weight dequantized in registers
//    (value x scale in f32, rounded to bf16) as qmm_rows.cuh does it: warp w
//    takes rows 16 (w % 2) .. + 15 of a stage and columns 64 (w / 2) .. +
//    63, two stages a turn (their loads and dequantizing overlap; each is
//    added in stage order).
//  * The splits meet in the first split's shared memory: every other split
//    sends its R x 128 partial sums there with st.async over the cluster,
//    and the first adds them in split order and runs the epilogue. No
//    global partials, no ticket, no float atomics: the same bits every run.
//    Each output row's sums run in an order that R does not change (the
//    tensor core sums each row alone), so every verify row is bit-identical
//    to the one-row step at its position.
//  * The QKV epilogue writes row r's new K and V at cache row head *
//    head_stride + r: K2's natural (Tc, S) cache (stride 1), K7's and K8's
//    row-flat time-major (Tc * B, S) cache (stride B: slot b at time t is
//    row t * B + b).
//
// attend_kernel (K2's self- and cross-attention, K7's cross-attention): the R
// query rows of one head against a key set in one pass.
// The grid is (heads) x (key chunks), a head's chunks one cluster (at most
// 8); the chunk length depends on Tp = min(Tc, n_text_ctx) for the
// self-cache (so the greedy loop's cache and the speculative loop's, Tp +
// gamma + 4 rows, split every row's keys alike) and on Ta for the
// cross-KV.
//  * The cross-KV chunk is copied (cp.async, 16 bytes a thread) before the
//    griddepcontrol.wait: it is fixed for the window, so it streams in while
//    the stages before run. The self-cache rows are copied after the wait: a
//    chain still in flight from the step before may be writing them (before
//    it, their lines are only prefetched into L2).
//  * Each block scores its keys for the R rows into shared memory (f32; Q
//    K^T on mma.sync, the K rows 144 bytes apart so fragment loads meet no
//    bank conflict), keeps each row's chunk max and sum of exponentials,
//    and the cluster exchanges them over distributed shared memory (one
//    round of loads). Every block then forms
//    the row max M and sum L from all chunks in chunk order (the same
//    numbers in every block), p = bf16(exp(s - M) / L) for its keys (the
//    rounding point of the full-row softmax) and its partial P.V in f32
//    (mma.sync, V's fragments by ldmatrix.trans).
//    The other chunks send their partials to the first with st.async, and
//    the first adds them in chunk order and rounds to bf16.
//  * Row r of K2's self-attention sees keys [0, min(head + 1 + r, Tc)); a
//    chunk wholly past a row's limit gives it max -inf and sum 0, as in the
//    one-row launch.

#pragma once

#include <math.h>
#include <string.h>

#include "sm90.cuh"

namespace mstream {

using namespace owk_sm90;
typedef __nv_bfloat16 bf16;

constexpr int kBN = 128;             // output columns of a GEMV block
constexpr int kQK = 32;              // K rows (int4: packed rows) a stage: one scale block
constexpr int kMaxDepth = 20;        // stages a GEMV ring may hold (the plan's depth)
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (1 + kConsumerWarps);   // GEMV: warp 0 the producer
constexpr int kRows = 8;             // x rows a GEMV block holds: R <= 8, the rest zero
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kDH = 64;              // head width
constexpr int kKV = kDH + 8;         // bf16 a K/V/q row in shared memory (144 bytes: no bank conflicts)
constexpr int kAttnThreads = 128;
constexpr int kMaxChunk = 256;       // keys a block of attend_kernel
constexpr int kMaxSmem = 200 * 1024; // what the kernels opt in to (the planner's MEGA_MAX_SMEM)
constexpr int kMaxLnK = 2048;        // the widest row a layernorm prologue takes

enum Kind { kDense = 0, kInt8 = 1, kInt4 = 2 };
enum Epi { kEpiQKV = 0, kEpiResid = 1, kEpiBias = 2, kEpiGelu = 3, kEpiLogits = 4 };

// bytes of a stage: the value tile(s), 1024-aligned for the swizzle, and the
// scale row(s)
__host__ __device__ constexpr uint32_t w_bytes(int kind) { return kind == kDense ? 8192 : 4096; }
__host__ __device__ constexpr uint32_t s_bytes(int kind) { return kind == kDense ? 0 : 512; }

// stages of K (dense, int8: 32 rows; int4: 32 packed rows = 64 K rows)
__host__ __device__ inline int n_stages(int kind, int K) {
  return (kind == kInt4 ? K / 2 : K) / kQK;
}

// bf16 values of x a row holds: the longest split's run (int4: its low and
// high runs), + 8 so that the 8 rows a fragment load touches fall in
// distinct banks
__host__ __device__ inline int run_len(int kind, int K, int splits) {
  const int n = n_stages(kind, K);
  return (n + splits - 1) / splits * kQK;
}
__host__ __device__ inline int x_stride(int kind, int K, int splits) {
  return (kind == kInt4 ? 2 : 1) * run_len(kind, K, splits) + 8;
}

// shared memory of a GEMV block, from a 1024-aligned base: the ring of
// `depth` stages (values, then scales), its barriers, the gather barrier,
// x's rows, the other splits' R x 128 partial sums (first split), and with
// a layernorm the R input rows whole (with one split x's rows are the whole
// rows, int4's two runs included, and hold them) and the split's layernorm
// weights
struct GemvLayout {
  uint32_t s_ring, bars, gather_bar, xs, parts, xrow, lnwb, total;
};

__host__ __device__ inline GemvLayout gemv_layout(int kind, int K, int S, int splits, int depth,
                                                  int R, bool ln) {
  GemvLayout o;
  const int runs = kind == kInt4 ? 2 : 1;
  uint32_t at = depth * w_bytes(kind);
  o.s_ring = at; at += depth * s_bytes(kind);
  o.bars = at; at += 16 * kMaxDepth;
  o.gather_bar = at; at += 16;
  o.xs = at; at += kRows * x_stride(kind, K, splits) * 2;
  o.parts = at; at += (splits - 1) * R * kBN * 4;
  o.xrow = at; if (ln && splits > 1) at += R * (S + 8) * 2;   // one split: staged in xs
  o.lnwb = at; if (ln) at += 2 * runs * run_len(kind, K, splits) * 2;
  o.total = 1024 + at;
  return o;
}

// attend_kernel's shared memory: K and V of the chunk and q (bf16, 144-byte
// rows), the scores, P (bf16), the chunk statistics and the cluster's, the
// warps' P.V sums, this chunk's partial, the other chunks' partials
struct AttnLayout {
  uint32_t vs, qb, sc, pb, stats, allst, red, part, gath, bar, total;
};

__host__ __device__ inline AttnLayout attn_layout(int chunk, int chunks, int R) {
  AttnLayout o;
  uint32_t at = chunk * kKV * 2;
  o.vs = at; at += chunk * kKV * 2;
  o.qb = at; at += kRows * kKV * 2;
  o.sc = at; at += kRows * chunk * 4;
  o.pb = at; at += kRows * (chunk + 8) * 2;
  o.stats = at; at += kRows * 8;
  o.allst = at; at += kMaxCluster * kRows * 8;
  o.red = at; at += kConsumerWarps * kRows * kDH * 4;
  o.part = at; at += R * kDH * 4;
  o.gath = at; at += (chunks - 1) * R * kDH * 4;
  o.bar = at; at += 16;
  o.total = at;
  return o;
}

// -- device helpers ------------------------------------------------------------

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// wait until the grids this one depends on have completed and their writes
// are visible (a no-op for a launch without the dependent-launch attribute)
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float bround(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  u.z = pack_bf16(f[4], f[5]);
  u.w = pack_bf16(f[6], f[7]);
  return u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// D (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16); rows 8-15 of A
// are zero here (a1 = a3 = 0)
__device__ __forceinline__ void mma_rows8(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// a nibble (0-15, byte k of u) minus 8 as f32, exactly (as q_at)
__device__ __forceinline__ float nib_at(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) - 8388616.0f;
}

__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// -- the GEMV ------------------------------------------------------------------

struct GemvArgs {
  const bf16* in;        // the R input rows, K wide (with a layernorm: the residual rows)
  const bf16* lnw;       // this layernorm's weight and bias rows, or null
  const bf16* lnb;
  const bf16* bias;      // this layer's N biases (null for the logits)
  bf16* out;             // q / cq (S wide), the GELU rows (N wide) or the residual rows
  float* out_f32;        // the logits rows (N wide)
  bf16* kk;              // this layer's self-cache: row r's new K/V at head * head_stride + r
  bf16* vv;
  const long long* head; // on the card
  const bf16* x0;        // the first stage only: x0, copied to `xres`
  bf16* xres;
  long long cache_rows;  // a row at or past it is not written
  float eps;
  float kq;              // bf16(dh^-0.25) as f32
  int K, N, S, R, layer, splits, depth, epi;
  int head_stride;       // K2 1, K7 and K8 B
};

// one row's 16 sums at columns n .. n + 15 -> the stage's output; `bq` the
// 16 biases, `rq` the 16 residual values (both read ahead)
__device__ __forceinline__ void epilogue16(const GemvArgs& a, int r, int n, const float (&v)[16],
                                           const uint4 (&bq)[2], const uint4 (&rq)[2]) {
  if (a.epi == kEpiLogits) {
    float4* dst = reinterpret_cast<float4*>(a.out_f32 + (size_t)r * a.N + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
    return;
  }
  float t[16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float b[8];
    unpack8(bq[h], b);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[8 * h + j] = bround(bround(v[8 * h + j]) + b[j]);
  }
  bf16* dst;
  float y[16];
  switch (a.epi) {
    case kEpiQKV: {
      // the 128-column tile lies wholly in q, k or v (S % 128 == 0)
      const int S = a.S;
      if (n < S) {
        dst = a.out + (size_t)r * S + n;
#pragma unroll
        for (int j = 0; j < 16; ++j) y[j] = t[j] * a.kq;
      } else {
        const long long crow = *a.head * a.head_stride + r;
        if (crow >= a.cache_rows) return;
        if (n < 2 * S) {
          dst = a.kk + (size_t)crow * S + (n - S);
#pragma unroll
          for (int j = 0; j < 16; ++j) y[j] = t[j] * a.kq;
        } else {
          dst = a.vv + (size_t)crow * S + (n - 2 * S);
#pragma unroll
          for (int j = 0; j < 16; ++j) y[j] = t[j];
        }
      }
      break;
    }
    case kEpiResid: {
      dst = a.out + (size_t)r * a.N + n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[8];
        unpack8(rq[h], x);
#pragma unroll
        for (int j = 0; j < 8; ++j) y[8 * h + j] = x[j] + t[8 * h + j];
      }
      break;
    }
    case kEpiGelu: {
      dst = a.out + (size_t)r * a.N + n;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float u = t[j];
        y[j] = u * (0.5f * (1.0f + tanhf(0.7978845608028654f * (u + 0.044715f * (u * u * u)))));
      }
      break;
    }
    default: {   // kEpiBias
      dst = a.out + (size_t)r * a.N + n;
#pragma unroll
      for (int j = 0; j < 16; ++j) y[j] = t[j];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = y[8 * h + j];
    reinterpret_cast<uint4*>(dst)[h] = pack8(f);
  }
}

// one stage's operands for one consumer warp lane: the weight words, the
// scales, x's A fragments (int4: of both runs)
struct Frag {
  uint4 wd[4];
  uint2 wq[4];
  float s0[8], s1[8];
  uint32_t a0, a2, h0, h2;
};

// lane (g, q) of warp (slice, h): rows 2q, 2q + 1, 2q + 8, 2q + 9 of the
// stage at columns 8g .. 8g + 7 of the half (woff), their scales, and x's
// words of row g at the stage's k (xk; int4 also the high run, xhi on)
template <int kKind>
__device__ __forceinline__ void load_frag(Frag& f, const uint8_t* wt, const uint8_t* st,
                                          const uint32_t (&woff)[4], const uint32_t* xw, int xk,
                                          int xhi) {
  f.a0 = xw[xk];
  f.a2 = xw[xk + 4];
  if constexpr (kKind == kDense) {
#pragma unroll
    for (int r = 0; r < 4; ++r) f.wd[r] = *reinterpret_cast<const uint4*>(wt + woff[r]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) f.wq[r] = *reinterpret_cast<const uint2*>(wt + woff[r]);
  }
  if constexpr (kKind == kInt8) {
    const float* sc = reinterpret_cast<const float*>(st);
    *reinterpret_cast<float4*>(&f.s0[0]) = *reinterpret_cast<const float4*>(sc);
    *reinterpret_cast<float4*>(&f.s0[4]) = *reinterpret_cast<const float4*>(sc + 4);
  }
  if constexpr (kKind == kInt4) {
    const bf16* sc = reinterpret_cast<const bf16*>(st);
    unpack8(*reinterpret_cast<const uint4*>(sc), f.s0);
    unpack8(*reinterpret_cast<const uint4*>(sc + 128), f.s1);
    f.h0 = xw[xk + xhi];
    f.h2 = xw[xk + xhi + 4];
  }
}

// the stage's eight products into acc: product j's column g is column 8g + j;
// each weight dequantized in registers (value x scale in f32, rounded to bf16)
template <int kKind>
__device__ __forceinline__ void mma_frag(float (&acc)[8][4], const Frag& f) {
  if constexpr (kKind == kDense) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      const uint32_t b0 = __byte_perm(word_of(f.wd[0], j >> 1), word_of(f.wd[1], j >> 1), sel);
      const uint32_t b1 = __byte_perm(word_of(f.wd[2], j >> 1), word_of(f.wd[3], j >> 1), sel);
      mma_rows8(acc[j], f.a0, f.a2, b0, b1);
    }
  } else if constexpr (kKind == kInt8) {
    uint32_t v[2][4];   // [columns 0-3, 4-7][row], each byte + 128
#pragma unroll
    for (int r = 0; r < 4; ++r) v[0][r] = f.wq[r].x ^ 0x80808080u, v[1][r] = f.wq[r].y ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* vj = v[j >> 2];
      const float sj = f.s0[j];
      const uint32_t b0 = pack_bf16(q_at(vj[0], j & 3) * sj, q_at(vj[1], j & 3) * sj);
      const uint32_t b1 = pack_bf16(q_at(vj[2], j & 3) * sj, q_at(vj[3], j & 3) * sj);
      mma_rows8(acc[j], f.a0, f.a2, b0, b1);
    }
  } else {   // int4: the low nibbles against x's low run, the high against the high
    uint32_t lo[2][4], hi[2][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      lo[0][r] = f.wq[r].x & 0x0F0F0F0Fu, hi[0][r] = (f.wq[r].x >> 4) & 0x0F0F0F0Fu;
      lo[1][r] = f.wq[r].y & 0x0F0F0F0Fu, hi[1][r] = (f.wq[r].y >> 4) & 0x0F0F0F0Fu;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t* lj = lo[j >> 2];
      const uint32_t* hj = hi[j >> 2];
      const int k = j & 3;
      const float sl = f.s0[j], sh = f.s1[j];
      const uint32_t b0 = pack_bf16(nib_at(lj[0], k) * sl, nib_at(lj[1], k) * sl);
      const uint32_t b1 = pack_bf16(nib_at(lj[2], k) * sl, nib_at(lj[3], k) * sl);
      mma_rows8(acc[j], f.a0, f.a2, b0, b1);
      const uint32_t c0 = pack_bf16(nib_at(hj[0], k) * sh, nib_at(hj[1], k) * sh);
      const uint32_t c1 = pack_bf16(nib_at(hj[2], k) * sh, nib_at(hj[3], k) * sh);
      mma_rows8(acc[j], f.h0, f.h2, c0, c1);
    }
  }
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_s,
            const GemvArgs a) {
  pdl_launch_dependents();
  extern __shared__ uint8_t smem_raw[];
  __shared__ float ln_mu[kRows], ln_rs[kRows];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  constexpr uint32_t kW = w_bytes(kKind), kS = s_bytes(kKind);
  constexpr int kRuns = kKind == kInt4 ? 2 : 1;
  const int R = a.R, splits = a.splits, depth = a.depth;
  const bool ln = a.lnw != nullptr;
  const GemvLayout lay = gemv_layout(kKind, a.K, a.S, splits, depth, R, ln);
  // the ring: stage i in slot i % depth, full[slot] then empty[slot]
  const uint32_t bars = base + lay.bars, gather_bar = base + lay.gather_bar;
  auto full = [&](int slot) { return bars + 8 * slot; };
  auto empty = [&](int slot) { return bars + 8 * (kMaxDepth + slot); };

  const int tile = blockIdx.x, split = blockIdx.y;   // a cluster: a tile's splits
  const int n0 = tile * kBN;
  const int nst = n_stages(kKind, a.K);
  const int st0 = split * nst / splits;
  const int n_steps = (split + 1) * nst / splits - st0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = run_len(kKind, a.K, splits);

  // the producer thread: barriers, then the first `depth` stages before the
  // sync and before any wait on the stages in front (the planes are the
  // step's constants)
  auto issue = [&](int i) {
    const int slot = i % depth;
    const uint32_t w = base + slot * kW;
    const uint32_t sc = base + lay.s_ring + slot * kS;
    const int row = (st0 + i) * kQK;
    mbar_expect_tx(full(slot), kW + kS);
    if (kKind == kDense) {
      tma_load_3d(w, &tm_w, full(slot), n0, row, a.layer);
      tma_load_3d(w + 4096, &tm_w, full(slot), n0 + 64, row, a.layer);
    } else {
      tma_load_3d(w, &tm_w, full(slot), n0, row, a.layer);
      tma_load_3d(sc, &tm_s, full(slot), n0, st0 + i, a.layer);
      if (kKind == kInt4)   // the high half's scale block: K/2 rows on
        tma_load_3d(sc + 256, &tm_s, full(slot), n0, st0 + i + nst, a.layer);
    }
  };
  const int primed = n_steps < depth ? n_steps : depth;
  if (threadIdx.x == 0) {
    prefetch_map(&tm_w);
    if (kKind != kDense) prefetch_map(&tm_s);
    for (int s = 0; s < depth; ++s) mbar_init(full(s), 1), mbar_init(empty(s), kConsumerWarps);
    mbar_init(gather_bar, 1);
    fence_barrier_init();
    for (int i = 0; i < primed; ++i) issue(i);
    if (split == 0 && splits > 1) mbar_expect_tx(gather_bar, (splits - 1) * R * kBN * 4);
  }

  // the consumers' constants, also before the wait: the split's layernorm
  // weights, and the epilogue's biases (first split, rows g < R)
  const int cw = warp - 1;                 // consumer warp (producer: -1)
  const int ct = threadIdx.x - 32;         // consumer thread 0-127
  const int g = lane / 4, q = lane % 4;
  const int slice = cw & 1, h = cw >> 1;
  const int col = h * 64 + 16 * q;         // an epilogue lane's first column in the tile
  const bool epi_lane = warp > 0 && split == 0 && slice == 0 && g < R;
  bf16* const lnwb = reinterpret_cast<bf16*>(gbase + lay.lnwb);
  if (warp > 0 && ln) {
    const int chunks = n_steps * kQK / 8;
    for (int c = ct; c < 2 * kRuns * chunks; c += 32 * kConsumerWarps) {
      const int which = c / (kRuns * chunks), rem = c % (kRuns * chunks);
      const int run = rem / chunks, k = (rem % chunks) * 8;
      cp_async16(smem_u32(lnwb + (which * kRuns + run) * rl + k),
                 (which ? a.lnb : a.lnw) + run * (a.K / 2) + st0 * kQK + k);
    }
    cp_async_commit();
  }
  // x's rows past R are zeros for the whole step: written before the wait
  const int xs_ld = x_stride(kKind, a.K, splits);
  bf16* const xs = reinterpret_cast<bf16*>(gbase + lay.xs);
  if (warp > 0)
    for (int c = ct; c < (kRows - R) * (xs_ld / 8); c += 32 * kConsumerWarps)
      *reinterpret_cast<uint4*>(xs + (R + c / (xs_ld / 8)) * xs_ld + (c % (xs_ld / 8)) * 8) =
          make_uint4(0, 0, 0, 0);
  uint4 bq[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)}, rq[2] = {bq[0], bq[1]};
  if (epi_lane && a.bias != nullptr) {
    bq[0] = *reinterpret_cast<const uint4*>(a.bias + n0 + col);
    bq[1] = *reinterpret_cast<const uint4*>(a.bias + n0 + col + 8);
  }
  // the first split's gather barrier must be ready before the others send:
  // every thread arrives on the cluster barrier now and waits before it
  // sends or exits
  if (splits > 1) cluster_arrive_relaxed();
  __syncthreads();

  if (warp == 0) {   // producer
    if (lane == 0) {
      for (int i = primed; i < n_steps; ++i) {
        if (i >= depth) mbar_wait(empty(i % depth), ((i / depth) & 1) ^ 1);
        issue(i);
      }
    }
    if (splits > 1) cluster_wait();
    return;
  }

  // ---- from here on the step's data: wait for the stages in front ----
  pdl_wait();
  if (epi_lane && a.epi == kEpiResid) {   // the residual values this lane adds to
    const uint4* src = reinterpret_cast<const uint4*>(a.out + (size_t)g * a.N + n0 + col);
    rq[0] = src[0];
    rq[1] = src[1];
  }
  // the first stage starts the residual rows as x0 (its own input)
  if (a.xres != nullptr && split == 0 && n0 < a.S) {
    for (int c = ct; c < R * (kBN / 8); c += 32 * kConsumerWarps) {
      const int r = c / (kBN / 8), k = n0 + (c % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(a.xres + (size_t)r * a.S + k) =
          *reinterpret_cast<const uint4*>(a.x0 + (size_t)r * a.S + k);
    }
  }

  // x's rows of this split -> shared memory (int4: the low run, then the
  // high run K/2 further on); with a layernorm, the R rows come in whole
  // first (one trip), a warp a row takes their statistics (from
  // registers), and the split's values are normalised from there
  bf16* const xrow = splits == 1 ? xs : reinterpret_cast<bf16*>(gbase + lay.xrow);
  const int xr_ld = splits == 1 ? xs_ld : a.S + 8;
  if (ln) {
    for (int c = ct; c < R * (a.K / 8); c += 32 * kConsumerWarps) {
      const int r = c / (a.K / 8), k = (c % (a.K / 8)) * 8;
      *reinterpret_cast<uint4*>(xrow + r * xr_ld + k) =
          *reinterpret_cast<const uint4*>(a.in + (size_t)r * a.K + k);
    }
    cp_async_wait_all();
    bar_sync(1, 32 * kConsumerWarps);
    for (int r = cw; r < R; r += kConsumerWarps) {
      const uint4* row = reinterpret_cast<const uint4*>(xrow + r * xr_ld);
      uint4 val[kMaxLnK / 256];   // lane's 16-byte chunks c = lane + 32 i
#pragma unroll
      for (int i = 0; i < kMaxLnK / 256; ++i)
        val[i] = lane + 32 * i < a.K / 8 ? row[lane + 32 * i] : make_uint4(0, 0, 0, 0);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxLnK / 256; ++i) {
        if (lane + 32 * i >= a.K / 8) break;
        float f[8];
        unpack8(val[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += f[j];
      }
      const float mu = warp_sum(s) / a.K;
      float qs = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxLnK / 256; ++i) {
        if (lane + 32 * i >= a.K / 8) break;
        float f[8];
        unpack8(val[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - mu;
          qs += d * d;
        }
      }
      qs = warp_sum(qs);
      if (lane == 0) {
        ln_mu[r] = mu;
        ln_rs[r] = rsqrtf(qs / a.K + a.eps);
      }
    }
    bar_sync(1, 32 * kConsumerWarps);
  }
  {
    const int chunks = n_steps * kQK / 8;   // 16-byte chunks of a run
    for (int c = ct; c < R * kRuns * chunks; c += 32 * kConsumerWarps) {
      const int m = c / (kRuns * chunks), rem = c % (kRuns * chunks);
      const int run = rem / chunks, k = (rem % chunks) * 8;
      const int kg = run * (a.K / 2) + st0 * kQK + k;
      uint4 v;
      {
        if (ln) {
          float f[8], w[8], b[8];
          unpack8(*reinterpret_cast<const uint4*>(xrow + m * xr_ld + kg), f);
          unpack8(*reinterpret_cast<const uint4*>(lnwb + run * rl + k), w);
          unpack8(*reinterpret_cast<const uint4*>(lnwb + (kRuns + run) * rl + k), b);
          const float mu = ln_mu[m], rs = ln_rs[m];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float y = (f[j] - mu) * rs;
            f[j] = y * w[j] + b[j];
          }
          v = pack8(f);
        } else {
          v = *reinterpret_cast<const uint4*>(a.in + (size_t)m * a.K + kg);
        }
      }
      *reinterpret_cast<uint4*>(xs + m * xs_ld + run * rl + k) = v;
    }
    bar_sync(1, 32 * kConsumerWarps);
  }

  // warp cw takes rows 16 slice .. + 15 and columns 64 h .. + 63 of a stage;
  // lane (g, q) rows 2q, 2q + 1, 2q + 8, 2q + 9 (its B fragment's k) at
  // columns 8g .. 8g + 7 of the half: product j's column g is column 8g + j
  uint32_t woff[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = slice * 16 + 2 * q + (r & 1) + 8 * (r >> 1);
    if (kKind == kDense)   // box h, 16-byte chunk g of the row, swizzled
      woff[r] = h * 4096 + row * 128 + ((g ^ (row & 7)) << 4);
    else                   // bytes 64 h + 8 g .. + 7 of the 128-byte row, swizzled
      woff[r] = row * 128 + (((h * 4 + (g >> 1)) ^ (row & 7)) << 4) + (g & 1) * 8;
  }
  const uint32_t* const xw = reinterpret_cast<const uint32_t*>(xs);
  const int xa = (g * xs_ld + slice * 16 + 2 * q) / 2;      // word of row g
  const int xhi = rl / 2;                                   // int4: the high run
  const int soff = kKind == kInt8 ? (h * 64 + 8 * g) * 4 : (h * 64 + 8 * g) * 2;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // two stages a turn (their loads and dequantizing overlap), each added
  // into acc in stage order: the same sums as one stage a turn
  int slot = 0, i = 0;
  uint32_t phase = 0;
  auto take = [&](Frag& f, int step) {
    mbar_wait(full(slot), phase);
    load_frag<kKind>(f, gbase + slot * kW, gbase + lay.s_ring + slot * kS + soff, woff, xw,
                     xa + step * (kQK / 2), xhi);
  };
  auto release = [&](int sl) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(sl));
  };
  if (depth >= 2) {
    for (; i + 1 < n_steps; i += 2) {
      Frag f0, f1;
      const int s0 = slot;
      take(f0, i);
      if (++slot == depth) slot = 0, phase ^= 1;
      const int s1 = slot;
      take(f1, i + 1);
      if (++slot == depth) slot = 0, phase ^= 1;
      release(s0);
      release(s1);
      mma_frag<kKind>(acc, f0);
      mma_frag<kKind>(acc, f1);
    }
  }
  for (; i < n_steps; ++i) {
    Frag f;
    const int s0 = slot;
    take(f, i);
    if (++slot == depth) slot = 0, phase ^= 1;
    release(s0);
    mma_frag<kKind>(acc, f);
  }

  // the two 16-row slices of a column half meet in shared memory: warp 2h +
  // 1's sums are added to warp 2h's, in that order (rows g only: 8 rows)
  float2* const red = reinterpret_cast<float2*>(gbase) + h * 8 * 32 + lane;
  bar_sync(1, 32 * kConsumerWarps);   // every warp is past the ring
  if (slice == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[j * 32] = make_float2(acc[j][0], acc[j][1]);
  }
  bar_sync(1, 32 * kConsumerWarps);
  if (slice == 1) {
    if (splits > 1) cluster_wait();
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 v = red[j * 32];
    acc[j][0] += v.x, acc[j][1] += v.y;
  }
  // row g's 16 sums, columns 16q .. 16q + 15 of the half, in column order
  float v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = acc[j][0], v[8 + j] = acc[j][1];

  if (splits > 1) cluster_wait();
  if (split > 0) {   // send the partial sums to the first split: slot split - 1
    if (g < R) {
      const uint32_t bar = map_rank(gather_bar, 0);
      const uint32_t dst = map_rank(
          base + lay.parts + (uint32_t)(((split - 1) * R + g) * kBN + col) * 4, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        st_async(dst + 16 * u, make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]),
                 bar);
    }
    return;
  }
  if (splits > 1) {   // the first split adds the others' sums, in split order
    mbar_wait_cluster(gather_bar, 0);
    if (g < R) {
      const float* parts = reinterpret_cast<const float*>(gbase + lay.parts) + col;
      for (int p = 0; p < splits - 1; ++p) {
        const float4* src = reinterpret_cast<const float4*>(parts + (size_t)(p * R + g) * kBN);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 t = src[u];
          v[4 * u] += t.x, v[4 * u + 1] += t.y, v[4 * u + 2] += t.z, v[4 * u + 3] += t.w;
        }
      }
    }
  }
  if (g < R) epilogue16(a, g, n0 + col, v, bq, rq);
}

// -- attention -------------------------------------------------------------------

struct AttnArgs {
  const bf16* q;          // R rows (S) bf16
  const bf16* k;          // (T, S) natural layout, shared by the R rows
  const bf16* v;
  const long long* head;  // K2's self-attention: row r keys [0, min(*head + 1 + r, T)); else null
  bf16* out;              // R rows (S) bf16
  int T;                  // rows of k / v (the self-cache's Tc, or Ta)
  int S, R, chunk;
  float scale;
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Scores and P.V on the tensor cores (mma.sync m16n8k16, rows 0-7 the query
// rows, rows past R zero): S = Q K^T over 8-key tiles, a warp every fourth
// tile; O = P V over 16-key steps, a warp every fourth step, the four warps'
// sums added in warp order. Each row's sums run in an order R does not
// change.
__global__ void __launch_bounds__(kAttnThreads) attend_kernel(const AttnArgs a) {
  pdl_launch_dependents();
  extern __shared__ __align__(16) uint8_t sm[];
  const int R = a.R, chunk = a.chunk, chunks = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / 4, q = lane % 4;
  const int hd = blockIdx.x, c = blockIdx.y;   // a cluster: a head's chunks, rank c
  const int S = a.S, t0 = c * chunk;
  const AttnLayout lay = attn_layout(chunk, chunks, R);
  bf16* const ks = reinterpret_cast<bf16*>(sm);
  bf16* const vs = reinterpret_cast<bf16*>(sm + lay.vs);
  bf16* const qb = reinterpret_cast<bf16*>(sm + lay.qb);
  float* const sc = reinterpret_cast<float*>(sm + lay.sc);
  bf16* const pb = reinterpret_cast<bf16*>(sm + lay.pb);
  float* const stats = reinterpret_cast<float*>(sm + lay.stats);
  float2* const allst = reinterpret_cast<float2*>(sm + lay.allst);
  float* const red = reinterpret_cast<float*>(sm + lay.red);
  float* const part = reinterpret_cast<float*>(sm + lay.part);
  float* const gath = reinterpret_cast<float*>(sm + lay.gath);
  const uint32_t gather_bar = smem_u32(sm + lay.bar);
  const int pb_ld = chunk + 8;
  __shared__ float Mrow[kRows], Lrow[kRows];
  __shared__ int nv_s[kRows];

  if (tid == 0) {
    mbar_init(gather_bar, 1);
    fence_barrier_init();
    if (c == 0 && chunks > 1) mbar_expect_tx(gather_bar, (chunks - 1) * R * kDH * 4);
  }
  // this block's K and V rows: 8 16-byte pieces a row each
  auto copy_rows = [&](int t1) {
    for (int i = tid; i < (t1 - t0) * 16; i += kAttnThreads) {
      const int t = i / 16, piece = i % 16, mat = piece / 8, col = (piece % 8) * 8;
      const bf16* src = (mat ? a.v : a.k) + (size_t)(t0 + t) * S + hd * kDH + col;
      cp_async16(smem_u32((mat ? vs : ks) + t * kKV + col), src);
    }
    cp_async_commit();
  };
  // zeros in the K and V rows past the keys loaded (the mma reads whole
  // 8- and 16-key tiles)
  auto zero_rows = [&](int t1) {
    for (int i = tid; i < (t0 + chunk - t1) * 16; i += kAttnThreads) {
      const int t = t1 - t0 + i / 16, piece = i % 16, col = (piece % 8) * 8;
      *reinterpret_cast<uint4*>((piece < 8 ? ks : vs) + t * kKV + col) = make_uint4(0, 0, 0, 0);
    }
  };
  const int t_end = min(t0 + chunk, a.T);
  if (a.head == nullptr) {   // the cross-KV: fixed for the window
    if (t_end > t0) copy_rows(t_end);
    zero_rows(max(t_end, t0));
  } else {
    // the self-cache rows may still be written by a chain in flight: only
    // ask L2 for their lines now (a hint; the copy after the wait reads
    // what is there then)
    for (int i = tid; i < (t_end - t0) * 2; i += kAttnThreads)
      asm volatile("prefetch.global.L2 [%0];" ::"l"((i & 1 ? a.v : a.k) +
                                                    (size_t)(t0 + i / 2) * S + hd * kDH));
  }
  // q's and P's rows past R are zeros for the whole call
  for (int i = tid; i < (kRows - R) * (kDH / 8); i += kAttnThreads)
    *reinterpret_cast<uint4*>(qb + (R + i / (kDH / 8)) * kKV + (i % (kDH / 8)) * 8) =
        make_uint4(0, 0, 0, 0);
  for (int i = tid; i < (kRows - R) * pb_ld / 2; i += kAttnThreads)
    reinterpret_cast<uint32_t*>(pb + R * pb_ld)[i] = 0u;

  pdl_wait();
  // each row's keys
  if (tid < kRows)
    nv_s[tid] = a.head != nullptr ? (int)min(*a.head + 1 + tid, (long long)a.T) : a.T;
  __syncthreads();
  const int nv_max = nv_s[R - 1];   // the most any row sees
  const int t1 = max(min(t_end, nv_max), t0);
  if (a.head != nullptr) {
    if (t1 > t0) copy_rows(t1);
    zero_rows(t1);
  }
  for (int i = tid; i < R * (kDH / 8); i += kAttnThreads) {
    const int r = i / (kDH / 8), col = (i % (kDH / 8)) * 8;
    *reinterpret_cast<uint4*>(qb + r * kKV + col) =
        *reinterpret_cast<const uint4*>(a.q + (size_t)r * S + hd * kDH + col);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- scores: S = Q K^T, 8 keys a tile ----
  {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(qb + g * kKV + 2 * q);
    uint32_t qa[4][2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) qa[kk][0] = qw[kk * 8], qa[kk][1] = qw[kk * 8 + 4];
    for (int nt = warp; nt * 8 < t1 - t0; nt += kAttnThreads / 32) {
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(ks + (nt * 8 + g) * kKV + 2 * q);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rows8(d, qa[kk][0], qa[kk][1], kw[kk * 8], kw[kk * 8 + 4]);
      if (g < R)
        *reinterpret_cast<float2*>(sc + g * chunk + nt * 8 + 2 * q) =
            make_float2(d[0] * a.scale, d[1] * a.scale);
    }
  }
  __syncthreads();

  // ---- this chunk's max and sum of exponentials, a warp per row ----
  for (int r = warp; r < R; r += kAttnThreads / 32) {
    const int nt = max(min(t_end, nv_s[r]) - t0, 0);
    float m = -INFINITY;
    for (int i = lane; i < nt; i += 32) m = fmaxf(m, sc[r * chunk + i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < nt; i += 32) l += expf(sc[r * chunk + i] - m);
    l = warp_sum(l);
    if (lane == 0) stats[2 * r] = m, stats[2 * r + 1] = l;
  }
  // the cluster's statistics are all written (and the first chunk's gather
  // barrier initialised) past this barrier; then one trip reads them all
  if (chunks > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int i = tid; i < chunks * R; i += kAttnThreads) {
    const int rank = i / R, r = i % R;
    allst[rank * kRows + r] = ld_cluster_f2(map_rank(smem_u32(stats + 2 * r), rank));
  }
  __syncthreads();
  // done reading the others' statistics (their values are in hand: no
  // release needed)
  if (chunks > 1) cluster_arrive_relaxed();
  if (tid < R) {   // the row's max and sum over the chunks, in chunk order
    float M = -INFINITY;
    for (int i = 0; i < chunks; ++i) M = fmaxf(M, allst[i * kRows + tid].x);
    float L = 0.f;
    for (int i = 0; i < chunks; ++i) {
      const float2 ml = allst[i * kRows + tid];
      if (ml.y > 0.f) L += ml.y * expf(ml.x - M);
    }
    Mrow[tid] = M;
    Lrow[tid] = L;
  }
  __syncthreads();

  // ---- P = bf16(exp(s - M) / L) on the row's keys, 0 elsewhere ----
  for (int i = tid; i < R * chunk; i += kAttnThreads) {
    const int r = i / chunk, j = i % chunk;
    float p = 0.f;
    if (t0 + j < min(t_end, nv_s[r])) p = expf(sc[r * chunk + j] - Mrow[r]) / Lrow[r];
    pb[r * pb_ld + j] = __float2bfloat16(p);
  }
  __syncthreads();

  // ---- O = P V, 16 keys a step ----
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(pb + g * pb_ld + 2 * q);
    const int m = lane / 8, rr = lane % 8;   // this lane's ldmatrix row address
    for (int kk = warp; kk * 16 < t1 - t0; kk += kAttnThreads / 32) {
      const uint32_t a0 = pw[kk * 8], a2 = pw[kk * 8 + 4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {   // n-tiles 2p and 2p + 1 (dims 16p .. 16p + 15)
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(vs + (kk * 16 + (m & 1) * 8 + rr) * kKV +
                                      (2 * p + (m >> 1)) * 8));
        mma_rows8(o[2 * p], a0, a2, b[0], b[1]);
        mma_rows8(o[2 * p + 1], a0, a2, b[2], b[3]);
      }
    }
  }
  if (g < R)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(red + (warp * kRows + g) * kDH + nt * 8 + 2 * q) =
          make_float2(o[nt][0], o[nt][1]);
  __syncthreads();
  for (int i = tid; i < R * kDH; i += kAttnThreads) {
    float s = red[i];
#pragma unroll
    for (int w = 1; w < kConsumerWarps; ++w) s += red[w * kRows * kDH + i];
    part[i] = s;
  }
  __syncthreads();

  if (c > 0) {   // send this chunk's partial to the first chunk: slot c - 1
    const uint32_t bar = map_rank(gather_bar, 0);
    const uint32_t dst = map_rank(smem_u32(gath + (c - 1) * R * kDH), 0);
    for (int i = tid; i < R * kDH / 4; i += kAttnThreads)
      st_async(dst + 16 * i, reinterpret_cast<const float4*>(part)[i], bar);
    cluster_wait();
    return;
  }
  if (chunks > 1) mbar_wait_cluster(gather_bar, 0);
  for (int i = tid; i < R * kDH; i += kAttnThreads) {
    float sum = part[i];
    for (int p = 0; p < chunks - 1; ++p) sum += gath[p * R * kDH + i];
    a.out[(size_t)(i / kDH) * S + hd * kDH + i % kDH] = __float2bfloat16(sum);
  }
  if (chunks > 1) cluster_wait();
}

// -- host side: the step's dims, workspace, launches and tensor maps ----------
//
// In an unnamed namespace: every kernel library that includes this header
// keeps its own copy, its own shared-memory opt-in flags included (a flag
// shared across libraries once let one library's kernel launch without its
// own attribute).

namespace {

struct Dims {
  int L, S, H, Tc, Ta, Vp;
  int kind[7];  // qkv, o, cq, co, mlp0, mlp1, logits
  int R;
};

// dims: L, S, H, Tc, Ta, Vp, the seven kinds (0 dense, 1 int8, 2 int4), R
inline Dims read_dims(const int* v) {
  Dims d;
  d.L = v[0]; d.S = v[1]; d.H = v[2]; d.Tc = v[3]; d.Ta = v[4]; d.Vp = v[5];
  for (int f = 0; f < 7; ++f) d.kind[f] = v[6 + f];
  d.R = v[13];
  return d;
}

// K (dense rows) and N of the seven weight fields
inline void field_kn(const Dims& d, int f, int* K, int* N) {
  const int S = d.S;
  const int k[7] = {S, S, S, S, S, 4 * S, S};
  const int n[7] = {3 * S, S, S, S, 4 * S, S, d.Vp};
  *K = k[f];
  *N = n[f];
}

// the workspace: the residual rows, q / cq, the attention output, the GELU rows
struct Layout {
  size_t xres, qb, ab, gb, total;
};

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

inline Layout layout(const Dims& d) {
  Layout o;
  size_t at = 0;
  o.xres = at; at = align256(at + (size_t)d.R * d.S * 2);
  o.qb = at; at = align256(at + (size_t)d.R * d.S * 2);
  o.ab = at; at = align256(at + (size_t)d.R * d.S * 2);
  o.gb = at; at = align256(at + (size_t)d.R * 4 * d.S * 2);
  o.total = at;
  return o;
}

// the GEMV's dynamic shared memory opt-in, once per device and kind
unsigned long long allowed_gemv[3];

// a launch with the programmatic-dependent-launch attribute, and a cluster
// of cluster_y blocks along y where cluster_y > 1
template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, int threads, int cluster_y, int smem, cudaStream_t st,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = cluster_y;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster_y > 1 ? 2 : 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

// One step's GEMV launches. p: x0 and head (unused: x0 and head take their
// place), lnw, lnb, the six bias stacks (qkv, o, cq, co, mlp0, mlp1), then
// (plane, scales) for qkv, o, cq, co, mlp0, mlp1, logits (scales null for
// dense), kv_k, kv_v (L, Tc * head_stride, S), xk, xv, logits (unused: the
// logits member), workspace.
struct Chain {
  Dims d;
  void* const* p;
  const int* plan;        // the seven fields' splits and ring depths, then two key chunks
  const CUtensorMap* maps;  // two a field
  cudaStream_t st;
  float eps, kq, cross_scale;
  const bf16* x0;
  const long long* head;
  float* logits;
  bf16 *xres, *qb, *ab, *gb;
  int head_stride;        // cache row of row r: head * head_stride + r

  Chain(const int* dims, void* const* p_, const int* plan_, const void* maps_, const void* x0_,
        const void* head_, void* logits_, float eps_, float kq_, float cross_scale_,
        void* stream, int head_stride_)
      : d(read_dims(dims)), p(p_), plan(plan_), maps(static_cast<const CUtensorMap*>(maps_)),
        st(static_cast<cudaStream_t>(stream)), eps(eps_), kq(kq_), cross_scale(cross_scale_),
        x0(static_cast<const bf16*>(x0_)), head(static_cast<const long long*>(head_)),
        logits(static_cast<float*>(logits_)), head_stride(head_stride_) {
    const Layout lay = layout(d);
    unsigned char* ws = static_cast<unsigned char*>(p[29]);
    xres = reinterpret_cast<bf16*>(ws + lay.xres);
    qb = reinterpret_cast<bf16*>(ws + lay.qb);
    ab = reinterpret_cast<bf16*>(ws + lay.ab);
    gb = reinterpret_cast<bf16*>(ws + lay.gb);
  }

  // what every step takes: R rows of S = H heads of 64, S % 128 == 0, a
  // layernorm row within kMaxLnK
  bool dims_ok() const {
    return d.R >= 1 && d.R <= kRows && d.S % kBN == 0 && d.S == d.H * kDH && d.S <= kMaxLnK;
  }

  // field f of layer il (the logits plane has no layer axis); the first
  // stage also starts the residual rows as x0
  int gemv(int f, int il, const bf16* in, int ln_row, int epi, bf16* out, bool first) const {
    int K, N;
    field_kn(d, f, &K, &N);
    const int kind = d.kind[f], splits = plan[f], depth = plan[7 + f], S = d.S;
    if (splits < 1 || splits > kMaxCluster || splits > n_stages(kind, K) || depth < 1 ||
        depth > kMaxDepth)
      return (int)cudaErrorInvalidValue;
    const int smem = (int)gemv_layout(kind, K, S, splits, depth, d.R, ln_row >= 0).total;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    const size_t cache_layer = (size_t)d.Tc * head_stride * S;
    GemvArgs a;
    a.in = in;
    a.lnw = ln_row >= 0 ? static_cast<const bf16*>(p[2]) + (size_t)ln_row * S : nullptr;
    a.lnb = ln_row >= 0 ? static_cast<const bf16*>(p[3]) + (size_t)ln_row * S : nullptr;
    a.bias = f < 6 ? static_cast<const bf16*>(p[4 + f]) + (size_t)il * N : nullptr;
    a.out = out;
    a.out_f32 = f == 6 ? logits : nullptr;
    a.kk = static_cast<bf16*>(p[24]) + il * cache_layer;
    a.vv = static_cast<bf16*>(p[25]) + il * cache_layer;
    a.head = head;
    a.x0 = x0;
    a.xres = first ? xres : nullptr;
    a.cache_rows = (long long)d.Tc * head_stride;
    a.eps = eps;
    a.kq = kq;
    a.K = K; a.N = N; a.S = S; a.R = d.R; a.layer = f < 6 ? il : 0;
    a.splits = splits; a.depth = depth; a.epi = epi;
    a.head_stride = head_stride;
    const dim3 grid(N / kBN, splits);
    const CUtensorMap& mw = maps[2 * f];
    const CUtensorMap& ms = maps[2 * f + 1];
    int e;
    switch (kind) {
      case kDense:
        if ((e = allow_smem(gemv_kernel<kDense>, kMaxSmem, allowed_gemv[0]))) return e;
        return launch(gemv_kernel<kDense>, grid, kThreads, splits, smem, st, mw, ms, a);
      case kInt8:
        if ((e = allow_smem(gemv_kernel<kInt8>, kMaxSmem, allowed_gemv[1]))) return e;
        return launch(gemv_kernel<kInt8>, grid, kThreads, splits, smem, st, mw, ms, a);
      case kInt4:
        if ((e = allow_smem(gemv_kernel<kInt4>, kMaxSmem, allowed_gemv[2]))) return e;
        return launch(gemv_kernel<kInt4>, grid, kThreads, splits, smem, st, mw, ms, a);
    }
    return (int)cudaErrorInvalidValue;
  }
};

// attend_kernel's dynamic shared memory opt-in, once per device
unsigned long long allowed_attend;

// attend_kernel for the R rows of qb against keys of layer il: K2's
// self-cache (row r up to head + r) or the shared (Ta, S) cross-KV (K2, K7);
// out -> ab
inline int attend(const Chain& c, int il, bool self) {
  const Dims& d = c.d;
  const int S = d.S, T = self ? d.Tc : d.Ta, chunk = c.plan[self ? 14 : 15];
  if (chunk < 16 || chunk > kMaxChunk || chunk % 16) return (int)cudaErrorInvalidValue;
  const int chunks = (T + chunk - 1) / chunk;
  if (chunks > kMaxCluster) return (int)cudaErrorInvalidValue;
  const bf16* k = static_cast<const bf16*>(c.p[self ? 24 : 26]) + (size_t)il * T * S;
  const bf16* v = static_cast<const bf16*>(c.p[self ? 25 : 27]) + (size_t)il * T * S;
  AttnArgs a;
  a.q = c.qb; a.k = k; a.v = v;
  a.head = self ? c.head : nullptr;
  a.out = c.ab;
  a.T = T; a.S = S; a.R = d.R; a.chunk = chunk;
  a.scale = self ? 1.0f : c.cross_scale;
  int e;
  if ((e = allow_smem(attend_kernel, kMaxSmem, allowed_attend))) return e;
  const int smem = (int)attn_layout(chunk, chunks, d.R).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return launch(attend_kernel, dim3(d.H, chunks), kAttnThreads, chunks, smem, c.st, a);
}

// The 14 tensor maps of a prepared decoder's planes (two a field: values,
// then scales; a dense field's second is a copy of its first), 128 bytes
// each, into maps_out. p and dims as a step's (only the planes and L, S, Vp
// and the kinds are read). Returns 0 or a cudaError_t.
inline int encode_step_maps(void* const* p, const int* dims, void* maps_out) {
  const Dims d = read_dims(dims);
  CUtensorMap maps[14];
  for (int f = 0; f < 7; ++f) {
    int K, N;
    field_kn(d, f, &K, &N);
    const int kind = d.kind[f];
    const cuuint64_t L = f < 6 ? d.L : 1;
    if (N % kBN || K % (kind == kInt4 ? 2 * kQK : kQK)) return (int)cudaErrorInvalidValue;
    const cuuint64_t rows = kind == kInt4 ? K / 2 : K;
    const cuuint64_t esz = kind == kDense ? 2 : 1;
    const cuuint64_t w_dims[3] = {(cuuint64_t)N, rows, L};
    const cuuint64_t w_stride[2] = {N * esz, rows * N * esz};
    const cuuint32_t w_box[3] = {kind == kDense ? 64u : 128u, (cuuint32_t)kQK, 1};
    int rc = encode_map(&maps[2 * f],
                        kind == kDense ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        3, p[10 + 2 * f], w_dims, w_stride, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
    if (kind == kDense) {
      maps[2 * f + 1] = maps[2 * f];
      continue;
    }
    const cuuint64_t ssz = kind == kInt8 ? 4 : 2;
    const cuuint64_t s_dims[3] = {(cuuint64_t)N, (cuuint64_t)(K / kQK), L};
    const cuuint64_t s_stride[2] = {N * ssz, (cuuint64_t)(K / kQK) * N * ssz};
    const cuuint32_t s_box[3] = {(cuuint32_t)kBN, 1, 1};
    rc = encode_map(&maps[2 * f + 1],
                    kind == kInt8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    3, p[11 + 2 * f], s_dims, s_stride, s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  }
  memcpy(maps_out, maps, sizeof maps);
  return 0;
}

}  // namespace

}  // namespace mstream
