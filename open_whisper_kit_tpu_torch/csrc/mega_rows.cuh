// The parts of a whole-decoder-step kernel that do not depend on how the
// self-cache is laid out, for R <= 8 query rows that share one weight
// stream: the split-K GEMV (layernorm prologue; bias, residual, GELU, QKV
// and logits epilogues), the full-row softmax attention against a shared
// key/value set (cross-attention, and K2's self-attention at R = 1), the
// workspace layout and the launch helpers. Used by mega_beam.cu alone (K7,
// R = B beams; K2 and K8 run on mega_stream.cuh); R is a template
// parameter. The K2 paths below (natural cache, `head`-limited rows) are
// no longer launched.
//
// Rounding points, per row, as the TPU kernel body (open_whisper_kit_tpu/
// ops/decode_megakernel.py::_make_kernel): layernorm with f32 statistics
// rounded to bf16; every product bf16 x bf16 summed in f32; a weight
// dequantized as value * scale in f32 and rounded to bf16; a matmul result
// rounded to bf16 before its bf16 bias is added in bf16; Q and K times
// bf16(dh^-0.25) in bf16; the residual stream bf16, each add rounded once;
// tanh-GELU in f32 rounded to bf16; f32 logits.
//
// gemv_kernel<R>: Y = X @ W for R rows. A block owns 64 output columns
// (8 threads x 8 columns, 16-byte loads of a bf16 row) and a run of K rows
// walked by 32 thread rows; each weight is loaded and dequantized once and
// multiplied into all R rows, so R rows cost one weight stream. Where one
// block per 64 columns would leave the 132 SMs idle (N = 1280: 20 blocks),
// K is split across blocks as well; each block writes its partial sums, and
// the last block of a column tile to finish (an atomic counter) adds the
// partials in split order and runs the epilogue. Sums are combined in a
// fixed order everywhere: no float atomics, the same result on every run.
// Each block recomputes the layernorm of its R input rows in shared memory.
//
// attend_kernel<R>: one head per blockIdx.x, keys split over blockIdx.y.
// Against K2's self-cache (`head` set) the rows are consecutive positions:
// row r sees keys [0, head + r] (capped at the cache's rows), the R = 1
// step's keys at position head + r. The key chunk depends on min(Tc,
// n_text_ctx) only (Dims::Tp), not on R, so a chunk that lies wholly past a
// row's limit contributes max -inf and sum 0 for that row, as it does in
// the R = 1 launch (also on a cache of other rows, whose extra chunks lie
// past every limit), and each row's sums run in the R = 1 launch's order:
// every row is bit-identical to the one-row step at its position.
// Pass one: each block scores its keys for the R rows (f32, written to a
// scratch row per row) and keeps its chunk's max and sum of exponentials;
// it also asks L2 for its keys' V rows. The last block of the head to
// finish combines the chunks' max and sum in chunk order, then makes pass
// two over the stored scores: p = bf16(exp(s - max) / sum), P.V summed in
// f32 by 32 key rows and added in row order, rounded to bf16. Each key and
// V row is read once for all R rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace mega {

typedef __nv_bfloat16 bf16;

constexpr int kQK = 32;          // rows per scale block
constexpr int kThreads = 256;
constexpr int kTX = 8;           // threads across a column tile
constexpr int kTY = 32;          // thread rows along K
constexpr int kCols = 8;         // columns per thread
constexpr int kBN = kTX * kCols; // 64 columns per block
constexpr int kDH = 64;          // head width
constexpr int kTargetBlocks = 264;  // two blocks per SM
constexpr int kMaxChunk = 256;   // keys per attention block
constexpr int kMaxRows = 8;
constexpr int kStaticSmem = 48 * 1024;

enum Kind { kDense = 0, kInt8 = 1, kInt4 = 2 };
enum Epi { kEpiQKV = 0, kEpiResid = 1, kEpiBias = 2, kEpiGelu = 3, kEpiLogits = 4 };

__device__ __forceinline__ float bround(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Gemv {
  const bf16* in;       // R input rows of K values; with LN, the residual rows (S)
  const bf16* lnw;      // layernorm weight and bias, or null (no LN)
  const bf16* lnb;
  float eps;
  const void* w;        // dense (K, N) bf16 | int8 (K, N) | int4 (K/2, N)
  const void* sc;       // int8: (K/32, N) f32; int4: (K/32, N) bf16
  int kind, K, N, chunk;  // chunk: rows (int4: packed rows) per K split
  int epi;
  const bf16* bias;     // (N) bf16
  bf16* out;            // R rows: q / cq (stride S), gelu (stride N), residual (stride S)
  float* out_f32;       // R rows of logits (stride N)
  bf16* kk;             // this layer's self-cache; row r's new K/V goes to
  bf16* vv;             //   cache row head * head_stride + r (QKV epilogue)
  const long long* head;
  int head_stride;      // R: K7's row-flat cache; 1: K2's natural one
  long long cache_rows; // rows of kk/vv: a row at or past it is not written
  int S;
  float kq;             // bf16(dh^-0.25) as f32
  float* part;          // (splits, R, N) partial sums
  unsigned* counters;   // one per column tile, zero between launches
};

// block-wide sum in a fixed order (warp tree, then warps in order)
__device__ __forceinline__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += sh[i];
  return t;
}

template <int R>
__device__ __forceinline__ void epilogue(const Gemv& g, int row, int n, float v) {
  if (g.epi == kEpiLogits) {
    g.out_f32[(size_t)row * g.N + n] = v;
    return;
  }
  const float t = bround(bround(v) + __bfloat162float(g.bias[n]));
  switch (g.epi) {
    case kEpiQKV: {
      const int S = g.S;
      const long long crow = (*g.head) * g.head_stride + row;
      if (n < S) {
        g.out[(size_t)row * S + n] = __float2bfloat16(t * g.kq);
      } else if (crow < g.cache_rows) {
        const size_t at = (size_t)crow * S;
        if (n < 2 * S) g.kk[at + (n - S)] = __float2bfloat16(t * g.kq);
        else g.vv[at + (n - 2 * S)] = __float2bfloat16(t);
      }
      break;
    }
    case kEpiResid: {
      bf16* o = g.out + (size_t)row * g.N + n;
      *o = __float2bfloat16(__bfloat162float(*o) + t);
      break;
    }
    case kEpiBias:
      g.out[(size_t)row * g.N + n] = __float2bfloat16(t);
      break;
    case kEpiGelu: {
      const float u = t;
      const float y = u * (0.5f * (1.0f + tanhf(0.7978845608028654f *
                                               (u + 0.044715f * (u * u * u)))));
      g.out[(size_t)row * g.N + n] = __float2bfloat16(y);
      break;
    }
  }
}

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) gemv_kernel(Gemv g) {
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* xs = reinterpret_cast<bf16*>(dyn);  // the R input rows, bf16
  __shared__ float red[kTY * kBN];
  __shared__ float wsum[kThreads / 32];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int K = g.K, N = g.N;

  // ---- prologue: the input rows, layernormed where asked ----
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const bf16* in = g.in + (size_t)r * K;
    bf16* x = xs + (size_t)r * K;
    if (g.lnw != nullptr) {
      float s = 0.f;
      for (int i = tid; i < K; i += kThreads) s += __bfloat162float(in[i]);
      const float mu = block_sum(s, wsum) / K;
      float q = 0.f;
      for (int i = tid; i < K; i += kThreads) {
        const float d = __bfloat162float(in[i]) - mu;
        q += d * d;
      }
      const float rstd = rsqrtf(block_sum(q, wsum) / K + g.eps);
      for (int i = tid; i < K; i += kThreads) {
        const float y = (__bfloat162float(in[i]) - mu) * rstd;
        x[i] = __float2bfloat16(y * __bfloat162float(g.lnw[i]) +
                                __bfloat162float(g.lnb[i]));
      }
    } else {
      for (int i = tid; i < K; i += kThreads) x[i] = in[i];
    }
  }
  __syncthreads();

  // ---- main loop: this block's columns over its run of K rows ----
  const int tx = tid % kTX, ty = tid / kTX;
  const int n0 = blockIdx.x * kBN + tx * kCols;
  const int rows = g.kind == kInt4 ? K / 2 : K;
  const int r0 = blockIdx.y * g.chunk;
  const int r1 = min(r0 + g.chunk, rows);
  float acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  if (g.kind == kDense) {
    const bf16* w = static_cast<const bf16*>(g.w);
#pragma unroll 4
    for (int k = r0 + ty; k < r1; k += kTY) {
      float f[kCols];
      unpack8(*reinterpret_cast<const uint4*>(w + (size_t)k * N + n0), f);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = __bfloat162float(xs[(size_t)r * K + k]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(x, f[j], acc[r][j]);
      }
    }
  } else if (g.kind == kInt8) {
    const int8_t* qs = static_cast<const int8_t*>(g.w);
    const float* sc = static_cast<const float*>(g.sc);
#pragma unroll 4
    for (int k = r0 + ty; k < r1; k += kTY) {
      const uint2 u = *reinterpret_cast<const uint2*>(qs + (size_t)k * N + n0);
      const int8_t* q = reinterpret_cast<const int8_t*>(&u);
      const float* s = sc + (size_t)(k / kQK) * N + n0;
      const float4 s0 = *reinterpret_cast<const float4*>(s);
      const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
      const float sv[kCols] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float f[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) f[j] = bround((float)q[j] * sv[j]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = __bfloat162float(xs[(size_t)r * K + k]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(x, f[j], acc[r][j]);
      }
    }
  } else {
    // split-half nibbles: packed row p holds row p (low) and p + K/2 (high)
    const uint8_t* qs = static_cast<const uint8_t*>(g.w);
    const bf16* sc = static_cast<const bf16*>(g.sc);
    const int half = K / 2;
#pragma unroll 4
    for (int p = r0 + ty; p < r1; p += kTY) {
      const uint2 u = *reinterpret_cast<const uint2*>(qs + (size_t)p * N + n0);
      const uint8_t* q = reinterpret_cast<const uint8_t*>(&u);
      float slo[kCols], shi[kCols], flo[kCols], fhi[kCols];
      unpack8(*reinterpret_cast<const uint4*>(sc + (size_t)(p / kQK) * N + n0), slo);
      unpack8(*reinterpret_cast<const uint4*>(sc + (size_t)((p + half) / kQK) * N + n0), shi);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        flo[j] = bround((float)((int)(q[j] & 15) - 8) * slo[j]);
        fhi[j] = bround((float)((int)(q[j] >> 4) - 8) * shi[j]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xlo = __bfloat162float(xs[(size_t)r * K + p]);
        const float xhi = __bfloat162float(xs[(size_t)r * K + p + half]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc[r][j] = fmaf(xlo, flo[j], acc[r][j]);
          acc[r][j] = fmaf(xhi, fhi[j], acc[r][j]);
        }
      }
    }
  }

  // ---- per row, the block's 32 thread rows added in row order ----
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[ty * kBN + tx * kCols + j] = acc[r][j];
    __syncthreads();
    float s = 0.f;
    if (tid < kBN)
      for (int i = 0; i < kTY; ++i) s += red[i * kBN + tid];
    v[r] = s;
    __syncthreads();
  }
  const int n = blockIdx.x * kBN + tid;

  if (gridDim.y == 1) {
    if (tid < kBN)
#pragma unroll
      for (int r = 0; r < R; ++r) epilogue<R>(g, r, n, v[r]);
    return;
  }
  // ---- K split across blocks: the last block of the tile adds the splits ----
  if (tid < kBN)
#pragma unroll
    for (int r = 0; r < R; ++r) g.part[((size_t)blockIdx.y * R + r) * N + n] = v[r];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&g.counters[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  if (tid < kBN) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float t = 0.f;
      for (int s = 0; s < (int)gridDim.y; ++s)
        t += __ldcg(g.part + ((size_t)s * R + r) * N + n);
      epilogue<R>(g, r, n, t);
    }
  }
  if (tid == 0) g.counters[blockIdx.x] = 0;
}

struct Attn {
  const bf16* q;        // R rows (S) bf16
  const bf16* k;        // (T, S) natural layout, shared by the R rows
  const bf16* v;
  const long long* head;  // K2's self-attention: row r keys [0, *head + 1 + r)
                          //   capped at n_valid (the cache rows); else null
  int n_valid;          // otherwise keys [0, n_valid) for every row
  int S, chunk, tmax;
  float scale;
  float* scores;        // (R, H, tmax)
  float* stats;         // (H, gridDim.y, R, 2): chunk max, chunk sum
  unsigned* counters;   // one per head, zero between launches
  bf16* out;            // R rows (S) bf16
};

template <int R>
__global__ void __launch_bounds__(kThreads) attend_kernel(Attn a) {
  __shared__ float qh[R][kDH];
  __shared__ float sc_sh[R][kMaxChunk];
  __shared__ float red[kTY * kDH];
  __shared__ float wsum[kThreads / 32];
  __shared__ float mrow[R], lrow[R];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, c = blockIdx.y, S = a.S, H = gridDim.x;
  int nv[R];  // each row's keys
#pragma unroll
  for (int r = 0; r < R; ++r)
    nv[r] = a.head != nullptr ? (int)min(*a.head + 1 + r, (long long)a.n_valid) : a.n_valid;
  const int n_valid = nv[R - 1];  // the most any row sees
  const int t0 = c * a.chunk;
  const int t1 = min(t0 + a.chunk, n_valid);
  if (tid < kDH)
#pragma unroll
    for (int r = 0; r < R; ++r)
      qh[r][tid] = __bfloat162float(a.q[(size_t)r * S + h * kDH + tid]);
  __syncthreads();

  // ---- pass one: this chunk's scores, max and sum of exponentials ----
  for (int t = t0 + warp; t < t1; t += kThreads / 32) {
    const __nv_bfloat162 kv = *reinterpret_cast<const __nv_bfloat162*>(
        a.k + (size_t)t * S + h * kDH + 2 * lane);
    const float2 kf = __bfloat1622float2(kv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d = qh[r][2 * lane] * kf.x + qh[r][2 * lane + 1] * kf.y;
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) {
        const float s = d * a.scale;
        sc_sh[r][t - t0] = s;
        a.scores[((size_t)r * H + h) * a.tmax + t] = s;
      }
    }
    // pass two reads this V row: bring it into L2 now
    if (lane == 0)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.v + (size_t)t * S + h * kDH));
  }
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const int nt = max(min(t0 + a.chunk, nv[r]) - t0, 0);
    float m = -INFINITY;
    for (int i = tid; i < nt; i += kThreads) m = fmaxf(m, sc_sh[r][i]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    __syncthreads();
    if (lane == 0) wsum[warp] = m;
    __syncthreads();
    m = -INFINITY;
    for (int i = 0; i < kThreads / 32; ++i) m = fmaxf(m, wsum[i]);
    float l = 0.f;
    for (int i = tid; i < nt; i += kThreads) l += expf(sc_sh[r][i] - m);
    l = block_sum(l, wsum);
    if (tid == 0) {
      a.stats[(((size_t)h * gridDim.y + c) * R + r) * 2] = m;
      a.stats[(((size_t)h * gridDim.y + c) * R + r) * 2 + 1] = l;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counters[h], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;

  // ---- the head's last block: combine the chunks in order, then P.V ----
  if (tid < R) {
    const float* st = a.stats + (size_t)h * gridDim.y * R * 2;
    float M = -INFINITY;
    for (int i = 0; i < (int)gridDim.y; ++i) M = fmaxf(M, __ldcg(st + ((size_t)i * R + tid) * 2));
    float L = 0.f;
    for (int i = 0; i < (int)gridDim.y; ++i) {
      const float li = __ldcg(st + ((size_t)i * R + tid) * 2 + 1);
      if (li > 0.f) L += li * expf(__ldcg(st + ((size_t)i * R + tid) * 2) - M);
    }
    mrow[tid] = M;
    lrow[tid] = L;
  }
  __syncthreads();
  const int tx = tid % kTX, ty = tid / kTX;
  float acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int t = ty; t < n_valid; t += kTY) {
    float f[kCols];
    unpack8(*reinterpret_cast<const uint4*>(a.v + (size_t)t * S + h * kDH + tx * kCols), f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t >= nv[r]) continue;
      const float p = bround(
          expf(__ldcg(a.scores + ((size_t)r * H + h) * a.tmax + t) - mrow[r]) / lrow[r]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(p, f[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[ty * kDH + tx * kCols + j] = acc[r][j];
    __syncthreads();
    if (tid < kDH) {
      float o = 0.f;
      for (int i = 0; i < kTY; ++i) o += red[i * kDH + tid];
      a.out[(size_t)r * S + h * kDH + tid] = __float2bfloat16(o);
    }
    __syncthreads();
  }
  if (tid == 0) a.counters[h] = 0;
}

// ---- host side: the launch plan and the workspace layout ----

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// (splits, rows per split) for a GEMV over `rows` K rows and N columns
inline void plan_gemv(int rows, int N, int* splits, int* chunk) {
  const int tiles = N / kBN;
  int ks = cdiv(kTargetBlocks, tiles);
  ks = std::max(1, std::min(ks, rows / kQK));
  *chunk = cdiv(cdiv(rows, ks), kQK) * kQK;
  *splits = cdiv(rows, *chunk);
}

// (splits, keys per split) for T keys; the chunk comes from `Tp` keys (Tp
// <= T), the splits cover all T
inline void plan_attend(int T, int H, int* splits, int* chunk, int Tp = 0) {
  int c = cdiv(Tp > 0 ? Tp : T, cdiv(kTargetBlocks, H));
  c = std::min(std::max(cdiv(c, kQK) * kQK, kQK), kMaxChunk);
  *chunk = c;
  *splits = cdiv(T, c);
}

struct Dims {
  int L, S, H, Tc, Ta, Vp;
  int kind[7];  // qkv, o, cq, co, mlp0, mlp1, logits
  // K2's self-attention plans its key chunk from Tp = min(Tc, n_text_ctx)
  // rows: the speculative loop's cache is n_text_ctx + gamma + 4 rows, the
  // greedy loop's n_text_ctx, and with one chunk size the two split every
  // row's keys alike, so a verify row is bit-identical to the greedy step
  int Tp;
};

// dims: L, S, H, Tc, Ta, Vp, the seven kinds, R, Tp
inline Dims read_dims(const int* v) {
  Dims d;
  d.L = v[0]; d.S = v[1]; d.H = v[2]; d.Tc = v[3]; d.Ta = v[4]; d.Vp = v[5];
  for (int f = 0; f < 7; ++f) d.kind[f] = v[6 + f];
  d.Tp = v[14];
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

struct Layout {
  size_t xres, qb, ab, gb, part, scores, stats, counters, total;
};

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// the workspace of a step over R rows (all of it zero between launches
// where it matters: the counters)
inline Layout layout(const Dims& d, int R) {
  size_t part = 0;
  int n_counters = d.H;  // one per attention head, and per GEMV column tile
  for (int f = 0; f < 7; ++f) {
    int K, N, ks, chunk;
    field_kn(d, f, &K, &N);
    plan_gemv(d.kind[f] == kInt4 ? K / 2 : K, N, &ks, &chunk);
    if (ks > 1) part = std::max(part, (size_t)ks * R * N);
    n_counters = std::max(n_counters, N / kBN);
  }
  int ks_self, ks_cross, chunk;
  plan_attend(d.Tc, d.H, &ks_self, &chunk, d.Tp);
  plan_attend(d.Ta, d.H, &ks_cross, &chunk);
  const int tmax = std::max(d.Tc, d.Ta);
  Layout o;
  size_t at = 0;
  o.xres = at; at = align256(at + (size_t)R * d.S * 2);
  o.qb = at; at = align256(at + (size_t)R * d.S * 2);
  o.ab = at; at = align256(at + (size_t)R * d.S * 2);
  o.gb = at; at = align256(at + (size_t)R * 4 * d.S * 2);
  o.part = at; at = align256(at + part * 4);
  o.scores = at; at = align256(at + (size_t)R * d.H * tmax * 4);
  o.stats = at; at = align256(at + (size_t)d.H * std::max(ks_self, ks_cross) * R * 2 * 4);
  o.counters = at; at = align256(at + (size_t)n_counters * 4);
  o.total = at;
  return o;
}

// The pointers and workspace views of one step. p: x0, head (int64,
// device), lnw, lnb, the six bias stacks (qkv, o, cq, co, mlp0, mlp1), then
// (plane, scales) for qkv, o, cq, co, mlp0, mlp1, logits (scales null for
// dense), kv_k, kv_v, xk, xv (L, Ta, S), logits out (R, Vp) f32, workspace.
template <int R>
struct Step {
  Dims d;
  Layout lay;
  void* const* p;
  cudaStream_t st;
  float eps, kq;
  bf16 *xres, *qb, *ab, *gb;
  float *part, *scores, *stats;
  unsigned* counters;
  const long long* head;
  int head_stride;  // cache row of row r: head * head_stride + r

  // natural: K2's (L, Tc, S) self-cache; otherwise K7's row-flat
  // (L, Tc * R, S)
  Step(void* const* p_, const int* dims, float eps_, float kq_, void* stream,
       bool natural = false)
      : d(read_dims(dims)), lay(layout(d, R)), p(p_),
        st(static_cast<cudaStream_t>(stream)), eps(eps_), kq(kq_),
        head_stride(natural ? 1 : R) {
    unsigned char* ws = static_cast<unsigned char*>(p[29]);
    xres = reinterpret_cast<bf16*>(ws + lay.xres);
    qb = reinterpret_cast<bf16*>(ws + lay.qb);
    ab = reinterpret_cast<bf16*>(ws + lay.ab);
    gb = reinterpret_cast<bf16*>(ws + lay.gb);
    part = reinterpret_cast<float*>(ws + lay.part);
    scores = reinterpret_cast<float*>(ws + lay.scores);
    stats = reinterpret_cast<float*>(ws + lay.stats);
    counters = reinterpret_cast<unsigned*>(ws + lay.counters);
    head = static_cast<const long long*>(p[1]);
  }

  bf16* kv_k() const { return static_cast<bf16*>(p[24]); }
  bf16* kv_v() const { return static_cast<bf16*>(p[25]); }
  const bf16* xk(int il) const { return static_cast<const bf16*>(p[26]) + (size_t)il * d.Ta * d.S; }
  const bf16* xv(int il) const { return static_cast<const bf16*>(p[27]) + (size_t)il * d.Ta * d.S; }
  float* logits() const { return static_cast<float*>(p[28]); }

  // the residual rows start as x0
  int start() const {
    return (int)cudaMemcpyAsync(xres, p[0], (size_t)R * d.S * 2, cudaMemcpyDeviceToDevice, st);
  }

  // field f of layer il (the logits plane has no layer axis)
  int gemv(int f, int il, const bf16* in, int ln_row, int epi, bf16* out, float* out_f32,
           bf16* kk, bf16* vv) const {
    int K, N, ks, chunk;
    field_kn(d, f, &K, &N);
    const int kind = d.kind[f];
    plan_gemv(kind == kInt4 ? K / 2 : K, N, &ks, &chunk);
    const size_t plane = kind == kDense ? (size_t)K * N * 2
                         : kind == kInt8 ? (size_t)K * N : (size_t)K / 2 * N;
    const size_t scales = kind == kInt8 ? (size_t)K / kQK * N * 4 : (size_t)K / kQK * N * 2;
    const int S = d.S;
    const bf16* lnw = static_cast<const bf16*>(p[2]);
    const bf16* lnb = static_cast<const bf16*>(p[3]);
    Gemv g;
    g.in = in;
    g.lnw = ln_row >= 0 ? lnw + (size_t)ln_row * S : nullptr;
    g.lnb = ln_row >= 0 ? lnb + (size_t)ln_row * S : nullptr;
    g.eps = eps;
    g.w = static_cast<const unsigned char*>(p[10 + 2 * f]) + (size_t)il * plane;
    g.sc = kind == kDense ? nullptr
                          : static_cast<const unsigned char*>(p[11 + 2 * f]) + (size_t)il * scales;
    g.kind = kind; g.K = K; g.N = N; g.chunk = chunk; g.epi = epi;
    g.bias = f < 6 ? static_cast<const bf16*>(p[4 + f]) + (size_t)il * N : nullptr;
    g.out = out; g.out_f32 = out_f32; g.kk = kk; g.vv = vv; g.head = head;
    g.head_stride = head_stride;
    g.cache_rows = (long long)d.Tc * head_stride;
    g.S = S; g.kq = kq; g.part = part; g.counters = counters;
    const size_t smem = (size_t)R * K * 2;
    if (smem > kStaticSmem) {
      // the R input rows of the widest K (mlp1, 4S) exceed the default
      // dynamic shared memory of a block: allow them, at every launch. No
      // "already allowed" flag: a function-local static of this template
      // is one object for the whole process (GNU unique symbol), shared by
      // every kernel library that includes this header, while each
      // library's gemv_kernel<R> needs the attribute set on itself
      const cudaError_t e = cudaFuncSetAttribute(
          gemv_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    gemv_kernel<R><<<dim3(N / kBN, ks), kThreads, smem, st>>>(g);
    return (int)cudaGetLastError();
  }

  // the R query rows in `q` against keys [0, T) (when `self_head`, row r
  // against [0, min(*head + 1 + r, T)): K2's self-cache) of natural (T, S)
  // k/v, full-row softmax; out -> ab
  int attend(const bf16* q, const bf16* k, const bf16* v, int T, bool self_head,
             float scale) const {
    int ks, chunk;
    plan_attend(T, d.H, &ks, &chunk, self_head ? d.Tp : 0);
    Attn a;
    a.q = q; a.k = k; a.v = v;
    a.head = self_head ? head : nullptr;
    a.n_valid = T; a.S = d.S; a.chunk = chunk; a.tmax = std::max(d.Tc, d.Ta);
    a.scale = scale; a.scores = scores; a.stats = stats; a.counters = counters;
    a.out = ab;
    attend_kernel<R><<<dim3(d.H, ks), kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
};

}  // namespace mega
