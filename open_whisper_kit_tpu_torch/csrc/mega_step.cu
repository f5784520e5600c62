// Kernel K2: one whole decoder step (every layer, the final layernorm and
// the vocab projection) for one token, over dense bf16, int8 or split-half
// int4 weight planes.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/decode_megakernel.py::
// mega_decode_step (kernel body _make_kernel), R = 1 rows. Same rounding
// points: layernorm with f32 statistics rounded to bf16; every product
// bf16 x bf16 summed in f32; a weight dequantized as value * scale in f32
// and rounded to bf16; the fused QKV result rounded to bf16, the bf16 bias
// added in bf16, Q and K multiplied by bf16(dh^-0.25) in bf16; attention
// scores in f32, a full-row softmax in f32 whose probabilities are rounded
// to bf16 before P.V; the residual stream bf16, each add rounded once;
// tanh-GELU in f32 rounded to bf16; f32 logits.
//
// Design. The TPU kernel is one pallas_call that runs in order on one core
// with a continuous weight-DMA pipeline. Hopper's blocks run in no order,
// and every stage needs the whole previous stage (a layernorm needs the full
// row, attention all of q), so its counterpart here is a fixed sequence of
// launches of this one source on one stream, 8 per layer plus 1:
//   qkv (LN prologue; the epilogue writes q and the new K/V row at `head`),
//   self-attend, o (+ residual), cq (LN prologue), cross-attend,
//   co (+ residual), mlp0 (LN prologue, GELU epilogue), mlp1 (+ residual),
//   then the logits (final-LN prologue, f32 out).
// 33 launches per token at large-v3-turbo. The stream orders them, so no
// layer grouping is needed (the TPU kernel chains groups of at most 8
// layers to bound its unrolled program; here depth costs launches only).
// A persistent single launch with grid barriers is a later design, to be
// measured against this one.
//
// gemv_kernel: y = x @ W for one row x. A block owns 64 output columns
// (8 threads x 8 columns, 16-byte loads of a bf16 row) and a run of K rows
// walked by 32 thread rows. Where one block per 64 columns would leave the
// 132 SMs idle (N = 1280: 20 blocks), K is split across blocks as well; each
// block writes its partial sums, and the last block of a column tile to
// finish (an atomic counter) adds the partials in split order and runs the
// epilogue. Sums are combined in a fixed order everywhere: no float atomics,
// the same result on every run. Each block recomputes the layernorm of its
// input row in shared memory (S = 1280 values).
//
// attend_kernel: one head per blockIdx.x, keys split over blockIdx.y. Pass
// one: each block scores its keys (f32, written to a scratch row) and keeps
// its chunk's max and sum of exponentials; it also asks L2 for its keys' V
// rows. The last block of the head to finish combines the chunks' max and
// sum in chunk order, then makes pass two over the stored scores: p =
// bf16(exp(s - max) / sum), P.V summed in f32 by 32 key rows and added in
// row order, rounded to bf16.
//
// What bounds a step on the H100: the bytes. Every weight plane, its scales
// and the cross-KV stream once per token. At large-v3-turbo (4 layers,
// S = 1280, vocabulary 51866, 1500 audio positions) that is 347 MB dense
// (104 us at 3.35 TB/s), 209 MB int8 (62 us), 120 MB int4 (36 us); 30.7 MB
// of each is cross-KV. This first version is bound by its launch chain and
// by the latency of each launch's loads, not by those bytes.
//
// Requires S % 128 == 0 (int4: S % 256 == 0), 64-wide heads, every plane
// width a multiple of 64 and 16-byte aligned planes; the Python wrapper
// checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <algorithm>
#include <stdint.h>

namespace {

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

enum Kind { kDense = 0, kInt8 = 1, kInt4 = 2 };
enum Epi { kEpiQKV = 0, kEpiResid = 1, kEpiBias = 2, kEpiGelu = 3, kEpiLogits = 4 };

__device__ __forceinline__ float bround(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Gemv {
  const bf16* in;       // input row (K values); with LN, the residual (S)
  const bf16* lnw;      // layernorm weight and bias, or null (no LN)
  const bf16* lnb;
  float eps;
  const void* w;        // dense (K, N) bf16 | int8 (K, N) | int4 (K/2, N)
  const void* sc;       // int8: (K/32, N) f32; int4: (K/32, N) bf16
  int kind, K, N, chunk;  // chunk: rows (int4: packed rows) per K split
  int epi;
  const bf16* bias;     // (N) bf16
  bf16* out;            // q / cq / gelu row / residual (updated in place)
  float* out_f32;       // logits
  bf16* kk;             // this layer's self-cache (Tc, S), QKV epilogue
  bf16* vv;
  const long long* head;
  int S;
  float kq;             // bf16(dh^-0.25) as f32
  float* part;          // (splits, N) partial sums
  unsigned* counters;   // one per column tile, zero between launches
};

// block-wide sum in a fixed order (warp tree, then warps in order)
__device__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += sh[i];
  return t;
}

__device__ __forceinline__ void epilogue(const Gemv& g, int n, float v) {
  if (g.epi == kEpiLogits) {
    g.out_f32[n] = v;
    return;
  }
  const float t = bround(bround(v) + __bfloat162float(g.bias[n]));
  switch (g.epi) {
    case kEpiQKV: {
      const int S = g.S;
      if (n < 2 * S) {
        const bf16 r = __float2bfloat16(t * g.kq);
        if (n < S) g.out[n] = r;
        else g.kk[(size_t)(*g.head) * S + (n - S)] = r;
      } else {
        g.vv[(size_t)(*g.head) * S + (n - 2 * S)] = __float2bfloat16(t);
      }
      break;
    }
    case kEpiResid:
      g.out[n] = __float2bfloat16(__bfloat162float(g.out[n]) + t);
      break;
    case kEpiBias:
      g.out[n] = __float2bfloat16(t);
      break;
    case kEpiGelu: {
      const float u = t;
      const float y = u * (0.5f * (1.0f + tanhf(0.7978845608028654f *
                                               (u + 0.044715f * (u * u * u)))));
      g.out[n] = __float2bfloat16(y);
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

__global__ void __launch_bounds__(kThreads) gemv_kernel(Gemv g) {
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* xs = reinterpret_cast<bf16*>(dyn);  // the input row, bf16
  __shared__ float red[kTY * kBN];
  __shared__ float wsum[kThreads / 32];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int K = g.K, N = g.N;

  // ---- prologue: the input row, layernormed where asked ----
  if (g.lnw != nullptr) {
    float s = 0.f;
    for (int i = tid; i < K; i += kThreads) s += __bfloat162float(g.in[i]);
    const float mu = block_sum(s, wsum) / K;
    float q = 0.f;
    for (int i = tid; i < K; i += kThreads) {
      const float d = __bfloat162float(g.in[i]) - mu;
      q += d * d;
    }
    const float rstd = rsqrtf(block_sum(q, wsum) / K + g.eps);
    for (int i = tid; i < K; i += kThreads) {
      const float y = (__bfloat162float(g.in[i]) - mu) * rstd;
      xs[i] = __float2bfloat16(y * __bfloat162float(g.lnw[i]) +
                               __bfloat162float(g.lnb[i]));
    }
  } else {
    for (int i = tid; i < K; i += kThreads) xs[i] = g.in[i];
  }
  __syncthreads();

  // ---- main loop: this block's columns over its run of K rows ----
  const int tx = tid % kTX, ty = tid / kTX;
  const int n0 = blockIdx.x * kBN + tx * kCols;
  const int rows = g.kind == kInt4 ? K / 2 : K;
  const int r0 = blockIdx.y * g.chunk;
  const int r1 = min(r0 + g.chunk, rows);
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  if (g.kind == kDense) {
    const bf16* w = static_cast<const bf16*>(g.w);
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += kTY) {
      float f[kCols];
      unpack8(*reinterpret_cast<const uint4*>(w + (size_t)r * N + n0), f);
      const float x = __bfloat162float(xs[r]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = fmaf(x, f[j], acc[j]);
    }
  } else if (g.kind == kInt8) {
    const int8_t* qs = static_cast<const int8_t*>(g.w);
    const float* sc = static_cast<const float*>(g.sc);
#pragma unroll 4
    for (int r = r0 + ty; r < r1; r += kTY) {
      const uint2 u = *reinterpret_cast<const uint2*>(qs + (size_t)r * N + n0);
      const int8_t* q = reinterpret_cast<const int8_t*>(&u);
      const float* s = sc + (size_t)(r / kQK) * N + n0;
      const float4 s0 = *reinterpret_cast<const float4*>(s);
      const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
      const float sv[kCols] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float x = __bfloat162float(xs[r]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[j] = fmaf(x, bround((float)q[j] * sv[j]), acc[j]);
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
      float slo[kCols], shi[kCols];
      unpack8(*reinterpret_cast<const uint4*>(sc + (size_t)(p / kQK) * N + n0), slo);
      unpack8(*reinterpret_cast<const uint4*>(sc + (size_t)((p + half) / kQK) * N + n0), shi);
      const float xlo = __bfloat162float(xs[p]);
      const float xhi = __bfloat162float(xs[p + half]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[j] = fmaf(xlo, bround((float)((int)(q[j] & 15) - 8) * slo[j]), acc[j]);
        acc[j] = fmaf(xhi, bround((float)((int)(q[j] >> 4) - 8) * shi[j]), acc[j]);
      }
    }
  }

  // ---- the block's 32 thread rows, added in row order ----
#pragma unroll
  for (int j = 0; j < kCols; ++j) red[ty * kBN + tx * kCols + j] = acc[j];
  __syncthreads();
  float v = 0.f;
  const int n = blockIdx.x * kBN + tid;
  if (tid < kBN)
    for (int i = 0; i < kTY; ++i) v += red[i * kBN + tid];

  if (gridDim.y == 1) {
    if (tid < kBN) epilogue(g, n, v);
    return;
  }
  // ---- K split across blocks: the last block of the tile adds the splits ----
  if (tid < kBN) g.part[(size_t)blockIdx.y * N + n] = v;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&g.counters[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  if (tid < kBN) {
    float t = 0.f;
    for (int s = 0; s < (int)gridDim.y; ++s) t += __ldcg(g.part + (size_t)s * N + n);
    epilogue(g, n, t);
  }
  if (tid == 0) g.counters[blockIdx.x] = 0;
}

struct Attn {
  const bf16* q;        // (S) bf16
  const bf16* k;        // (T, S) natural layout
  const bf16* v;
  const long long* head;  // self-attention: keys [0, *head + 1); else null
  int n_valid;          // cross-attention: keys [0, n_valid)
  int S, chunk, tmax;
  float scale;
  float* scores;        // (H, tmax)
  float* stats;         // (H, gridDim.y, 2): chunk max, chunk sum
  unsigned* counters;   // one per head, zero between launches
  bf16* out;            // (S) bf16
};

__global__ void __launch_bounds__(kThreads) attend_kernel(Attn a) {
  __shared__ float qh[kDH];
  __shared__ float sc_sh[kMaxChunk];
  __shared__ float red[kTY * kDH];
  __shared__ float wsum[kThreads / 32];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, c = blockIdx.y, S = a.S;
  const int n_valid = a.head != nullptr ? (int)(*a.head) + 1 : a.n_valid;
  const int t0 = c * a.chunk;
  const int t1 = min(t0 + a.chunk, n_valid);
  if (tid < kDH) qh[tid] = __bfloat162float(a.q[h * kDH + tid]);
  __syncthreads();

  // ---- pass one: this chunk's scores, max and sum of exponentials ----
  const float q0 = qh[2 * lane], q1 = qh[2 * lane + 1];
  for (int t = t0 + warp; t < t1; t += kThreads / 32) {
    const __nv_bfloat162 kv = *reinterpret_cast<const __nv_bfloat162*>(
        a.k + (size_t)t * S + h * kDH + 2 * lane);
    const float2 kf = __bfloat1622float2(kv);
    float d = q0 * kf.x + q1 * kf.y;
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) {
      const float s = d * a.scale;
      sc_sh[t - t0] = s;
      a.scores[(size_t)h * a.tmax + t] = s;
      // pass two reads this V row: bring it into L2 now
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.v + (size_t)t * S + h * kDH));
    }
  }
  __syncthreads();
  const int nt = max(t1 - t0, 0);
  float m = -INFINITY;
  for (int i = tid; i < nt; i += kThreads) m = fmaxf(m, sc_sh[i]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __syncthreads();
  if (lane == 0) wsum[warp] = m;
  __syncthreads();
  m = -INFINITY;
  for (int i = 0; i < kThreads / 32; ++i) m = fmaxf(m, wsum[i]);
  float l = 0.f;
  for (int i = tid; i < nt; i += kThreads) l += expf(sc_sh[i] - m);
  l = block_sum(l, wsum);
  if (tid == 0) {
    a.stats[((size_t)h * gridDim.y + c) * 2] = m;
    a.stats[((size_t)h * gridDim.y + c) * 2 + 1] = l;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counters[h], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;

  // ---- the head's last block: combine the chunks in order, then P.V ----
  float M = -INFINITY;
  for (int i = 0; i < (int)gridDim.y; ++i)
    M = fmaxf(M, __ldcg(a.stats + ((size_t)h * gridDim.y + i) * 2));
  float L = 0.f;
  for (int i = 0; i < (int)gridDim.y; ++i) {
    const float li = __ldcg(a.stats + ((size_t)h * gridDim.y + i) * 2 + 1);
    if (li > 0.f)
      L += li * expf(__ldcg(a.stats + ((size_t)h * gridDim.y + i) * 2) - M);
  }
  const int tx = tid % kTX, ty = tid / kTX;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  const float* srow = a.scores + (size_t)h * a.tmax;
#pragma unroll 4
  for (int t = ty; t < n_valid; t += kTY) {
    const float p = bround(expf(__ldcg(srow + t) - M) / L);
    float f[kCols];
    unpack8(*reinterpret_cast<const uint4*>(a.v + (size_t)t * S + h * kDH + tx * kCols), f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = fmaf(p, f[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) red[ty * kDH + tx * kCols + j] = acc[j];
  __syncthreads();
  if (tid < kDH) {
    float o = 0.f;
    for (int i = 0; i < kTY; ++i) o += red[i * kDH + tid];
    a.out[h * kDH + tid] = __float2bfloat16(o);
  }
  if (tid == 0) a.counters[h] = 0;
}

// ---- host side: the launch plan and the workspace layout ----

int cdiv(int a, int b) { return (a + b - 1) / b; }

// (splits, rows per split) for a GEMV over `rows` K rows and N columns
void plan_gemv(int rows, int N, int* splits, int* chunk) {
  const int tiles = N / kBN;
  int ks = cdiv(kTargetBlocks, tiles);
  ks = std::max(1, std::min(ks, rows / kQK));
  *chunk = cdiv(cdiv(rows, ks), kQK) * kQK;
  *splits = cdiv(rows, *chunk);
}

void plan_attend(int T, int H, int* splits, int* chunk) {
  int c = cdiv(T, cdiv(kTargetBlocks, H));
  c = std::min(std::max(cdiv(c, kQK) * kQK, kQK), kMaxChunk);
  *chunk = c;
  *splits = cdiv(T, c);
}

struct Dims {
  int L, S, H, Tc, Ta, Vp;
  int kind[7];  // qkv, o, cq, co, mlp0, mlp1, logits
};

// K (dense rows) and N of the seven weight fields
void field_kn(const Dims& d, int f, int* K, int* N) {
  const int S = d.S;
  const int k[7] = {S, S, S, S, S, 4 * S, S};
  const int n[7] = {3 * S, S, S, S, 4 * S, S, d.Vp};
  *K = k[f];
  *N = n[f];
}

struct Layout {
  size_t xres, qb, ab, gb, part, scores, stats, counters, total;
};

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

Layout layout(const Dims& d) {
  size_t part = 0;
  for (int f = 0; f < 7; ++f) {
    int K, N, ks, chunk;
    field_kn(d, f, &K, &N);
    plan_gemv(d.kind[f] == kInt4 ? K / 2 : K, N, &ks, &chunk);
    if (ks > 1) part = std::max(part, (size_t)ks * N);
  }
  int ks_self, ks_cross, chunk;
  plan_attend(d.Tc, d.H, &ks_self, &chunk);
  plan_attend(d.Ta, d.H, &ks_cross, &chunk);
  const int tmax = std::max(d.Tc, d.Ta);
  Layout o;
  size_t at = 0;
  o.xres = at; at = align256(at + (size_t)d.S * 2);
  o.qb = at; at = align256(at + (size_t)d.S * 2);
  o.ab = at; at = align256(at + (size_t)d.S * 2);
  o.gb = at; at = align256(at + (size_t)4 * d.S * 2);
  o.part = at; at = align256(at + part * 4);
  o.scores = at; at = align256(at + (size_t)d.H * tmax * 4);
  o.stats = at; at = align256(at + (size_t)d.H * std::max(ks_self, ks_cross) * 2 * 4);
  o.counters = at; at = align256(at + (size_t)std::max(d.Vp / kBN, d.H) * 4);
  o.total = at;
  return o;
}

Dims read_dims(const int* v) {
  Dims d;
  d.L = v[0]; d.S = v[1]; d.H = v[2]; d.Tc = v[3]; d.Ta = v[4]; d.Vp = v[5];
  for (int f = 0; f < 7; ++f) d.kind[f] = v[6 + f];
  return d;
}

}  // namespace

// bytes of zero-initialised workspace a step needs (dims as owk_mega_step)
extern "C" long long owk_mega_step_workspace(const int* dims) {
  return (long long)layout(read_dims(dims)).total;
}

// One decoder step. p: x0, head (int64, device), lnw, lnb, the six bias
// stacks (qkv, o, cq, co, mlp0, mlp1), then (plane, scales) for qkv, o, cq,
// co, mlp0, mlp1, logits (scales null for dense), kv_k, kv_v (L, Tc, S),
// xk, xv (L, Ta, S), logits out (Vp) f32, workspace. dims: L, S, H, Tc, Ta,
// Vp, then the seven kinds (0 dense, 1 int8, 2 int4). Returns the first
// nonzero cudaError_t of the 33 launches, or 0.
extern "C" int owk_mega_step(void* const* p, const int* dims, float eps,
                             float kq, float cross_scale, void* stream) {
  const Dims d = read_dims(dims);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout lay = layout(d);
  unsigned char* ws = static_cast<unsigned char*>(p[29]);
  bf16* xres = reinterpret_cast<bf16*>(ws + lay.xres);
  bf16* qb = reinterpret_cast<bf16*>(ws + lay.qb);
  bf16* ab = reinterpret_cast<bf16*>(ws + lay.ab);
  bf16* gb = reinterpret_cast<bf16*>(ws + lay.gb);
  float* part = reinterpret_cast<float*>(ws + lay.part);
  float* scores = reinterpret_cast<float*>(ws + lay.scores);
  float* stats = reinterpret_cast<float*>(ws + lay.stats);
  unsigned* counters = reinterpret_cast<unsigned*>(ws + lay.counters);
  const long long* head = static_cast<const long long*>(p[1]);
  const bf16* lnw = static_cast<const bf16*>(p[2]);
  const bf16* lnb = static_cast<const bf16*>(p[3]);
  const int S = d.S;

  cudaError_t rc = cudaMemcpyAsync(xres, p[0], (size_t)S * 2,
                                   cudaMemcpyDeviceToDevice, st);
  if (rc != cudaSuccess) return (int)rc;

  // field f of layer il (the logits plane has no layer axis)
  auto run = [&](int f, int il, const bf16* in, int ln_row, int epi, bf16* out,
                 float* out_f32, bf16* kk, bf16* vv) -> int {
    int K, N, ks, chunk;
    field_kn(d, f, &K, &N);
    const int kind = d.kind[f];
    plan_gemv(kind == kInt4 ? K / 2 : K, N, &ks, &chunk);
    const size_t plane = kind == kDense ? (size_t)K * N * 2
                         : kind == kInt8 ? (size_t)K * N : (size_t)K / 2 * N;
    const size_t scales = kind == kInt8 ? (size_t)K / kQK * N * 4 : (size_t)K / kQK * N * 2;
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
    g.S = S; g.kq = kq; g.part = part; g.counters = counters;
    gemv_kernel<<<dim3(N / kBN, ks), kThreads, (size_t)K * 2, st>>>(g);
    return (int)cudaGetLastError();
  };
  auto attend = [&](const bf16* q, const bf16* k, const bf16* v, int T,
                    bool self, float scale) -> int {
    int ks, chunk;
    plan_attend(T, d.H, &ks, &chunk);
    Attn a;
    a.q = q; a.k = k; a.v = v;
    a.head = self ? head : nullptr;
    a.n_valid = T; a.S = S; a.chunk = chunk; a.tmax = std::max(d.Tc, d.Ta);
    a.scale = scale; a.scores = scores; a.stats = stats; a.counters = counters;
    a.out = ab;
    attend_kernel<<<dim3(d.H, ks), kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  };

  bf16* kv_k = static_cast<bf16*>(p[24]);
  bf16* kv_v = static_cast<bf16*>(p[25]);
  const bf16* xk = static_cast<const bf16*>(p[26]);
  const bf16* xv = static_cast<const bf16*>(p[27]);
  int e;
  for (int il = 0; il < d.L; ++il) {
    bf16* kk = kv_k + (size_t)il * d.Tc * S;
    bf16* vv = kv_v + (size_t)il * d.Tc * S;
    if ((e = run(0, il, xres, 3 * il, kEpiQKV, qb, nullptr, kk, vv))) return e;
    if ((e = attend(qb, kk, vv, d.Tc, true, 1.0f))) return e;
    if ((e = run(1, il, ab, -1, kEpiResid, xres, nullptr, nullptr, nullptr))) return e;
    if ((e = run(2, il, xres, 3 * il + 1, kEpiBias, qb, nullptr, nullptr, nullptr))) return e;
    if ((e = attend(qb, xk + (size_t)il * d.Ta * S, xv + (size_t)il * d.Ta * S, d.Ta,
                    false, cross_scale))) return e;
    if ((e = run(3, il, ab, -1, kEpiResid, xres, nullptr, nullptr, nullptr))) return e;
    if ((e = run(4, il, xres, 3 * il + 2, kEpiGelu, gb, nullptr, nullptr, nullptr))) return e;
    if ((e = run(5, il, gb, -1, kEpiResid, xres, nullptr, nullptr, nullptr))) return e;
  }
  return run(6, 0, xres, 3 * d.L, kEpiLogits, nullptr, static_cast<float*>(p[28]),
             nullptr, nullptr);
}
