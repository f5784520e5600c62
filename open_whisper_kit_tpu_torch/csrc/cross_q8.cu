// Kernels K9b and K9a: one decoder query row per (stream, head) against
// int8 cross-KV planes with one f32 scale per (position, head),
//
//   s_k = (q_h . kq[b,h,k]) * ks[b,h,k] * scale     for keys k < n_keys
//   p   = softmax(s)
//   out = sum_k round(p_k * vs[b,h,k]) * vq[b,h,k]
//
// Replaces the TPU kernels open_whisper_kit_tpu/ops/experiments.py::
// cross_attention_q8 (K9b, head-major planes, body _cross_q8_kernel) and
// cross_attention_q8_nat (K9a, natural planes, body _cross_q8_nat_kernel).
// One templated body serves both: the planes are read at element strides
// (batch, head, row) -- head-major (H*Ta*dh, Ta*dh, dh), natural (Tap*S,
// dh, S) -- and the scales at (batch, head) -- (H*Ta, Ta) or (Hs*Tap, Tap);
// a batch stride of 0 lets every stream read one shared batch-1 plane.
// Keys at or past n_keys (K9a's ta_valid) are never read, which is what
// the TPU kernel's -inf mask gives.
//
// Rounding points, in the activations' type T. bf16 (the port's real
// models) takes the TPU kernel's: bf16 q, int8 exact in f32, f32 dot
// products, the scales folded after the dot ((dot * ks) * scale), f32
// softmax with p = e / sum before the multiply by vs, p * vs rounded to
// bf16, f32 accumulation against V, the output rounded to bf16. f32 keeps
// f32 throughout (no rounding of q or p * vs), so that the port's decoder
// computes JAX's _attention_hm_q at every dtype. The dequantized K/V never
// exist in device memory: each int8 row converts in registers.
//
// What bounds it on the H100: bytes. At large-v3-turbo (H = 20, dh = 64,
// Ta = 1500) one launch (one layer) reads 2 * H * Ta * dh bytes of planes
// and 2 * H * Ta * 4 of scales per stream: 4.08 MB, about 1.2 us at 3.35
// TB/s (shared by B = 5 beams), 32.6 MB and 9.7 us for B = 8 streams,
// half of what the bf16 cross-KV it replaces reads. ~7.7 MFLOP per stream
// do not bind.
//
// Design, a simple kernel that is right (making it fast is later work):
// a grid of (B, H) would give 20 blocks at B = 1 on 132 SMs, so the keys
// are split into chunks (a multiple of 32 keys, at most 512; the wrapper
// plans about two blocks per SM) and three launches combine them in a
// fixed order, with no float atomics:
//   * scores_kernel, grid (chunks, H, B): four threads score one 64-byte
//     key row with 16-byte loads (a warp 8 rows, the block 32 at a time),
//     reduce by two shuffles, keep the chunk's scores in shared memory and
//     write them out with the chunk's max and sum of exp(s - max);
//   * pv_kernel, same grid: every block combines all chunks' (max, sum)
//     of its (stream, head) in chunk order into the row's (M, L), then
//     takes p = exp(s - M) / L for its keys, w = round(p * vs), and sums
//     w * V with four threads per 64-byte V row, 16 columns each; the 32
//     row slots add up in slot order into the chunk's 64 partial sums;
//   * combine_kernel, grid (H, B): adds the chunks' partial sums in chunk
//     order and rounds to T.
// Requires 64-wide heads, 16-byte aligned planes and row strides that are
// multiples of 16 bytes; the Python wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kDH = 64;                  // head width
constexpr int kThreads = 128;
constexpr int kSlots = kThreads / 4;     // key rows in flight: 4 threads a row
constexpr int kMaxChunk = 512;           // keys per block

struct Args {
  const void* q;         // (B, H * dh) in T
  const int8_t* kq;      // planes, read at the strides below
  const float* ks;       // scales
  const int8_t* vq;
  const float* vs;
  void* out;             // (B, H * dh) in T
  float* scores;         // (B, H, chunks, chunk)
  float* stats;          // (B, H, chunks, 2): chunk max, chunk sum
  float* part;           // (B, H, chunks, dh)
  int H, n_keys, chunk, n_chunks;
  long long kb, kh, kr;  // plane strides (elements): batch, head, row
  long long sb, sh;      // scale strides: batch, head
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// p * vs as the matrix product takes it: rounded to T
template <typename T>
__device__ __forceinline__ float in_type(float x) { return to_f32(from_f32<T>(x)); }

// 16 int8 values (one 16-byte load, little-endian) -> f32, exactly
__device__ __forceinline__ void unpack16(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = (float)((int)(w[i] << (24 - 8 * j)) >> 24);
}

// block-wide max / sum of one value per thread, the same on every thread
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, red[i]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) v += red[i];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scores_kernel(Args a) {
  __shared__ float qh[kDH];
  __shared__ float sc[kMaxChunk];
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int g = tid & 3;  // which 16 bytes of a key row
  if (tid < kDH)
    qh[tid] = to_f32(static_cast<const T*>(a.q)[((size_t)b * a.H + h) * kDH + tid]);
  __syncthreads();
  const int t0 = c * a.chunk;
  const int n = min(t0 + a.chunk, a.n_keys) - t0;
  const int8_t* kbase = a.kq + b * a.kb + h * a.kh;
  const float* ksb = a.ks + b * a.sb + h * a.sh;
  // every lane runs every pass (the shuffles need the whole warp)
  for (int r0 = 0; r0 < n; r0 += kSlots) {
    const int r = r0 + (tid >> 2);
    float d = 0.f;
    if (r < n) {
      float f[16];
      unpack16(*reinterpret_cast<const uint4*>(kbase + (t0 + r) * a.kr + g * 16), f);
#pragma unroll
      for (int j = 0; j < 16; ++j) d = fmaf(qh[g * 16 + j], f[j], d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (r < n && g == 0) sc[r] = d * ksb[t0 + r] * a.scale;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int i = tid; i < n; i += kThreads) m = fmaxf(m, sc[i]);
  m = block_max(m, red);
  float l = 0.f;
  for (int i = tid; i < n; i += kThreads) l += expf(sc[i] - m);
  l = block_sum(l, red);
  const size_t row = ((size_t)b * a.H + h) * a.n_chunks + c;
  float* srow = a.scores + row * a.chunk;
  for (int i = tid; i < n; i += kThreads) srow[i] = sc[i];
  if (tid == 0) {
    a.stats[row * 2] = m;
    a.stats[row * 2 + 1] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pv_kernel(Args a) {
  __shared__ float red[kSlots * kDH];
  __shared__ float ml[2];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int g = tid & 3;  // which 16 columns of a V row
  const size_t bh = (size_t)b * a.H + h;
  if (tid == 0) {
    // the softmax's max and sum over all keys, chunks combined in order
    const float* st = a.stats + bh * a.n_chunks * 2;
    float M = -INFINITY;
    for (int i = 0; i < a.n_chunks; ++i) M = fmaxf(M, st[2 * i]);
    float L = 0.f;
    for (int i = 0; i < a.n_chunks; ++i) L += st[2 * i + 1] * expf(st[2 * i] - M);
    ml[0] = M;
    ml[1] = L;
  }
  __syncthreads();
  const float M = ml[0], L = ml[1];
  const int t0 = c * a.chunk;
  const int n = min(t0 + a.chunk, a.n_keys) - t0;
  const float* srow = a.scores + (bh * a.n_chunks + c) * a.chunk;
  const int8_t* vbase = a.vq + b * a.kb + h * a.kh;
  const float* vsb = a.vs + b * a.sb + h * a.sh;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int r = tid >> 2; r < n; r += kSlots) {
    const float p = expf(srow[r] - M) / L;
    const float w = in_type<T>(p * vsb[t0 + r]);
    float f[16];
    unpack16(*reinterpret_cast<const uint4*>(vbase + (t0 + r) * a.kr + g * 16), f);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = fmaf(w, f[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) red[(tid >> 2) * kDH + g * 16 + j] = acc[j];
  __syncthreads();
  if (tid < kDH) {
    float o = 0.f;
    for (int i = 0; i < kSlots; ++i) o += red[i * kDH + tid];
    a.part[(bh * a.n_chunks + c) * kDH + tid] = o;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDH) combine_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t bh = (size_t)b * a.H + h;
  const float* p = a.part + bh * a.n_chunks * kDH;
  float o = 0.f;
  for (int c = 0; c < a.n_chunks; ++c) o += p[(size_t)c * kDH + d];
  static_cast<T*>(a.out)[bh * kDH + d] = from_f32<T>(o);
}

template <typename T>
int run(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
        void* out, void* scores, void* stats, void* part, int B, int H, int n_keys,
        int chunk, int kb, int kh, int kr, int sb, int sh, float scale, void* stream) {
  if (B < 1 || H < 1 || n_keys < 1 || chunk < 32 || chunk > kMaxChunk || chunk % 32 ||
      kr % 16 || kh % 16 || kb % 16)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.kq = static_cast<const int8_t*>(kq);
  a.ks = static_cast<const float*>(ks);
  a.vq = static_cast<const int8_t*>(vq);
  a.vs = static_cast<const float*>(vs);
  a.out = out;
  a.scores = static_cast<float*>(scores);
  a.stats = static_cast<float*>(stats);
  a.part = static_cast<float*>(part);
  a.H = H;
  a.n_keys = n_keys;
  a.chunk = chunk;
  a.n_chunks = (n_keys + chunk - 1) / chunk;
  a.kb = kb; a.kh = kh; a.kr = kr;
  a.sb = sb; a.sh = sh;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.n_chunks, H, B);
  scores_kernel<T><<<grid, kThreads, 0, st>>>(a);
  int e = (int)cudaGetLastError();
  if (e) return e;
  pv_kernel<T><<<grid, kThreads, 0, st>>>(a);
  e = (int)cudaGetLastError();
  if (e) return e;
  combine_kernel<T><<<dim3(H, B), kDH, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q and out (B, H * 64) in bf16 | f32; kq/vq int8 planes and ks/vs f32
// scales read at element strides (kb, kh, kr) and (sb, sh), a batch stride
// of 0 for planes every stream shares; scores (B*H*chunks*chunk), stats
// (B*H*chunks*2) and part (B*H*chunks*64) f32 scratch, chunks =
// ceil(n_keys / chunk). Returns the first nonzero cudaError_t of the three
// launches, or 0.
extern "C" int owk_cross_q8_bf16(const void* q, const void* kq, const void* ks,
                                 const void* vq, const void* vs, void* out, void* scores,
                                 void* stats, void* part, int B, int H, int n_keys,
                                 int chunk, int kb, int kh, int kr, int sb, int sh,
                                 float scale, void* stream) {
  return run<bf16>(q, kq, ks, vq, vs, out, scores, stats, part, B, H, n_keys, chunk, kb,
                   kh, kr, sb, sh, scale, stream);
}

extern "C" int owk_cross_q8_f32(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs, void* out, void* scores,
                                void* stats, void* part, int B, int H, int n_keys,
                                int chunk, int kb, int kh, int kr, int sb, int sh,
                                float scale, void* stream) {
  return run<float>(q, kq, ks, vq, vs, out, scores, stats, part, B, H, n_keys, chunk, kb,
                    kh, kr, sb, sh, scale, stream);
}
