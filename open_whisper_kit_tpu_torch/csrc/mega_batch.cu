// Kernel K8: one whole decoder step for B <= 8 independent streams (batched
// serving) through one weight stream (every layer, the final layernorm and
// the vocab projection), over dense bf16, int8 or split-half int4 planes.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/decode_megakernel.py::
// mega_decode_step_batch (kernel body _make_kernel with n_beams = B,
// per_row_cross). It computes that kernel's function: the B rows take K2's
// rounding points (mega_rows.cuh) through every matmul; the self-attention
// is the blocked online softmax of K7 (mega_blocked.cuh) with the identity
// lineage (stream b owns slot b at every time, so no origin table); the
// cross-attention is per stream, each stream against its own cross-KV.
//
// Design. The launch sequence of K2 and K7 (8 launches per layer plus the
// logits, 33 at large-v3-turbo), R = B rows in each:
//   * the GEMVs (gemv_kernel<B>) read and dequantize each weight once for
//     the B rows; the QKV epilogue writes stream b's new K/V row to flat
//     cache row head * B + b;
//   * the self-attention (beam_attend_kernel, origin null) scores one row
//     per time step of the stream's own slot;
//   * the cross-attention (batch_cross_kernel below) is one block per
//     (head, stream) over the stream's (Ta, S) keys in chunks of 256 rows,
//     the TPU kernel's chunked online softmax exactly: m starts at -1e30;
//     per chunk mn = max(m, max s), a = exp(m - mn), e = bf16(exp(s - mn)),
//     l = l * a + sum(e), o = o * a + e . V in f32; out bf16(o / l). Keys
//     past Ta, which the TPU kernel pads to the chunk and scores -1e30, add
//     exact zeros there; here the last chunk stops at Ta. Each thread
//     scores one key row (its 64 bf16 values, one 128-byte line), so a
//     chunk's keys arrive in one round of loads.
//
// What bounds a step on the H100: the bytes. Each stream reads its own
// cross-KV, L * 2 * Ta * S * 2 bytes (30.7 MB at large-v3-turbo), so at
// B = 8 the cross-KV (246 MB) outweighs the weights (350 MB dense, 211 MB
// int8, 122 MB int4), which stream once for the 8 rows. This first version
// is bound by its launch chain and load latency, not by those bytes.
//
// Requires 2 <= B <= 8, S % 128 == 0 (int4: S % 256 == 0), 64-wide heads,
// every plane width a multiple of 64 and 16-byte aligned planes; the Python
// wrapper checks.

#include "mega_blocked.cuh"

using namespace mega;

// the kernel sits in the header's unnamed namespace: nvcc's generated stub
// names one unnamed namespace per file for its kernels
namespace mega {
namespace {

constexpr int kTAC = 256;   // key rows per cross chunk (the TPU kernel's tac)
static_assert(kTAC == kThreads, "one key row per thread");

struct BatchCross {
  const bf16* q;        // (B, S) bf16 cross queries
  const bf16* k;        // this layer's (B, Ta, S): stream b's keys, pre-scaled
  const bf16* v;
  int S, Ta;
  float scale;          // dh^-0.25 as f32
  bf16* out;            // (B, S) bf16
};

__global__ void __launch_bounds__(kThreads) batch_cross_kernel(BatchCross a) {
  __shared__ float qh[kDH];
  __shared__ float e_sh[kTAC];
  __shared__ float red[kTY * kDH];
  __shared__ float wsum[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y, S = a.S, Ta = a.Ta;
  const bf16* kb = a.k + (size_t)b * Ta * S + h * kDH;
  const bf16* vb = a.v + (size_t)b * Ta * S + h * kDH;
  if (tid < kDH) qh[tid] = __bfloat162float(a.q[(size_t)b * S + h * kDH + tid]);
  __syncthreads();
  const int tx = tid % kTX, ty = tid / kTX;

  float m = -1e30f, l = 0.f, o = 0.f;      // o: output column tid (tid < 64)
  for (int c0 = 0; c0 < Ta; c0 += kTAC) {
    const int t = c0 + tid;
    const int nrow = min(kTAC, Ta - c0);
    // ---- this thread's key row: its score ----
    float s = -INFINITY;
    if (t < Ta) {
      const bf16* kr = kb + (size_t)t * S;
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < kDH; j += kCols) {
        float f[kCols];
        unpack8(*reinterpret_cast<const uint4*>(kr + j), f);
#pragma unroll
        for (int u = 0; u < kCols; ++u) d = fmaf(qh[j + u], f[u], d);
      }
      s = d * a.scale;
    }
    // ---- the chunk's max, then e = bf16(exp(s - mn)) and their sum ----
    float mx = s;
    for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    if (lane == 0) wsum[warp] = mx;
    __syncthreads();
    mx = -INFINITY;
    for (int i = 0; i < kThreads / 32; ++i) mx = fmaxf(mx, wsum[i]);
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    const float e = t < Ta ? bround(expf(s - mn)) : 0.f;
    e_sh[tid] = e;
    l = l * al + block_sum(e, wsum);       // its barriers publish e_sh too
    // ---- P.V over the chunk's rows with e != 0 ----
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int tl = ty; tl < nrow; tl += kTY) {
      const float w = e_sh[tl];
      if (w != 0.f) {
        float f[kCols];
        unpack8(*reinterpret_cast<const uint4*>(vb + (size_t)(c0 + tl) * S + tx * kCols), f);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(w, f[c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[ty * kDH + tx * kCols + c] = acc[c];
    __syncthreads();
    if (tid < kDH) {
      float pv = 0.f;
      for (int i = 0; i < kTY; ++i) pv += red[i * kDH + tid];
      o = o * al + pv;
    }
    m = mn;
    __syncthreads();                       // e_sh, red and wsum are reused
  }
  if (tid < kDH) a.out[(size_t)b * S + h * kDH + tid] = __float2bfloat16(o / l);
}

}  // namespace
}  // namespace mega

namespace {

template <int B>
int batch_step(void* const* p, const int* dims, float eps, float kq, float cross_scale,
               void* stream) {
  const Step<B> s(p, dims, eps, kq, stream);
  const Dims& d = s.d;
  const size_t cross_layer = (size_t)B * d.Ta * d.S;   // (B, Ta, S) per layer
  int e;
  if ((e = s.start())) return e;
  for (int il = 0; il < d.L; ++il) {
    bf16* kk = s.kv_k() + (size_t)il * d.Tc * B * d.S;
    bf16* vv = s.kv_v() + (size_t)il * d.Tc * B * d.S;
    if ((e = s.gemv(0, il, s.xres, 3 * il, kEpiQKV, s.qb, nullptr, kk, vv))) return e;
    BeamAttn a;
    a.q = s.qb; a.k = kk; a.v = vv; a.origin = nullptr; a.head = s.head;
    a.B = B; a.S = d.S; a.Tc = d.Tc; a.out = s.ab;
    beam_attend_kernel<<<dim3(d.H, B), kThreads, 0, s.st>>>(a);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = s.gemv(1, il, s.ab, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(2, il, s.xres, 3 * il + 1, kEpiBias, s.qb, nullptr, nullptr, nullptr))) return e;
    BatchCross c;
    c.q = s.qb;
    c.k = static_cast<const bf16*>(p[26]) + il * cross_layer;
    c.v = static_cast<const bf16*>(p[27]) + il * cross_layer;
    c.S = d.S; c.Ta = d.Ta; c.scale = cross_scale; c.out = s.ab;
    batch_cross_kernel<<<dim3(d.H, B), kThreads, 0, s.st>>>(c);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = s.gemv(3, il, s.ab, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(4, il, s.xres, 3 * il + 2, kEpiGelu, s.gb, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(5, il, s.gb, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
  }
  return s.gemv(6, 0, s.xres, 3 * d.L, kEpiLogits, nullptr, s.logits(), nullptr, nullptr);
}

}  // namespace

// bytes of zero-initialised workspace a step needs (dims as owk_mega_batch)
extern "C" long long owk_mega_batch_workspace(const int* dims) {
  return (long long)layout(read_dims(dims), dims[13]).total;
}

// One batched decoder step. p: as mega::Step with kv_k, kv_v (L, Tc * B, S)
// row-flat time-major, xk, xv (L, B, Ta, S) per stream and logits out
// (B, Vp). dims: L, S, H, Tc (per stream), Ta, Vp, the seven kinds (0 dense,
// 1 int8, 2 int4), B, Tp (K2's self-attention plan; not used here).
// Returns the first nonzero cudaError_t of the launches, or 0
// (cudaErrorInvalidValue for B outside 2..8).
extern "C" int owk_mega_batch(void* const* p, const int* dims, float eps,
                              float kq, float cross_scale, void* stream) {
  switch (dims[13]) {
    case 2: return batch_step<2>(p, dims, eps, kq, cross_scale, stream);
    case 3: return batch_step<3>(p, dims, eps, kq, cross_scale, stream);
    case 4: return batch_step<4>(p, dims, eps, kq, cross_scale, stream);
    case 5: return batch_step<5>(p, dims, eps, kq, cross_scale, stream);
    case 6: return batch_step<6>(p, dims, eps, kq, cross_scale, stream);
    case 7: return batch_step<7>(p, dims, eps, kq, cross_scale, stream);
    case 8: return batch_step<8>(p, dims, eps, kq, cross_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
