// The self-attention of a decode step over a row-flat, time-major cache
// (L, Tc * B, S): row t * B + j is slot j at time t. Used by mega_beam.cu
// alone (K7, beam lineage through an origin table; a null table is the
// identity lineage).
//
// beam_attend_kernel is one block per (head, row b). It walks the time
// blocks 0 .. head / 128 in order and keeps the TPU kernel's online
// softmax (open_whisper_kit_tpu/ops/decode_megakernel.py::_make_kernel,
// attend_beams) exactly: m starts at -1e30; per block mn = max(m, max s),
// a = exp(m - mn), e = bf16(exp(s - mn)), l = l * a + sum(e),
// o = o * a + e . V in f32; out bf16(o / l). The TPU kernel masks with a
// 0/-inf bias that leaves one slot per time row unmasked (origin[b, t], or
// b itself for independent streams) for t <= head; a masked entry adds an
// exact zero to every sum, so this kernel scores only that slot's row,
// 1/B of the self-KV bytes the TPU kernel's slab copy reads.

#pragma once

#include "mega_rows.cuh"

namespace mega {
namespace {   // each kernel library gets its own copy

constexpr int kBT = 128;   // time rows per self-attention block (the TPU kernel's BT)

struct BeamAttn {
  const bf16* q;        // (B, S) bf16, pre-scaled
  const bf16* k;        // this layer's (Tc * B, S): row t * B + j is slot j at time t
  const bf16* v;
  const long long* origin;  // (B, Tc): the slot holding beam b's row for time t;
                            // null: the identity lineage (row b is slot b)
  const long long* head;
  int B, S, Tc;
  bf16* out;            // (B, S) bf16
};

__global__ void __launch_bounds__(kThreads) beam_attend_kernel(BeamAttn a) {
  __shared__ float qh[kDH];
  __shared__ float e_sh[kBT];              // per time row: score, then e
  __shared__ int slot[kBT];                // its cache slot, -1 where masked
  __shared__ float red[kTY * kDH];
  __shared__ float wsum[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y, B = a.B, S = a.S;
  const int head = (int)(*a.head);
  const int nblk = min(head / kBT + 1, (a.Tc + kBT - 1) / kBT);
  const long long* org = a.origin != nullptr ? a.origin + (size_t)b * a.Tc : nullptr;
  if (tid < kDH) qh[tid] = __bfloat162float(a.q[(size_t)b * S + h * kDH + tid]);
  __syncthreads();
  const float q0 = qh[2 * lane], q1 = qh[2 * lane + 1];
  const int tx = tid % kTX, ty = tid / kTX;

  float m = -1e30f, l = 0.f, o = 0.f;      // o: output column tid (tid < 64)
  for (int tb = 0; tb < nblk; ++tb) {
    // ---- the score of each time row's unmasked slot, -inf past head ----
    for (int tl = warp; tl < kBT; tl += kThreads / 32) {
      const int t = tb * kBT + tl;
      const long long j = (t <= head && t < a.Tc) ? (org != nullptr ? org[t] : b) : -1;
      float s = -INFINITY;
      if (j >= 0 && j < B) {
        const __nv_bfloat162 kv = *reinterpret_cast<const __nv_bfloat162*>(
            a.k + ((size_t)t * B + j) * S + h * kDH + 2 * lane);
        const float2 kf = __bfloat1622float2(kv);
        float d = q0 * kf.x + q1 * kf.y;
        for (int o2 = 16; o2 > 0; o2 >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o2);
        s = d;                             // the TPU kernel's scale is 1.0
      }
      if (lane == 0) {
        e_sh[tl] = s;
        slot[tl] = (j >= 0 && j < B) ? (int)j : -1;
      }
    }
    __syncthreads();
    // ---- the block's max, then e = bf16(exp(s - mn)) and their sum ----
    float mx = tid < kBT ? e_sh[tid] : -INFINITY;
    for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    if (lane == 0) wsum[warp] = mx;
    __syncthreads();
    mx = -INFINITY;
    for (int i = 0; i < kThreads / 32; ++i) mx = fmaxf(mx, wsum[i]);
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    float ls = 0.f;
    if (tid < kBT) {
      const float e = bround(expf(e_sh[tid] - mn));
      e_sh[tid] = e;
      ls = e;
    }
    ls = block_sum(ls, wsum);              // its barriers publish e_sh too
    l = l * al + ls;
    // ---- P.V over the rows with e != 0 (masked ones are exact zeros) ----
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int tl = ty; tl < kBT; tl += kTY) {
      const float e = e_sh[tl];
      if (e != 0.f) {
        float f[kCols];
        unpack8(*reinterpret_cast<const uint4*>(
                    a.v + ((size_t)(tb * kBT + tl) * B + slot[tl]) * S + h * kDH
                    + tx * kCols), f);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(e, f[c], acc[c]);
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
    __syncthreads();                       // e_sh, slot, red and wsum are reused
  }
  if (tid < kDH) a.out[(size_t)b * S + h * kDH + tid] = __float2bfloat16(o / l);
}

}  // namespace
}  // namespace mega
