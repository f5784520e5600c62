// The tiled dequantize-matmul of kernel K4 (qmm4.cu, every M) and of K5's
// route above 16 rows (ffn_int8.cu's owk_ffn_int8: prompt ingest). K3 left
// it for its own bodies (qmm.cu above 16 rows, qmm_rows.cuh below), and
// K5's decode rows run qmm_rows.cuh too.
//
// y[M, Np] = bf16(x)[M, K] @ bf16(dequant(planes))[K, Np], f32 accumulation.
// x arrives in bf16 (the wrappers cast it, as the TPU kernels do); each
// weight is dequantized in f32 (value * its 32-row block's scale) and rounded
// to bf16 once, in shared memory, which is where the TPU kernels round it.
//
// Design (first version, right before fast): one block of 4 warps computes a
// (16 * MF) x 128 output tile. The K loop steps by 32 rows, one scale block:
// the x tile (16 * MF x 32 bf16) and the weight tile (32 x 128, dequantized
// to bf16) go to shared memory, then each warp runs bf16 wmma 16x16x16
// (mma.sync) on its 32 columns for every 16-row slice of the tile. The next
// step's global loads are issued into registers before this step's products,
// so one step's load latency overlaps the previous step's math. MF = 1 serves
// the skinny rows (M <= 16: K4's logits; the idle rows of the 16-row slice
// are wasted tensor work, the weight stream is what bounds them), MF = 4
// more rows (K5's ingest rows). Rows past M load as zero and are never
// stored. An epilogue functor stores each output element: plain f32 (K4,
// K5's second half) or bias + gelu_tanh rounded to bf16 (K5's first half).
//
// Requires K % 32 == 0, Np % 128 == 0, 16-byte aligned x/scales rows and
// 4-byte aligned value rows; the Python wrappers check.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace owk_qtile {

using namespace nvcuda;

constexpr int kQK = 32;        // rows per scale block = K per main-loop step
constexpr int kBN = 128;       // output columns per block
constexpr int kThreads = 128;  // 4 warps; warp w owns columns [32w, 32w + 32)
constexpr int kLdx = kQK + 8;  // x tile row stride, bf16 (80 bytes)
constexpr int kLdw = kBN + 8;  // weight tile row stride, bf16 (272 bytes)
constexpr int kLds = 16 + 4;   // f32 staging row stride

__device__ __forceinline__ void put4(__nv_bfloat16* dst, float a, float b,
                                     float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// int8 planes: qs (K, Np), sc (K/32, Np). Thread t takes columns
// 4 * (t % 32) .. +4 of rows 8 * (t / 32) .. +8 of one 32-row block.
struct Int8Planes {
  const int8_t* qs;
  const float* sc;
  int Np;
  struct Regs {
    char4 q[8];
    float4 s;
  };
  __device__ __forceinline__ void fetch(Regs& r, int kb, int n0) const {
    const int c = n0 + (threadIdx.x & 31) * 4;
    const int r0 = kb * kQK + (threadIdx.x >> 5) * 8;
    r.s = *reinterpret_cast<const float4*>(sc + (size_t)kb * Np + c);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r.q[i] = *reinterpret_cast<const char4*>(qs + (size_t)(r0 + i) * Np + c);
  }
  __device__ __forceinline__ void store(const Regs& r, __nv_bfloat16* w_sh) const {
    const int c = (threadIdx.x & 31) * 4;
    const int r0 = (threadIdx.x >> 5) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      put4(w_sh + (r0 + i) * kLdw + c, (float)r.q[i].x * r.s.x,
           (float)r.q[i].y * r.s.y, (float)r.q[i].z * r.s.z,
           (float)r.q[i].w * r.s.w);
  }
};

// split-half int4 planes: qs (K/2, Np) uint8, packed row p holds K row 2p in
// its low nibble and K row 2p + 1 in its high nibble; sc (K/32, Np). Thread
// t takes columns 4 * (t % 32) .. +4 of packed rows 4 * (t / 32) .. +4.
struct Int4Planes {
  const uint8_t* qs;
  const float* sc;
  int Np;
  struct Regs {
    uchar4 q[4];
    float4 s;
  };
  __device__ __forceinline__ void fetch(Regs& r, int kb, int n0) const {
    const int c = n0 + (threadIdx.x & 31) * 4;
    const int p0 = kb * (kQK / 2) + (threadIdx.x >> 5) * 4;
    r.s = *reinterpret_cast<const float4*>(sc + (size_t)kb * Np + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r.q[i] = *reinterpret_cast<const uchar4*>(qs + (size_t)(p0 + i) * Np + c);
  }
  __device__ __forceinline__ void store(const Regs& r, __nv_bfloat16* w_sh) const {
    const int c = (threadIdx.x & 31) * 4;
    const int p0 = (threadIdx.x >> 5) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uchar4 q = r.q[i];
      put4(w_sh + (2 * (p0 + i)) * kLdw + c,
           (float)((int)(q.x & 15) - 8) * r.s.x, (float)((int)(q.y & 15) - 8) * r.s.y,
           (float)((int)(q.z & 15) - 8) * r.s.z, (float)((int)(q.w & 15) - 8) * r.s.w);
      put4(w_sh + (2 * (p0 + i) + 1) * kLdw + c,
           (float)((int)(q.x >> 4) - 8) * r.s.x, (float)((int)(q.y >> 4) - 8) * r.s.y,
           (float)((int)(q.z >> 4) - 8) * r.s.z, (float)((int)(q.w >> 4) - 8) * r.s.w);
    }
  }
};

// the x tile: BM rows x 32 bf16 as 16-byte chunks of 8 values
template <int BM>
struct XTile {
  static constexpr int kChunks = BM * kQK / 8;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  uint4 v[kPer];
  __device__ __forceinline__ void fetch(const __nv_bfloat16* x, int M, int K,
                                        int m0, int kb) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i >> 2, c = (i & 3) * 8;
      v[j] = make_uint4(0, 0, 0, 0);
      if (i < kChunks && m0 + r < M)
        v[j] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + kb * kQK + c);
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* x_sh) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < kChunks)
        *reinterpret_cast<uint4*>(x_sh + (i >> 2) * kLdx + (i & 3) * 8) = v[j];
    }
  }
};

struct StoreF32 {
  float* out;
  int ldo;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    out[(size_t)r * ldo + c] = v;
  }
};

// h = bf16(gelu_tanh(v + b)), the formula of jax.nn.gelu(approximate=True)
struct BiasGeluBf16 {
  __nv_bfloat16* h;
  const float* b;
  int ldh;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const float u = v + b[c];
    const float g = u * (0.5f * (1.0f + tanhf(0.7978845608028654f *
                                              (u + 0.044715f * (u * u * u)))));
    h[(size_t)r * ldh + c] = __float2bfloat16(g);
  }
};

template <int MF, class Planes, class Epilogue>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, Planes w,
           Epilogue ep) {
  constexpr int BM = 16 * MF;
  __shared__ __align__(128) __nv_bfloat16 x_sh[BM * kLdx];
  __shared__ __align__(128) __nv_bfloat16 w_sh[kQK * kLdw];
  __shared__ __align__(128) float st_sh[kThreads / 32][16 * kLds];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][2];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[m][n], 0.0f);

  XTile<BM> xt;
  typename Planes::Regs wr;
  const int nkb = K / kQK;
  xt.fetch(x, M, K, m0, 0);
  w.fetch(wr, 0, n0);
  for (int kb = 0; kb < nkb; ++kb) {
    xt.store(x_sh);
    w.store(wr, w_sh);
    __syncthreads();
    if (kb + 1 < nkb) {   // next step's loads fly while this step multiplies
      xt.fetch(x, M, K, m0, kb + 1);
      w.fetch(wr, kb + 1, n0);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wmma::load_matrix_sync(bf[n], w_sh + kk * 16 * kLdw + warp * 32 + n * 16, kLdw);
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, x_sh + m * 16 * kLdx + kk * 16, kLdx);
#pragma unroll
        for (int n = 0; n < 2; ++n) wmma::mma_sync(acc[m][n], af, bf[n], acc[m][n]);
      }
    }
    __syncthreads();
  }

  float* st = st_sh[warp];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      wmma::store_matrix_sync(st, acc[m][n], kLds, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int row = m0 + m * 16 + (i >> 4);
        if (row < M) ep(row, n0 + warp * 32 + n * 16 + (i & 15), st[(i >> 4) * kLds + (i & 15)]);
      }
      __syncwarp();
    }
}

// launch on `stream`; returns the cudaError_t of the launch
template <class Planes, class Epilogue>
int launch(const void* x, int M, int K, int Np, Planes w, Epilogue ep,
           cudaStream_t stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (M <= 16) {
    const dim3 grid(Np / kBN, 1);
    qmm_kernel<1><<<grid, kThreads, 0, stream>>>(xb, M, K, w, ep);
  } else {
    const dim3 grid(Np / kBN, (M + 63) / 64);
    qmm_kernel<4><<<grid, kThreads, 0, stream>>>(xb, M, K, w, ep);
  }
  return (int)cudaGetLastError();
}

}  // namespace owk_qtile
