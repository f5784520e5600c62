// Kernel T1: a bf16 GEMM, out = bf16(f32(a @ b)).
//
// Replaces the TPU kernel tools/bench_int8_mxu.py::pallas_mm_bf16 (kernel
// body _mm_bf16_kernel): a (M, K) bf16 times b (K, N) bf16, the products
// summed in f32, each sum rounded to bf16 to nearest even. The tensor-core
// probe chains it at large-v3-turbo's MLP shapes, (1536, 1280) @ (1280, 5120)
// and (1536, 5120) @ (5120, 1280).
//
// What bounds it on the H100: operations. One probe product does 2 * M * K
// * N = 20.1 GFLOP on 32.8 MB (a, b and out once): 20.3 us at 989 TFLOP/s
// against 9.8 us at 3.35 TB/s.
//
// Design: 128 x 128 output tiles, one block of 8 warps each, every warp 64 x
// 32 of them through mma.sync m16n8k16 bf16 -> f32; K in steps of 32 through
// a double buffer in shared memory filled by cp.async (the next step's tiles
// load during this step's products). Fragments come from shared memory by
// ldmatrix: a's rows as they are, b in its natural (K, N) layout through
// ldmatrix.trans, so the caller transposes nothing. Shared rows are padded
// (a to 80 bytes, b to 272) so that the eight 16-byte rows each ldmatrix
// reads fall in distinct banks. The epilogue rounds to bf16, nearest even.
// wgmma, TMA and a deeper pipeline are later work.
//
// Requires M % 128 == 0, N % 128 == 0, K % 32 == 0 and a, b, out on 16-byte
// boundaries; the Python wrapper pads and checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;   // bf16 per shared row of a (80 bytes)
constexpr int kLdB = kBN + 8;   // bf16 per shared row of b (272 bytes)

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(unsigned* r, const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm4_trans(unsigned* r, const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// a's tile: 128 rows of 32 bf16 (64 bytes), 512 chunks of 16 bytes, 2 per thread
__device__ __forceinline__ void load_a(__nv_bfloat16* dst, const __nv_bfloat16* src, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 8;
    cp16(dst + r * kLdA + col, src + (size_t)r * K + col);
  }
}

// b's tile: 32 rows of 128 bf16 (256 bytes), 512 chunks of 16 bytes, 2 per thread
__device__ __forceinline__ void load_b(__nv_bfloat16* dst, const __nv_bfloat16* src, int N) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 4, col = (c & 15) * 8;
    cp16(dst + r * kLdB + col, src + (size_t)r * N + col);
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out, int K,
          int N) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][kBM * kLdA];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kBK * kLdB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16* a_src = a + (size_t)m0 * K;
  const __nv_bfloat16* b_src = b + n0;
  // ldmatrix row addresses: lanes 0-15 rows 0-15 at column 0, lanes 16-31 the
  // same rows at column 8. For a that gives the m16n8k16 A fragment {a0..a3};
  // for b (rows are k) under .trans, B fragments {b0, b1} of two 8-column blocks.
  const int lr = lane & 15, lc = (lane >> 4) * 8;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int nk = K / kBK;
  load_a(sa[0], a_src, K);
  load_b(sb[0], b_src, N);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_a(sa[buf ^ 1], a_src + (kt + 1) * kBK, K);
      load_b(sb[buf ^ 1], b_src + (size_t)(kt + 1) * kBK * N, N);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);   // step kt's tiles are in
    __syncthreads();
    const __nv_bfloat16* A = sa[buf];
    const __nv_bfloat16* B = sb[buf];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm4(af[mi], A + (wm * 64 + mi * 16 + lr) * kLdA + ks + lc);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        ldsm4_trans(r, B + (ks + lr) * kLdB + wn * 32 + nj * 16 + lc);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[mi][ni][0]), "+f"(acc[mi][ni][1]), "+f"(acc[mi][ni][2]),
                "+f"(acc[mi][ni][3])
              : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]), "r"(af[mi][3]),
                "r"(bfr[ni][0]), "r"(bfr[ni][1]));
    }
    __syncthreads();   // the next step's loads overwrite this buffer
  }

  // ---- epilogue: f32 sums -> bf16, nearest even ----
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t * 2;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// a (M, K) bf16, b (K, N) bf16, out (M, N) bf16, all row-major. Returns the
// launch's cudaError_t, or cudaErrorInvalidValue for a shape the tile does
// not take.
extern "C" int owk_mm_bf16(const void* a, const void* b, void* out, int M, int K, int N,
                           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || M % kBM || N % kBN || K % kBK)
    return (int)cudaErrorInvalidValue;
  gemm_bf16<<<dim3(N / kBN, M / kBM), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), K, N);
  return (int)cudaGetLastError();
}
