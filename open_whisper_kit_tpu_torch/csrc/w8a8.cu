// Kernel K6: the W8A8 matmul of the int8 encoder,
// out = bf16((f32(quantize_rows(x) @ wq) * xs) * ws).
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/encoder_int8.py::_w8a8_mm
// (kernel body _w8a8_kernel). Same function, bit for bit: each row of x
// (bf16 or f32) is quantized once, r = 127 / amax (IEEE division, r = 0 for
// an all-zero row), q = rint(x * r) clipped to +-127 (rint rounds half to
// even, as jnp.round does), row scale xs = amax * f32(1/127); the products
// accumulate exactly in s32 (127^2 * 5120 < 2^31); the epilogue is
// (f32(acc) * xs) * ws in that order, rounded to bf16 to nearest even.
// Build without --use_fast_math: the division and the rounding are IEEE.
//
// What bounds it on the H100: operations. At large-v3-turbo's encoder
// shapes (M = 1536 per window, K x N of 1280 x 3840, 1280 x 1280,
// 1280 x 5120, 5120 x 1280) it does 2 * M * K * N int8 operations on
// M * K + K * N bytes in: hundreds of operations per byte, far past the
// card's int8 ridge (~590 per byte at 1979 TOP/s and 3.35 TB/s).
//
// Design, two launches:
//   * quantize_rows: one block per row writes the row's int8 values (the
//     K padding zeroed) and its scale; rows past M are zeros, so the GEMM
//     needs no row masks. Each row is quantized once for all N tiles, as
//     the TPU kernel quantizes each row block once into VMEM scratch.
//   * gemm_s8: 128 x 128 output tiles, 8 warps of 64 x 32, mma.sync
//     m16n8k32 s8 x s8 -> s32 from shared memory, K in steps of 64 bytes
//     through a double buffer filled by cp.async (the next step's tiles
//     load during this step's products); the weight plane is stored
//     transposed, (N, K), so each B fragment is four consecutive bytes of
//     one column. Rows of the shared tiles are padded to 80 bytes, which
//     makes the fragment loads free of bank conflicts.
// A fused quantize prologue, wgmma and TMA are later work.
//
// Kernel T2 is gemm_s8 launched alone (owk_mm_s8): it replaces the TPU
// kernel tools/bench_int8_mxu.py::pallas_mm_s8 (kernel body _mm_s8_kernel),
// whose function is this GEMM with its epilogue on rows the caller has
// quantized, row scales given.
//
// Requires K % 8 == 0, Kp % 64 == 0, Mp % 128 == 0, Np % 128 == 0, x on a
// 16-byte boundary; the Python wrapper pads and checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
constexpr int kLd = kBK + 16;   // bytes per shared tile row

__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void widen8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows(const T* x, int8_t* xq, float* xs, int M, int K, int Kp, float inv127) {
  __shared__ float wmax[kThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  int8_t* q = xq + (size_t)row * Kp;
  if (row >= M) {
    for (int i = tid * 8; i < Kp; i += kThreads * 8)
      *reinterpret_cast<uint2*>(q + i) = make_uint2(0u, 0u);
    if (tid == 0) xs[row] = 0.f;
    return;
  }
  const T* in = x + (size_t)row * K;
  float m = 0.f;
  for (int i = tid * 8; i < K; i += kThreads * 8) {
    float f[8];
    widen8(in + i, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) amax = fmaxf(amax, wmax[i]);
  const float r = amax == 0.f ? 0.f : 127.0f / amax;
  for (int i = tid * 8; i < K; i += kThreads * 8) {
    float f[8];
    widen8(in + i, f);
    uint2 packed;
    int8_t* b = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = fminf(fmaxf(rintf(f[j] * r), -127.f), 127.f);
      b[j] = (int8_t)(int)v;
    }
    *reinterpret_cast<uint2*>(q + i) = packed;
  }
  for (int i = K + tid * 8; i < Kp; i += kThreads * 8)
    *reinterpret_cast<uint2*>(q + i) = make_uint2(0u, 0u);
  if (tid == 0) xs[row] = amax * inv127;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// one 128-row tile of 64 bytes each: 512 chunks of 16 bytes, 2 per thread
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int ld_src) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 16;
    cp16(dst + r * kLd + col, src + (size_t)r * ld_src + col);
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_s8(const int8_t* xq, const float* xs, const int8_t* wt, const float* ws,
        __nv_bfloat16* out, int Kp, int Np) {
  __shared__ __align__(16) int8_t sa[2][kBM * kLd];
  __shared__ __align__(16) int8_t sb[2][kBN * kLd];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int8_t* a_src = xq + (size_t)m0 * Kp;
  const int8_t* b_src = wt + (size_t)n0 * Kp;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int nk = Kp / kBK;
  load_tile(sa[0], a_src, Kp);
  load_tile(sb[0], b_src, Kp);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_tile(sa[buf ^ 1], a_src + (kt + 1) * kBK, Kp);
      load_tile(sb[buf ^ 1], b_src + (kt + 1) * kBK, Kp);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);   // step kt's tiles are in
    __syncthreads();
    const int8_t* A = sa[buf];
    const int8_t* B = sb[buf];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = A + (wm * 64 + mi * 16 + g) * kLd + ks + t * 4;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kLd);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = B + (wn * 32 + ni * 8 + g) * kLd + ks + t * 4;
        bfr[ni][0] = lds32(p);
        bfr[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+r"(acc[mi][ni][0]), "+r"(acc[mi][ni][1]), "+r"(acc[mi][ni][2]),
                "+r"(acc[mi][ni][3])
              : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]), "r"(af[mi][3]),
                "r"(bfr[ni][0]), "r"(bfr[ni][1]));
    }
    __syncthreads();   // the next step's loads overwrite this buffer
  }

  // ---- epilogue: (f32(acc) * row scale) * column scale -> bf16 ----
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
      const float sr = xs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t * 2;
        const float v0 = ((float)acc[mi][ni][2 * h] * sr) * ws[col];
        const float v1 = ((float)acc[mi][ni][2 * h + 1] * sr) * ws[col + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * Np + col) =
            __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      }
    }
  }
}

template <typename T>
int run(const void* x, void* xq, void* xs, const void* wt, const void* ws, void* out,
        int M, int K, int Mp, int Kp, int Np, float inv127, void* stream) {
  if (K % 8 || Kp % kBK || Mp % kBM || Np % kBN || K > Kp || M > Mp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  quantize_rows<T><<<Mp, kThreads, 0, st>>>(static_cast<const T*>(x),
                                            static_cast<int8_t*>(xq),
                                            static_cast<float*>(xs), M, K, Kp, inv127);
  int e = (int)cudaGetLastError();
  if (e) return e;
  gemm_s8<<<dim3(Np / kBN, Mp / kBM), kThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wt), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), Kp, Np);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 | f32; xq (Mp, Kp) int8 and xs (Mp) f32 scratch; wt (Np, Kp)
// int8, ws (Np) f32; out (Mp, Np) bf16. inv127 = f32(1/127). Returns the first
// nonzero cudaError_t of the two launches, or 0.
extern "C" int owk_w8a8_bf16(const void* x, void* xq, void* xs, const void* wt,
                             const void* ws, void* out, int M, int K, int Mp, int Kp,
                             int Np, float inv127, void* stream) {
  return run<__nv_bfloat16>(x, xq, xs, wt, ws, out, M, K, Mp, Kp, Np, inv127, stream);
}

extern "C" int owk_w8a8_f32(const void* x, void* xq, void* xs, const void* wt,
                            const void* ws, void* out, int M, int K, int Mp, int Kp,
                            int Np, float inv127, void* stream) {
  return run<float>(x, xq, xs, wt, ws, out, M, K, Mp, Kp, Np, inv127, stream);
}

// Kernel T2: xq (Mp, Kp) int8 with row scales xs (Mp) f32, wt (Np, Kp) int8
// with column scales ws (Np) f32 -> out (Mp, Np) bf16, the GEMM alone. Returns
// the launch's cudaError_t, or cudaErrorInvalidValue for a shape the tile
// does not take.
extern "C" int owk_mm_s8(const void* xq, const void* xs, const void* wt, const void* ws,
                         void* out, int Mp, int Kp, int Np, void* stream) {
  if (Mp <= 0 || Kp <= 0 || Np <= 0 || Kp % kBK || Mp % kBM || Np % kBN)
    return (int)cudaErrorInvalidValue;
  gemm_s8<<<dim3(Np / kBN, Mp / kBM), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wt), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(out), Kp, Np);
  return (int)cudaGetLastError();
}
