// Kernel K6: the W8A8 matmul of the int8 encoder,
// out = bf16((f32(quantize_rows(x) @ wq) * xs) * ws).
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/encoder_int8.py::_w8a8_mm
// (kernel body _w8a8_kernel). Same function, bit for bit: each row of x
// (bf16 or f32) is quantized once, r = 127 / amax (IEEE division, r = 0 for
// an all-zero row), q = rint(x * r) clipped to +-127 (rint rounds half to
// even, as jnp.round does), row scale xs = amax * f32(1/127); the products
// accumulate exactly in s32 (127^2 * 5120 < 2^31), so their order is free;
// the epilogue is (f32(acc) * xs) * ws in that order, rounded to bf16 to
// nearest even. Build without --use_fast_math: the division and the
// rounding are IEEE.
//
// Kernel T2 is the GEMM launched alone (owk_mm_s8): it replaces the TPU
// kernel tools/bench_int8_mxu.py::pallas_mm_s8 (kernel body _mm_s8_kernel),
// whose function is this GEMM with its epilogue on rows the caller has
// quantized, row scales given.
//
// What bounds it on the H100: operations. At large-v3-turbo's encoder
// shapes (M = 1536 per window, K x N of 1280 x 3840, 1280 x 1280,
// 1280 x 5120, 5120 x 1280) it does 2 * M * K * N int8 operations on
// M * K + K * N bytes in and 2 * M * N out: hundreds of operations per
// byte, past the card's int8 ridge (~590 per byte at 1979 TOP/s and
// 3.35 TB/s). mlp0 over 8 windows: 161 GOP, 81.4 us at the int8 peak.
// Only wgmma reaches that rate; mma.sync from shared memory (the first
// design of this file) ran at 16-17 % of it.
//
// Design, two launches:
//  * quantize_rows: one warp per row, 16-byte loads; the row is read from
//    HBM once, into the warp's registers (5, 10 or 20 chunks of 16 bytes a
//    lane, the fewest that hold it: up to 5120 bf16 values; a longer row
//    is read twice), its amax taken, and its int8 values and scale written
//    once: a byte stream (bf16 x in, int8 out). amax is an order-free max,
//    so the warp's reduction gives the same bits as any other. It signals
//    the dependent GEMM at its start.
//  * gemm_s8: the structure of T1 (csrc/mm_bf16.cu) for s8: a
//    warp-specialised, persistent TMA + wgmma GEMM on clusters of two
//    blocks. One producer warpgroup (one thread issues TMA) and two
//    consumer warpgroups of 64 rows each; 384 threads, one block per SM.
//    - Tiles of 128 x 128 or 128 x 256 (the wrapper's plan,
//      ops/gemm.py::w8a8_plan: the wider where its tile pairs fill the card),
//      K in steps of 128 bytes: one 128-byte swizzled row holds 128 int8
//      values of K, both operands K-major (xq (M, K); the weight stored
//      transposed, (N, K)), as wgmma takes 8-bit operands; its k32 steps
//      advance 32 bytes inside the swizzle pattern, as T1's bf16 k16 steps
//      do, so sm90.cuh's K-major descriptor serves both.
//    - The two blocks of a cluster compute two row tiles of one column
//      tile and share its weight tile: each loads its own xq tile and half
//      of the weight tile's rows, multicast into both blocks.
//    - A ring of 192 KB (six 32 KB stages, or four of 48 KB) on full /
//      empty mbarriers; a stage's empty barrier counts the consumer warps of
//      both blocks, since either block's producer writes into both.
//    - Each consumer runs four wgmma m64nNk32 s8 steps per K step, one K
//      step in flight, and frees a stage when its products have retired;
//      at 128 x 256 its 128 s32 accumulators take setmaxnreg (producer 40,
//      consumers 232).
//    - Programmatic dependent launch (K6): the producer issues the weight's
//      first stages (constants of the call) before griddepcontrol.wait and
//      xq's after it; the consumers wait before they read xs. Without the
//      attribute (T2) the wait returns at once.
//    - The epilogue: (f32(acc) * xs[row]) * ws[col], rounded to bf16
//      nearest even; rows >= M and columns >= N are not stored. Each
//      consumer warp stages its 16 rows 64 columns at a time in shared
//      memory (18 KB for the eight warps, beside the ring) and stores them
//      as whole 128-byte lines, 16 bytes a lane, with the streaming hint;
//      the column scales load eight pairs at a time. Stored as pairs
//      straight from the accumulators, with a scale load before each, the
//      epilogue took longer than the products.
//    - Ragged shapes: TMA fills rows past M, columns past K and weight
//      rows past N with zeros (an all-zero row or column adds nothing to a
//      sum), so M, N and K need no padding; only 16-byte rows remain:
//      K % 16 == 0 for TMA and N % 8 == 0 for the stores (the wrapper pads
//      the rare K or N that is not).
//
// The fused quantize prologue (every column tile recomputing its rows'
// amax over all of K) is not built: at mlp0 it reads x 20 times.

#include "sm90.cuh"

namespace {

using namespace owk_sm90;

// ---- quantize_rows --------------------------------------------------------

constexpr int kQuantWarps = 4;   // rows a block (8 was slower at mlp1's K = 5120)

__device__ __forceinline__ void widen(const uint4& u, const __nv_bfloat16*, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void widen(const uint4& u, const float*, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}

// four values' int8 codes, packed: x * r rounded to the nearest integer,
// ties to even, as rintf rounds, clipped to +-127. Adding 1.5 * 2^23 leaves
// that integer in the low mantissa bits (|x * r| is at most 127 and an ulp),
// so no conversion-unit instruction is needed; the product and the sum are
// rounded apart (__fmul_rn, __fadd_rn: never one fused multiply-add).
__device__ __forceinline__ uint32_t quant4(const float* f, float r) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = __float_as_int(__fadd_rn(__fmul_rn(f[j], r), 12582912.0f)) - 0x4B400000;
    out |= (uint32_t)(min(max(v, -127), 127) & 0xFF) << (8 * j);
  }
  return out;
}

template <typename T>
__device__ __forceinline__ void quant_store(int8_t* q, int i, const uint4& u, float r) {
  constexpr int kVals = 16 / sizeof(T);
  float f[kVals];
  widen(u, static_cast<const T*>(nullptr), f);
  if constexpr (kVals == 8)
    *reinterpret_cast<uint2*>(q + i * 8) = make_uint2(quant4(f, r), quant4(f + 4, r));
  else
    *reinterpret_cast<uint32_t*>(q + i * 4) = quant4(f, r);
}

template <typename T>
__device__ __forceinline__ float amax16(const uint4& u, float m) {
  constexpr int kVals = 16 / sizeof(T);
  float f[kVals];
  widen(u, static_cast<const T*>(nullptr), f);
#pragma unroll
  for (int j = 0; j < kVals; ++j) m = fmaxf(m, fabsf(f[j]));
  return m;
}

// x (M, K) of T, K % 16 == 0 -> xq (M, K) int8, xs (M) f32; one warp a row.
// With kChunks > 0 a lane keeps its kChunks 16-byte chunks of the row in
// registers, so the row is read once (every load in flight before any is
// used); with 0 it reads the row twice (amax, then values).
template <typename T, int kChunks>
__global__ void __launch_bounds__(32 * kQuantWarps)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int M,
              int K, float inv127) {
  pdl_trigger();   // the GEMM's blocks may start: they read nothing of ours before their wait
  constexpr int kVals = 16 / sizeof(T);   // values a 16-byte load
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* in = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  int8_t* q = xq + (size_t)row * K;
  const int n = K / kVals;
  float m = 0.f;
  if constexpr (kChunks > 0) {
    uint4 v[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      v[c] = c * 32 + lane < n ? __ldcs(in + c * 32 + lane) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) m = amax16<T>(v[c], m);   // zeros change no amax
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float r = m == 0.f ? 0.f : 127.0f / m;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (c * 32 + lane < n) quant_store<T>(q, c * 32 + lane, v[c], r);
  } else {
    for (int i = lane; i < n; i += 32) m = amax16<T>(__ldg(in + i), m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float r = m == 0.f ? 0.f : 127.0f / m;
    for (int i = lane; i < n; i += 32) quant_store<T>(q, i, __ldg(in + i), r);
  }
  if (lane == 0) xs[row] = m * inv127;
}

// the quantize launch for a row of K values of T: the fewest register
// chunks a lane that hold it (5: 1280 bf16, 20: 5120 bf16 or 2560 f32), or
// two passes over a longer row
template <typename T>
int launch_quantize(const void* x, void* xq, void* xs, int M, int K, float inv127,
                    cudaStream_t st) {
  const int n = K / (16 / (int)sizeof(T));
  const dim3 grid((M + kQuantWarps - 1) / kQuantWarps), block(32 * kQuantWarps);
  const T* xt = static_cast<const T*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  if (n <= 32 * 5)
    quantize_rows<T, 5><<<grid, block, 0, st>>>(xt, q, s, M, K, inv127);
  else if (n <= 32 * 10)
    quantize_rows<T, 10><<<grid, block, 0, st>>>(xt, q, s, M, K, inv127);
  else if (n <= 32 * 20)
    quantize_rows<T, 20><<<grid, block, 0, st>>>(xt, q, s, M, K, inv127);
  else
    quantize_rows<T, 0><<<grid, block, 0, st>>>(xt, q, s, M, K, inv127);
  return (int)cudaGetLastError();
}

// ---- gemm_s8 --------------------------------------------------------------

constexpr int kBM = 128, kBK = 128;         // K step: 128 int8 values, one swizzled row
constexpr int kCluster = 2;                 // two row tiles that share the weight tile
constexpr int kThreads = 384;               // warpgroup 0 producer, 1-2 consumers
constexpr uint32_t kABytes = kBM * kBK;     // 16 KB
constexpr uint32_t kRingBytes = 192 * 1024;
// the epilogue's staging rows: 16 rows of 64 bf16 a consumer warp, each
// padded by 16 bytes so that the lanes' pair stores fall in distinct banks
constexpr int kEpiRow = 64 * 2 + 16;
constexpr int kEpiWarpBytes = 16 * kEpiRow;

template <int kBN>
struct Tile {
  static constexpr uint32_t kBBytes = kBN * kBK;   // 16 or 32 KB: kBN weight rows of 128 K bytes
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;   // 6 at 128 columns, 4 at 256
  static constexpr uint32_t kBars = kStages * kStageBytes;   // every tile 1024-aligned
  static constexpr uint32_t kEpi = kBars + 16 * kStages;     // the consumers' staging rows
  static constexpr size_t kSmemBytes = 1024 + kEpi + 8 * kEpiWarpBytes;
  static constexpr uint32_t kHalfB = kBBytes / kCluster;     // a block's share of the weight tile
  static constexpr bool kShift = kBN == 256;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(!kShift || kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
                "setmaxnreg: more registers asked for than the block holds");
};

// one k32 step of a warpgroup's 64 x kBN product: a, b the stage's tiles
template <int kBN, bool kFirst>
__device__ __forceinline__ void mma_k32(int32_t (&acc)[kBN / 2], uint32_t a, uint32_t b, int kk) {
  const uint64_t da = desc_sw128(a + 32 * kk, 16, 1024), db = desc_sw128(b + 32 * kk, 16, 1024);
  if constexpr (kBN == 256) {
    if constexpr (kFirst) wgmma_m64n256k32_s8_first(acc, da, db);
    else wgmma_m64n256k32_s8(acc, da, db, 1);
  } else {
    if constexpr (kFirst) wgmma_m64n128k32_s8_first(acc, da, db);
    else wgmma_m64n128k32_s8(acc, da, db, 1);
  }
}

template <int kBN>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
gemm_s8(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
        const float* __restrict__ xs, const float* __restrict__ ws,
        __nv_bfloat16* __restrict__ out, int M, int N, int K, int m_pairs, int n_tiles) {
  using T = Tile<kBN>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles: 1024-aligned
  const StageRing<kStages> ring{base + T::kBars};

  const int warp = threadIdx.x / 32;
  const int n_k = (K + kBK - 1) / kBK;
  const int n_pairs = m_pairs * n_tiles;
  const int rank = (int)cluster_rank();
  const int first = blockIdx.x / kCluster, stride = gridDim.x / kCluster;

  if (threadIdx.x == 0) {   // expected arrivals: producer 1, consumer warps 8 of each block
    prefetch_map(&tm_a);
    prefetch_map(&tm_b);
    for (int s = 0; s < kStages; ++s)
      mbar_init(ring.full(s), 1), mbar_init(ring.empty(s), 8 * kCluster);
    fence_barrier_init();
  }
  // the other block multicasts into this one's ring and arrives on its barriers
  cluster_arrive_relaxed();
  cluster_wait();

  if (warp < 4) {   // producer
    if (T::kShift) regs_release<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      auto stage = [&](int it) { return base + (it % kStages) * T::kStageBytes; };
      // this block's half of the weight tile's rows, into both blocks
      auto load_b = [&](int it, int n0, int ks) {
        mbar_expect_tx(ring.full(it), T::kStageBytes);
        tma_load_2d_multicast(stage(it) + kABytes + rank * T::kHalfB, &tm_b, ring.full(it),
                              ks * kBK, n0 + rank * (kBN / 2), (1u << kCluster) - 1);
      };
      // the weight is a constant of the call: the first tile's first stages
      // are asked for before the wait for the quantize launch
      const int primed = first < n_pairs ? (n_k < kStages ? n_k : kStages) : 0;
      for (int ks = 0; ks < primed; ++ks) load_b(ks, (first / m_pairs) * kBN, ks);
      pdl_sync();
      int it = 0;
      for (int p = first; p < n_pairs; p += stride) {
        const int m0 = ((p % m_pairs) * kCluster + rank) * kBM, n0 = (p / m_pairs) * kBN;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          if (it >= primed) {
            ring.wait_empty(it);   // both blocks are done with the stage
            load_b(it, n0, ks);
          }
          tma_load_2d(stage(it), &tm_a, ring.full(it), ks * kBK, m0);
        }
      }
    }
  } else {   // consumers: warpgroup wg computes rows wg * 64 .. + 63 of each tile
    if (T::kShift) regs_claim<T::kConsumerRegs>();
    pdl_sync();   // xs is the quantize launch's
    const int wg = warp / 4 - 1;
    const int lane = threadIdx.x % 32;
    // a stage is free when both blocks' consumers are done with it
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(ring.empty(i));
        mbar_arrive_cluster(map_rank(ring.empty(i), rank ^ 1));
      }
    };
    int32_t acc[kBN / 2];
    int it = 0;
    for (int p = first; p < n_pairs; p += stride) {
      const int m0 = ((p % m_pairs) * kCluster + rank) * kBM, n0 = (p / m_pairs) * kBN;
      // the tile's first step starts a fresh accumulator (peeled: no wgmma
      // is issued under a condition)
      {
        ring.wait_full(it);
        const uint32_t a = base + (it % kStages) * T::kStageBytes + wg * 64 * kBK;
        const uint32_t b = base + (it % kStages) * T::kStageBytes + kABytes;
        wgmma_fence();
        mma_k32<kBN, true>(acc, a, b, 0);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk) mma_k32<kBN, false>(acc, a, b, kk);
        wgmma_commit();
      }
      for (int ks = 1; ks < n_k; ++ks) {
        const int i = it + ks;
        ring.wait_full(i);
        const uint32_t a = base + (i % kStages) * T::kStageBytes + wg * 64 * kBK;
        const uint32_t b = base + (i % kStages) * T::kStageBytes + kABytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_k32<kBN, false>(acc, a, b, kk);
        wgmma_commit();
        wgmma_wait<1>();   // step i - 1 has retired: its stage is free
        fence_regs(acc);
        release(i - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it + n_k - 1);
      it += n_k;

      // the warp's 16 rows go out 64 columns at a time through its staging
      // rows in shared memory: each lane puts its scaled pairs there, then
      // every row leaves as 128-byte lines, a 16-byte store a lane
      const int r0 = wg * 64 + (warp % 4) * 16;   // the warp's first row in the tile
      const int g = lane / 4, t = lane % 4;
      const float s0 = m0 + r0 + g < M ? xs[m0 + r0 + g] : 0.f;
      const float s1 = m0 + r0 + g + 8 < M ? xs[m0 + r0 + g + 8] : 0.f;
      uint8_t* const stage_rows = smem_raw + (base - raw) + T::kEpi + (warp - 4) * kEpiWarpBytes;
#pragma unroll
      for (int c0 = 0; c0 < kBN; c0 += 64) {
        float2 w[8];   // the column scales of this lane's 8 pairs, loaded together
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + c0 + 8 * j + 2 * t;   // N is even: a pair is in or out whole
          w[j] = c < N ? __ldg(reinterpret_cast<const float2*>(ws + c)) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int a = 4 * (c0 / 8 + j);
          const __nv_bfloat162 v0 = __floats2bfloat162_rn(((float)acc[a] * s0) * w[j].x,
                                                          ((float)acc[a + 1] * s0) * w[j].y);
          const __nv_bfloat162 v1 = __floats2bfloat162_rn(((float)acc[a + 2] * s1) * w[j].x,
                                                          ((float)acc[a + 3] * s1) * w[j].y);
          *reinterpret_cast<__nv_bfloat162*>(stage_rows + g * kEpiRow + (8 * j + 2 * t) * 2) = v0;
          *reinterpret_cast<__nv_bfloat162*>(stage_rows + (g + 8) * kEpiRow + (8 * j + 2 * t) * 2) =
              v1;
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int r = 4 * it + lane / 8, row = m0 + r0 + r, col = n0 + c0 + 8 * (lane % 8);
          if (row < M && col < N)   // N % 8 == 0: eight columns are in or out whole
            __stcs(reinterpret_cast<uint4*>(out + (size_t)row * N + col),
                   *reinterpret_cast<const uint4*>(stage_rows + r * kEpiRow + 16 * (lane % 8)));
        }
        __syncwarp();
      }
    }
  }
  // neither block may leave while the other can still arrive on its barriers
  cluster_arrive();
  cluster_wait();
}

// Launch the GEMM: xq (M, K) int8, wt (N, K) int8, xs (M) and ws (N) f32,
// out (M, N) bf16; `grid` blocks (clusters of two) walk the pairs of 128 x
// `bn` tiles; `dependent` with the programmatic-dependent-launch attribute.
int launch_gemm(const void* xq, const void* xs, const void* wt, const void* ws, void* out, int M,
                int K, int N, int bn, int grid, bool dependent, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 || N % 8 || grid <= 0 || grid % kCluster ||
      (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t b_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint32_t a_box[2] = {kBK, kBM};
  const cuuint32_t b_box[2] = {kBK, (cuuint32_t)(bn / kCluster)};
  int rc = encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, a_dims, stride, a_box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wt, b_dims, stride, b_box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static unsigned long long allowed128 = 0, allowed256 = 0;
  auto kernel = bn == 256 ? gemm_s8<256> : gemm_s8<128>;
  const int smem = (int)(bn == 256 ? Tile<256>::kSmemBytes : Tile<128>::kSmemBytes);
  rc = allow_smem(kernel, smem, bn == 256 ? allowed256 : allowed128);
  if (rc != 0) return rc;
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + bn - 1) / bn;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1], static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), M, N, K,
      (m_tiles + kCluster - 1) / kCluster, n_tiles);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int run(const void* x, void* xq, void* xs, const void* wt, const void* ws, void* out, int M,
        int K, int N, float inv127, int bn, int grid, void* stream) {
  if (M <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = launch_quantize<T>(x, xq, xs, M, K, inv127, st);
  if (e) return e;
  return launch_gemm(xq, xs, wt, ws, out, M, K, N, bn, grid, true, st);
}

}  // namespace

// K6: x (M, K) bf16 | f32, K % 16 == 0; xq (M, K) int8 and xs (M) f32
// scratch; wt (N, K) int8, ws (N) f32; out (M, N) bf16. inv127 = f32(1/127);
// bn and grid from the wrapper's plan. Returns the first nonzero
// cudaError_t of the two launches, or 0.
extern "C" int owk_w8a8_bf16(const void* x, void* xq, void* xs, const void* wt,
                             const void* ws, void* out, int M, int K, int N, float inv127,
                             int bn, int grid, void* stream) {
  return run<__nv_bfloat16>(x, xq, xs, wt, ws, out, M, K, N, inv127, bn, grid, stream);
}

extern "C" int owk_w8a8_f32(const void* x, void* xq, void* xs, const void* wt,
                            const void* ws, void* out, int M, int K, int N, float inv127,
                            int bn, int grid, void* stream) {
  return run<float>(x, xq, xs, wt, ws, out, M, K, N, inv127, bn, grid, stream);
}

// The quantize launch alone (timed apart from the GEMM): x (M, K) bf16 |
// f32 -> xq, xs as above.
extern "C" int owk_quantize_rows(const void* x, int is_f32, void* xq, void* xs, int M, int K,
                                 float inv127, void* stream) {
  if (M <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch_quantize<float>(x, xq, xs, M, K, inv127, st)
                : launch_quantize<__nv_bfloat16>(x, xq, xs, M, K, inv127, st);
}

// Kernel T2 (and K6's GEMM timed alone): xq (M, K) int8 with row scales xs
// (M) f32, wt (N, K) int8 with column scales ws (N) f32 -> out (M, N) bf16,
// K % 16 == 0, N % 8 == 0, at the plan's bn and grid; an ordinary launch.
// Returns the launch's cudaError_t (or the tensor maps'), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int owk_mm_s8(const void* xq, const void* xs, const void* wt, const void* ws,
                         void* out, int M, int K, int N, int bn, int grid, void* stream) {
  return launch_gemm(xq, xs, wt, ws, out, M, K, N, bn, grid, false,
                     static_cast<cudaStream_t>(stream));
}
