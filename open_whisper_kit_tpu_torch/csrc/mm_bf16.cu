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
// Design: a warp-specialised, persistent TMA + wgmma GEMM on clusters of two
// blocks (csrc/sm90.cuh), built for two output tiles.
//  * Tiles of 128 x 128 or 128 x 256, K in steps of 64. One producer
//    warpgroup (one thread issues the loads) and two consumer warpgroups of
//    64 rows each; 384 threads, one block per SM. The wrapper's plan
//    (ops/gemm.py::mm_bf16_plan) takes 128 x 256 where its tile pairs still
//    fill the card (the probe's first product: 240 tiles), else 128 x 128
//    (the second: 120 tiles; at 128 x 256 only 60 SMs would work).
//  * Why the wider tile: a 128 x 128 step brings 32 KB into shared memory
//    (TMA) and its eight m64n128k16 read 48 KB back out, 160 bytes a clock
//    at the full tensor rate against the SM's 128; the 128 x 256 step's
//    two m64n256k16 per k16 need 128 (48 KB in, 80 KB out, per twice the
//    work), and each product's operands move once per twice the FLOP from
//    L2. Its 128 f32 accumulators a thread take setmaxnreg: the producer
//    warpgroup drops to 40 registers, the consumers rise to 232.
//  * The two blocks of a cluster compute two row tiles of the same column
//    tile, so they share b's tile: each loads its own a tile (128 x 64,
//    128-byte swizzle: wgmma's K-major A operand) and half of b's 64-column
//    blocks (64 K rows each), multicast into both blocks, 8 KB apart (the
//    MN-major operand, read with wgmma's transpose bit, so b stays in its
//    natural layout): a 128 x 128 step reads 24 KB per block from L2, not 32.
//  * A ring of 192 KB (six 32 KB stages, or four of 48 KB) on full / empty
//    mbarriers. A stage's empty barrier counts the consumer warps of both
//    blocks (each warp arrives on its own block's and on the other's), since
//    either block's producer writes into both.
//  * Each consumer runs four wgmma steps of k16 (m64n128k16 or m64n256k16,
//    both operands in shared memory) per K step, keeping one K step in
//    flight, and frees a stage when its products have retired.
//  * Waves: min(tile pairs, SMs / 2) clusters, cluster c takes pairs c, c +
//    clusters, ...: a persistent tile loop, in which the producer runs into
//    the next tile's loads while the consumers store this one's. Both probe
//    products fill 120 of the 132 SMs' rounds (first: 120 pairs, two rounds
//    of 66 clusters; second: 60 pairs, one round). A split of K would not
//    fill the card better until 11 splits.
//  * The epilogue rounds each f32 sum to bf16 once (nearest even) and
//    stores pairs straight from the accumulators.
//  * Ragged shapes: TMA fills rows of a past M and past K, and rows of b
//    past K and columns past N, with zeros; the stores skip rows >= M and
//    columns >= N (an odd count of row tiles leaves the last pair's second
//    tile all zeros and unstored). So M and K are free and only TMA's
//    16-byte row strides remain: K % 8 == 0 and N % 8 == 0 (the wrapper
//    pads otherwise).
//
// Requires a, b, out on 16-byte boundaries, K % 8 == 0, N % 8 == 0 and a
// grid of a positive even number of blocks; the Python wrapper checks and
// pads.

#include "sm90.cuh"

namespace {

using namespace owk_sm90;

constexpr int kBM = 128, kBK = 64;
constexpr int kCluster = 2;                 // two row tiles that share b's tile
constexpr int kThreads = 384;               // warpgroup 0 producer, 1-2 consumers
constexpr uint32_t kABytes = kBM * kBK * 2;   // 16 KB
constexpr uint32_t kRingBytes = 192 * 1024;   // the stages' share of shared memory

// the shapes that follow from the tile's width (128 or 256 columns)
template <int kBN>
struct Tile {
  static constexpr uint32_t kBBytes = kBK * kBN * 2;   // kBN / 64 blocks of 64 columns, 8 KB each
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;   // 6 at 128 columns, 4 at 256
  static constexpr uint32_t kBars = kStages * kStageBytes;   // every tile 1024-aligned
  static constexpr size_t kSmemBytes = 1024 + kBars + 16 * kStages;
  // registers: the 256-column accumulator (128 a thread) needs the producer's
  static constexpr bool kShift = kBN == 256;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(!kShift || kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
                "setmaxnreg: more registers asked for than the block holds");
};

// one k16 step of a warpgroup's 64 x kBN product: a, b the stage's tiles
template <int kBN, bool kFirst>
__device__ __forceinline__ void mma_k16(float (&acc)[kBN / 2], uint32_t a, uint32_t b, int kk) {
  const uint64_t da = desc_sw128(a + 32 * kk, 16, 1024), db = desc_sw128(b + 2048 * kk, 8192, 1024);
  if constexpr (kBN == 256) {
    if constexpr (kFirst) wgmma_m64n256k16_ss_first<1>(acc, da, db);
    else wgmma_m64n256k16_ss<1>(acc, da, db, 1);
  } else {
    if constexpr (kFirst) wgmma_m64n128k16_ss_first<1>(acc, da, db);
    else wgmma_m64n128k16_ss<1>(acc, da, db, 1);
  }
}

template <int kBN>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
mm_bf16_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
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
      int it = 0;
      for (int p = first; p < n_pairs; p += stride) {
        const int m0 = ((p % m_pairs) * kCluster + rank) * kBM, n0 = (p / m_pairs) * kBN;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          ring.wait_empty(it);   // both blocks are done with the stage
          const uint32_t a = base + (it % kStages) * T::kStageBytes, b = a + kABytes;
          mbar_expect_tx(ring.full(it), T::kStageBytes);
          tma_load_2d(a, &tm_a, ring.full(it), ks * kBK, m0);
          for (int h = rank; h < kBN / 64; h += kCluster)   // b's 64-column blocks
            tma_load_2d_multicast(b + h * 8192, &tm_b, ring.full(it), n0 + 64 * h, ks * kBK,
                                  (1u << kCluster) - 1);
        }
      }
    }
  } else {   // consumers: warpgroup wg computes rows wg * 64 .. + 63 of each tile
    if (T::kShift) regs_claim<T::kConsumerRegs>();
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
    float acc[kBN / 2];
    int it = 0;
    for (int p = first; p < n_pairs; p += stride) {
      const int m0 = ((p % m_pairs) * kCluster + rank) * kBM, n0 = (p / m_pairs) * kBN;
      // the tile's first step starts a fresh accumulator (peeled: no wgmma
      // is issued under a condition)
      {
        ring.wait_full(it);
        const uint32_t a = base + (it % kStages) * T::kStageBytes + wg * 64 * 128;
        const uint32_t b = base + (it % kStages) * T::kStageBytes + kABytes;
        wgmma_fence();
        mma_k16<kBN, true>(acc, a, b, 0);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk) mma_k16<kBN, false>(acc, a, b, kk);
        wgmma_commit();
      }
      for (int ks = 1; ks < n_k; ++ks) {
        const int i = it + ks;
        ring.wait_full(i);
        const uint32_t a = base + (i % kStages) * T::kStageBytes + wg * 64 * 128;
        const uint32_t b = base + (i % kStages) * T::kStageBytes + kABytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_k16<kBN, false>(acc, a, b, kk);
        wgmma_commit();
        wgmma_wait<1>();   // step i - 1 has retired: its stage is free
        fence_regs(acc);
        release(i - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it + n_k - 1);
      it += n_k;

      const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
      const int col = n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = col + 8 * j;   // N is even: a pair is in or out whole
        if (row < M && c < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + c) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (row + 8 < M && c < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * N + c) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  // neither block may leave while the other can still arrive on its barriers
  cluster_arrive();
  cluster_wait();
}

template <int kBN>
int launch(const CUtensorMap (&maps)[2], void* out, int M, int K, int N, int grid,
           cudaStream_t stream) {
  static unsigned long long smem_allowed = 0;
  const int rc = allow_smem(mm_bf16_kernel<kBN>, (int)Tile<kBN>::kSmemBytes, smem_allowed);
  if (rc != 0) return rc;
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  mm_bf16_kernel<kBN><<<grid, kThreads, Tile<kBN>::kSmemBytes, stream>>>(
      maps[0], maps[1], static_cast<__nv_bfloat16*>(out), M, N, K,
      (m_tiles + kCluster - 1) / kCluster, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// a (M, K) bf16, b (K, N) bf16, out (M, N) bf16, all row-major; `grid`
// blocks (clusters of two) walk the pairs of 128 x `bn` output tiles (bn 128
// or 256). Returns the launch's cudaError_t (or the tensor-map encoding's),
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int owk_mm_bf16(const void* a, const void* b, void* out, int M, int K, int N, int bn,
                           int grid, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || grid <= 0 || grid % kCluster ||
      (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {kBK, kBM};
  const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t b_stride[1] = {(cuuint64_t)N * 2};
  const cuuint32_t b_box[2] = {64, kBK};
  int rc = encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, a_dims, a_stride, a_box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, b_dims, b_stride, b_box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bn == 256 ? launch<256>(maps, out, M, K, N, grid, st)
                   : launch<128>(maps, out, M, K, N, grid, st);
}
