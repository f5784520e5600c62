// Kernel K3: y = x @ dequant(int8 planes), f32 out.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/quant_matmul.py::_qmm
// (kernel body _qmm_kernel). Same contract: x (M, K) in bf16; qs (K, Np)
// int8 and scales (K/32, Np) f32; each weight dequantized in f32 as q * s
// and rounded to bf16; the product accumulates in f32; out (M, Np) f32.
//
// What bounds it on the H100: at the decode rows (M = 1..5) it streams
// K * Np bytes of values plus K/32 * Np * 4 of scales and does ~2 FLOP per
// byte, so HBM bandwidth bounds it (the (1280, 52224) logits plane: 75 MB,
// 22 us at 3.35 TB/s). At the encoder's M = 1536 it does 2 * M FLOP per
// weight byte, far past the ~295 FLOP/byte ridge: tensor-core bound
// (mlp0 and mlp1, 1536 x 1280 x 5120: 20.4 us at 989 TFLOP/s).
//
// Two routes, chosen by the caller (ops/quant_matmul.py::qmm_route):
//  * "rows", M <= 16 (the decode rows): owk_qmm_rows in qmm_rows.cu, a
//    split weight stream on TMA rings (its own library);
//  * "tiles", M > 16 (the encoder, the cross-KV, prompt ingest):
//    owk_qmm_tiles, this file, a Hopper kernel (TMA, mbarriers, wgmma).
//
// Design of the tiles route: one block per 128 x 128 output tile, five
// warpgroups, one block per SM; the grid is fixed per shape: mlp0 (1536 x
// 5120) 480 blocks (3.6 waves of 132 SMs), mlp1 and q/k/v/o (N = 1280) and
// the cross-KV (M = 1500) 120 blocks (one wave, 12 SMs idle). K steps by 64
// (two scale blocks).
//  * A producer warpgroup (one thread) issues the TMA loads: the x tile (128
//    x 64 bf16, 128-byte swizzle: wgmma's K-major A operand) into a ring of
//    six, and the int8 tile (64 x 128) with its two rows of scales into
//    another ring of six. Rows of x past M and K rows past K load as zero, so
//    M is free and K % 64 == 32 needs no pad.
//  * Two dequantizing warpgroups turn each int8 tile into a bf16 B tile, q *
//    s in f32 rounded to bf16 (the TPU kernel's rounding point; q leaves
//    int8 through a byte permute into a float's mantissa, not the slower
//    int-to-float unit), in the MN-major 128-byte-swizzled layout that wgmma
//    reads with its transpose bit (two 64-column blocks, 8 KB apart), fence
//    the async proxy and hand it over through a ring of three.
//  * Two consumer warpgroups (64 rows each) wait for an x tile and a B tile
//    and run four wgmma m64n128k16 on them, keeping one step in flight.
//  * Each ring has full / empty mbarriers; the epilogue stores f32 pairs
//    straight from the accumulators, rows >= M dropped.
// What holds it above torch.matmul on the dequantized weight: shared memory.
// Both consumer warpgroups read the whole B tile, so a step's products read
// 48 KB (96 bytes a clock at the full tensor rate, of the SM's 128), and the
// step's TMA writes (25 KB) and the dequantizing round trip (9 KB read, 16 KB
// written) come on top; the x tile is also fetched again by every column
// tile (240 MB through L2 at mlp0 and mlp1).
//
// Requires K % 32 == 0, Np % 128 == 0, x, qs and scales on 16-byte
// boundaries; the Python wrapper checks. The entry launches on `stream` and
// returns the cudaError_t of the launch (or of the tensor-map encoding).

#include "sm90.cuh"

namespace {

using namespace owk_sm90;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kXStages = 6;     // x tiles
constexpr int kWStages = 6;     // int8 tiles with their scales
constexpr int kBStages = 3;     // dequantized bf16 B tiles
// warpgroups: 0 producer (one thread issues the loads), 1-2 dequantizers, 3-4
// consumers; setmaxnreg takes registers from the producer and the dequantizers
// and gives them to the consumers, within the block's launch allocation of
// 640 x 96 (a consumer that asks for more than is freed waits for ever)
constexpr int kThreads = 640;
constexpr int kProducerRegs = 40, kDequantRegs = 80, kConsumerRegs = 136;
static_assert(kProducerRegs + 2 * kDequantRegs + 2 * kConsumerRegs <= 5 * 96,
              "setmaxnreg: more registers asked for than the block holds");
constexpr uint32_t kXBytes = kBM * kBK * 2;         // 16 KB
constexpr uint32_t kQBytes = kBK * kBN;             // 8 KB
constexpr uint32_t kWBytes = kQBytes + (kBK / 32) * kBN * 4;   // + 1 KB of scales
constexpr uint32_t kBBytes = kBK * kBN * 2;         // 16 KB
constexpr uint32_t kXRing = 0;
constexpr uint32_t kWRing = kXRing + kXStages * kXBytes;
constexpr uint32_t kBRing = kWRing + kWStages * kWBytes;   // every tile 1024-aligned
constexpr uint32_t kBars = kBRing + kBStages * kBBytes;
constexpr size_t kSmemBytes = 1024 + kBars + 8 * 2 * (kXStages + kWStages + kBStages);

// the int8 tile (64 x 128, row-major) and its scales (2 x 128) at `w` -> bf16
// B tile at `dst`, MN-major, 128-byte swizzle. 256 threads; thread t takes
// the 8-column chunk t % 16 of rows t / 16 + 16 u (u < 4), so it needs two
// scale vectors a step; every load is issued before the arithmetic.
__device__ __forceinline__ void dequantize(const uint8_t* w, uint8_t* dst, int t) {
  const int nc = t % 16, r0 = t / 16;
  const float* sc = reinterpret_cast<const float*>(w + kQBytes) + nc * 8;
  float s[2][8];
#pragma unroll
  for (int b = 0; b < 2; ++b) {   // scale block b: rows 32 b .. + 31, u = 2 b, 2 b + 1
    *reinterpret_cast<float4*>(&s[b][0]) = *reinterpret_cast<const float4*>(sc + b * kBN);
    *reinterpret_cast<float4*>(&s[b][4]) = *reinterpret_cast<const float4*>(sc + b * kBN + 4);
  }
  uint2 q[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    q[u] = *reinterpret_cast<const uint2*>(w + (r0 + 16 * u) * kBN + nc * 8);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float* sv = s[u / 2];
    const uint32_t lo = q[u].x ^ 0x80808080u, hi = q[u].y ^ 0x80808080u;
    uint4 v;
    v.x = pack_bf16(q_at(lo, 0) * sv[0], q_at(lo, 1) * sv[1]);
    v.y = pack_bf16(q_at(lo, 2) * sv[2], q_at(lo, 3) * sv[3]);
    v.z = pack_bf16(q_at(hi, 0) * sv[4], q_at(hi, 1) * sv[5]);
    v.w = pack_bf16(q_at(hi, 2) * sv[6], q_at(hi, 3) * sv[7]);
    const int r = r0 + 16 * u;
    const int chunk = (nc & 7) ^ (r & 7);   // the 128-byte swizzle
    *reinterpret_cast<uint4*>(dst + (nc >> 3) * 8192 + r * 128 + chunk * 16) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
qmm_tiles_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_s, float* __restrict__ out, int M,
                 int K, int Np) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzled tiles: 1024-aligned
  uint8_t* const gbase = smem_raw + (base - raw);
  const StageRing<kXStages> xr{base + kBars};
  const StageRing<kWStages> wr{xr.bars + 16 * kXStages};
  const StageRing<kBStages> br{wr.bars + 16 * kWStages};

  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_steps = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {   // expected arrivals: producer 1, consumer warps 8, dequantizers 8
    for (int s = 0; s < kXStages; ++s) mbar_init(xr.full(s), 1), mbar_init(xr.empty(s), 8);
    for (int s = 0; s < kWStages; ++s) mbar_init(wr.full(s), 1), mbar_init(wr.empty(s), 8);
    for (int s = 0; s < kBStages; ++s) mbar_init(br.full(s), 8), mbar_init(br.empty(s), 8);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {   // producer
    regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_steps; ++i) {
        xr.wait_empty(i);
        mbar_expect_tx(xr.full(i), kXBytes);
        tma_load_2d(base + kXRing + (i % kXStages) * kXBytes, &tm_x, xr.full(i), i * kBK, m0);
        wr.wait_empty(i);
        const uint32_t w = base + kWRing + (i % kWStages) * kWBytes;
        mbar_expect_tx(wr.full(i), kWBytes);
        tma_load_2d(w, &tm_q, wr.full(i), n0, i * kBK);
        tma_load_2d(w + kQBytes, &tm_s, wr.full(i), n0, i * (kBK / 32));
      }
    }
    return;
  }

  if (warp < 12) {   // dequantizers
    regs_release<kDequantRegs>();
    for (int i = 0; i < n_steps; ++i) {
      wr.wait_full(i);
      br.wait_empty(i);
      dequantize(gbase + kWRing + (i % kWStages) * kWBytes,
                 gbase + kBRing + (i % kBStages) * kBBytes, threadIdx.x - 128);
      fence_proxy_async();   // the B tile is read by wgmma (the async proxy)
      br.arrive_warp(br.full(i));
      wr.arrive_warp(wr.empty(i));
    }
    return;
  }

  // consumers: warpgroup wg computes rows wg * 64 .. + 63 of the tile
  regs_claim<kConsumerRegs>();
  const int wg = warp / 4 - 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  for (int i = 0; i < n_steps; ++i) {
    xr.wait_full(i);
    br.wait_full(i);
    const uint32_t x = base + kXRing + (i % kXStages) * kXBytes + wg * 64 * 128;
    const uint32_t bt = base + kBRing + (i % kBStages) * kBBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_ss<1>(acc, desc_sw128(x + 32 * kk, 16, 1024),
                             desc_sw128(bt + 2048 * kk, 8192, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();   // step i - 1 has retired: its x and B tiles are free
    fence_regs(acc);
    if (i >= 1) {
      xr.arrive_warp(xr.empty(i - 1));
      br.arrive_warp(br.empty(i - 1));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int lane = threadIdx.x % 32;
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  float* o = out + n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (row < M)
      *reinterpret_cast<float2*>(o + (size_t)row * Np + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(o + (size_t)(row + 8) * Np + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace

extern "C" int owk_qmm_tiles(const void* x, const void* qs, const void* scales, void* out,
                             int M, int K, int Np, void* stream) {
  CUtensorMap maps[3];
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {kBK, kBM};
  const cuuint64_t q_dims[2] = {(cuuint64_t)Np, (cuuint64_t)K};
  const cuuint64_t q_stride[1] = {(cuuint64_t)Np};
  const cuuint32_t q_box[2] = {kBN, kBK};
  const cuuint64_t s_dims[2] = {(cuuint64_t)Np, (cuuint64_t)(K / 32)};
  const cuuint64_t s_stride[1] = {(cuuint64_t)Np * 4};
  const cuuint32_t s_box[2] = {kBN, kBK / 32};
  int rc = encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_stride,
                      x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qs, q_dims, q_stride, q_box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = encode_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, s_dims, s_stride,
                    s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  static unsigned long long smem_allowed = 0;
  rc = allow_smem(qmm_tiles_kernel, (int)kSmemBytes, smem_allowed);
  if (rc != 0) return rc;
  const dim3 grid(Np / kBN, (M + kBM - 1) / kBM);
  qmm_tiles_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(out), M, K, Np);
  return (int)cudaGetLastError();
}
