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
//    owk_qmm_wgmma, this file, on the TMA + wgmma tiles body of
//    qmm_wgmma.cuh (one block per 128 x 128 output tile, a producer
//    warpgroup on TMA rings, two dequantizing warpgroups writing swizzled
//    bf16 B tiles, two wgmma consumer warpgroups), which K4 and K5 above 16
//    rows share. K3 takes it with the int8 loader, the f32 store and no
//    split of K, so its grid is fixed per shape: mlp0 (1536 x 5120) 480
//    blocks (3.6 waves of 132 SMs), mlp1 and q/k/v/o (N = 1280) and the
//    cross-KV (M = 1500) 120 blocks (one wave, 12 SMs idle); what holds it
//    above torch.matmul is in the header.
//
// Requires K % 32 == 0, Np % 128 == 0, x, qs and scales on 16-byte
// boundaries; the Python wrapper checks. owk_qmm_wgmma launches on `stream`
// and returns the cudaError_t of the launch (or of the tensor-map encoding);
// owk_qmm_clusters(splits) returns how many clusters of `splits` tiles
// blocks the card holds at once (or minus a cudaError_t), which the plans of
// K4 and K5 above 16 rows count their waves in (the card's GPCs hold 39
// clusters of 3 such blocks on the H100, not 132 / 3).

#include "qmm_wgmma.cuh"

extern "C" int owk_qmm_wgmma(const void* x, const void* qs, const void* scales, void* out,
                             int M, int K, int Np, void* stream) {
  using namespace owk_qwg;
  static unsigned long long smem_allowed = 0, small_allowed = 0;
  const StoreF32 ep{static_cast<float*>(out), Np};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // up to 64 rows the ingest build (x's 64 rows, one consumer warpgroup at
  // work: the same sums), unsplit
  return M <= 64 ? launch_tiles<Int8Planes, StoreF32, kPdlNone, true>(
                       x, qs, scales, ep, M, K, Np, 1, 1, st, small_allowed)
                 : launch_tiles<Int8Planes, StoreF32, kPdlNone, false>(
                       x, qs, scales, ep, M, K, Np, 1, 1, st, smem_allowed);
}

extern "C" int owk_qmm_clusters(int splits) {
  using namespace owk_qwg;
  static unsigned long long smem_allowed = 0;
  return max_clusters<Int8Planes, StoreF32, kPdlNone, true>(splits, smem_allowed);
}
