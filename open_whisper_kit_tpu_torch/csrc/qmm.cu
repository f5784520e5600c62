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
// weight byte, far past the ~295 FLOP/byte ridge: tensor-core bound.
//
// Design: the shared tile loop of qmm_tile.cuh (bf16 wmma on 16 x 128 or
// 64 x 128 output tiles, weights dequantized to bf16 in shared memory, the
// next K step's loads in flight during this step's products). wgmma, TMA
// and a split-K GEMV for the skinny rows are later work.

#include "qmm_tile.cuh"

extern "C" int owk_qmm(const void* x, const void* qs, const void* scales,
                       void* out, int M, int K, int Np, void* stream) {
  using namespace owk_qtile;
  return launch(x, M, K, Np,
                Int8Planes{static_cast<const int8_t*>(qs),
                           static_cast<const float*>(scales), Np},
                StoreF32{static_cast<float*>(out), Np},
                static_cast<cudaStream_t>(stream));
}
