// Kernel K4: y = x @ dequant(split-half int4 planes), f32 out.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/quant_matmul.py::_qmm4
// (kernel body _make_qmm4_kernel, the default path: _QMM4_TRICK = False).
// The TPU kernel splits x into even and odd columns and sums
// x_even @ W_lo + x_odd @ W_hi; here the two nibbles of a packed row are
// written back as K rows 2p and 2p + 1 of one bf16 tile, which is the same
// sum over K. Each weight is (nibble - 8) * s in f32, rounded to bf16 (the
// TPU rounding; JAX's interpret mode keeps it f32); x in bf16; f32 out.
//
// What bounds it on the H100: the logits plane at decode rows, K/2 * Np
// bytes of nibbles plus the scales (the (1280, 52224) plane: 42 MB, 12.5 us
// at 3.35 TB/s): HBM bandwidth.
//
// Design: the shared tile loop of qmm_tile.cuh with an int4 loader.

#include "qmm_tile.cuh"

extern "C" int owk_qmm4(const void* x, const void* qs, const void* scales,
                        void* out, int M, int K, int Np, void* stream) {
  using namespace owk_qtile;
  return launch(x, M, K, Np,
                Int4Planes{static_cast<const uint8_t*>(qs),
                           static_cast<const float*>(scales), Np},
                StoreF32{static_cast<float*>(out), Np},
                static_cast<cudaStream_t>(stream));
}
