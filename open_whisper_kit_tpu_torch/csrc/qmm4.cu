// Kernel K4: y = x @ dequant(split-half int4 planes), f32 out.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/quant_matmul.py::_qmm4
// (kernel body _make_qmm4_kernel, the default path: _QMM4_TRICK = False).
// The TPU kernel splits x into even and odd columns and sums
// x_even @ W_lo + x_odd @ W_hi; here the two nibbles of a packed row are
// K rows 2p and 2p + 1 of one bf16 operand, which is the same sum over K.
// Each weight is (nibble - 8) * s in f32, rounded to bf16 (the TPU
// rounding; JAX's interpret mode keeps it f32); x in bf16; f32 out.
//
// What bounds it on the H100: the logits plane at decode rows, K/2 * Np
// bytes of nibbles plus the scales (the (1280, 51866) plane: 42 MB, 12.4 us
// at 3.35 TB/s): HBM bandwidth. At 17-64 rows the same bytes and the f32
// output (13.5-16.4 us), but the tiles walk their 20 steps of 64 K rows in
// 406 blocks, one a column tile, four waves of the card: 59-62 us.
//
// Design: two bodies by the number of rows, as K3's.
//  * M <= 16 (every decode call: one row, beams, lockstep streams, verify
//    rows): K3's rows body (qmm_rows.cuh) with its int4 stage, one 32-row
//    scale block of a 128-column tile as two TMA boxes (16 packed rows x
//    128 bytes; 128 scales), on K3's ring of 4 stages, split-K over a
//    cluster as the wrapper's plan says (quant_matmul.py::qmm4_rows_plan).
//    On the W4 logits (H100 80GB HBM3) rings of 8 and 16 stages, two scale
//    blocks a stage, or a block's scales in one box at its start were no
//    faster: the time follows the column tiles times the stages of each,
//    as the W8 logits' on this body do, not the bytes, the TMA boxes or the
//    bytes in flight.
//  * M > 16 (speculative verify at gamma >= 16, full logits): K3's TMA +
//    wgmma tiles (qmm_wgmma.cuh) with the int4 loader (a 32 x 128-byte TMA
//    box of packed rows and two rows of scales a 64-row step, each nibble
//    dequantized in shared memory by the byte permute of q_at). The W4
//    logits' 406 column tiles fill the card, so its plan
//    (quant_matmul.py::tiles_plan) splits K only for a plane with fewer
//    column tiles than SMs. The old body here (wmma over 64-row tiles, loads
//    through registers) took 106.0 us at 17 rows and 110.7 at 64 against
//    torch.matmul's 86.1 / 88.3 on the dequantized plane (H100 80GB HBM3).
//
// Entries (plain C, for ctypes), each returning 0 or a cudaError_t:
//  * owk_qmm4(x, qs, scales, out, M, K, Np, splits, unit, stream): the tiles
//    body at M > 16, `splits` splits of K in runs of `unit` 64-row steps;
//  * owk_qmm4_rows_maps(qs, scales, K, Np, maps): encode the two tensor maps
//    of one plane (256 bytes) into `maps`, kept by the wrapper per plane;
//  * owk_qmm4_rows(x, maps, out, M, K, Np, splits, stream): the rows body
//    at 1 <= M <= 16.
// Require K % 32 == 0, Np % 128 == 0, 16-byte aligned x, qs and scales.

#include <string.h>

#include "qmm_rows.cuh"
#include "qmm_wgmma.cuh"

extern "C" int owk_qmm4(const void* x, const void* qs, const void* scales, void* out, int M,
                        int K, int Np, int splits, int unit, void* stream) {
  namespace W = owk_qwg;
  static unsigned long long smem_allowed = 0;
  return W::launch_tiles<W::Int4Planes, W::StoreF32, W::kPdlNone, true>(
      x, qs, scales, W::StoreF32{static_cast<float*>(out), Np}, M, K, Np, splits, unit,
      static_cast<cudaStream_t>(stream), smem_allowed);
}

extern "C" int owk_qmm4_rows_maps(const void* qs, const void* scales, int K, int Np,
                                  void* maps_out) {
  CUtensorMap maps[2];
  const int rc = owk_qrows::encode_rows_maps(qs, scales, K, Np, maps, 4);
  if (rc == 0) memcpy(maps_out, maps, sizeof maps);
  return rc;
}

extern "C" int owk_qmm4_rows(const void* x, const void* maps, void* out, int M, int K, int Np,
                             int splits, void* stream) {
  using namespace owk_qrows;
  static unsigned long long smem_allowed = 0;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof m);
  return launch_rows<4, kGatherCap, StoreF32Rows, kPdlNone, 4>(
      m, x, StoreF32Rows{static_cast<float*>(out), Np}, M, K, Np, splits,
      static_cast<cudaStream_t>(stream), smem_allowed);
}
