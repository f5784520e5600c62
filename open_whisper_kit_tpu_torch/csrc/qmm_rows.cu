// Kernel K3, "rows" route (M <= 16, the decode rows): y = x @ dequant(int8
// planes), f32 out.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/quant_matmul.py::_qmm
// (kernel body _qmm_kernel) at the decode rows; K3's M > 16 route is
// owk_qmm_tiles in qmm.cu. What bounds it on the H100 (the plane stream) and
// the design (a split weight stream on TMA rings, an ordered combine of the
// splits in the same launch) are in qmm_rows.cuh.
//
// Entries (plain C, for ctypes):
//  * owk_qmm_rows_maps(qs, scales, K, Np, maps): encode the two tensor maps
//    of one plane (256 bytes) into `maps`. The wrapper keeps them per plane
//    and device, so a token step encodes nothing.
//  * owk_qmm_rows(x, maps, out, M, K, Np, splits, stream): launch on
//    `stream`, `splits` from the wrapper's plan (1..8, each split a block of
//    the column tile's cluster).
// Requires 1 <= M <= 16, K % 32 == 0, Np % 128 == 0, x, qs and scales on
// 16-byte boundaries (the wrapper checks). Each returns 0 or a cudaError_t.

#include <string.h>

#include "qmm_rows.cuh"

using namespace owk_qrows;

extern "C" int owk_qmm_rows_maps(const void* qs, const void* scales, int K, int Np,
                                 void* maps_out) {
  CUtensorMap maps[2];
  const int rc = encode_rows_maps(qs, scales, K, Np, maps);
  if (rc == 0) memcpy(maps_out, maps, sizeof maps);
  return rc;
}

extern "C" int owk_qmm_rows(const void* x, const void* maps, void* out, int M, int K, int Np,
                            int splits, void* stream) {
  static unsigned long long smem_allowed = 0;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof m);
  return launch_rows<4, kGatherCap, StoreF32Rows, kPdlNone>(m, x, StoreF32Rows{static_cast<float*>(out), Np},
                                                M, K, Np, splits, (cudaStream_t)stream,
                                                smem_allowed);
}
