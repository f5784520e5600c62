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
  if (K <= 0 || K % kQK || Np <= 0 || Np % kBN) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  const cuuint64_t q_dims[2] = {(cuuint64_t)Np, (cuuint64_t)K};
  const cuuint64_t q_stride[1] = {(cuuint64_t)Np};
  const cuuint32_t q_box[2] = {kBN, kQK};
  const cuuint64_t s_dims[2] = {(cuuint64_t)Np, (cuuint64_t)(K / kQK)};
  const cuuint64_t s_stride[1] = {(cuuint64_t)Np * 4};
  const cuuint32_t s_box[2] = {kBN, 1};
  int rc = encode_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qs, q_dims, q_stride, q_box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = encode_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, s_dims, s_stride,
                    s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0) memcpy(maps_out, maps, sizeof maps);
  return rc;
}

extern "C" int owk_qmm_rows(const void* x, const void* maps, void* out, int M, int K, int Np,
                            int splits, void* stream) {
  if (M < 1 || M > 16 || K <= 0 || K % kQK || Np <= 0 || Np % kBN || splits < 1 ||
      splits > kMaxSplits || splits > K / kQK)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(M, K, splits);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static unsigned long long smem_allowed = 0;
  int err = allow_smem(qmm_rows_kernel, kMaxSmem, smem_allowed);
  if (err != 0) return err;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof m);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Np / kBN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, qmm_rows_kernel, m[0], m[1],
                                            static_cast<const __nv_bfloat16*>(x),
                                            static_cast<float*>(out), M, K, Np, splits);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}
