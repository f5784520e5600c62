// Kernel K5: y = gelu_tanh(x @ W0 + b0) @ W1 over int8 planes, f32 out.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/quant_matmul.py::_ffn_int8
// (kernel body _ffn_kernel). Same rounding points: h = x @ W0_t + b0_t in
// f32, gelu_tanh in f32, h rounded to bf16, then h @ W1_t with an f32 sum
// over the hidden axis in order (the TPU kernel adds its 512-wide tiles in
// grid order; here one block sums all of K for its outputs, in order, with
// no float atomics, so the result is the same on every run).
//
// Two launches on one stream, chosen over one: the TPU kernel carries the
// sum across its sequential grid, and a Hopper grid has no order, so one
// launch would need every output block to recompute all of h (12x the W0
// stream at whisper-large) or a grid-wide barrier. Launch 1 writes h in
// bf16 (M x 4S x 2 bytes: 10 KB per decode row) with the bias + gelu +
// bf16 rounding fused into its epilogue; launch 2 is the K3 tile loop over
// h. The bf16 rounding of h stays where the TPU kernel has it.
//
// What bounds it on the H100: at decode rows both weight planes stream once
// (2 * 1280 * 5120 bytes + scales at whisper-large: 14 MB, 4.2 us at
// 3.35 TB/s): HBM bandwidth.

#include "qmm_tile.cuh"

extern "C" int owk_ffn_int8(const void* x, const void* q0, const void* s0,
                            const void* b0, const void* q1, const void* s1,
                            void* h, void* out, int M, int K, int FF, int N1p,
                            void* stream) {
  using namespace owk_qtile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch(x, M, K, FF,
                        Int8Planes{static_cast<const int8_t*>(q0),
                                   static_cast<const float*>(s0), FF},
                        BiasGeluBf16{static_cast<__nv_bfloat16*>(h),
                                     static_cast<const float*>(b0), FF},
                        st);
  if (rc != 0) return rc;
  return launch(h, M, FF, N1p,
                Int8Planes{static_cast<const int8_t*>(q1),
                           static_cast<const float*>(s1), N1p},
                StoreF32{static_cast<float*>(out), N1p}, st);
}
