// Kernel K5: y = gelu_tanh(x @ W0 + b0) @ W1 over int8 planes, f32 out.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/quant_matmul.py::_ffn_int8
// (kernel body _ffn_kernel). Same rounding points: h = x @ W0_t + b0_t in
// f32, gelu_tanh in f32, h rounded to bf16, then h @ W1_t with an f32 sum
// over the hidden axis (the TPU kernel adds its 512-wide tiles in grid
// order; here the splits of the hidden axis add in split order, with no
// float atomics, so the result is the same on every run).
//
// Two launches on one stream, chosen over one: the TPU kernel carries the
// sum across its sequential grid, and a Hopper grid has no order, so one
// launch would need every output block to recompute all of h (10x the W0
// stream at whisper-large) or a grid-wide barrier. The first launch writes
// h in bf16 (M x 4S x 2 bytes: 10 KB per decode row) with the bias + gelu +
// bf16 rounding fused into its epilogue; the second sums over h. The bf16
// rounding of h stays where the TPU kernel has it.
//
// What bounds it on the H100: at decode rows both weight planes stream once
// (2 * 1280 * 5120 bytes + scales at whisper-large: 14.7 MB, 4.4 us at
// 3.35 TB/s): HBM bandwidth, behind the latency of two dependent launches.
// At a prompt ingest (17-227 rows) the same bytes and, at 227 rows, 5.95
// GFLOP (6.0 us at 989 TFLOP/s); what a tiled launch takes is set by how
// many 64-row K steps its longest block walks, one after another.
//
// Design at M <= 16 (every decode row; owk_ffn_int8_rows): both halves are
// qmm_rows.cuh's split weight stream (TMA rings on full / empty mbarriers,
// mma.sync m16n8k16, the splits of a column tile one cluster, combined in
// split order by st.async), each planned by the wrapper
// (ops/quant_matmul.py::ffn_int8_rows_plan: splits of K towards ~100 blocks).
//  * The first half (M, K -> FF) stores bias + gelu_tanh rounded to bf16
//    into h from its first split (BiasGeluBf16Rows, reading the bias in
//    f32 or bf16 as the model keeps it: no conversion launch a call), and
//    signals its dependent launch at its start.
//  * The second half (M, FF -> N1p) is a programmatic dependent launch with
//    a ring as deep as its split (kDownStages stages of 4.5 KB): its blocks
//    start while the first half runs, and each producer issues its split's
//    W1 stages and scales at once, before anything waits; the consumers
//    wait for the first half (griddepcontrol.wait) before they read h. So
//    W1 streams in beside W0, and what follows the first half is h's load,
//    the products from shared memory and the combine. Nothing the second
//    half reads before its wait is written by anyone (the planes); the
//    first half carries no attribute, so it starts only when the stream's
//    earlier work (the previous call included) has completed.
// Design at M > 16 (the prompt ingest; owk_ffn_int8): both halves are
// qmm_wgmma.cuh's TMA + wgmma tiles (128 x 128 output tiles, dequantizing
// warpgroups, wgmma consumers), with the splits of K the wrapper plans
// (ops/quant_matmul.py::ffn_int8_tiles_plan), each tile's splits one
// cluster whose sums meet over DSMEM in split order.
//  * The old tiles body (wmma over 64-row tiles, one block per column tile
//    walking all of K) took 242-259 us at 24-227 rows whatever M was: the
//    second half has only N1p / 128 = 10 column tiles, each walking FF / 32
//    = 160 dependent steps on 10-40 of the 132 SMs.
//  * The first half (M, K -> FF; 40 column tiles a row tile) splits K
//    where its tiles leave SMs idle, and its epilogue stores bias +
//    gelu_tanh rounded to bf16 (BiasGeluBf16, the bias in f32 or bf16);
//    it signals its dependent launch at its start.
//  * The second half (M, FF -> N1p) splits the hidden axis on its 512-row
//    tiles (unit 8 steps: the TPU kernel's grid tiles, added in the TPU
//    kernel's order) so that column tiles x row tiles x splits spread over
//    the card; it is a programmatic dependent launch whose producer fills
//    its W1 ring (six 9 KB stages) before griddepcontrol.wait and reads h
//    only after it.
//
// Requires K % 32 == 0, FF % 128 == 0, N1p % 128 == 0 and 16-byte aligned
// x, planes, b0 and h; the Python wrapper checks.

#include <string.h>

#include "qmm_rows.cuh"
#include "qmm_wgmma.cuh"

namespace {

// ring depths of the two halves (ops/quant_matmul.py's FFN_UP_STAGES,
// FFN_DOWN_STAGES): the first half's splits at whisper-large take 13-14
// stages, the second half's 20 at 8 splits
constexpr int kUpStages = 14;
constexpr int kDownStages = 20;

}  // namespace

// the four tensor maps (qs, scales of W0, then of W1; 512 bytes) into
// maps_out. Returns 0 or a cudaError_t.
extern "C" int owk_ffn_int8_maps(const void* q0, const void* s0, int K, int FF, const void* q1,
                                 const void* s1, int N1p, void* maps_out) {
  CUtensorMap maps[4];
  int rc = owk_qrows::encode_rows_maps(q0, s0, K, FF, maps);
  if (rc == 0) rc = owk_qrows::encode_rows_maps(q1, s1, FF, N1p, maps + 2);
  if (rc == 0) memcpy(maps_out, maps, sizeof maps);
  return rc;
}

namespace {

template <typename TB>
int ffn_rows(const void* x, const CUtensorMap (&m)[4], const void* b0, void* h, void* out,
             int M, int K, int FF, int N1p, int splits_up, int splits_down, cudaStream_t st) {
  using namespace owk_qrows;
  static unsigned long long up_allowed = 0, down_allowed = 0;
  const CUtensorMap up[2] = {m[0], m[1]}, down[2] = {m[2], m[3]};
  const int rc = launch_rows<kUpStages, kFfnGatherCap, BiasGeluBf16Rows<TB>, kPdlPrimary>(
      up, x,
      BiasGeluBf16Rows<TB>{static_cast<__nv_bfloat16*>(h), static_cast<const TB*>(b0), FF}, M,
      K, FF, splits_up, st, up_allowed);
  if (rc != 0) return rc;
  return launch_rows<kDownStages, kFfnGatherCap, StoreF32Rows, kPdlSecondary>(
      down, h, StoreF32Rows{static_cast<float*>(out), N1p}, M, FF, N1p, splits_down, st,
      down_allowed);
}

}  // namespace

// M <= 16: x (M, K) bf16, maps from owk_ffn_int8_maps, b0 (FF) f32 or (b0_bf16)
// bf16, h (M, FF) bf16 scratch, out (M, N1p) f32; splits of each half from
// the plan. Returns the first nonzero cudaError_t of the two launches, or 0.
extern "C" int owk_ffn_int8_rows(const void* x, const void* maps, const void* b0, int b0_bf16,
                                 void* h, void* out, int M, int K, int FF, int N1p,
                                 int splits_up, int splits_down, void* stream) {
  CUtensorMap m[4];
  memcpy(m, maps, sizeof m);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return b0_bf16 ? ffn_rows<__nv_bfloat16>(x, m, b0, h, out, M, K, FF, N1p, splits_up,
                                           splits_down, st)
                 : ffn_rows<float>(x, m, b0, h, out, M, K, FF, N1p, splits_up, splits_down, st);
}

namespace {

template <typename TB>
int ffn_tiles(const void* x, const void* q0, const void* s0, const void* b0, const void* q1,
              const void* s1, void* h, void* out, int M, int K, int FF, int N1p, int splits_up,
              int splits_down, int unit_down, cudaStream_t st) {
  namespace W = owk_qwg;
  static unsigned long long up_allowed = 0, down_allowed = 0;
  const int rc = W::launch_tiles<W::Int8Planes, W::BiasGeluBf16<TB>, W::kPdlPrimary, true>(
      x, q0, s0,
      W::BiasGeluBf16<TB>{static_cast<__nv_bfloat16*>(h), static_cast<const TB*>(b0), FF}, M,
      K, FF, splits_up, 1, st, up_allowed);
  if (rc != 0) return rc;
  return W::launch_tiles<W::Int8Planes, W::StoreF32, W::kPdlSecondary, true>(
      h, q1, s1, W::StoreF32{static_cast<float*>(out), N1p}, M, FF, N1p, splits_down,
      unit_down, st, down_allowed);
}

}  // namespace

// M > 16: the tiles body twice, h (M, FF) bf16 scratch, b0 (FF) f32 or
// (b0_bf16) bf16; splits of each half and the second half's run of steps
// (a 512-row hidden tile: 8) from the plan. Returns the first nonzero
// cudaError_t of the two launches, or 0.
extern "C" int owk_ffn_int8(const void* x, const void* q0, const void* s0, const void* b0,
                            int b0_bf16, const void* q1, const void* s1, void* h, void* out,
                            int M, int K, int FF, int N1p, int splits_up, int splits_down,
                            int unit_down, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return b0_bf16 ? ffn_tiles<__nv_bfloat16>(x, q0, s0, b0, q1, s1, h, out, M, K, FF, N1p,
                                            splits_up, splits_down, unit_down, st)
                 : ffn_tiles<float>(x, q0, s0, b0, q1, s1, h, out, M, K, FF, N1p, splits_up,
                                    splits_down, unit_down, st);
}
