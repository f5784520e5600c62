// Kernel K2: one whole decoder step (every layer, the final layernorm and
// the vocab projection) for R <= 8 consecutive tokens of one stream, over
// dense bf16, int8 or split-half int4 weight planes: R = 1 is the greedy
// step, R = gamma + 1 the speculative verify pass.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/decode_megakernel.py::
// mega_decode_step (kernel body _make_kernel), R = 1..8 rows. Same rounding
// points: layernorm with f32 statistics rounded to bf16; every product
// bf16 x bf16 summed in f32; a weight dequantized as value * scale in f32
// and rounded to bf16; the fused QKV result rounded to bf16, the bf16 bias
// added in bf16, Q and K multiplied by bf16(dh^-0.25) in bf16; attention
// scores in f32, a full-row softmax in f32 whose probabilities are rounded
// to bf16 before P.V; the residual stream bf16, each add rounded once;
// tanh-GELU in f32 rounded to bf16; f32 logits.
//
// What bounds a step on the H100: the bytes. Every weight plane, its scales
// and the cross-KV stream once per step, whatever R (a verify pass adds only
// its R rows of self-KV). At large-v3-turbo (4 layers, S = 1280, vocabulary
// 51866, 1500 audio positions) that is 347 MB dense (104 us at 3.35 TB/s),
// 209 MB int8 (62 us), 120 MB int4 (36 us); 30.7 MB of each is cross-KV.
//
// Design. The TPU kernel is one pallas_call that runs in order on one core,
// its weight DMA continuous across stage and layer boundaries. Hopper's
// blocks run in no order, and every stage needs the whole previous stage (a
// layernorm needs the full row, attention all of q), so here the step is a
// fixed chain of launches on one stream, 8 per layer plus 1:
//   qkv (LN prologue; the first also starts the residual rows as x0; the
//   epilogue writes q and row r's new K/V at cache row head + r, none at or
//   past Tc: `head` lives on the card, so the kernel checks the bound),
//   self-attend, o (+ residual), cq (LN prologue), cross-attend,
//   co (+ residual), mlp0 (LN prologue, GELU epilogue), mlp1 (+ residual),
//   then the logits (final-LN prologue, f32 out).
// Every launch carries the programmatic-dependent-launch attribute, and
// every kernel signals its dependents as it starts, so the next stages'
// blocks are resident while this one runs and stream their weight tiles
// (a split's ring holds the whole split where shared memory allows) and the
// cross-KV chunk before they wait for it: the weight stream runs on across
// the boundaries, the Hopper form of the TPU kernel's continuous pipeline.
// What is left on the critical path is each stage's own work after its
// wait (loading x, the products of its split, the combine, the epilogue):
// a chain of 33 empty dependent launches costs ~30 us on the H100 (a
// throwaway ablation, PERF.md), the step several times that. The bodies (a
// split TMA weight stream combined over clusters; one-pass attention over a
// cluster of key chunks) and the host side of the chain are in
// mega_stream.cuh; the launch plan comes from the Python wrapper
// (ops/decode_megakernel.py::mega_step_plan) and depends on each field's
// format, K and N and on Tp = min(Tc, n_text_ctx), never on R, so every
// verify row is bit-identical to the one-row greedy step at its position:
// speculative decoding emits exactly the greedy tokens. A persistent single
// launch with grid barriers is a later design, to be measured against this.
//
// Requires S % 128 == 0 (int4: S % 256 == 0), S <= 2048, 64-wide heads, every plane
// width a multiple of 128 and 16-byte aligned planes; the Python wrapper
// checks.

#include "mega_stream.cuh"

using namespace mstream;

// bytes of workspace a step needs (dims as owk_mega_step)
extern "C" long long owk_mega_step_workspace(const int* dims) {
  return (long long)layout(read_dims(dims)).total;
}

// The 14 tensor maps of a prepared decoder's planes (encode_step_maps in
// mega_stream.cuh). p and dims as owk_mega_step. Returns 0 or a cudaError_t.
extern "C" int owk_mega_step_maps(void* const* p, const int* dims, void* maps_out) {
  return encode_step_maps(p, dims, maps_out);
}

// One decoder step for R rows on `stream`. p: x0 (unused: the x0 argument
// takes its place), head (likewise), lnw, lnb, the six bias stacks (qkv, o,
// cq, co, mlp0, mlp1), then (plane, scales) for qkv, o, cq, co, mlp0, mlp1,
// logits (scales null for dense), kv_k, kv_v (L, Tc, S), xk, xv (L, Ta, S),
// logits (unused: the logits argument), workspace. dims: L, S, H, Tc, Ta,
// Vp, the seven kinds (0 dense, 1 int8, 2 int4), R (1..8). plan: the seven
// fields' splits, their ring depths, then the self-attention's and the
// cross-attention's key chunk. maps: owk_mega_step_maps' 14. x0 (R, S) bf16, head an int64 on
// the card, logits (R, Vp) f32 out. Returns the first nonzero cudaError_t
// of the 33 launches, or 0.
extern "C" int owk_mega_step(void* const* p, const int* dims, const int* plan, const void* maps,
                             const void* x0, const void* head, void* logits, float eps,
                             float kq, float cross_scale, void* stream) {
  const Chain c(dims, p, plan, maps, x0, head, logits, eps, kq, cross_scale, stream, 1);
  const Dims& d = c.d;
  if (!c.dims_ok()) return (int)cudaErrorInvalidValue;
  int e;
  for (int il = 0; il < d.L; ++il) {
    const bf16* in = il == 0 ? c.x0 : c.xres;
    if ((e = c.gemv(0, il, in, 3 * il, kEpiQKV, c.qb, il == 0))) return e;
    if ((e = attend(c, il, true))) return e;
    if ((e = c.gemv(1, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(2, il, c.xres, 3 * il + 1, kEpiBias, c.qb, false))) return e;
    if ((e = attend(c, il, false))) return e;
    if ((e = c.gemv(3, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(4, il, c.xres, 3 * il + 2, kEpiGelu, c.gb, false))) return e;
    if ((e = c.gemv(5, il, c.gb, -1, kEpiResid, c.xres, false))) return e;
  }
  return c.gemv(6, 0, c.xres, 3 * d.L, kEpiLogits, nullptr, false);
}
