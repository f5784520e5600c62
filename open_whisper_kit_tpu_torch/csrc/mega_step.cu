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
// Design. The TPU kernel is one pallas_call that runs in order on one core
// with a continuous weight-DMA pipeline. Hopper's blocks run in no order,
// and every stage needs the whole previous stage (a layernorm needs the full
// row, attention all of q), so its counterpart here is a fixed sequence of
// launches of this one source on one stream, 8 per layer plus 1:
//   qkv (LN prologue; the epilogue writes q and row r's new K/V at cache
//   row head + r, none at or past Tc: `head` lives on the card, so the
//   kernel checks the bound, not the host),
//   self-attend, o (+ residual), cq (LN prologue), cross-attend,
//   co (+ residual), mlp0 (LN prologue, GELU epilogue), mlp1 (+ residual),
//   then the logits (final-LN prologue, f32 out).
// 33 launches per token at large-v3-turbo. The stream orders them, so no
// layer grouping is needed (the TPU kernel chains groups of at most 8
// layers to bound its unrolled program; here depth costs launches only).
// A persistent single launch with grid barriers is a later design, to be
// measured against this one.
//
// The GEMV (split-K over blocks, LN prologue, deterministic ordered combine)
// and the attention kernel (two passes, full-row softmax) live in
// mega_rows.cuh, shared with K7 (mega_beam.cu) and K8 (mega_batch.cu); K2
// runs them at R rows, its self-attention as attend_kernel with row r over
// keys [0, head + r] of the layer's (Tc, S) cache: all R rows' K/V are
// written before the attention launch, and that per-row limit is what keeps
// a row from seeing the rows after it (the TPU kernel's per-row causal
// mask). The GEMV's split plan depends on K and N only, the attention's key
// chunk on min(Tc, n_text_ctx) only (the speculative loop's cache has gamma
// + 4 rows more than the greedy loop's, and the chunk must not follow them),
// and each row's sums run in the order of the R = 1 step, so every verify
// row is bit-identical to the one-row greedy step at its position:
// speculative decoding emits exactly the greedy tokens.
//
// What bounds a step on the H100: the bytes. Every weight plane, its scales
// and the cross-KV stream once per step, whatever R (a verify pass adds only
// its R rows of self-KV). At large-v3-turbo (4 layers, S = 1280, vocabulary
// 51866, 1500 audio positions) that is 347 MB dense (104 us at 3.35 TB/s),
// 209 MB int8 (62 us), 120 MB int4 (36 us); 30.7 MB of each is cross-KV.
// This first version is bound by its launch chain and by the latency of
// each launch's loads, not by those bytes.
//
// Requires S % 128 == 0 (int4: S % 256 == 0), 64-wide heads, every plane
// width a multiple of 64 and 16-byte aligned planes; the Python wrapper
// checks.

#include "mega_rows.cuh"

using namespace mega;

// bytes of zero-initialised workspace a step needs (dims as owk_mega_step)
extern "C" long long owk_mega_step_workspace(const int* dims) {
  return (long long)layout(read_dims(dims), dims[13]).total;
}

template <int R>
int mega_step(void* const* p, const int* dims, float eps, float kq, float cross_scale,
              void* stream) {
  const Step<R> s(p, dims, eps, kq, stream, /*natural=*/true);
  const Dims& d = s.d;
  int e;
  if ((e = s.start())) return e;
  for (int il = 0; il < d.L; ++il) {
    bf16* kk = s.kv_k() + (size_t)il * d.Tc * d.S;
    bf16* vv = s.kv_v() + (size_t)il * d.Tc * d.S;
    if ((e = s.gemv(0, il, s.xres, 3 * il, kEpiQKV, s.qb, nullptr, kk, vv))) return e;
    if ((e = s.attend(s.qb, kk, vv, d.Tc, true, 1.0f))) return e;
    if ((e = s.gemv(1, il, s.ab, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(2, il, s.xres, 3 * il + 1, kEpiBias, s.qb, nullptr, nullptr, nullptr))) return e;
    if ((e = s.attend(s.qb, s.xk(il), s.xv(il), d.Ta, false, cross_scale))) return e;
    if ((e = s.gemv(3, il, s.ab, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(4, il, s.xres, 3 * il + 2, kEpiGelu, s.gb, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(5, il, s.gb, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
  }
  return s.gemv(6, 0, s.xres, 3 * d.L, kEpiLogits, nullptr, s.logits(), nullptr, nullptr);
}

// One decoder step for R rows. p: as mega::Step, kv_k and kv_v (L, Tc, S),
// logits out (R, Vp). dims: L, S, H, Tc, Ta, Vp, the seven kinds (0 dense,
// 1 int8, 2 int4), R (1..8), and Tp, the rows the self-attention plans its
// key chunks from (min(Tc, n_text_ctx), see Dims). Returns the first nonzero
// cudaError_t of the 33 launches, or 0.
extern "C" int owk_mega_step(void* const* p, const int* dims, float eps,
                             float kq, float cross_scale, void* stream) {
  switch (dims[13]) {
    case 1: return mega_step<1>(p, dims, eps, kq, cross_scale, stream);
    case 2: return mega_step<2>(p, dims, eps, kq, cross_scale, stream);
    case 3: return mega_step<3>(p, dims, eps, kq, cross_scale, stream);
    case 4: return mega_step<4>(p, dims, eps, kq, cross_scale, stream);
    case 5: return mega_step<5>(p, dims, eps, kq, cross_scale, stream);
    case 6: return mega_step<6>(p, dims, eps, kq, cross_scale, stream);
    case 7: return mega_step<7>(p, dims, eps, kq, cross_scale, stream);
    case 8: return mega_step<8>(p, dims, eps, kq, cross_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
