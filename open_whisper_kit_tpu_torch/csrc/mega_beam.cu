// Kernel K7: one whole decoder step for B = 2..8 beams through one weight
// stream (every layer, the final layernorm and the vocab projection), over
// dense bf16, int8 or split-half int4 planes.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/decode_megakernel.py::
// mega_decode_step_beam (kernel body _make_kernel with n_beams = B,
// use_bias, self_blocked). It computes that kernel's function at its
// rounding points:
//  * the B rows take K2's through every matmul (mega_stream.cuh);
//  * the self-attention is the TPU kernel's online softmax over 128-row
//    time blocks (BT, attend_beams) of a row-flat, time-major (Tc * B, S)
//    cache whose lineage is an origin table: beam b scores only slot
//    origin[b, t] at each time t <= head (the TPU kernel masks the other
//    slots with the 0/-inf bias beam_attn_bias builds; a masked slot adds
//    an exact zero). m starts at -1e30; block c's scores s (f32) give
//    m_c = max(m_{c-1}, max s), e = bf16(exp(s - m_c)), l = l * a + sum(e),
//    o = o * a + e . V in f32 with a = exp(m_{c-1} - m_c); out bf16(o / l).
//    K2's full-row self-attention, which rounds p = exp(s - M) / L to bf16,
//    is another function and is not used for it;
//  * the cross-attention over the (Ta, S) cross-KV that the beams share is
//    the full-row softmax, p = bf16(exp(s - M) / L), keys at or past Ta
//    masked: K2's attend_kernel at R = B.
//
// Design: K2's chain (mega_stream.cuh), 8 launches per layer plus the
// logits (33 at large-v3-turbo), each a programmatic dependent launch:
//   * the GEMVs are K2's gemv_kernel at R = B, planned as K2's at R = B
//     (ops/decode_megakernel.py::mega_beam_plan): TMA rings issued before
//     the wait, split-K over clusters combined by st.async, mma.sync on the
//     8 rows; each weight is read once for the B beams. The QKV epilogue
//     writes beam b's new K/V at row head * B + b of the cache;
//   * the self-attention is mega_blocks.cuh's attend_blocks_kernel<128>
//     given the origin table: grid heads x time blocks x beams, a (head,
//     beam) pair's blocks one cluster (Tc <= 1024: 4 blocks at n_text_ctx
//     448); a block reads row t * B + origin[b, t] for its times. The
//     origin table is step data (the beam loop writes it with torch ops just
//     before each call, and back-to-back chains overlap their grids), so it
//     and the rows it selects are read only after the griddepcontrol.wait;
//   * the cross-attention is K2's attend_kernel at R = B over the shared
//     cross-KV (mega_stream.cuh attend(): 8 chunks of <= 256 keys a head,
//     copied before the wait), read once for the B beams.
// Nothing the step produces is read before a launch's wait, and nothing
// global is written before it. Every sum runs in a fixed order (no float
// atomics) and no row's sums depend on another row's values: two launches
// give the same bits, and B identical beams with one lineage give B
// identical rows.
//
// What bounds a step on the H100: the bytes. The weights and the cross-KV
// stream once for the B beams (K2's: 347 MB dense, 209 MB int8, 120 MB int4
// at large-v3-turbo, 30.7 MB of it cross-KV); each beam adds its lineage's
// self-KV rows, L * 2 * (head + 1) * S * 2 bytes, and its logits row.
//
// Requires 2 <= B <= 8, S % 128 == 0 (int4: S % 256 == 0), S <= 2048,
// 64-wide heads, Tc <= 1024, Ta <= 2048, every plane width a multiple of
// 128 and 16-byte aligned planes, origin values in 0 .. B - 1; the Python
// wrapper checks the shapes.

#include "mega_blocks.cuh"

using namespace mstream;

// bytes of workspace a step needs (dims as owk_mega_beam)
extern "C" long long owk_mega_beam_workspace(const int* dims) {
  return (long long)layout(read_dims(dims)).total;
}

// The 14 tensor maps of a prepared decoder's planes (encode_step_maps in
// mega_stream.cuh). p and dims as owk_mega_beam. Returns 0 or a cudaError_t.
extern "C" int owk_mega_beam_maps(void* const* p, const int* dims, void* maps_out) {
  return encode_step_maps(p, dims, maps_out);
}

// One beam decoder step on `stream`. p as owk_mega_step's, with kv_k, kv_v
// (L, Tc * B, S) row-flat time-major (row t * B + b is slot b at time t)
// and xk, xv (L, Ta, S) shared by the beams. dims as owk_mega_step's with
// Tc the rows of one beam and R = B (2..8). plan: the seven fields' splits
// and ring depths, then 128 (the self-attention's time block; anything
// else is refused) and the cross-attention's key chunk. maps:
// owk_mega_beam_maps' 14. x0 (B, S) bf16, head an int64 on the card, origin
// the (B, Tc) int64 lineage table on the card, logits (B, Vp) f32 out.
// Returns the first nonzero cudaError_t of the 33 launches, or 0
// (cudaErrorInvalidValue for dims or a plan it does not take).
extern "C" int owk_mega_beam(void* const* p, const int* dims, const int* plan, const void* maps,
                             const void* x0, const void* head, const void* origin,
                             void* logits, float eps, float kq, float cross_scale,
                             void* stream) {
  const int B = dims[13];
  const Chain c(dims, p, plan, maps, x0, head, logits, eps, kq, cross_scale, stream, B);
  const Dims& d = c.d;
  if (B < 2 || !c.dims_ok() || origin == nullptr || plan[14] != kBT ||
      cdiv(d.Tc, kBT) > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  BlockArgs sa;   // the lineage self-attention over the (Tc * B, S) cache
  sa.q = c.qb; sa.head = c.head; sa.origin = static_cast<const long long*>(origin);
  sa.out = c.ab;
  sa.stream_ld = d.S; sa.row_ld = (size_t)B * d.S;
  sa.S = d.S; sa.T = d.Tc; sa.origin_ld = d.Tc; sa.scale = 1.0f;
  const size_t self_layer = (size_t)d.Tc * B * d.S;
  int e;
  for (int il = 0; il < d.L; ++il) {
    const bf16* in = il == 0 ? c.x0 : c.xres;
    if ((e = c.gemv(0, il, in, 3 * il, kEpiQKV, c.qb, il == 0))) return e;
    sa.k = static_cast<const bf16*>(p[24]) + il * self_layer;
    sa.v = static_cast<const bf16*>(p[25]) + il * self_layer;
    if ((e = attend_blocks<kBT>(c, sa, allowed_blocks[0]))) return e;
    if ((e = c.gemv(1, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(2, il, c.xres, 3 * il + 1, kEpiBias, c.qb, false))) return e;
    if ((e = attend(c, il, false))) return e;
    if ((e = c.gemv(3, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(4, il, c.xres, 3 * il + 2, kEpiGelu, c.gb, false))) return e;
    if ((e = c.gemv(5, il, c.gb, -1, kEpiResid, c.xres, false))) return e;
  }
  return c.gemv(6, 0, c.xres, 3 * d.L, kEpiLogits, nullptr, false);
}
