// Kernel K8: one whole decoder step for B = 2..8 independent streams
// (batched serving) through one weight stream (every layer, the final
// layernorm and the vocab projection), over dense bf16, int8 or split-half
// int4 planes.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/decode_megakernel.py::
// mega_decode_step_batch (kernel body _make_kernel with n_beams = B,
// per_row_cross). It computes that kernel's function at its rounding
// points: the B rows take K2's through every matmul (mega_stream.cuh); the
// self-attention is the TPU kernel's online softmax over 128-row time
// blocks (BT, attend_beams) with the identity lineage (stream b owns slot b
// at every time); the cross-attention is per stream, each stream against
// its own cross-KV, the TPU kernel's online softmax over 256-row key chunks
// (tac, per_row_cross). Both online softmaxes keep the TPU kernel's
// rounding points: m starts at -1e30; block c's scores s (f32) give
// m_c = max(m_{c-1}, max s), e = bf16(exp(s - m_c)), l = l * a + sum(e),
// o = o * a + e . V in f32 with a = exp(m_{c-1} - m_c); out bf16(o / l).
// Only the f32 summation order inside a block differs. K2's full-row
// softmax, which rounds p = exp(s - M) / L to bf16, is another function
// and is not used here.
//
// Design: K2's chain (mega_stream.cuh), 8 launches per layer plus the
// logits (33 at large-v3-turbo), each a programmatic dependent launch:
//   * the GEMVs are K2's gemv_kernel at R = B, planned as K2's at R = B
//     (ops/decode_megakernel.py::mega_batch_plan): TMA rings issued before
//     the wait, split-K over clusters combined by st.async, mma.sync on the
//     8 rows. The QKV epilogue writes stream b's new K/V at row
//     head * B + b of the (Tc * B, S) time-major cache;
//   * the self- and the cross-attention are one kernel,
//     attend_blocks_kernel<rows> (mega_blocks.cuh, shared with K7, which
//     gives it a lineage): grid (heads, key blocks, streams), a
//     (head, stream) pair's blocks one cluster (at most 8); q K^T and e V
//     on mma.sync (the query row 0 of the A tile, e exact in bf16), e one
//     thread a key. Self: 128-row time blocks (Tc <= 1024; 4 at n_text_ctx 448)
//     of stream b's rows t * B + b, read after the wait (before it their
//     lines are only prefetched into L2); blocks past `head` take part
//     with no keys (max -inf: a = 1, l and o unchanged, exactly). Cross:
//     256-row chunks of stream b's own cross-KV (Ta <= 2048; Ta 1500 gives
//     6: 960 blocks at B = 8), copied (cp.async) before the wait, since the
//     cross-KV is fixed for the window, so the chunks of every block the
//     card holds stream in while the stages in front run. Each block scores
//     its keys, the cluster exchanges the block maxima over distributed
//     shared memory, each block forms m_c in block order and its partial
//     l_c, o_c (f32), and the first block adds the partials in block order
//     and rounds. (One block per (head, chunk) taking the B streams in turn
//     through a ring, 120 blocks, was 1.10-1.21x slower on the H100:
//     PERF.md.)
// Nothing the step produces (x0, head, q, the residual rows, the new K/V
// rows) is read before a launch's wait, and nothing global is written
// before it: a chain may start while the one before it is still running.
// Every sum runs in a fixed order (no float atomics) and no row's sums
// depend on another row's values: two launches give the same bits, and B
// identical streams give B identical rows.
//
// What bounds a step on the H100: the bytes. Each stream reads its own
// cross-KV, L * 2 * Ta * S * 2 bytes (30.7 MB at large-v3-turbo), so at
// B = 8 the cross-KV (246 MB) outweighs the weights (350 MB dense, 211 MB
// int8, 122 MB int4), which stream once for the 8 rows; the self-cache rows
// add B * L * 2 * (head + 1) * S * 2 bytes.
//
// Requires 2 <= B <= 8, S % 128 == 0 (int4: S % 256 == 0), S <= 2048,
// 64-wide heads, Tc <= 1024, Ta <= 2048, every plane width a multiple of
// 128 and 16-byte aligned planes; the Python wrapper checks.

#include "mega_blocks.cuh"

using namespace mstream;

// bytes of workspace a step needs (dims as owk_mega_batch)
extern "C" long long owk_mega_batch_workspace(const int* dims) {
  return (long long)layout(read_dims(dims)).total;
}

// The 14 tensor maps of a prepared decoder's planes (encode_step_maps in
// mega_stream.cuh). p and dims as owk_mega_batch. Returns 0 or a cudaError_t.
extern "C" int owk_mega_batch_maps(void* const* p, const int* dims, void* maps_out) {
  return encode_step_maps(p, dims, maps_out);
}

// One batched decoder step on `stream`. p as owk_mega_step's, with kv_k,
// kv_v (L, Tc * B, S) row-flat time-major (row t * B + b is stream b at
// time t) and xk, xv (L, B, Ta, S) per stream. dims as owk_mega_step's with
// Tc the rows of one stream and R = B (2..8). plan: the seven fields'
// splits and ring depths, then 128 and 256 (the self-attention's time
// block and the cross chunk; anything else is refused). maps:
// owk_mega_batch_maps' 14. x0 (B, S) bf16, head an int64 on the card,
// logits (B, Vp) f32 out. Returns the first nonzero cudaError_t of the 33
// launches, or 0 (cudaErrorInvalidValue for dims or a plan it does not take).
extern "C" int owk_mega_batch(void* const* p, const int* dims, const int* plan, const void* maps,
                              const void* x0, const void* head, void* logits, float eps,
                              float kq, float cross_scale, void* stream) {
  const int B = dims[13];
  const Chain c(dims, p, plan, maps, x0, head, logits, eps, kq, cross_scale, stream, B);
  const Dims& d = c.d;
  if (B < 2 || !c.dims_ok() || plan[14] != kBT || plan[15] != kTAC ||
      cdiv(d.Tc, kBT) > kMaxCluster || cdiv(d.Ta, kTAC) > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  BlockArgs sa;   // the self-attention over the (Tc * B, S) cache
  sa.q = c.qb; sa.head = c.head; sa.origin = nullptr; sa.out = c.ab;
  sa.stream_ld = d.S; sa.row_ld = (size_t)B * d.S;
  sa.S = d.S; sa.T = d.Tc; sa.origin_ld = 0; sa.scale = 1.0f;
  BlockArgs ca = sa;   // the cross-attention over each stream's (Ta, S) cross-KV
  ca.head = nullptr;
  ca.stream_ld = (size_t)d.Ta * d.S; ca.row_ld = d.S;
  ca.T = d.Ta; ca.scale = cross_scale;
  const size_t self_layer = (size_t)d.Tc * B * d.S, cross_layer = (size_t)B * d.Ta * d.S;
  int e;
  for (int il = 0; il < d.L; ++il) {
    const bf16* in = il == 0 ? c.x0 : c.xres;
    if ((e = c.gemv(0, il, in, 3 * il, kEpiQKV, c.qb, il == 0))) return e;
    sa.k = static_cast<const bf16*>(p[24]) + il * self_layer;
    sa.v = static_cast<const bf16*>(p[25]) + il * self_layer;
    if ((e = attend_blocks<kBT>(c, sa, allowed_blocks[0]))) return e;
    if ((e = c.gemv(1, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(2, il, c.xres, 3 * il + 1, kEpiBias, c.qb, false))) return e;
    ca.k = static_cast<const bf16*>(p[26]) + il * cross_layer;
    ca.v = static_cast<const bf16*>(p[27]) + il * cross_layer;
    if ((e = attend_blocks<kTAC>(c, ca, allowed_blocks[1]))) return e;
    if ((e = c.gemv(3, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(4, il, c.xres, 3 * il + 2, kEpiGelu, c.gb, false))) return e;
    if ((e = c.gemv(5, il, c.gb, -1, kEpiResid, c.xres, false))) return e;
  }
  return c.gemv(6, 0, c.xres, 3 * d.L, kEpiLogits, nullptr, false);
}
