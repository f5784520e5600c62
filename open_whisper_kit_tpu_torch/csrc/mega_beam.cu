// Kernel K7: one whole decoder step for B <= 8 beams through one weight
// stream (every layer, the final layernorm and the vocab projection), over
// dense bf16, int8 or split-half int4 weight planes.
//
// Replaces the TPU kernel open_whisper_kit_tpu/ops/decode_megakernel.py::
// mega_decode_step_beam (kernel body _make_kernel with n_beams = B,
// use_bias, self_blocked). It computes that kernel's function: the B rows
// take K2's rounding points (mega_rows.cuh) through every matmul and the
// cross-attention; the self-attention is the TPU kernel's blocked online
// softmax over 128-row time blocks of a row-flat, time-major cache whose
// lineage is an origin table, with no physical reorder.
//
// Design. The same launch sequence as K2 (8 launches per layer plus the
// logits, 33 at large-v3-turbo), with R = B rows in each:
//   * the GEMVs (mega_rows.cuh gemv_kernel<B>) read and dequantize each
//     weight once and multiply it into all B rows, so a beam step streams
//     about one greedy step of weight bytes, not B of them; the QKV
//     epilogue writes beam b's new K/V row to flat cache row head * B + b;
//   * the cross-attention (attend_kernel<B>) reads the shared (Ta, S)
//     cross-KV once for the B rows: full-row softmax, p rounded to bf16,
//     keys at or past Ta masked;
//   * the self-attention (beam_attend_kernel, mega_blocked.cuh) is one block per
//     (head, beam). It walks the time blocks 0 .. head / 128 in order and
//     keeps JAX's online softmax exactly: m starts at -1e30; per block
//     mn = max(m, max s), a = exp(m - mn), e = bf16(exp(s - mn)),
//     l = l * a + sum(e), o = o * a + e . V in f32; out bf16(o / l).
//     The TPU kernel masks with a 0/-inf bias (beam_attn_bias) that leaves
//     one slot per time row unmasked: slot origin[b, t] for t <= head. A
//     masked entry adds an exact zero to every sum, so this kernel reads
//     the origin table and scores only row t * B + origin[b, t], 1/B of the
//     self-KV bytes the TPU kernel's slab copy reads.
//
// What bounds a step on the H100: the bytes, as for K2. At large-v3-turbo
// and B = 5 the weights and cross-KV are K2's (347 MB dense, 209 MB int8,
// 120 MB int4), the self-KV rows B times K2's and the logits B rows. This
// first version is bound by its launch chain and the latency of each
// launch's loads, not by those bytes.
//
// Requires 2 <= B <= 8, S % 128 == 0 (int4: S % 256 == 0), 64-wide heads,
// every plane width a multiple of 64 and 16-byte aligned planes; the Python
// wrapper checks.

#include "mega_blocked.cuh"

using namespace mega;

namespace {

template <int B>
int beam_step(void* const* p, const int* dims, float eps, float kq, float cross_scale,
              void* stream) {
  const Step<B> s(p, dims, eps, kq, stream);
  const Dims& d = s.d;
  const long long* origin = static_cast<const long long*>(p[30]);
  int e;
  if ((e = s.start())) return e;
  for (int il = 0; il < d.L; ++il) {
    bf16* kk = s.kv_k() + (size_t)il * d.Tc * B * d.S;
    bf16* vv = s.kv_v() + (size_t)il * d.Tc * B * d.S;
    if ((e = s.gemv(0, il, s.xres, 3 * il, kEpiQKV, s.qb, nullptr, kk, vv))) return e;
    BeamAttn a;
    a.q = s.qb; a.k = kk; a.v = vv; a.origin = origin; a.head = s.head;
    a.B = B; a.S = d.S; a.Tc = d.Tc; a.out = s.ab;
    beam_attend_kernel<<<dim3(d.H, B), kThreads, 0, s.st>>>(a);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = s.gemv(1, il, s.ab, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(2, il, s.xres, 3 * il + 1, kEpiBias, s.qb, nullptr, nullptr, nullptr))) return e;
    if ((e = s.attend(s.qb, s.xk(il), s.xv(il), d.Ta, false, cross_scale))) return e;
    if ((e = s.gemv(3, il, s.ab, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(4, il, s.xres, 3 * il + 2, kEpiGelu, s.gb, nullptr, nullptr, nullptr))) return e;
    if ((e = s.gemv(5, il, s.gb, -1, kEpiResid, s.xres, nullptr, nullptr, nullptr))) return e;
  }
  return s.gemv(6, 0, s.xres, 3 * d.L, kEpiLogits, nullptr, s.logits(), nullptr, nullptr);
}

}  // namespace

// bytes of zero-initialised workspace a step needs (dims as owk_mega_beam)
extern "C" long long owk_mega_beam_workspace(const int* dims) {
  return (long long)layout(read_dims(dims), dims[13]).total;
}

// One beam decoder step. p: as mega::Step with kv_k, kv_v (L, Tc * B, S)
// row-flat time-major and logits out (B, Vp), then p[30] the (B, Tc) int64
// origin table.
// dims: L, S, H, Tc (per beam), Ta, Vp, the seven kinds (0 dense, 1 int8,
// 2 int4), B, Tp (K2's self-attention plan; not used here). Returns the
// first nonzero cudaError_t of the launches, or 0 (cudaErrorInvalidValue for
// B outside 2..8).
extern "C" int owk_mega_beam(void* const* p, const int* dims, float eps,
                             float kq, float cross_scale, void* stream) {
  switch (dims[13]) {
    case 2: return beam_step<2>(p, dims, eps, kq, cross_scale, stream);
    case 3: return beam_step<3>(p, dims, eps, kq, cross_scale, stream);
    case 4: return beam_step<4>(p, dims, eps, kq, cross_scale, stream);
    case 5: return beam_step<5>(p, dims, eps, kq, cross_scale, stream);
    case 6: return beam_step<6>(p, dims, eps, kq, cross_scale, stream);
    case 7: return beam_step<7>(p, dims, eps, kq, cross_scale, stream);
    case 8: return beam_step<8>(p, dims, eps, kq, cross_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
