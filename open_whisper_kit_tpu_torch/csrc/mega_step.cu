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
// a chain of 33 empty dependent launches costs ~30 us on the H100
// (kernel_times.py --ablate), the step several times that. The bodies (a split TMA weight stream combined over
// clusters; one-pass attention over a cluster of key chunks) are in
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

#include <string.h>

#include "mega_stream.cuh"

using namespace mstream;

namespace {

struct Dims {
  int L, S, H, Tc, Ta, Vp;
  int kind[7];  // qkv, o, cq, co, mlp0, mlp1, logits
  int R;
};

Dims read_dims(const int* v) {
  Dims d;
  d.L = v[0]; d.S = v[1]; d.H = v[2]; d.Tc = v[3]; d.Ta = v[4]; d.Vp = v[5];
  for (int f = 0; f < 7; ++f) d.kind[f] = v[6 + f];
  d.R = v[13];
  return d;
}

// K (dense rows) and N of the seven weight fields
void field_kn(const Dims& d, int f, int* K, int* N) {
  const int S = d.S;
  const int k[7] = {S, S, S, S, S, 4 * S, S};
  const int n[7] = {3 * S, S, S, S, 4 * S, S, d.Vp};
  *K = k[f];
  *N = n[f];
}

// the workspace: the residual rows, q / cq, the attention output, the GELU rows
struct Layout {
  size_t xres, qb, ab, gb, total;
};

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

Layout layout(const Dims& d) {
  Layout o;
  size_t at = 0;
  o.xres = at; at = align256(at + (size_t)d.R * d.S * 2);
  o.qb = at; at = align256(at + (size_t)d.R * d.S * 2);
  o.ab = at; at = align256(at + (size_t)d.R * d.S * 2);
  o.gb = at; at = align256(at + (size_t)d.R * 4 * d.S * 2);
  o.total = at;
  return o;
}

// the dynamic shared memory opt-in, once per device and kernel
unsigned long long allowed_gemv[3], allowed_attend;

template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, int threads, int cluster_y, int smem, cudaStream_t st,
           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = cluster_y;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster_y > 1 ? 2 : 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

struct Chain {
  Dims d;
  void* const* p;
  const int* plan;        // the seven fields' splits and ring depths, the self and cross key chunks
  const CUtensorMap* maps;  // two a field
  cudaStream_t st;
  float eps, kq;
  const bf16* x0;
  const long long* head;
  float* logits;
  bf16 *xres, *qb, *ab, *gb;

  int gemv(int f, int il, const bf16* in, int ln_row, int epi, bf16* out, bool first) const {
    int K, N;
    field_kn(d, f, &K, &N);
    const int kind = d.kind[f], splits = plan[f], depth = plan[7 + f], S = d.S;
    if (splits < 1 || splits > kMaxCluster || splits > n_stages(kind, K) || depth < 1 ||
        depth > kMaxDepth)
      return (int)cudaErrorInvalidValue;
    const int smem = (int)gemv_layout(kind, K, S, splits, depth, d.R, ln_row >= 0).total;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    GemvArgs a;
    a.in = in;
    a.lnw = ln_row >= 0 ? static_cast<const bf16*>(p[2]) + (size_t)ln_row * S : nullptr;
    a.lnb = ln_row >= 0 ? static_cast<const bf16*>(p[3]) + (size_t)ln_row * S : nullptr;
    a.bias = f < 6 ? static_cast<const bf16*>(p[4 + f]) + (size_t)il * N : nullptr;
    a.out = out;
    a.out_f32 = f == 6 ? logits : nullptr;
    a.kk = static_cast<bf16*>(p[24]) + (size_t)il * d.Tc * S;
    a.vv = static_cast<bf16*>(p[25]) + (size_t)il * d.Tc * S;
    a.head = head;
    a.x0 = x0;
    a.xres = first ? xres : nullptr;
    a.cache_rows = d.Tc;
    a.eps = eps;
    a.kq = kq;
    a.K = K; a.N = N; a.S = S; a.R = d.R; a.layer = f < 6 ? il : 0;
    a.splits = splits; a.depth = depth; a.epi = epi;
    const dim3 grid(N / kBN, splits);
    const CUtensorMap& mw = maps[2 * f];
    const CUtensorMap& ms = maps[2 * f + 1];
    int e;
    switch (kind) {
      case kDense:
        if ((e = allow_smem(gemv_kernel<kDense>, kMaxSmem, allowed_gemv[0]))) return e;
        return launch(gemv_kernel<kDense>, grid, kThreads, splits, smem, st, mw, ms, a);
      case kInt8:
        if ((e = allow_smem(gemv_kernel<kInt8>, kMaxSmem, allowed_gemv[1]))) return e;
        return launch(gemv_kernel<kInt8>, grid, kThreads, splits, smem, st, mw, ms, a);
      case kInt4:
        if ((e = allow_smem(gemv_kernel<kInt4>, kMaxSmem, allowed_gemv[2]))) return e;
        return launch(gemv_kernel<kInt4>, grid, kThreads, splits, smem, st, mw, ms, a);
    }
    return (int)cudaErrorInvalidValue;
  }

  // the R rows of qb against keys of layer il: the self-cache (row r up to
  // head + r) or the cross-KV; out -> ab
  int attend(int il, bool self) const {
    const int S = d.S, T = self ? d.Tc : d.Ta, chunk = plan[self ? 14 : 15];
    if (chunk < 16 || chunk > kMaxChunk || chunk % 16) return (int)cudaErrorInvalidValue;
    const int chunks = (T + chunk - 1) / chunk;
    if (chunks > kMaxCluster) return (int)cudaErrorInvalidValue;
    const bf16* k = static_cast<const bf16*>(p[self ? 24 : 26]) + (size_t)il * T * S;
    const bf16* v = static_cast<const bf16*>(p[self ? 25 : 27]) + (size_t)il * T * S;
    AttnArgs a;
    a.q = qb; a.k = k; a.v = v;
    a.head = self ? head : nullptr;
    a.out = ab;
    a.T = T; a.S = S; a.R = d.R; a.chunk = chunk;
    a.scale = self ? 1.0f : cross_scale;
    int e;
    if ((e = allow_smem(attend_kernel, kMaxSmem, allowed_attend))) return e;
    const int smem = (int)attn_layout(chunk, chunks, d.R).total;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    return launch(attend_kernel, dim3(d.H, chunks), kAttnThreads, chunks, smem, st, a);
  }

  float cross_scale;
};

}  // namespace

// bytes of workspace a step needs (dims as owk_mega_step)
extern "C" long long owk_mega_step_workspace(const int* dims) {
  return (long long)layout(read_dims(dims)).total;
}

// The 14 tensor maps of a prepared decoder's planes (two a field: values,
// then scales; a dense field's second is a copy of its first), 128 bytes
// each, into maps_out. p and dims as owk_mega_step (only the planes and
// L, S, Vp and the kinds are read). Returns 0 or a cudaError_t.
extern "C" int owk_mega_step_maps(void* const* p, const int* dims, void* maps_out) {
  const Dims d = read_dims(dims);
  CUtensorMap maps[14];
  for (int f = 0; f < 7; ++f) {
    int K, N;
    field_kn(d, f, &K, &N);
    const int kind = d.kind[f];
    const cuuint64_t L = f < 6 ? d.L : 1;
    if (N % kBN || K % (kind == kInt4 ? 2 * kQK : kQK)) return (int)cudaErrorInvalidValue;
    const cuuint64_t rows = kind == kInt4 ? K / 2 : K;
    const cuuint64_t esz = kind == kDense ? 2 : 1;
    const cuuint64_t w_dims[3] = {(cuuint64_t)N, rows, L};
    const cuuint64_t w_stride[2] = {N * esz, rows * N * esz};
    const cuuint32_t w_box[3] = {kind == kDense ? 64u : 128u, (cuuint32_t)kQK, 1};
    int rc = encode_map(&maps[2 * f],
                        kind == kDense ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        3, p[10 + 2 * f], w_dims, w_stride, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
    if (kind == kDense) {
      maps[2 * f + 1] = maps[2 * f];
      continue;
    }
    const cuuint64_t ssz = kind == kInt8 ? 4 : 2;
    const cuuint64_t s_dims[3] = {(cuuint64_t)N, (cuuint64_t)(K / kQK), L};
    const cuuint64_t s_stride[2] = {N * ssz, (cuuint64_t)(K / kQK) * N * ssz};
    const cuuint32_t s_box[3] = {(cuuint32_t)kBN, 1, 1};
    rc = encode_map(&maps[2 * f + 1],
                    kind == kInt8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    3, p[11 + 2 * f], s_dims, s_stride, s_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  }
  memcpy(maps_out, maps, sizeof maps);
  return 0;
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
  Chain c;
  c.d = read_dims(dims);
  const Dims& d = c.d;
  if (d.R < 1 || d.R > kRows || d.S % kBN || d.S != d.H * kDH || d.S > kMaxLnK)
    return (int)cudaErrorInvalidValue;
  c.p = p;
  c.plan = plan;
  c.maps = static_cast<const CUtensorMap*>(maps);
  c.st = static_cast<cudaStream_t>(stream);
  c.eps = eps;
  c.kq = kq;
  c.cross_scale = cross_scale;
  c.x0 = static_cast<const bf16*>(x0);
  c.head = static_cast<const long long*>(head);
  c.logits = static_cast<float*>(logits);
  const Layout lay = layout(d);
  unsigned char* ws = static_cast<unsigned char*>(p[29]);
  c.xres = reinterpret_cast<bf16*>(ws + lay.xres);
  c.qb = reinterpret_cast<bf16*>(ws + lay.qb);
  c.ab = reinterpret_cast<bf16*>(ws + lay.ab);
  c.gb = reinterpret_cast<bf16*>(ws + lay.gb);
  int e;
  for (int il = 0; il < d.L; ++il) {
    const bf16* in = il == 0 ? c.x0 : c.xres;
    if ((e = c.gemv(0, il, in, 3 * il, kEpiQKV, c.qb, il == 0))) return e;
    if ((e = c.attend(il, true))) return e;
    if ((e = c.gemv(1, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(2, il, c.xres, 3 * il + 1, kEpiBias, c.qb, false))) return e;
    if ((e = c.attend(il, false))) return e;
    if ((e = c.gemv(3, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(4, il, c.xres, 3 * il + 2, kEpiGelu, c.gb, false))) return e;
    if ((e = c.gemv(5, il, c.gb, -1, kEpiResid, c.xres, false))) return e;
  }
  return c.gemv(6, 0, c.xres, 3 * d.L, kEpiLogits, nullptr, false);
}
