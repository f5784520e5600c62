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
//     attend_blocks_kernel<rows>: grid (heads, key blocks, streams), a
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

#include "mega_stream.cuh"

using namespace mstream;

namespace mstream {
namespace {

constexpr int kBT = 128;             // time rows of a self-attention block (the TPU kernel's BT)
constexpr int kTAC = 256;            // key rows of a cross chunk (the TPU kernel's tac)
constexpr int kRowBytes = kDH * 2;   // a head's 64 bf16 of one K/V row
constexpr int kPart = kDH + 4;       // a partial: o (64 f32), l, 3 of padding (16-byte multiple)

// byte offset of 16-byte piece p of row r in a tile of 128-byte rows, the
// pieces of eight consecutive rows on distinct banks: the mma fragments of
// eight keys and ldmatrix's eight row addresses meet no bank conflict
__device__ __forceinline__ uint32_t swz(int r, int p) { return r * kRowBytes + ((p ^ (r & 7)) << 4); }

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// rows [0, n) of one head's (rows, 64) bf16 slice, row stride ld elements ->
// a swizzled tile (cp.async, not committed)
__device__ __forceinline__ void copy_tile(uint32_t tile, const bf16* src, size_t ld, int n,
                                          int tid, int threads) {
  for (int i = tid; i < n * 8; i += threads) {
    const int r = i >> 3, pc = i & 7;
    cp_async16(tile + swz(r, pc), src + (size_t)r * ld + pc * 8);
  }
}

// the online softmax's combine of one output column over `n` partials in
// block order (block 0's at part0, block c's at gath + (c - 1) * gstride;
// block c's max at maxes[c]): m the running max (from -1e30),
// a = exp(m_prev - m), l = l * a + l_c, o = o * a + o_c (each product and
// sum rounded alone, as the TPU kernel's separate f32 ops); bf16(o / l)
__device__ __forceinline__ bf16 combine(const float* part0, const float* gath, int gstride,
                                        const float* maxes, int n, int col) {
  float m = -1e30f, l = 0.f, o = 0.f;
  for (int c = 0; c < n; ++c) {
    const float* pc = c == 0 ? part0 : gath + (c - 1) * gstride;
    const float mc = fmaxf(m, maxes[c]);
    const float al = expf(m - mc);
    l = __fadd_rn(__fmul_rn(l, al), pc[kDH]);
    o = __fadd_rn(__fmul_rn(o, al), pc[col]);
    m = mc;
  }
  return __float2bfloat16(o / l);
}

// -- attention: a cluster of key blocks per (head, stream) ---------------------------

struct BlockArgs {
  const bf16* q;          // (B, S) bf16, pre-scaled
  const bf16* k;          // this layer's keys: stream b's row t at b * stream_ld + t * row_ld
  const bf16* v;
  const long long* head;  // self: on the card, every stream attends t <= head; cross: null
  bf16* out;              // (B, S) bf16
  size_t stream_ld, row_ld;   // self: S and B * S ((Tc * B, S) cache); cross: Ta * S and S
  int S, T;               // T key rows: self Tc, cross Ta
  float scale;            // self 1.0 (the TPU kernel's), cross dh^-0.25 as f32
};

// shared memory of a block of kRows keys: K and V (128-byte rows), q, e, the
// warps' P.V sums, this block's partial and the other blocks', its max and
// the cluster's, the warps' maxima or sums, the gather barrier
struct BlockLayout {
  uint32_t vs, qs, es, red, part, gath, stat, allm, wtmp, bar, total;
};

template <int kRows>
__host__ __device__ inline BlockLayout block_layout() {
  BlockLayout o;
  uint32_t at = kRows * kRowBytes;
  o.vs = at; at += kRows * kRowBytes;
  o.qs = at; at += kDH * 2;
  o.es = at; at += kRows * 4;
  o.red = at; at += (kRows / 32) * kDH * 4;
  o.part = at; at += kPart * 4;
  o.gath = at; at += (kMaxCluster - 1) * kPart * 4;
  o.stat = at; at += 16;
  o.allm = at; at += kMaxCluster * 4;
  o.wtmp = at; at += 32;
  o.bar = at; at += 16;
  o.total = at + 128;   // the base aligned to 128 bytes
  return o;
}

// One block per (head, key block c of kRows rows, stream b), kRows threads;
// a (head, stream) pair's blocks are one cluster (rank c).
template <int kRows>
__global__ void __launch_bounds__(kRows) attend_blocks_kernel(const BlockArgs a) {
  constexpr int kWarps = kRows / 32;
  pdl_launch_dependents();
  extern __shared__ uint8_t sm_raw[];
  uint8_t* const sm = sm_raw + ((128 - (smem_u32(sm_raw) & 127)) & 127);
  const BlockLayout lay = block_layout<kRows>();
  uint8_t* const ks = sm;
  uint8_t* const vs = sm + lay.vs;
  uint32_t* const qw = reinterpret_cast<uint32_t*>(sm + lay.qs);   // q's 64 bf16
  float* const es = reinterpret_cast<float*>(sm + lay.es);
  float* const red = reinterpret_cast<float*>(sm + lay.red);
  float* const part = reinterpret_cast<float*>(sm + lay.part);
  float* const gath = reinterpret_cast<float*>(sm + lay.gath);
  float* const stat = reinterpret_cast<float*>(sm + lay.stat);
  float* const allm = reinterpret_cast<float*>(sm + lay.allm);
  float* const wtmp = reinterpret_cast<float*>(sm + lay.wtmp);
  const uint32_t gather_bar = smem_u32(sm + lay.bar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nblk = gridDim.y;
  const int S = a.S, t0 = c * kRows, t_end = min(t0 + kRows, a.T);
  const size_t row0 = b * a.stream_ld + (size_t)t0 * a.row_ld + h * kDH;
  if (tid == 0) {
    mbar_init(gather_bar, 1);
    fence_barrier_init();
    if (c == 0 && nblk > 1) mbar_expect_tx(gather_bar, (nblk - 1) * kPart * 4);
  }
  const bool cross = a.head == nullptr;
  if (cross) {   // the cross-KV is fixed for the window: it streams in while the stages in front run
    copy_tile(smem_u32(ks), a.k + row0, a.row_ld, t_end - t0, tid, kRows);
    copy_tile(smem_u32(vs), a.v + row0, a.row_ld, t_end - t0, tid, kRows);
    cp_async_commit();
  } else {
    // the self-cache rows may still be written by a chain in flight: only
    // ask L2 for their lines now (a hint; the copy after the wait reads
    // what is there then)
    for (int i = tid; i < (t_end - t0) * 2; i += kRows)
      asm volatile("prefetch.global.L2 [%0];" ::"l"((i & 1 ? a.v : a.k) + row0 +
                                                    (i >> 1) * a.row_ld));
  }

  pdl_wait();
  // this block's keys: the self-attention's up to head
  const int n = cross ? t_end - t0 : (int)max(min((long long)t_end, *a.head + 1) - t0, 0ll);
  if (!cross && n > 0) {
    copy_tile(smem_u32(ks), a.k + row0, a.row_ld, n, tid, kRows);
    copy_tile(smem_u32(vs), a.v + row0, a.row_ld, n, tid, kRows);
    cp_async_commit();
  }
  // zeros in the K and V rows past the keys (the products read whole 8- and
  // 16-key tiles)
  for (int i = tid; i < (kRows - n) * 8; i += kRows) {
    const uint32_t at = swz(n + (i >> 3), i & 7);
    *reinterpret_cast<uint4*>(ks + at) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(vs + at) = make_uint4(0, 0, 0, 0);
  }
  if (tid < kDH / 2)
    qw[tid] = *reinterpret_cast<const uint32_t*>(a.q + (size_t)b * S + h * kDH + 2 * tid);
  cp_async_wait_all();
  __syncthreads();

  // ---- the scores, S = q K^T on mma.sync (row 0 of the A tile the query,
  // the rest zero), 8 keys a tile, a warp every kWarps-th tile ----
  const int g = lane >> 2, q4 = lane & 3;
  {
    uint32_t qa[4][2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      qa[kk][0] = g == 0 ? qw[kk * 8 + q4] : 0u, qa[kk][1] = g == 0 ? qw[kk * 8 + 4 + q4] : 0u;
    for (int nt = warp; nt * 8 < n; nt += kWarps) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rows8(d, qa[kk][0], qa[kk][1],
                  *reinterpret_cast<const uint32_t*>(ks + swz(nt * 8 + g, 2 * kk) + 4 * q4),
                  *reinterpret_cast<const uint32_t*>(ks + swz(nt * 8 + g, 2 * kk + 1) + 4 * q4));
      if (g == 0) es[nt * 8 + 2 * q4] = d[0] * a.scale, es[nt * 8 + 2 * q4 + 1] = d[1] * a.scale;
    }
  }
  __syncthreads();
  const float s = tid < n ? es[tid] : -INFINITY;
  float mx = warp_max(s);
  if (lane == 0) wtmp[warp] = mx;
  __syncthreads();
  mx = wtmp[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wtmp[w]);
  if (tid == 0) stat[0] = mx;
  // every block's max is written (and the first block's gather barrier
  // initialised) past this barrier; then one trip reads them all
  if (nblk > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (tid < nblk) allm[tid] = ld_cluster_f32(map_rank(smem_u32(stat), tid));
  __syncthreads();
  // done reading the others' maxima (their values are in hand)
  if (nblk > 1) cluster_arrive_relaxed();

  // ---- m_c in block order, e = bf16(exp(s - m_c)), l_c, o_c ----
  float mc = -1e30f;
  for (int r = 0; r <= c; ++r) mc = fmaxf(mc, allm[r]);
  const float e = tid < n ? bround(expf(s - mc)) : 0.f;
  es[tid] = e;
  const float ls = warp_sum(e);
  __syncthreads();   // e published; every thread is past reading wtmp
  if (lane == 0) wtmp[warp] = ls;
  // ---- o_c = e V on mma.sync (e exact in bf16), 16 keys a step, a warp
  // every kWarps-th step, V's fragments by ldmatrix.trans ----
  {
    float o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
    const int m = lane >> 3, rr = lane & 7;   // this lane's ldmatrix row address
    for (int kk = warp; kk * 16 < n; kk += kWarps) {
      const float* ek = es + kk * 16 + 2 * q4;
      const uint32_t a0 = g == 0 ? pack_bf16(ek[0], ek[1]) : 0u;
      const uint32_t a2 = g == 0 ? pack_bf16(ek[8], ek[9]) : 0u;
#pragma unroll
      for (int p2 = 0; p2 < 4; ++p2) {   // n-tiles 2 p2 and 2 p2 + 1 (columns 16 p2 .. + 15)
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_u32(vs) + swz(kk * 16 + (m & 1) * 8 + rr, 2 * p2 + (m >> 1)));
        mma_rows8(o[2 * p2], a0, a2, bv[0], bv[1]);
        mma_rows8(o[2 * p2 + 1], a0, a2, bv[2], bv[3]);
      }
    }
    if (g == 0)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(red + warp * kDH + nt * 8 + 2 * q4) = make_float2(o[nt][0], o[nt][1]);
  }
  __syncthreads();
  if (tid < kDH) {   // the warps' sums in warp order
    float o = red[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += red[w * kDH + tid];
    part[tid] = o;
  } else if (tid < kPart) {
    float l = wtmp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l += wtmp[w];
    part[tid] = tid == kDH ? l : 0.f;
  }
  __syncthreads();

  if (c > 0) {   // the partial to the first block: slot c - 1
    const uint32_t bar = map_rank(gather_bar, 0);
    const uint32_t dst = map_rank(smem_u32(gath + (c - 1) * kPart), 0);
    if (tid < kPart / 4) st_async(dst + 16 * tid, reinterpret_cast<const float4*>(part)[tid], bar);
    cluster_wait();
    return;
  }
  if (nblk > 1) mbar_wait_cluster(gather_bar, 0);
  if (tid < kDH)
    a.out[(size_t)b * S + h * kDH + tid] = combine(part, gath, kPart, allm, nblk, tid);
  if (nblk > 1) cluster_wait();
}

// the attention kernels' dynamic shared memory opt-in, once per device
unsigned long long allowed_attend[2];

inline int cdiv(int x, int y) { return (x + y - 1) / y; }

// one attention launch: grid (heads, key blocks, streams), a (head, stream)
// pair's blocks one cluster
template <int kRows>
int attend_blocks(const Chain& c, const BlockArgs& a, unsigned long long& allowed) {
  const int blocks = cdiv(a.T, kRows), smem = (int)block_layout<kRows>().total;
  int e;
  if ((e = allow_smem(attend_blocks_kernel<kRows>, smem, allowed))) return e;
  return launch(attend_blocks_kernel<kRows>, dim3(c.d.H, blocks, c.d.R), kRows, blocks, smem,
                c.st, a);
}

}  // namespace
}  // namespace mstream

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
  sa.q = c.qb; sa.head = c.head; sa.out = c.ab;
  sa.stream_ld = d.S; sa.row_ld = (size_t)B * d.S;
  sa.S = d.S; sa.T = d.Tc; sa.scale = 1.0f;
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
    if ((e = attend_blocks<kBT>(c, sa, allowed_attend[0]))) return e;
    if ((e = c.gemv(1, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(2, il, c.xres, 3 * il + 1, kEpiBias, c.qb, false))) return e;
    ca.k = static_cast<const bf16*>(p[26]) + il * cross_layer;
    ca.v = static_cast<const bf16*>(p[27]) + il * cross_layer;
    if ((e = attend_blocks<kTAC>(c, ca, allowed_attend[1]))) return e;
    if ((e = c.gemv(3, il, c.ab, -1, kEpiResid, c.xres, false))) return e;
    if ((e = c.gemv(4, il, c.xres, 3 * il + 2, kEpiGelu, c.gb, false))) return e;
    if ((e = c.gemv(5, il, c.gb, -1, kEpiResid, c.xres, false))) return e;
  }
  return c.gemv(6, 0, c.xres, 3 * d.L, kEpiLogits, nullptr, false);
}
