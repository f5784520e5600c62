// The TPU kernel's blocked online-softmax attention for the decode steps of
// B rows whose caches are row-flat and time-major: K8's self- and
// cross-attention (mega_batch.cu) and K7's lineage self-attention
// (mega_beam.cu), on mega_stream.cuh's chain.
//
// attend_blocks_kernel<rows>: one block per (head, key block of `rows`
// keys, row b); a (head, row) pair's blocks are one thread-block cluster (at
// most 8). Row b's keys at time t sit at cache row
//   slot * stream_ld + t * row_ld
// (elements), slot being b (K8: the identity lineage, and the cross-KV of
// stream b) or, given an origin table, origin[b, t] (K7: beam b reads the
// slot that holds its lineage's row for time t; the TPU kernel masks the
// other slots with the 0/-inf bias beam_attn_bias builds, and a masked slot
// adds an exact zero to every sum, so reading the one slot computes the
// same function on 1/B of the bytes).
//  * Self (a head pointer): 128-row time blocks; keys past `head` take no
//    part (a block past it joins with no keys: max -inf, a = 1, l and o
//    unchanged, exactly). The rows, and K7's origin table, are step data:
//    they are read after the griddepcontrol.wait. Before it K8 asks L2 for
//    its own rows' lines; K7 asks for nothing. Of the two hints it could
//    give, every slot's lines of its time block measured 2-10 % slower at
//    B = 5 and 8 on the H100, and the origin row's lines of it within 1 %
//    of none at B = 2, 5 and 8 (PERF.md).
//  * Cross (no head pointer): 256-row chunks of row b's own cross-KV,
//    copied (cp.async) before the wait, since it is fixed for the window.
//  * q K^T and e V on mma.sync (the query row 0 of the A tile, e exact in
//    bf16), e one thread a key. Each block scores its keys, the cluster
//    exchanges the block maxima over distributed shared memory, each block
//    forms m_c = max(m_{c-1}, max s) in block order (m from -1e30),
//    e = bf16(exp(s - m_c)) and its partial l_c, o_c (f32), and the first
//    block adds the partials in block order (a = exp(m_{c-1} - m_c),
//    l = l * a + l_c, o = o * a + o_c) and writes bf16(o / l): the TPU
//    kernel's rounding points (attend_beams / per_row_cross), only the f32
//    order inside a block differing.
// Every sum runs in a fixed order (no float atomics) and no row's sums
// depend on another row's values: two launches give the same bits, and
// identical rows give identical results.

#pragma once

#include "mega_stream.cuh"

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
  const bf16* k;          // this layer's keys: slot s's row t at s * stream_ld + t * row_ld
  const bf16* v;
  const long long* head;  // self: on the card, every row attends t <= head; cross: null
  const long long* origin;    // self: (B, origin_ld) slots of each row's lineage, or null
                              // (row b reads slot b)
  bf16* out;              // (B, S) bf16
  size_t stream_ld, row_ld;   // self: S and B * S ((Tc * B, S) cache); cross: Ta * S and S
  int S, T;               // T key rows: self Tc, cross Ta
  int origin_ld;          // self with a lineage: Tc
  float scale;            // self 1.0 (the TPU kernel's), cross dh^-0.25 as f32
};

// shared memory of a block of kRows keys: K and V (128-byte rows), q, e, the
// warps' P.V sums, this block's partial and the other blocks', its max and
// the cluster's, the warps' maxima or sums, the gather barrier, the slots
// of a lineage's rows
struct BlockLayout {
  uint32_t vs, qs, es, red, part, gath, stat, allm, wtmp, bar, slot, total;
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
  o.slot = at; at += kRows * 4;
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
  int* const slot = reinterpret_cast<int*>(sm + lay.slot);
  if (cross) {   // the cross-KV is fixed for the window: it streams in while the stages in front run
    copy_tile(smem_u32(ks), a.k + row0, a.row_ld, t_end - t0, tid, kRows);
    copy_tile(smem_u32(vs), a.v + row0, a.row_ld, t_end - t0, tid, kRows);
    cp_async_commit();
  } else if (a.origin == nullptr) {
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
  if (!cross && n > 0 && a.origin != nullptr) {
    // the lineage: time t's row of slot origin[b, t] (a slot outside
    // 0 .. B - 1, which the beam loop never writes, is clamped into the cache)
    if (tid < n)
      slot[tid] = (int)min(max(a.origin[(size_t)b * a.origin_ld + t0 + tid], 0ll),
                           (long long)gridDim.z - 1);
    __syncthreads();
    const size_t at0 = (size_t)t0 * a.row_ld + h * kDH;
    for (int i = tid; i < n * 8; i += kRows) {
      const int r = i >> 3, pc = i & 7;
      const size_t at = at0 + (size_t)slot[r] * a.stream_ld + (size_t)r * a.row_ld + pc * 8;
      cp_async16(smem_u32(ks) + swz(r, pc), a.k + at);
      cp_async16(smem_u32(vs) + swz(r, pc), a.v + at);
    }
    cp_async_commit();
  } else if (!cross && n > 0) {
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

// the block attention kernels' dynamic shared memory opt-in, once per device
// (BT and TAC rows)
unsigned long long allowed_blocks[2];

inline int cdiv(int x, int y) { return (x + y - 1) / y; }

// one attention launch: grid (heads, key blocks, rows), a (head, row)
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
