// Kernels K9b and K9a: decoder query rows against int8 cross-KV planes with
// one f32 scale per (position, head),
//
//   s_k = (q_h . kq[b,h,k]) * ks[b,h,k] * scale     for keys k < n_keys
//   p   = softmax(s)
//   out = sum_k round(p_k * vs[b,h,k]) * vq[b,h,k]
//
// Replaces the TPU kernels open_whisper_kit_tpu/ops/experiments.py::
// cross_attention_q8 (K9b, head-major planes, body _cross_q8_kernel) and
// cross_attention_q8_nat (K9a, natural planes, body _cross_q8_nat_kernel).
// One templated body serves both: the planes are read at element strides
// (batch, head, row) -- head-major (H*Ta*dh, Ta*dh, dh), natural (Tap*S,
// dh, S) -- and the scales at (batch, head) -- (H*Ta, Ta) or (Hs*Tap, Tap);
// a batch stride of 0 lets every row read one shared batch-1 plane. Keys at
// or past n_keys (K9a's ta_valid) are never read, which is what the TPU
// kernel's -inf mask gives.
//
// Rounding points, in the activations' type T. bf16 (the port's real
// models) takes the TPU kernel's: bf16 q, int8 exact in f32, f32 dot
// products, the scales folded after the dot ((dot * ks) * scale), f32
// softmax with p = e / sum before the multiply by vs, p * vs rounded to
// bf16, f32 accumulation against V, the output rounded to bf16. f32 keeps
// f32 throughout (no rounding of q or p * vs), so that the port's decoder
// computes JAX's _attention_hm_q at every dtype. The dequantized K/V never
// exist in device memory: each int8 row converts in registers.
//
// What bounds it on the H100: bytes, and at these sizes the latency of one
// launch. At large-v3-turbo (H = 20, dh = 64, Ta = 1500) one launch (one
// layer) reads 2 * H * Ta * dh bytes of planes and 2 * H * Ta * 4 of scales
// per plane batch: 4.08 MB, about 1.2 us at 3.35 TB/s (shared by B = 5
// beams), 32.6 MB and 9.7 us for B = 8 streams, half of what the bf16
// cross-KV it replaces reads. ~7.7 MFLOP per row do not bind. A 4 MB plane
// is in flight whole when every block asks for its keys at its start, so
// the time is one HBM round trip, the block's arithmetic and its combine,
// on top of the launch.
//
// Design: one launch, one thread-block cluster per (head, row group).
//  * The cluster's C blocks (C <= 8, the portable size) take the live keys
//    in C chunks of a multiple of 32 keys (the wrapper's plan,
//    ops/experiments.py::cross_q8_plan; at turbo 8 chunks of 192 keys, the
//    last 156). A row group is every query row that reads one plane: with
//    a shared batch-1 plane (beams) up to 8 rows a block, so the plane is
//    read once, not once a row; with a plane a row (lockstep streams) one.
//  * A block is eight warps: at these sizes every phase is a short chain of
//    dependent steps, and more threads a block shorten each one.
//  * Each block asks for its chunk's K rows and scales, then its V rows and
//    scales, at its start (cp.async, 16 bytes a thread: a 64-byte head row
//    at the layout's row stride; two groups), so V arrives while K scores.
//  * Scores: four threads a 64-byte K row, each 16 values against the
//    block's query rows (f32 FMAs from shared memory), two shuffles; then
//    each row's chunk max and sum of exp(s - max), one warp a row.
//  * The blocks push their (max, sum) pairs into every block's shared
//    memory (st.shared::cluster) behind one cluster barrier; every block
//    then forms the row's M and L (one warp a row, lane c chunk c, the
//    terms added in chunk order), p = exp(s - M) / L (a division, as the TPU
//    kernel), w = round_T(p * vs), and sums w * V in f32: sixteen threads a
//    V row, four columns each, sixteen key slots, the slots added in a
//    fixed order.
//  * Every block but the first sends its partial sums (rows x 64 f32) into
//    the first block's shared memory (st.async, counted on an mbarrier
//    there); the first adds them in chunk order, rounds to T and stores.
//    No global scratch and no float atomics: the same bits from run to run.
// Requires 64-wide heads, 16-byte aligned planes and row strides that are
// multiples of 16 bytes; the Python wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace owk_sm90;
typedef __nv_bfloat16 bf16;

constexpr int kDH = 64;             // head width
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;      // keys per block (ops/experiments.py: K9_MAX_CHUNK)
constexpr int kMaxCluster = 8;      // the portable cluster size (K9_MAX_CLUSTER)
constexpr int kMaxRows = 8;         // query rows a block (K9_MAX_ROWS)
constexpr int kQLd = 80;            // floats of a q row in shared memory: 4 x (16 + 4 pad)
constexpr int kSlots = kThreads / 16;   // key slots of the P.V pass: 16 threads a V row

struct Args {
  const void* q;         // (B, H * dh) in T
  const int8_t* kq;      // planes, read at the strides below
  const float* ks;       // scales
  const int8_t* vq;
  const float* vs;
  void* out;             // (B, H * dh) in T
  int B, H, n_keys, chunk, rows;   // rows: query rows a block (a row group)
  int kb, kh, kr;        // plane strides (elements): batch, head, row
  int sb, sh;            // scale strides: batch, head
  float scale;
};

// Shared memory of a block: K and V rows of the chunk, their scales, the
// query rows, the scores (then the weights), every block's (max, sum) per
// row, each row's (M, L), the gather barrier; then the warps' partial sums
// and (first block) the others' partial sums, in the K rows' place when
// they fit there (the K rows are dead once scored), else after the rest.
// Offsets in bytes, each 16-aligned.
struct Layout {
  uint32_t k, v, ksc, vsc, q, sc, stats, ml, bar, red, gather, total;
  __host__ __device__ Layout(int chunk, int rows, int chunks) {
    k = 0;
    v = k + chunk * kDH;
    ksc = v + chunk * kDH;
    vsc = ksc + chunk * 4;
    q = vsc + chunk * 4;
    sc = q + rows * kQLd * 4;
    stats = sc + rows * chunk * 4;
    ml = stats + kMaxCluster * kMaxRows * 8;
    bar = ml + kMaxRows * 8;
    total = bar + 16;
    const uint32_t sums = (kWarps + chunks - 1) * rows * kDH * 4;
    red = sums <= (uint32_t)(chunk * kDH) ? k : total;
    gather = red + kWarps * rows * kDH * 4;
    if (red == total) total += sums;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// p * vs as the matrix product takes it: rounded to T
template <typename T>
__device__ __forceinline__ float in_type(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// two floats into another block's shared memory (`addr` from map_rank)
__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

// 16 int8 values (one 16-byte load, little-endian) -> f32, exactly
__device__ __forceinline__ void unpack16(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = (float)((int)(w[i] << (24 - 8 * j)) >> 24);
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads) cross_q8_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int chunks = gridDim.x;             // the cluster: the chunks of one (head, row group)
  const int rank = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout L(a.chunk, a.rows, chunks);
  int8_t* const ksh = reinterpret_cast<int8_t*>(smem + L.k);
  int8_t* const vsh = reinterpret_cast<int8_t*>(smem + L.v);
  float* const ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* const vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* const qsh = reinterpret_cast<float*>(smem + L.q);
  float* const sc = reinterpret_cast<float*>(smem + L.sc);
  float* const stats = reinterpret_cast<float*>(smem + L.stats);
  float2* const ml = reinterpret_cast<float2*>(smem + L.ml);
  float* const red = reinterpret_cast<float*>(smem + L.red);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + L.bar;

  const int b0 = grp * a.rows;                    // the group's first query row
  const int rows = min(a.rows, a.B - b0);         // its rows (the last group may hold fewer)
  const int t0 = rank * a.chunk;
  const int n = min(a.chunk, a.n_keys - t0);      // live keys of this chunk, >= 1 by the plan
  // the group's plane: batch b0 (a shared plane has batch stride 0)
  const int8_t* const kbase = a.kq + (size_t)b0 * a.kb + (size_t)h * a.kh + (size_t)t0 * a.kr;
  const int8_t* const vbase = a.vq + (size_t)b0 * a.kb + (size_t)h * a.kh + (size_t)t0 * a.kr;
  const float* const ksb = a.ks + (size_t)b0 * a.sb + (size_t)h * a.sh + t0;
  const float* const vsb = a.vs + (size_t)b0 * a.sb + (size_t)h * a.sh + t0;

  // the chunk's K rows and scales, then its V rows and scales, at once
  for (int i = tid; i < n * 4; i += kThreads)
    cp_async16(base + L.k + i * 16, kbase + (size_t)(i >> 2) * a.kr + (i & 3) * 16);
  for (int i = tid; i < n; i += kThreads) cp_async4(base + L.ksc + i * 4, ksb + i);
  cp_async_commit();
  for (int i = tid; i < n * 4; i += kThreads)
    cp_async16(base + L.v + i * 16, vbase + (size_t)(i >> 2) * a.kr + (i & 3) * 16);
  for (int i = tid; i < n; i += kThreads) cp_async4(base + L.vsc + i * 4, vsb + i);
  cp_async_commit();

  // the first block's gather barrier expects the others' partial sums; the
  // cluster barrier's first half now, its wait before any block writes
  // into another's shared memory (every block has started by then)
  if (rank == 0 && tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    if (chunks > 1) mbar_expect_tx(bar, (chunks - 1) * rows * kDH * 4);
  }
  // the warp whole again before it arrives: a warp that reaches the
  // (non-aligned) cluster arrive in two parts was seen to hang the cluster
  // on the H100 (warp 0 here, behind thread 0's barrier setup)
  __syncwarp();
  if (chunks > 1) cluster_arrive_relaxed();

  // the query rows in f32, each 16-value group padded to spread the banks
  for (int i = tid; i < rows * kDH; i += kThreads) {
    const int r = i / kDH, d = i % kDH;
    qsh[r * kQLd + (d / 16) * 20 + d % 16] =
        to_f32(static_cast<const T*>(a.q)[((size_t)(b0 + r) * a.H + h) * kDH + d]);
  }
  cp_async_wait<1>();
  __syncthreads();

  // scores: four threads a key row, 16 values each; every lane runs every
  // pass (the shuffles need the whole warp)
  {
    const int g = tid & 3;
    const float4* const q4 = reinterpret_cast<const float4*>(qsh + g * 20);
    for (int r0 = 0; r0 < n; r0 += kThreads / 4) {
      const int r = r0 + (tid >> 2);
      float d[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) d[rr] = 0.f;
      if (r < n) {
        float f[16];
        unpack16(*reinterpret_cast<const uint4*>(ksh + r * kDH + g * 16), f);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          if (rr < rows) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 qv = q4[rr * (kQLd / 4) + i];
              d[rr] = fmaf(qv.x, f[4 * i], d[rr]);
              d[rr] = fmaf(qv.y, f[4 * i + 1], d[rr]);
              d[rr] = fmaf(qv.z, f[4 * i + 2], d[rr]);
              d[rr] = fmaf(qv.w, f[4 * i + 3], d[rr]);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        d[rr] += __shfl_xor_sync(0xffffffffu, d[rr], 1);
        d[rr] += __shfl_xor_sync(0xffffffffu, d[rr], 2);
      }
      if (r < n && g == 0) {
        const float s = ksc[r];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          if (rr < rows) sc[rr * a.chunk + r] = d[rr] * s * a.scale;
      }
    }
  }
  __syncthreads();

  // each row's chunk max and sum of exp(s - max), one warp a row; lane c
  // pushes the pair to block c
  if (chunks > 1) cluster_wait();
  for (int rr = warp; rr < rows; rr += kWarps) {
    const float* const s = sc + rr * a.chunk;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, s[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int i = lane; i < n; i += 32) l += expf(s[i] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    const uint32_t slot = base + L.stats + (rank * kMaxRows + rr) * 8;
    if (lane < chunks) {
      if (lane == rank)
        *reinterpret_cast<float2*>(smem + L.stats + (rank * kMaxRows + rr) * 8) =
            make_float2(m, l);
      else
        st_cluster_f2(map_rank(slot, lane), m, l);
    }
  }
  __syncwarp();
  if (chunks > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // each row's M and L from every chunk's pair, one warp a row, lane c
  // chunk c: M the largest max, L the terms l_c * exp(m_c - M) added in
  // chunk order
  cp_async_wait<0>();
  for (int rr = warp; rr < rows; rr += kWarps) {
    const float2 st = lane < chunks ? *reinterpret_cast<const float2*>(
                                          stats + (lane * kMaxRows + rr) * 2)
                                    : make_float2(-INFINITY, 0.f);
    float M = st.x;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float term = lane < chunks ? st.y * expf(st.x - M) : 0.f;
    float Lsum = 0.f;
    for (int c = 0; c < chunks; ++c) Lsum += __shfl_sync(0xffffffffu, term, c);
    if (lane == 0) ml[rr] = make_float2(M, Lsum);
  }
  __syncthreads();

  // the weights w = round_T(exp(s - M) / L * vs), every (row, key) of the chunk
  for (int i = tid; i < rows * n; i += kThreads) {
    const int rr = i / n, k = i - rr * n;
    float* const s = sc + rr * a.chunk + k;
    *s = in_type<T>(expf(*s - ml[rr].x) / ml[rr].y * vsc[k]);
  }
  __syncthreads();

  // P.V: thread (slot, cg) sums columns 4cg .. 4cg + 3 over keys slot,
  // slot + kSlots, ...; slots 2w and 2w + 1 meet by a shuffle, the warps in
  // shared memory in warp order
  {
    const int cg = tid & 15, slot = tid >> 4;
    float acc[kRows][4];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rr][e] = 0.f;
    for (int k = slot; k < n; k += kSlots) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(vsh + k * kDH + 4 * cg);
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = (float)((int)(u << (24 - 8 * e)) >> 24);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (rr < rows) {
          const float w = sc[rr * a.chunk + k];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rr][e] = fmaf(w, f[e], acc[rr][e]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], 16);
    if (lane < 16) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (rr < rows)
          *reinterpret_cast<float4*>(red + (warp * rows + rr) * kDH + 4 * cg) =
              make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
    }
  }
  __syncthreads();

  // the chunk's partial sums, four columns a thread; every block but the
  // first sends them to the first, which adds them in chunk order
  if (tid >= rows * 16) return;
  const int rr = tid / 16, c4 = tid % 16;
  float4 o = *reinterpret_cast<const float4*>(red + rr * kDH + 4 * c4);
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float4 v = *reinterpret_cast<const float4*>(red + (w * rows + rr) * kDH + 4 * c4);
    o.x += v.x, o.y += v.y, o.z += v.z, o.w += v.w;
  }
  if (rank > 0) {
    const uint32_t dst = base + L.gather + (((rank - 1) * rows + rr) * kDH + 4 * c4) * 4;
    st_async(map_rank(dst, 0), o, map_rank(bar, 0));
    return;
  }
  if (chunks > 1) {
    mbar_wait_cluster(bar, 0);
    const float* const parts = reinterpret_cast<const float*>(smem + L.gather);
    for (int c = 1; c < chunks; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(parts + ((c - 1) * rows + rr) * kDH + 4 * c4);
      o.x += v.x, o.y += v.y, o.z += v.z, o.w += v.w;
    }
  }
  T* const dst = static_cast<T*>(a.out) + ((size_t)(b0 + rr) * a.H + h) * kDH + 4 * c4;
  dst[0] = from_f32<T>(o.x);
  dst[1] = from_f32<T>(o.y);
  dst[2] = from_f32<T>(o.z);
  dst[3] = from_f32<T>(o.w);
}

// each instantiation's opt-in to its largest shared memory, one bit a device
unsigned long long smem_allowed[2][4];

template <typename T, int kRows>
int launch(const Args& a, int chunks, int groups, cudaStream_t stream) {
  const int smem = (int)Layout(a.chunk, a.rows, chunks).total;
  const int max_smem = (int)Layout(kMaxChunk, kMaxRows, kMaxCluster).total;
  const int err = allow_smem(cross_q8_kernel<T, kRows>, max_smem,
                             smem_allowed[sizeof(T) == 4][kRows == 1 ? 0 : kRows == 2 ? 1
                                                          : kRows == 4 ? 2 : 3]);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, a.H, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = chunks > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, cross_q8_kernel<T, kRows>, a);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
        void* out, int B, int H, int n_keys, int chunk, int rows, int kb, int kh, int kr,
        int sb, int sh, float scale, void* stream) {
  if (B < 1 || H < 1 || n_keys < 1 || chunk < 32 || chunk > kMaxChunk || chunk % 32 ||
      rows < 1 || rows > kMaxRows || (rows > 1 && (kb != 0 || sb != 0)) || kr % 16 ||
      kh % 16 || kb % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = (n_keys + chunk - 1) / chunk;
  if (chunks > kMaxCluster) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.kq = static_cast<const int8_t*>(kq);
  a.ks = static_cast<const float*>(ks);
  a.vq = static_cast<const int8_t*>(vq);
  a.vs = static_cast<const float*>(vs);
  a.out = out;
  a.B = B;
  a.H = H;
  a.n_keys = n_keys;
  a.chunk = chunk;
  a.rows = rows;
  a.kb = kb; a.kh = kh; a.kr = kr;
  a.sb = sb; a.sh = sh;
  a.scale = scale;
  const int groups = (B + rows - 1) / rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 1) return launch<T, 1>(a, chunks, groups, st);
  if (rows == 2) return launch<T, 2>(a, chunks, groups, st);
  if (rows <= 4) return launch<T, 4>(a, chunks, groups, st);
  return launch<T, 8>(a, chunks, groups, st);
}

}  // namespace

// q and out (B, H * 64) in bf16 | f32; kq/vq int8 planes and ks/vs f32
// scales read at element strides (kb, kh, kr) and (sb, sh); `chunk` keys a
// block (a multiple of 32, at most 256; at most 8 chunks cover n_keys, one
// cluster), `rows` query rows a block: 1 with a plane a row, up to 8 rows
// of a shared plane (batch strides 0). Returns 0 or a cudaError_t.
extern "C" int owk_cross_q8_bf16(const void* q, const void* kq, const void* ks,
                                 const void* vq, const void* vs, void* out, int B, int H,
                                 int n_keys, int chunk, int rows, int kb, int kh, int kr,
                                 int sb, int sh, float scale, void* stream) {
  return run<bf16>(q, kq, ks, vq, vs, out, B, H, n_keys, chunk, rows, kb, kh, kr, sb, sh,
                   scale, stream);
}

extern "C" int owk_cross_q8_f32(const void* q, const void* kq, const void* ks,
                                const void* vq, const void* vs, void* out, int B, int H,
                                int n_keys, int chunk, int rows, int kb, int kh, int kr,
                                int sb, int sh, float scale, void* stream) {
  return run<float>(q, kq, ks, vq, vs, out, B, H, n_keys, chunk, rows, kb, kh, kr, sb, sh,
                    scale, stream);
}
