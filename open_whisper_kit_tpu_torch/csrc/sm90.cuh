// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels
// (K1's bf16 body in mha_packed.cu, K3's M > 16 body in qmm.cu, the rows body
// of K3 and K5 in qmm_rows.cuh, T1 in mm_bf16.cu, K6 and T2 in w8a8.cu).
//
//  * mbarriers: init, arrive, arrive with an expected transaction count, and
//    a phase-parity wait that traps after ~10 s instead of hanging the card
//    (a wrong parity or byte count then fails the launch's stream with an
//    error rather than a hang); StageRing, the full / empty barrier pairs of
//    a ring of shared-memory stages;
//  * clusters: the cluster barrier's two halves, a block's rank, its shared
//    addresses as another block of the cluster sees them, arrivals on
//    another block's mbarrier, and st.async stores into another block's
//    shared memory that complete on its mbarrier;
//  * TMA: 2-D and 3-D tile loads from a CUtensorMap kernel parameter
//    (`const __grid_constant__`) into shared memory, completing on an
//    mbarrier (2-D also multicast to the blocks of a cluster); the host encodes the map with libcuda's cuTensorMapEncodeTiled,
//    looked up at run time (cudaGetDriverEntryPoint), so no library links
//    -lcuda;
//  * wgmma: shared-memory matrix descriptors for the 128-byte swizzle, and
//    m64n128k16 and m64n256k16 (both operands in shared memory) and
//    m64n64k16 (A in registers) bf16 -> f32 products, m64n128k32 and
//    m64n256k32 s8 -> s32 products (both operands K-major in shared memory),
//    with their fence, commit and wait;
//  * programmatic dependent launch: the signal that lets the dependent
//    launch start, and the wait for the grids a launch depends on;
//  * the async-proxy fence that makes threads' shared-memory writes visible
//    to wgmma; setmaxnreg for warp-specialised blocks; the once-per-device
//    opt-in to more than 48 KB of dynamic shared memory;
//  * q_at, an int8 value to f32 exactly through a byte permute (the
//    dequantizing kernels' way past the slower int-to-float unit).
//
// Layouts. A 128-byte-swizzled tile stores each row of 64 bf16 (128 bytes)
// with its 16-byte chunk c at chunk position c ^ (row % 8); the pattern
// repeats every 8 rows (1024 bytes), so every tile starts on a 1024-byte
// boundary. TMA writes that layout when its map asks for
// CU_TENSOR_MAP_SWIZZLE_128B with a 64-element inner box.
//  * K-major operand (rows = M or N, 64 K values per row): descriptor SBO =
//    1024 (the next 8 rows); LBO unused; the k16 step k starts 32 * k bytes
//    into the row (the swizzle is applied to the address, so the offset
//    stays inside the 1024-byte pattern's phase).
//  * MN-major operand (rows = K, 64 M or N values per row; wgmma's
//    transpose bit set): SBO = 1024 (the next 8 K rows), LBO = the distance
//    between 64-wide column blocks along M or N; the k16 step k starts
//    2048 * k bytes in.
// The accumulator of m64nN: thread t of the warpgroup holds rows
// 16 * (t / 32) + (t % 32) / 4 and that + 8; element 4j + e (e < 2) is the
// first row at column 8j + 2 (t % 4) + e, element 4j + 2 + e the second.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace owk_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to the
// other threads; the caller then synchronises the block
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();   // ~10 s: a pipeline fault, not a wait
}

// the same wait with cluster-scope acquire: for phases that other blocks of
// the cluster complete (st_async, a peer's arrive)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// -- clusters ------------------------------------------------------------------

// the cluster barrier in two halves: every thread of every block of the
// cluster arrives (release: its block's writes so far, barrier inits
// included, are visible to the cluster) and later waits (acquire), before it
// exits; the halves may sit far apart, so the barrier costs little
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// the same without the release: enough at a kernel's start, where the one
// write the others need, the barrier inits, is already released by
// fence_barrier_init; a release there costs a launch time (kernel_times.py
// --ablate, variant release-arrive)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of `addr` (a shared::cta address) in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// arrive on an mbarrier of another block of the cluster (`bar` from map_rank);
// the default .release.cta: a cluster-scope release here waits for the
// warp's wgmma still in flight and serialises a pipeline
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// store 16 bytes into another block's shared memory (`addr` and `bar` from
// map_rank); the bytes count against `bar`'s expected transaction
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// full / empty mbarrier pairs of a ring of kStages stages, at bars: full[s],
// then empty[s]; step i uses stage i % kStages
template <int kStages>
struct StageRing {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full(int i) const { return bars + 8 * (i % kStages); }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return bars + 8 * (kStages + i % kStages);
  }
  // step i's slot holds data (consumer side)
  __device__ __forceinline__ void wait_full(int i) const { mbar_wait(full(i), (i / kStages) & 1); }
  // step i's slot is free again (producer side; the first round is free)
  __device__ __forceinline__ void wait_empty(int i) const {
    if (i >= kStages) mbar_wait(empty(i), ((i / kStages) & 1) ^ 1);
  }
  // one arrival per warp, after the whole warp is done with step i's slot
  __device__ __forceinline__ void arrive_warp(uint32_t bar) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(bar);
  }
};

// -- programmatic dependent launch -------------------------------------------

// let the launch that depends on this one start (its blocks run up to their
// pdl_sync while this grid finishes)
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// wait until the grids this one depends on have completed and their writes
// are visible (a no-op for a launch without the dependent-launch attribute)
__device__ __forceinline__ void pdl_sync() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// -- TMA -------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `n` threads, a multiple of 32
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// fetch a tensor map (a __grid_constant__ kernel parameter) ahead of its first load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the 2-D tile load into the same shared offset of every block of the cluster
// in `mask`, completing on the mbarrier at the same offset in each
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// threads' shared-memory writes -> visible to wgmma and TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma -----------------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand starting at shared address `addr`
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// warp-specialised kernels: hand registers from the producer warpgroup to the
// consumers (every warp of a warpgroup executes it; the count is a multiple of 8)
template <int kRegs>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// keep the compiler from moving reads of accumulators across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, f32) = A (64 x 16, bf16, K-major, shared) * B (16 x 128, bf16,
// shared; K-major when kTransB is 0, MN-major when 1) + (scale_d ? D : 0)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a_desc,
                                                    uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(kTransB));
}

// the same with D = A * B: the accumulator is only written (scale-d 0), so
// no earlier value of it has to be kept in the registers it lands in
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss_first(float (&d)[64], uint64_t a_desc,
                                                          uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(0), "n"(kTransB));
}

// D (64 x 256, f32) = A (64 x 16, bf16, K-major, shared) * B (16 x 256, bf16,
// shared; K-major when kTransB is 0, MN-major when 1) + (scale_d ? D : 0): per
// k16 half the shared-memory reads of A that two m64n128k16 need
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t a_desc,
                                                    uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(kTransB));
}

// the same with D = A * B (scale-d 0, the accumulator only written)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16_ss_first(float (&d)[128], uint64_t a_desc,
                                                          uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]),
        "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]),
        "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]),
        "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]),
        "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]),
        "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]),
        "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]),
        "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]), "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]),
        "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(0), "n"(kTransB));
}

// D (64 x 64, f32) = A (64 x 16, bf16, registers) * B (16 x 64, bf16, shared)
// + (scale_d ? D : 0). Thread t's four A registers hold two bf16 each (the
// lower column first): rows r = 16 (t / 32) + (t % 32) / 4 and r + 8 at
// columns 2 (t % 4) + {0, 1} in a[0] and a[1], and at 8 + 2 (t % 4) + {0, 1}
// in a[2] and a[3]: the accumulator's own layout, so an m64nN result packs
// straight into the next product's A operand.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d),
        "n"(kTransB));
}

// D (64 x 128, s32) = A (64 x 32, s8, K-major, shared) * B (32 x 128, s8,
// K-major, shared) + (scale_d ? D : 0). For 8-bit operands wgmma takes
// K-major layouts only (no transpose bits); the s32 sums are exact.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64], uint64_t a_desc,
                                                    uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// the same with D = A * B (scale-d 0, the accumulator only written)
__device__ __forceinline__ void wgmma_m64n128k32_s8_first(int32_t (&d)[64], uint64_t a_desc,
                                                          uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]), "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]), "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31]),
        "=r"(d[32]), "=r"(d[33]), "=r"(d[34]), "=r"(d[35]), "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]),
        "=r"(d[40]), "=r"(d[41]), "=r"(d[42]), "=r"(d[43]), "=r"(d[44]), "=r"(d[45]), "=r"(d[46]), "=r"(d[47]),
        "=r"(d[48]), "=r"(d[49]), "=r"(d[50]), "=r"(d[51]), "=r"(d[52]), "=r"(d[53]), "=r"(d[54]), "=r"(d[55]),
        "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]), "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(0));
}

// D (64 x 256, s32) = A (64 x 32, s8, K-major, shared) * B (32 x 256, s8,
// K-major, shared) + (scale_d ? D : 0). For 8-bit operands wgmma takes
// K-major layouts only (no transpose bits); the s32 sums are exact.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int32_t (&d)[128], uint64_t a_desc,
                                                    uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// the same with D = A * B (scale-d 0, the accumulator only written)
__device__ __forceinline__ void wgmma_m64n256k32_s8_first(int32_t (&d)[128], uint64_t a_desc,
                                                          uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]), "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]), "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31]),
        "=r"(d[32]), "=r"(d[33]), "=r"(d[34]), "=r"(d[35]), "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]),
        "=r"(d[40]), "=r"(d[41]), "=r"(d[42]), "=r"(d[43]), "=r"(d[44]), "=r"(d[45]), "=r"(d[46]), "=r"(d[47]),
        "=r"(d[48]), "=r"(d[49]), "=r"(d[50]), "=r"(d[51]), "=r"(d[52]), "=r"(d[53]), "=r"(d[54]), "=r"(d[55]),
        "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]), "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63]),
        "=r"(d[64]), "=r"(d[65]), "=r"(d[66]), "=r"(d[67]), "=r"(d[68]), "=r"(d[69]), "=r"(d[70]), "=r"(d[71]),
        "=r"(d[72]), "=r"(d[73]), "=r"(d[74]), "=r"(d[75]), "=r"(d[76]), "=r"(d[77]), "=r"(d[78]), "=r"(d[79]),
        "=r"(d[80]), "=r"(d[81]), "=r"(d[82]), "=r"(d[83]), "=r"(d[84]), "=r"(d[85]), "=r"(d[86]), "=r"(d[87]),
        "=r"(d[88]), "=r"(d[89]), "=r"(d[90]), "=r"(d[91]), "=r"(d[92]), "=r"(d[93]), "=r"(d[94]), "=r"(d[95]),
        "=r"(d[96]), "=r"(d[97]), "=r"(d[98]), "=r"(d[99]), "=r"(d[100]), "=r"(d[101]), "=r"(d[102]), "=r"(d[103]),
        "=r"(d[104]), "=r"(d[105]), "=r"(d[106]), "=r"(d[107]), "=r"(d[108]), "=r"(d[109]), "=r"(d[110]), "=r"(d[111]),
        "=r"(d[112]), "=r"(d[113]), "=r"(d[114]), "=r"(d[115]), "=r"(d[116]), "=r"(d[117]), "=r"(d[118]), "=r"(d[119]),
        "=r"(d[120]), "=r"(d[121]), "=r"(d[122]), "=r"(d[123]), "=r"(d[124]), "=r"(d[125]), "=r"(d[126]), "=r"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// int8 x4 -> f32 x4 exactly: `biased` is four int8 values XOR 0x80808080
// (each + 128 as a byte); byte k lands in the mantissa of 2^23
__device__ __forceinline__ float q_at(uint32_t biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + k)) - 8388736.0f;
}

// -- host: tensor maps -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once per library (static:
// internal linkage, no symbol shared between the kernel libraries)
static EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map a row-major tensor for tile loads: dims[0] is the contiguous axis (in
// elements), strides[i] the byte stride of axis i + 1, box the tile in
// elements. Elements outside the tensor load as zero. Returns 0 or a
// cudaError_t.
static int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult rc = fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
                         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Let `kernel` use `bytes` of dynamic shared memory on the current device,
// asking the runtime once per device and library (`done` is the caller's
// own flag word: one bit per device).
template <class Kernel>
static int allow_smem(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done & bit)) return 0;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) done |= bit;
  return static_cast<int>(rc);
}

}  // namespace owk_sm90
