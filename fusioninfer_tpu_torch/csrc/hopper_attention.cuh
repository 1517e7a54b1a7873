// Shared machinery of the Hopper (sm_90a) attention kernels:
// csrc/flash_attention.cu, csrc/paged_window_attention.cu and (its
// mbarriers, bulk copies and cluster wrappers) csrc/paged_attention.cu.
//
// PTX wrappers (mbarrier, TMA and bulk copies, cp.async into an mbarrier,
// cluster rank, barrier and distributed shared memory reads, named
// barriers, wgmma and its fences, setmaxnreg), the wgmma shared-memory
// descriptors of the 128-byte-swizzled layout, the host-side tensor-map
// encoder, the fold of split partials, and the consumer side that both
// kernels share.  A consumer warpgroup owns 64 query rows and walks a ring
// of K/V stages that a producer fills: for each stage it waits on the
// stage's "full" mbarrier, runs S = Q K^T as wgmma m64nBKk16 from shared
// memory, applies the K scale and the mask (only on tiles that need one),
// updates the online softmax in f32 registers (base 2), runs O += P V as
// wgmma m64nHDk16 with P from registers, and arrives on the stage's "empty"
// mbarrier.  Two loops order this work: consume (one warpgroup,
// software-pipelined) and consume_pingpong (two warpgroups taking turns on
// the tensor cores).  The kernels differ only in their producers and their
// masks.
//
// Tile layout in shared memory (what TMA's 128-byte swizzle writes and
// wgmma's SWIZZLE_128B descriptors read): a tile of R rows and HD bf16
// columns is HD / 64 column blocks [R][64], each row 128 bytes, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8), every block
// 1024-byte aligned.  Q and K are read K-major (along the head dim), V
// MN-major (transposed by the descriptor).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG_THREADS = 128;
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and announce the bytes that async copies will deliver to this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of the given parity has completed.  A wait that
// never ends (a fault in the ring's protocol) traps after 2^24 tries, so
// it surfaces as a failed launch rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// -- thread-block clusters ------------------------------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the two halves of cluster_sync: a block may arrive and leave without
// waiting, while the blocks that stay wait for every block's arrival
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// every thread of every block of the cluster: writes to shared memory before
// it are visible to the whole cluster after it
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the address of `p` (in this block's shared memory) in block `rank`'s
// shared memory, for ld.shared::cluster
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// One arrival on the mbarrier at `bar`'s place in block `rank`'s shared
// memory, releasing at cluster scope what this thread has written (and,
// after a block barrier, what its block has): the waiter's acquire
// (mbar_wait_cluster) then sees it through ld.shared::cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_map(bar, rank))
               : "memory");
}

// mbar_wait with cluster-scope acquire: the phase's remote arrivals'
// writes are visible after it; traps after 2^24 tries, as mbar_wait
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// -- copies -----------------------------------------------------------------------

// tensor-map tile load into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// contiguous bytes (a multiple of 16, both ends 16-byte aligned) into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 (or 4) bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
// (counted in the barrier's arrival count: no increment)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// order this thread's generic-proxy view of shared memory before later
// async-proxy accesses (wgmma operands written by threads or by cp.async)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk `c` (of HD / 8) of row `r` in a swizzled
// tile of `rows` rows
__device__ __forceinline__ int swizzled(int rows, int r, int c) {
  return (c >> 3) * rows * ROW_BYTES + r * ROW_BYTES + (((c & 7) ^ (r & 7)) << 4);
}

// -- warpgroup roles ----------------------------------------------------------------

// named barrier `id` (1..15; 0 is __syncthreads) over `n` threads
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- wgmma --------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma region
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// SWIZZLE_128B shared-memory matrix descriptor
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major operand (Q, or K as B of Q K^T): k-step kk (16 columns) of a
// swizzled tile of `rows` rows; 8-row groups are 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * rows * ROW_BYTES + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (V as B of P V): k-step kk (16 keys) of a swizzled tile
// of `rows` keys; the 64-column blocks are rows * 128 bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return desc(tile + kk * 16 * ROW_BYTES, rows * ROW_BYTES, 1024);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D (+)= A B: A [64 x 16] and B [16 x 64] from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D = A B (a first k-step: D's old value is dead), operands as in ss
  static __device__ __forceinline__ void ss0(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
          "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
          "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(a), "l"(b), "r"(0));
  }
  // D (+)= A B: A [64 x 16] from registers, B [16 x 64] from shared memory, MN-major
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // D (+)= A B: A [64 x 16] and B [16 x 128] from shared memory, both K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D = A B (a first k-step: D's old value is dead), operands as in ss
  static __device__ __forceinline__ void ss0(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
          "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
          "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
          "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
          "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]),
          "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]),
          "=f"(d[63])
        : "l"(a), "l"(b), "r"(0));
  }
  // D (+)= A B: A [64 x 16] from registers, B [16 x 128] from shared memory, MN-major
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
};

// -- the consumer side ----------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the MUFU unit, flushing subnormal results to zero (a weight below
// 2^-126 of the row's max is zero in f32 sums anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A consumer warpgroup's state for its 64 rows.  This thread holds rows
// row(0) and row(1) and, of each, columns col(j, e) = 8j + 2(lane % 4) + e
// of the wgmma accumulator layout: o[4j + 2i + e] is (row(i), col(j, e)).
template <int HD>
struct RowState {
  float o[HD / 2];
  float m[2];  // running max of the scaled scores, base-2 units
  float l[2];  // this thread's share of the row sums (quad-summed at the end)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
  // row (0..63) of the warpgroup's tile held as row i of this thread
  static __device__ __forceinline__ int row(int i) {
    return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * i;
  }
  static __device__ __forceinline__ int col(int j, int e) {
    return 8 * j + 2 * (threadIdx.x & 3) + e;
  }
};

// Bytes of one K/V ring stage: K then V, each a swizzled [BK] x [HD] tile,
// then (int8 pages) the BK K scales and the BK V scales.
template <int HD, int BK, bool Q8>
__host__ __device__ constexpr int stage_bytes() {
  return round_up(2 * BK * HD * 2 + (Q8 ? 2 * BK * 4 : 0), 1024);
}

// Q K^T of one key tile into the score accumulators s (issued and
// committed, not waited for).
template <int HD, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q, uint32_t k) {
  wgmma_fence();
  Wgmma<BK>::ss0(s, kmajor_desc(q, 64, 0), kmajor_desc(k, BK, 0));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    Wgmma<BK>::ss(s, kmajor_desc(q, 64, kk), kmajor_desc(k, BK, kk), 1);
  wgmma_commit();
}

// O += P V of one key tile, P from registers (issued and committed).
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) Wgmma<HD>::rs(o, pa[kk], mnmajor_desc(v, BK, kk), 1);
  wgmma_commit();
}

// The online softmax of one tile of raw scores s (keys k0 ..): K scale,
// mask (only where `mask.masked(k0)`; then `mask.keep(i, key)` per
// score), running max and row sums in base 2; s becomes P (times the V
// scale).  Returns in alpha the factor the output must be rescaled by once
// the previous tile's P V has landed.
template <int HD, int BK, bool Q8, class Mask>
__device__ __forceinline__ void softmax_tile(RowState<HD>& st, float (&s)[BK / 2],
                                             const float* ks, const float* vs, float scale2,
                                             const Mask& mask, int k0, float (&alpha)[2]) {
  using St = RowState<HD>;
  if (Q8) {  // the K scale multiplies the score after Q K^T
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] *= ks[St::col(j, e & 1)];
  }
  if (mask.masked(k0)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!mask.keep(e >> 1, k0 + St::col(j, e & 1))) s[4 * j + e] = -INFINITY;
  }
  // the scale is positive: the max of the raw scores scales to the max
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(st.m[i], quad_max(mx[i]) * scale2);
    mu[i] = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
    alpha[i] = fast_exp2(st.m[i] - mu[i]);
    st.m[i] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[4 * j + e], scale2, -mu[e >> 1]));
      sum[e >> 1] += p;
      // the V scale weights P V, not the row sum
      s[4 * j + e] = Q8 ? p * vs[St::col(j, e & 1)] : p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * alpha[i] + sum[i];
}

// P to bf16 in wgmma's A-register layout, which is the score accumulator's
// layout: registers 8kk .. 8kk + 7 hold keys 16kk .. 16kk + 15
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int HD>
__device__ __forceinline__ void rescale(RowState<HD>& st, const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[4 * j + e] *= alpha[e >> 1];
}

// The consumer main loops walk key tiles j_lo .. j_hi - 1 from a ring of
// NS stages: tile it from j_lo is the ring's it0 + it-th, in stage
// (it0 + it) % NS, phase ((it0 + it) / NS) & 1, where it0 counts the
// tiles of earlier work items of a persistent block.  A
// stage is released (one arrival per warpgroup on its "empty" barrier)
// once its P V has landed.  `mask.gathered(k0)` says whether a tile was
// written by cp.async rather than TMA, which needs a proxy fence before
// wgmma reads it.  Both loops keep every wgmma_wait count static, so ptxas
// never serialises the wgmmas.
template <int HD, int BK, int NS, bool Q8, class Mask>
struct Ring {
  static constexpr int SB = stage_bytes<HD, BK, Q8>();
  static constexpr int TILE = BK * HD * 2;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int j_lo, it0;
  const Mask& mask;

  __device__ __forceinline__ unsigned char* stage(int it) const {
    return ring + (it0 + it) % NS * SB;
  }
  // wait for tile it, issue its Q K^T into s
  __device__ __forceinline__ void start_qk(float (&s)[BK / 2], uint32_t q, int it) const {
    mbar_wait(full + (it0 + it) % NS, ((it0 + it) / NS) & 1);
    if (mask.gathered((j_lo + it) * BK)) fence_proxy_async();
    issue_qk<HD, BK>(s, q, smem_u32(stage(it)));
  }
  __device__ __forceinline__ uint32_t v(int it) const { return smem_u32(stage(it) + TILE); }
  __device__ __forceinline__ const float* scales(int it) const {
    return reinterpret_cast<const float*>(stage(it) + 2 * TILE);
  }
  __device__ __forceinline__ void release(int it) const {
    if (threadIdx.x % WG_THREADS == 0) mbar_arrive(empty + (it0 + it) % NS);
  }
  __device__ __forceinline__ void softmax(RowState<HD>& st, float (&s)[BK / 2], int it,
                                          float scale2, float (&alpha)[2]) const {
    softmax_tile<HD, BK, Q8>(st, s, scales(it), scales(it) + BK, scale2, mask,
                             (j_lo + it) * BK, alpha);
  }
};

// One warpgroup alone, software-pipelined: tile it + 1's Q K^T is issued
// before tile it's P V, so the softmax of tile it + 1 runs while the
// tensor cores do tile it's P V.  Holds S, P and O at once (BK = 64 at
// Hd 128), and needs three stages to keep a load in flight.
template <int HD, int BK, int NS, bool Q8, class Mask>
__device__ __forceinline__ void consume(RowState<HD>& st, uint32_t q, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int j_lo, int j_hi,
                                        float scale2, const Mask& mask, int it0 = 0) {
  const Ring<HD, BK, NS, Q8, Mask> r{ring, full, empty, j_lo, it0, mask};
  const int n = j_hi - j_lo;
  if (n <= 0) return;
  uint32_t pa[BK / 16][4];
  float alpha[2];
  {
    float s[BK / 2];
    r.start_qk(s, q, 0);
    wgmma_wait<0>();
    fence_regs(s);
    r.softmax(st, s, 0, scale2, alpha);
    pack_p<BK>(pa, s);
  }
  // every iteration commits two groups, so wait<1> retires the Q K^T
  for (int it = 0; it + 1 < n; ++it) {
    float s[BK / 2];
    r.start_qk(s, q, it + 1);
    issue_pv<HD, BK>(st.o, pa, r.v(it));
    wgmma_wait<1>();  // the Q K^T; the P V may still run
    fence_regs(s);
    r.softmax(st, s, it + 1, scale2, alpha);
    wgmma_wait<0>();
    fence_regs(st.o);
    r.release(it);
    rescale(st, alpha);
    pack_p<BK>(pa, s);
  }
  issue_pv<HD, BK>(st.o, pa, r.v(n - 1));
  wgmma_wait<0>();
  fence_regs(st.o);
  r.release(n - 1);
}

// Two warpgroups (wg 0 and 1, the same tiles) taking turns on the tensor
// cores, as FlashAttention-3's ping-pong: in its turn a warpgroup issues
// tile it's Q K^T and tile it - 1's P V and passes the turn (named
// barriers 1 and 2), so its softmax runs while the other warpgroup's
// products do.  With OVERLAP the two products go back to back and the
// softmax of tile it also overlaps this warpgroup's own P V (S, P and O
// live at once: BK = 128 fits the 168 registers of a three-warpgroup
// block only where little else is live).  Without it P V lands before
// Q K^T is issued, so S and P are never live together.
template <int HD, int BK, int NS, bool Q8, bool OVERLAP, class Mask>
__device__ __forceinline__ void consume_pingpong(RowState<HD>& st, int wg, uint32_t q,
                                                 unsigned char* ring, uint64_t* full,
                                                 uint64_t* empty, int j_lo, int j_hi,
                                                 float scale2, const Mask& mask, int it0 = 0) {
  const Ring<HD, BK, NS, Q8, Mask> r{ring, full, empty, j_lo, it0, mask};
  const int n = j_hi - j_lo;  // >= 1, the same for both warpgroups
  uint32_t pa[BK / 16][4];
  float alpha[2];
  const int mine = 1 + wg, other = 2 - wg;
  if (wg == 1) named_arrive(other, 2 * WG_THREADS);  // warpgroup 0 goes first
  named_sync(mine, 2 * WG_THREADS);
  {
    float s[BK / 2];
    r.start_qk(s, q, 0);
    named_arrive(other, 2 * WG_THREADS);
    wgmma_wait<0>();
    fence_regs(s);
    r.softmax(st, s, 0, scale2, alpha);
    pack_p<BK>(pa, s);
  }
  for (int it = 1; it < n; ++it) {
    float s[BK / 2];
    named_sync(mine, 2 * WG_THREADS);
    if constexpr (OVERLAP) {
      r.start_qk(s, q, it);
      issue_pv<HD, BK>(st.o, pa, r.v(it - 1));
      named_arrive(other, 2 * WG_THREADS);
      wgmma_wait<1>();  // the Q K^T; the P V may still run
      fence_regs(s);
      r.softmax(st, s, it, scale2, alpha);
      wgmma_wait<0>();
      fence_regs(st.o);
      r.release(it - 1);
    } else {
      issue_pv<HD, BK>(st.o, pa, r.v(it - 1));
      wgmma_wait<0>();
      fence_regs(st.o);
      r.release(it - 1);
      r.start_qk(s, q, it);
      named_arrive(other, 2 * WG_THREADS);
      wgmma_wait<0>();
      fence_regs(s);
      r.softmax(st, s, it, scale2, alpha);
    }
    rescale(st, alpha);
    pack_p<BK>(pa, s);
  }
  named_sync(mine, 2 * WG_THREADS);
  issue_pv<HD, BK>(st.o, pa, r.v(n - 1));
  if (wg == 0) named_arrive(other, 2 * WG_THREADS);  // warpgroup 1 has no turn left to pass
  wgmma_wait<0>();
  fence_regs(st.o);
  r.release(n - 1);
}

// The fixed fold of split partials (natural-log units), as the plain
// combine_kvsplit_partials (ops/paged_attention.py) folds them: (m, l, a)
// absorbs the next chunk's or rank's (mc, lc, ac); -inf - -inf is guarded.
// The page walks' cluster merge and the query-window kernel's combine fold
// with it, left to right.
__device__ __forceinline__ void fold(float& m, float& l, float* a, int n, float mc, float lc,
                                     const float* ac) {
  const float m_new = fmaxf(m, mc);
  const bool dead = m_new == -INFINITY;
  const float alpha = dead ? 0.f : expf(m - m_new);
  const float beta = dead ? 0.f : expf(mc - m_new);
  l = alpha * l + beta * lc;
  for (int i = 0; i < n; ++i) a[i] = alpha * a[i] + beta * ac[i];
  m = m_new;
}

// -- host: tensor maps ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled map of rank `rank` over `base`: dims innermost first, byte strides
// of dims 1.., the box.  Out-of-range elements of a box read as zeros.
// Returns 0 or a cudaError_t.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, elem_strides,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
