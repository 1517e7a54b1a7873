// Row-invariant GEMM for Hopper (sm_90a): y[M, N] = x[M, K] @ w[K, N].
//
// Replaces no TPU kernel: the JAX package leaves its projections to XLA.
// It exists because cuBLAS picks its kernel and its split of K by the row
// count M, so a row's output bits could change with the batch it rode in
// (decode rows beside a prefill chunk, a speculative window against a
// plain decode row).  Here each output element is reduced over K in one
// order that depends on (N, K) alone, and every M runs the same adds:
//
// * K is split into `splits` ranges of whole 64-deep blocks, chosen by
//   the caller from (N, K) alone (ops/gemm.py::split_k); range s is
//   accumulated in f32 registers by wgmma m64nWk16 steps in k order from
//   zero (rows past M are never stored; a warpgroup wholly past M issues
//   no wgmma);
// * the ranges' partials are added in range order 0, 1, ...: the ranges
//   of a tile are the K ranks of one thread-block cluster; each rank
//   stages its f32 partial in its own shared memory, and after a cluster
//   barrier rank r folds columns [r W, (r + 1) W) of the tile (W = tile
//   columns / splits), reading every rank's partial through distributed
//   shared memory (ld.shared::cluster, eight loads in flight a thread) and
//   adding them in rank order.  No partial goes to device memory, and no
//   counter or atomic decides the order.
//
// The tile (64 x 64 or 64 x 128 rows x columns at up to 64 rows; 128 x
// 64, 128 x 128 or 128 x 256 above, alone or paired) changes which wgmma
// width W computes a column and which block loads what, never the adds of
// an element: each element is its own dot product in the tensor cores,
// the same at every W (chip_smoke.py phase 3 checks every row's bits at
// every M against the same row alone, across the tiles and pairings).
//
// x and w are bf16, x [M, K] row-major, w [K, N] row-major (the JAX
// [in, out] layout; wgmma reads the 16-bit B operand MN-major through its
// transpose bit, so no transposed copy).  y is bf16 from the f32 sum.
//
// What bounds it on an H100, and what the design does about it.
// * Decode rows (M <= 64) stream the weights once (2 K N bytes for 2 M K N
//   FLOP, far below the 295 FLOP/byte ridge): bound by bytes, which reach
//   the card's rate only when every SM streams an equal share with enough
//   bytes in flight.  64-row tiles two blocks an SM; the split of K makes
//   about 128 clusters' ranks of 64-column tiles; a stage holds only the
//   live x rows (M rounded up to 8), so the ring runs up to 16 stages deep
//   (6 where blocks share an SM: deeper was slower there); short K ranges
//   run two 64-deep blocks a stage (fewer, larger stages were faster:
//   tools/gemm_sweep.py times the tiles and splits).
// * Prefill rows would be bound by the tensor cores, but a 128 x 256
//   tile's 64-deep stage moves 48 KB into shared memory for 4.2 MFLOP, and
//   the kernel measured ~60 % of the 989 TFLOP/s bf16 rate with every
//   tile shape (the L2 -> shared memory path and the shared memory the
//   wgmma operands are read from).  So: 128 x 256 tiles (two consumer
//   warpgroups, each wgmma m64n256k16 into 128 f32 registers, which
//   setmaxnreg takes from a producer warpgroup); two row tiles with the
//   same columns may pair in the cluster and load their weight tile once,
//   each block half of it multicast to both (TMA .multicast::cluster), 32
//   KB a stage instead of 48; a persistent grid of as many clusters as the
//   card holds, each walking the output tiles with the m index fastest so
//   the tiles in flight share a few weight panels in L2.  The caller picks
//   tile and pairing by the rounds of that grid (ops/gemm.py::tile_shape).
// * One producer warp keeps a ring of (x, w) stages in flight by TMA with
//   mbarriers and runs ahead into the next tile while the consumers store
//   the last one (with one range a tile); a stage is free again once the
//   consumer warps of both blocks of a pair have arrived on it.  With
//   several ranges the top of the ring doubles as the fold's staging: the
//   producer loads the next tile's stages that lie below it, then waits
//   for the fold before it loads the rest.

#include "hopper_attention.cuh"

namespace {

using namespace hopper;

constexpr int BK = 64;          // K per ring stage
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int WN_MAX = 256;     // the widest wgmma N
// with two consumer warpgroups, the registers a thread of the producer
// warpgroup keeps and a consumer's (setmaxnreg; 128 x 40 + 256 x 232 fit
// the SM's 65536)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// NC consumer warpgroups of 64 rows each (1 or 2), BN columns, KB
// 64-deep K blocks a stage
template <int NC, int BN, int KB>
struct Cfg {
  static constexpr int BM = 64 * NC;                   // rows per tile
  static constexpr int WN = BN < WN_MAX ? BN : WN_MAX;  // one wgmma's columns
  static constexpr int W_BLOCK = KB * BK * ROW_BYTES;  // one swizzled [KB 64 k][64 n] block
  // the ring: two blocks an SM with one warpgroup, one with two; a stage
  // is KB swizzled [x rows][64] blocks of x and BN / 64 weight blocks,
  // so fewer live rows make more stages: at most MAX_NS, or SHARED_NS
  // where blocks share an SM (deeper rings there were slower at decode
  // rows: more requests queued for the same bytes)
  static constexpr int RING = (NC == 1 ? 96 : 192) * 1024;
  static constexpr int MAX_NS = 16, SHARED_NS = 6;
  static constexpr int LD = BN + 8;  // staged partial's row stride in floats (no bank conflicts)
  static constexpr int STAGED = BM * LD * 4;  // the staged partial, at the ring's top
  static constexpr int SMEM = RING + 2 * MAX_NS * 8 + 1024;  // + barriers, alignment
  static constexpr int CONSUMERS = NC * WG_THREADS;
  // + one producer warp; with two consumer warpgroups a producer
  // warpgroup, whose registers setmaxnreg hands to the consumers
  static constexpr int NTHREADS = CONSUMERS + (NC == 1 ? 32 : WG_THREADS);
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 2 : 1;
  static_assert(STAGED <= RING && STAGED % 16 == 0, "the staged partial fits in the ring");
  static_assert(BN % WN == 0 && BN % 64 == 0, "whole wgmma widths and weight blocks");
};

// this block's coordinates in its cluster, and the cluster's extent
__device__ __forceinline__ int cluster_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_y() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctaid.y;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_nx() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctaid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_ny() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctaid.y;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// one arrival on the mbarrier at `bar`'s offset in block `rank` of the
// cluster (CTA-scope release: what it orders is this warp's wgmma reads,
// complete before the arrival)
__device__ __forceinline__ void arrive_remote(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_map(bar, rank))
               : "memory");
}

// cluster_sync whose arrival orders nothing: for a barrier that only has
// to follow reads whose values this thread has already used
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cluster_wait();
}

// tensor-map tile load into the same shared-memory offset of every block
// in `mask`, completing on the mbarrier at `bar`'s offset in each
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// D += A B, m64nWNk16: A K-major and B MN-major, both from shared memory
template <int WN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Fold columns [rank W, (rank + 1) W) of a staged tile: for each 4-column
// group of a live row, rank 0's partial plus rank 1's, ... in rank order,
// read from ranks pair * S + s; to bf16.  Each thread keeps MAX_SPLITS
// remote loads in flight (MAX_SPLITS / S groups of S; 16 spilled).
template <int S, int CONSUMERS, int LD>
__device__ __forceinline__ void fold(const float* staged, int pair, int rank, int W,
                                     __nv_bfloat16* __restrict__ y, int N, int m0, int n0,
                                     int rows) {
  constexpr int B = MAX_SPLITS / S;
  uint32_t from[S];
#pragma unroll
  for (int s = 0; s < S; ++s) from[s] = cluster_map(staged, pair * S + s);
  const int quads = W / 4, total = rows * quads;
  for (int e0 = threadIdx.x; e0 < total; e0 += CONSUMERS * B) {
    float4 v[B][S];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int e = e0 + b * CONSUMERS;
      if (e < total) {
        const uint32_t off = (uint32_t)((e / quads) * LD + rank * W + 4 * (e % quads)) * 4;
#pragma unroll
        for (int s = 0; s < S; ++s) v[b][s] = ld_cluster4(from[s] + off);
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int e = e0 + b * CONSUMERS;
      const int r = e / quads, c = n0 + rank * W + 4 * (e % quads);
      if (e >= total || c >= N) continue;
      float4 acc = v[b][0];
#pragma unroll
      for (int s = 1; s < S; ++s) {
        acc.x += v[b][s].x;
        acc.y += v[b][s].y;
        acc.z += v[b][s].z;
        acc.w += v[b][s].w;
      }
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * N + c);
      o[0] = __floats2bfloat162_rn(acc.x, acc.y);
      o[1] = __floats2bfloat162_rn(acc.z, acc.w);
    }
  }
}

// Grid (S clusters, P) in clusters of S x P blocks: cluster x is the K
// rank (range s, blocks [s per, min(kb, (s + 1) per))), cluster y the
// place in a pair (P = 2) of row tiles that load their weight tile once.
// Cluster c runs units c, c + clusters, ...: unit u covers row tiles
// (u % m_groups) P + y and columns [BN (u / m_groups), + BN).
template <int NC, int BN, int KB>
__global__ void __launch_bounds__(Cfg<NC, BN, KB>::NTHREADS, Cfg<NC, BN, KB>::BLOCKS_PER_SM)
gemm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
            __nv_bfloat16* __restrict__ y, int M, int N, int kb, int per, int m_tiles,
            int n_tiles, int max_ns) {
  using C = Cfg<NC, BN, KB>;
  constexpr int BM = C::BM, WN = C::WN, LD = C::LD;
  constexpr int CONSUMERS = C::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING);
  uint64_t* empty = full + C::MAX_NS;
  const int S = cluster_nx(), P = cluster_ny(), rank = cluster_x(), pair = cluster_y();
  // this rank's K range: n_it 64-deep blocks (a multiple of KB) in n_st stages
  const int k_lo = rank * per, n_it = min(kb, k_lo + per) - k_lo, n_st = n_it / KB;
  const int m_groups = (m_tiles + P - 1) / P, units = m_groups * n_tiles;
  const int first = blockIdx.x / S, stride = gridDim.x / S;
  // a stage's x rows: the tile's, or M rounded up to 8 when that is fewer
  // (rows past them are never stored, so they need no zeros)
  const int x_rows = min(BM, (M + 7) / 8 * 8);
  const int x_block = x_rows * ROW_BYTES, a_bytes = KB * x_block;
  const int stage_bytes = a_bytes + BN / 64 * C::W_BLOCK;
  const int NS = min(max_ns, C::RING / stage_bytes);  // ring stages

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32 * P);  // every consumer warp of the pair
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (S * P > 1) cluster_sync();  // the cluster's barriers are set up before any remote use

  if (threadIdx.x >= CONSUMERS) {  // the producer warp (warpgroup)
    if constexpr (NC == 2) regs_dealloc<PRODUCER_REGS>();
    const bool leader = threadIdx.x == CONSUMERS;
    if (leader) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mw)) : "memory");
    }
    const uint16_t both = (uint16_t)((1u << rank) | (1u << (rank + S)));  // the pair, this K rank
    int s = 0, phase = 0, issued = 0;  // the ring's next stage, its phase
    // load stage i of unit u's K range into the ring's next stage
    auto load = [&](int u, int i) {
      const int m0 = ((u % m_groups) * P + pair) * BM, n0 = (u / m_groups) * BN;
      // weight blocks of the tile inside N (a block wholly past N is not
      // loaded: its columns are never stored); a pair splits them
      const int w_blocks = min(BN / 64, (N - n0 + 63) / 64);
      const int x_blocks = m0 < M ? KB : 0;
      if (issued++ >= NS) mbar_wait(empty + s, phase ^ 1);
      unsigned char* stage = smem + s * stage_bytes;
      const int k0 = (k_lo + i * KB) * BK;
      mbar_arrive_expect_tx(full + s, x_blocks * x_block + w_blocks * C::W_BLOCK);
      for (int j = 0; j < x_blocks; ++j)
        tma_load_2d(stage + j * x_block, &mx, full + s, k0 + j * BK, m0);
      for (int b = pair; b < w_blocks; b += P) {
        unsigned char* dst = stage + a_bytes + b * C::W_BLOCK;
        if (P > 1)
          tma_load_2d_multicast(dst, &mw, full + s, n0 + 64 * b, k0, both);
        else
          tma_load_2d(dst, &mw, full + s, n0 + 64 * b, k0);
      }
      if (++s == NS) {
        s = 0;
        phase ^= 1;
      }
    };
    int early = 0;  // K blocks of this unit loaded while the last one folded
    for (int u = first; u < units; u += stride) {
      if (leader)
        for (int i = early; i < n_st; ++i) load(u, i);
      early = 0;
      if (S > 1) {  // the consumers stage and fold in the ring's top: wait for them
        // first the next unit's leading stages that lie wholly below the
        // staged partial
        if (leader && u + stride < units)
          while (early < n_st && early < NS && (s + 1) * stage_bytes <= C::RING - C::STAGED)
            load(u + stride, early++);
        __syncwarp();
        cluster_sync();          // every rank's partial is staged
        cluster_sync_relaxed();  // and read
      }
    }
  } else {
    if constexpr (NC == 2) regs_alloc<CONSUMER_REGS>();
    // consumer warpgroup wg: rows row(i) of its 64, columns col(w, j) of
    // its accumulator d[w]; a warpgroup wholly past M only keeps the
    // ring's pace
    const int wg = threadIdx.x / WG_THREADS;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int row_in = wg * 64 + warp * 16 + (lane >> 2), col_in = 2 * (lane & 3);
    const int peer = rank + (1 - pair) * S;  // the pair's other block (P = 2)
    float* staged = reinterpret_cast<float*>(smem + C::RING - C::STAGED);
    // one arrival a warp on the stage's "empty" barrier of both blocks of
    // the pair, whose producers both write it
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(empty + s);
        if (P > 1) arrive_remote(empty + s, peer);
      }
    };
    int s = 0, phase = 0, last = 0;  // the ring's next stage, its phase; the last stage read
    for (int u = first; u < units; u += stride) {
      const int m0 = ((u % m_groups) * P + pair) * BM, n0 = (u / m_groups) * BN;
      const bool live = m0 + wg * 64 < M;
      float d[BN / WN][WN / 2];
#pragma unroll
      for (int w = 0; w < BN / WN; ++w)
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) d[w][i] = 0.f;
      for (int i = 0; i < n_st; ++i) {
        mbar_wait(full + s, phase);
        if (live) {
          const uint32_t a = smem_u32(smem + s * stage_bytes) + wg * 64 * ROW_BYTES;
          const uint32_t b = smem_u32(smem + s * stage_bytes) + a_bytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KB * BK / 16; ++kk)
#pragma unroll
            for (int w = 0; w < BN / WN; ++w)
              Mma<WN>::run(d[w], kmajor_desc(a, x_rows, kk),
                           mnmajor_desc(b + w * (WN / 64) * C::W_BLOCK, KB * BK, kk));
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's group has retired
#pragma unroll
          for (int w = 0; w < BN / WN; ++w) fence_regs(d[w]);
        }
        if (i > 0) release(last);
        last = s;
        if (++s == NS) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int w = 0; w < BN / WN; ++w) fence_regs(d[w]);
      release(last);

      if (S == 1) {  // the sum is this range's: store it
        if (!live) continue;
#pragma unroll
        for (int w = 0; w < BN / WN; ++w)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = m0 + row_in + 8 * i;
            if (r >= M) continue;
            __nv_bfloat16* yr = y + (size_t)r * N;
#pragma unroll
            for (int j = 0; j < WN / 8; ++j) {
              const int c = n0 + w * WN + 8 * j + col_in;
              if (c < N)
                *reinterpret_cast<__nv_bfloat162*>(yr + c) =
                    __floats2bfloat162_rn(d[w][4 * j + 2 * i], d[w][4 * j + 2 * i + 1]);
            }
          }
        continue;
      }

      // stage this range's partial in the ring once both warpgroups' last
      // wgmma has read it, then fold this rank's columns of the tile from
      // every rank's partial in rank order
      named_sync(1, CONSUMERS);
      if (live) {
#pragma unroll
        for (int w = 0; w < BN / WN; ++w)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < WN / 8; ++j)
              *reinterpret_cast<float2*>(staged + (row_in + 8 * i) * LD + w * WN + 8 * j +
                                         col_in) =
                  make_float2(d[w][4 * j + 2 * i], d[w][4 * j + 2 * i + 1]);
      }
      __syncwarp();
      cluster_sync();  // every rank's partial is staged
      const int rows = max(0, min(BM, M - m0)), W = BN / S;
      if (S == 2) fold<2, CONSUMERS, LD>(staged, pair, rank, W, y, N, m0, n0, rows);
      else if (S == 4) fold<4, CONSUMERS, LD>(staged, pair, rank, W, y, N, m0, n0, rows);
      else fold<8, CONSUMERS, LD>(staged, pair, rank, W, y, N, m0, n0, rows);
      fence_proxy_async();  // the ring's next TMA writes come after these accesses
      __syncwarp();
      cluster_sync_relaxed();  // every rank's partial is read: the ring is free
    }
  }
  if (P > 1) {  // no block leaves while its pair may still signal or fill it
    __syncwarp();
    cluster_sync();
  }
}

// Launch in clusters of splits x pair blocks on a persistent grid: as many
// clusters as fit on the card at once (asked of the card once per cluster
// shape, outside any CUDA-graph capture that later launches replay), at
// most one a unit.
template <int NC, int BN, int KB>
int launch(const void* x, const void* w, void* y, int M, int N, int K, int splits, int pair,
           cudaStream_t stream) {
  using C = Cfg<NC, BN, KB>;
  CUtensorMap mx, mw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {BK, (cuuint32_t)(M < C::BM ? (M + 7) / 8 * 8 : C::BM)};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t w_box[2] = {64, KB * BK};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = encode_map(&mx, bf16, 2, x, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode_map(&mw, bf16, 2, w, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  void (*kern)(const CUtensorMap, const CUtensorMap, __nv_bfloat16*, int, int, int, int, int,
               int, int) = gemm_kernel<NC, BN, KB>;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(C::NTHREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = pair;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int fit[MAX_SPLITS + 1][3] = {};  // clusters the card holds at once, by shape
  static int sms = 0;
  if (!fit[splits][pair]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3(splits, pair);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    fit[splits][pair] = clusters;
  }
  const int kb = (K + BK - 1) / BK, per = (kb + splits - 1) / splits;
  const int m_tiles = (M + C::BM - 1) / C::BM, n_tiles = (N + BN - 1) / BN;
  const long long units = (long long)((m_tiles + pair - 1) / pair) * n_tiles;
  if (units > (1 << 30)) return (int)cudaErrorInvalidValue;
  const unsigned clusters = (unsigned)(units < fit[splits][pair] ? units : fit[splits][pair]);
  cfg.gridDim = dim3(clusters * splits, pair);
  const int max_ns = (int)(clusters * splits * pair) > sms ? C::SHARED_NS : C::MAX_NS;
  return (int)cudaLaunchKernelEx(&cfg, kern, mx, mw, static_cast<__nv_bfloat16*>(y), M, N, kb,
                                 per, m_tiles, n_tiles, max_ns);
}

}  // namespace

// x [M, K], w [K, N], y [M, N] bf16, row-major, 16-byte aligned, K and N
// multiples of 8.  splits: the K ranges (1, 2, 4 or 8; every range holds
// a 64-deep block), the cluster's x extent; tile_rows x tile_cols: 64 x
// 64, 64 x 128, 128 x 64, 128 x 128 or 128 x 256, tile_cols a multiple of
// 4 splits (the fold's column slices); pair: 2 to pair 128-row tiles that
// load their weight tile once (the cluster's y extent; splits x pair at
// most 8), else 1.  Returns a cudaError_t.
extern "C" int gemm_bf16(const void* x, const void* w, void* y, int M, int N, int K, int splits,
                         int tile_rows, int tile_cols, int pair, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || splits < 1 || splits > MAX_SPLITS ||
      (splits & (splits - 1)) || tile_cols % (4 * splits) || pair < 1 || pair > 2 ||
      splits * pair > MAX_SPLITS || (pair == 2 && tile_rows != 128))
    return (int)cudaErrorInvalidValue;
  const int kb = (K + BK - 1) / BK, per = (kb + splits - 1) / splits;
  if ((splits - 1) * per >= kb) return (int)cudaErrorInvalidValue;  // an empty range
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the narrow decode tile streams two K blocks a stage where every range
  // holds an even number of them, at most 32: short ranges ran faster in
  // fewer, larger stages; long ones slower (the ring holds fewer stages)
  if (tile_rows == 64 && tile_cols == 64)
    return kb % 2 == 0 && per % 2 == 0 && per <= 32
               ? launch<1, 64, 2>(x, w, y, M, N, K, splits, pair, st)
               : launch<1, 64, 1>(x, w, y, M, N, K, splits, pair, st);
  if (tile_rows == 64 && tile_cols == 128)
    return launch<1, 128, 1>(x, w, y, M, N, K, splits, pair, st);
  if (tile_rows == 128 && tile_cols == 64)
    return launch<2, 64, 1>(x, w, y, M, N, K, splits, pair, st);
  if (tile_rows == 128 && tile_cols == 128)
    return launch<2, 128, 1>(x, w, y, M, N, K, splits, pair, st);
  if (tile_rows == 128 && tile_cols == 256)
    return launch<2, 256, 1>(x, w, y, M, N, K, splits, pair, st);
  return (int)cudaErrorInvalidValue;
}
