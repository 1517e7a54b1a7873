// Row-invariant GEMM for Hopper (sm_90a): y[M, N] = x[M, K] @ w[K, N].
//
// Replaces no TPU kernel: the JAX package leaves its projections to XLA.
// It was added because cuBLAS picks its kernel and its split of K by the
// row count M, so a row's output bits could change with the batch it rode
// in (decode rows beside a prefill chunk, a speculative window against a
// plain decode row).  Here each output element is reduced over K in one
// order that depends on (N, K) alone:
//
// * every 64 rows x 128 columns are run by one consumer warpgroup as
//   wgmma m64n128k16 chains, rows padded to 64 (the TMA box zero-fills
//   rows past M; a warpgroup wholly past M issues no wgmma), so row r of
//   an M = 1 call and of an M = 3000 call run the same instructions on the
//   same operands.  A block holds one such warpgroup (64-row tiles, up to
//   64 rows: two blocks an SM stream the weight) or two sharing each w
//   tile (128-row tiles, more rows: half the w reads per FLOP);
// * the split of K into `splits` ranges of whole 64-deep blocks is chosen
//   by the caller from (N, K) alone (ops/gemm.py::split_k); each range is
//   accumulated by wgmma m64n128k16 in k order, in f32 registers;
// * with splits > 1 the ranges' f32 partials are added in range order
//   0, 1, ...  Where the tiles alone fill the card (many rows), one block
//   runs all of a tile's ranges and folds each range's accumulator into a
//   running sum in registers as it ends.  Where they do not (decode rows),
//   each range is its own block: it stores its partial, and the last
//   block of a tile to finish (an atomic count per tile) adds the partials
//   in range order from memory, whatever order they finished in; its
//   threads each take four columns of a row and issue all of that
//   element's partial loads before the ordered adds.  Both folds are the
//   same f32 adds in the same order, so the bits do not depend on which
//   one ran.
//
// x and w are bf16, x [M, K] row-major, w [K, N] row-major (the JAX
// [in, out] layout; wgmma reads the 16-bit B operand MN-major through its
// transpose bit, so no transposed copy).  y is bf16 from the f32 sum.
//
// What bounds it on an H100: at decode (M <= 64) the product streams the
// weights once (2 K N bytes for 2 M K N FLOP, far below the 295 FLOP/byte
// ridge), so it is bound by bytes; the split of K exists to put ~132
// blocks on the card when N / 128 alone gives few.  At prefill M it is
// bound by the tensor cores.  The design: one producer warp keeps a ring
// of (x, w) tiles in flight by TMA with mbarriers (four stages with one
// consumer warpgroup, six with two); the consumers run wgmma from shared
// memory, each keeping one group in flight while the next stage is
// issued.

#include "hopper_attention.cuh"

namespace {

using namespace hopper;

constexpr int BN = 128;               // columns per tile (one wgmma N)
constexpr int BK = 64;                // K per ring stage
constexpr int B_BYTES = BK * BN * 2;  // two swizzled [64 k][64 n] blocks
constexpr int MAX_SPLITS = 16;

// NC consumer warpgroups of 64 rows each (1 or 2)
template <int NC>
struct Cfg {
  static constexpr int BM = 64 * NC;            // rows per tile
  static constexpr int NS = NC == 1 ? 4 : 6;    // ring stages
  static constexpr int A_BYTES = BM * BK * 2;   // one swizzled [BM][64] block
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = NS * STAGE + 2 * NS * 8 + 16 + 1024;  // + barriers, flag, align
  static constexpr int CONSUMERS = NC * WG_THREADS;
  static constexpr int NTHREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 2 : 1;
};

// D (+)= A B, m64n128k16: A K-major and B MN-major, both from shared memory
__device__ __forceinline__ void mma_ss_tb(float (&d)[64], uint64_t a, uint64_t b) {
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
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Grid (m tiles, n tiles, splits) or (m tiles, n tiles, 1).  Block (mt,
// nt, s) accumulates rows [128 mt, 128 mt + 128) x columns [128 nt, 128 nt
// + 128) over the K blocks of range s, [s * per, min(kb, (s + 1) * per));
// with one block a tile it runs every range in turn.
template <int NC>
__global__ void __launch_bounds__(Cfg<NC>::NTHREADS, Cfg<NC>::BLOCKS_PER_SM)
gemm_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
            __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int* __restrict__ counts,
            int M, int N, int kb, int per) {
  using C = Cfg<NC>;
  constexpr int BM = C::BM, NS = C::NS, A_BYTES = C::A_BYTES, STAGE = C::STAGE;
  constexpr int CONSUMERS = C::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NS * STAGE);
  uint64_t* empty = full + NS;
  int* last_flag = reinterpret_cast<int*>(empty + NS);
  const int mt = blockIdx.x, nt = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int k_lo = split * per, k_hi = splits > 1 ? min(kb, k_lo + per) : kb;
  const int n_it = k_hi - k_lo;
  const bool fold_here = splits == 1 && per < kb;  // every range in this block

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp
    if (threadIdx.x == CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mw)) : "memory");
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(empty + s, ((it / NS) & 1) ^ 1);
        unsigned char* stage = smem + s * STAGE;
        const int k0 = (k_lo + it) * BK;
        mbar_arrive_expect_tx(full + s, STAGE);
        tma_load_2d(stage, &mx, full + s, k0, mt * BM);
        tma_load_2d(stage + A_BYTES, &mw, full + s, nt * BN, k0);
        tma_load_2d(stage + A_BYTES + BK * ROW_BYTES, &mw, full + s, nt * BN + 64, k0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows row(i) of its half, columns col(j, e) of
  // the accumulator; f is the running fold of the finished ranges when
  // they all run here.  A half wholly past M only keeps the ring's pace.
  const int wg = threadIdx.x / WG_THREADS;
  const bool live = mt * BM + wg * 64 < M;
  float d[64], f[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % NS;
    mbar_wait(full + s, (it / NS) & 1);
    if (live) {
      const uint32_t a = smem_u32(smem + s * STAGE) + wg * 64 * ROW_BYTES;
      const uint32_t b = smem_u32(smem + s * STAGE) + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_ss_tb(d, kmajor_desc(a, 64, kk), mnmajor_desc(b, BK, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group has retired
      fence_regs(d);
    }
    if (it > 0) mbar_arrive(empty + (it - 1) % NS);
    if (live && fold_here && ((it + 1) % per == 0 || it + 1 == n_it)) {  // a range ends
      wgmma_wait<0>();
      fence_regs(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        f[i] = it < per ? d[i] : f[i] + d[i];
        d[i] = 0.f;
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
  if (fold_here) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = f[i];
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = mt * BM + wg * 64 + warp * 16 + (lane >> 2);
  const int c0 = nt * BN + 2 * (lane & 3);
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j;
        if (c < N)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * N + c) =
              __floats2bfloat162_rn(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      }
    }
    return;
  }

  // split K: store this range's partial, then the tile's last block to
  // finish adds all partials in range order
  const size_t plane = (size_t)M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j;
      if (c < N)
        __stcg(reinterpret_cast<float2*>(ws + split * plane + (size_t)r * N + c),
               make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]));
    }
  }
  __threadfence();
  named_sync(1, CONSUMERS);
  int* count = counts + mt * gridDim.y + nt;
  if (threadIdx.x == 0) *last_flag = atomicAdd(count, 1) == splits - 1;
  named_sync(1, CONSUMERS);
  if (!*last_flag) return;
  __threadfence();
  const int rows = min(BM, M - mt * BM), quads = min(BN, N - nt * BN) / 4;
  for (int e = threadIdx.x; e < rows * quads; e += CONSUMERS) {
    const int r = mt * BM + e / quads, c = nt * BN + 4 * (e % quads);
    const float* p = ws + (size_t)r * N + c;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int t = 0; t < MAX_SPLITS; ++t)
      if (t < splits) v[t] = __ldcg(reinterpret_cast<const float4*>(p + t * plane));
    float4 acc = v[0];
#pragma unroll
    for (int t = 1; t < MAX_SPLITS; ++t) {
      if (t < splits) {
        acc.x += v[t].x;
        acc.y += v[t].y;
        acc.z += v[t].z;
        acc.w += v[t].w;
      }
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * N + c);
    o[0] = __floats2bfloat162_rn(acc.x, acc.y);
    o[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
  if (threadIdx.x == 0) *count = 0;  // ready for the next launch
}

template <int NC>
int launch(const void* x, const void* w, void* y, float* ws, int* counts, int M, int N, int K,
           int kb, int per, int blocks_z, cudaStream_t stream) {
  using C = Cfg<NC>;
  CUtensorMap mx, mw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {BK, C::BM};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t w_box[2] = {64, BK};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = encode_map(&mx, bf16, 2, x, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = encode_map(&mw, bf16, 2, w, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_attr_set = true;
  }
  const dim3 grid((M + C::BM - 1) / C::BM, (N + BN - 1) / BN, blocks_z);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gemm_kernel<NC><<<grid, C::NTHREADS, C::SMEM, stream>>>(
      mx, mw, static_cast<__nv_bfloat16*>(y), ws, counts, M, N, kb, per);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N], y [M, N] bf16, row-major, 16-byte aligned, K and N
// multiples of 8.  Up to 64 rows run in 64-row tiles, more in 128-row
// tiles.  With splits > 1, a ws of splits * M * N floats and counts of
// one int per tile (zero before the first launch; each launch leaves
// them zero) launch a block per range; ws NULL runs a tile's ranges in
// one block.  Returns a cudaError_t.
extern "C" int gemm_bf16(const void* x, const void* w, void* y, void* ws, void* counts, int M,
                         int N, int K, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int kb = (K + BK - 1) / BK;
  const int per = (kb + splits - 1) / splits;
  // every range holds at least one K block
  if ((splits - 1) * per >= kb || (ws != nullptr && counts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks_z = ws != nullptr ? splits : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(ws);
  int* c = static_cast<int*>(counts);
  if (M <= 64) return launch<1>(x, w, y, p, c, M, N, K, kb, per, blocks_z, st);
  return launch<2>(x, w, y, p, c, M, N, K, kb, per, blocks_z, st);
}
