// Paged attention of query windows, written for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of fusioninfer_tpu/ops/paged_attention.py:
// paged_verify_attention (per-sequence windows of up to C queries) and
// paged_prefill_attention (one sequence's suffix of C queries, which is the
// verify window of a batch of one).
//
// q [B, C, H, Hd] bf16; pools [L, KV, n_pages, ps, Hd], bf16, or int8 with
// f32 scales [L, KV, n_pages, 1, ps]; page_tables [B, mp], starts / counts
// [B] int32.  Query i of sequence b sits at position starts[b] + i and
// attends causally (and within `window` when > 0) over that sequence's
// pages; rows i >= counts[b] are padding and come out as zeros, so
// counts[b] = 0 is an inactive slot.  out [B, C, H * Hd] bf16.
//
// What bounds it: verify at small C reads every live page byte once for a
// few queries each, so it is bound by bytes, and its few (tile, KV head,
// sequence) blocks each walk thousands of keys; prefill at C in the
// hundreds is bound by operations.  The design (shared parts in
// hopper_attention.cuh):
//
// * Rows: a tile's rows are (query, group head) pairs, row i * G + g for
//   query i and head g of the KV head's G query heads, as on the TPU, so
//   every K/V tile a block reads serves all G heads.  One consumer
//   warpgroup owns 64 rows; a block has two where C * G > 64 and one where
//   C * G <= 64 (verify), so a tile is not mostly padding.  Both products
//   run as wgmma (Q K^T m64nBKk16, P V m64nHDk16 with P from registers),
//   softmax statistics in f32 registers.  Two consumer warpgroups take
//   turns on the tensor cores (consume_pingpong) on 128-key tiles (64 with
//   int8 pages, for the raw ring's room), each letting its P V land before
//   it issues the next Q K^T: this consumer keeps more state live than
//   flash's, and with both products in flight it spills; one warpgroup
//   runs software-pipelined (consume) on 64-key tiles.
// * Key split: the key range is cut into fixed chunks of CHUNK positions;
//   the boundaries depend only on key position.  Each (tile, KV head,
//   sequence, chunk) is its own block.  A tile whose keys lie in one chunk
//   writes its output directly; otherwise every chunk's block writes f32
//   partials (acc, m, l) and window_combine_kernel folds them left to right
//   with the split walk's arithmetic (hopper::fold).  The result depends
//   only on the chunking, never on how many blocks ran, and verify's 64
//   blocks become ~4x as many with chains of at most CHUNK / BK tiles.
//   The scratch and the grid hold n_chunks slots per sequence, which the
//   caller sizes to the most chunks any live sequence's keys touch; slot 0
//   is the chunk of the sequence's first key (first_chunk), so a sliding
//   window costs the chunks it covers, not those below it.
// * Producer warpgroup (setmaxnreg lowers it to 40 registers), warp 0 the
//   loader.  Q comes by one 3-D TMA copy per 64-column block over q viewed
//   as [B*C][H][Hd] (box 64 / G queries x G heads), which lands the rows in
//   (query, head) order.  A K/V tile that lies whole in one page and ends
//   at or before the last key (page size a multiple of BK) comes by TMA
//   over the layer's pool viewed as rows [KV * n_pages * ps, Hd]: one copy
//   per page segment, one table lookup per tile.  Every other tile (page
//   sizes below BK, and the ragged last tile of a range) is gathered by the
//   same warp with cp.async, each key row finding its page, rows past the
//   last key zero-filled, into the same swizzled layout; each lane's copies
//   complete on the stage's "full" mbarrier (cp.async.mbarrier.arrive), and
//   the consumers fence the async proxy before wgmma reads such a tile.
//   So no byte past the last key, and no page past it, is ever read.
// * int8 pages: the loader stages raw int8 rows (TMA without swizzle, and
//   the tile's scales by bulk copy; or the gather) in a second ring, and
//   the producer's warps 1-3 widen them to bf16 into the swizzled stage
//   (exactly, int8 values being exact in bf16, and with full-rate integer
//   and f32 adds rather than conversions: widen16), copy the scales, fence
//   the async proxy and arrive.  The K scale multiplies each score after Q K^T and the V
//   scale each probability before P V, so no page is dequantized.
// * Only tiles that cross a row's causal position or reach below a row's
//   window are masked; rows past counts[b] are zeroed at the end.  No
//   __syncthreads in the key loop.

#include <string.h>

#include "hopper_attention.cuh"

namespace {

using namespace hopper;

constexpr int CHUNK = 1024;  // key positions per split chunk (ops/paged_attention.py WINDOW_CHUNK)
// keys per K/V tile: 128 for two consumer warpgroups on bf16 pages, 64
// for one warpgroup (short windows: shorter tiles, and its pipelined loop
// holds S, P and O at once) and for int8 pages (room for the raw ring)
template <int NC, bool Q8>
__host__ __device__ constexpr int tile_keys() { return NC == 2 && !Q8 ? 128 : 64; }

// ring stages
template <int NC, bool Q8>
__host__ __device__ constexpr int stages() { return NC == 1 && !Q8 ? 4 : 3; }

template <int HD, int NC, bool Q8>
struct Layout {
  static constexpr int BK = tile_keys<NC, Q8>();
  static constexpr int NS = stages<NC, Q8>();
  static constexpr int Q_BYTES = NC * 64 * HD * 2;
  static constexpr int SB = stage_bytes<HD, BK, Q8>();
  // raw int8 stage: K rows, V rows [BK][HD], K scales, V scales [BK]
  static constexpr int RAW_SB = Q8 ? round_up(2 * BK * HD + 2 * BK * 4, 1024) : 0;
  static constexpr int RING = Q_BYTES;
  static constexpr int RAW = RING + NS * SB;
  static constexpr int BARS = RAW + NS * RAW_SB;
  static constexpr int BYTES = BARS + (1 + 4 * NS) * 8 + 1024;  // + alignment slack
};

struct Params {
  const unsigned char* k;  // the layer's pools, rows of HD elements
  const unsigned char* v;
  const float* ks;  // the layer's scales (int8 pages), one per row
  const float* vs;
  const int* tables;
  const int* starts;
  const int* counts;
  __nv_bfloat16* out;
  float* acc_p;  // split partials [n_chunks][B][C][H][HD], m / l [n_chunks][B][C][H],
                 // slot s of sequence b holding chunk first_chunk(b) + s
  float* m_p;
  float* l_p;
  int B, C, KV, G, n_pages, ps, mp, window, n_chunks, use_tma;
  float scale;
};

// Keys [k_lo, k_hi) that some live row of the tile of `rows` rows at
// tile0 sees; empty when it has no live row.  The kernel and the combine
// compute it alike.
struct TileRange {
  int k_lo, k_hi;
  __device__ __forceinline__ bool empty() const { return k_lo >= k_hi; }
};

__device__ __forceinline__ TileRange tile_range(const Params& p, int tile0, int rows, int b) {
  const int count = min(p.counts[b], p.C);
  const int start = p.starts[b];
  const int i_first = tile0 / p.G;
  const int i_last = min(min(tile0 + rows, p.C * p.G) / p.G, count) - 1;  // last live query
  TileRange r;
  r.k_hi = i_last >= i_first ? min(start + i_last + 1, p.mp * p.ps) : 0;
  r.k_lo = p.window > 0 ? max(start + i_first - p.window + 1, 0) : 0;
  return r;
}

// The chunk of sequence b's first key, its scratch slot 0: no tile of b
// reaches below it.
__device__ __forceinline__ int first_chunk(const Params& p, int b) {
  return p.window > 0 ? max(p.starts[b] - p.window + 1, 0) / CHUNK : 0;
}

// One consumer warpgroup's mask; positions are start + row / G.
template <int BK>
struct WindowMask {
  int p_first, p_last, p[2], window, k_hi;
  bool tma;

  __device__ __forceinline__ bool masked(int k0) const {
    return k0 + BK - 1 > p_first || (window > 0 && k0 <= p_last - window);
  }
  __device__ __forceinline__ bool keep(int i, int key) const {
    return key <= p[i] && (window <= 0 || p[i] - key < window);
  }
  __device__ __forceinline__ bool gathered(int k0) const { return !(tma && k0 + BK <= k_hi); }
};

// int8 -> bf16 for 16 values (two 16-byte chunks), exactly and at full
// rate: byte u = x + 128 goes into the mantissa of 2^23 (0x4B0000uu), the
// f32 subtraction of 2^23 + 128 leaves x, and x (|x| <= 128) has no bits
// below bf16's, so the upper half of each f32 is the bf16.
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo, uint4& hi) {
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = in[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)) - 8388736.f;
    w[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    w[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <int HD, int NC, bool Q8>
__global__ void __launch_bounds__((NC + 1) * WG_THREADS, 1)
window_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, const Params p) {
  using L = Layout<HD, NC, Q8>;
  constexpr int BK = L::BK;
  constexpr int NS = L::NS;
  constexpr int BQT = 64 * NC;      // rows per tile
  constexpr int TILE = BK * HD * 2;  // bytes of one bf16 K or V tile
  constexpr int EB = Q8 ? 1 : 2;     // page element bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + L::RING;
  unsigned char* raw = smem + L::RAW;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;
  uint64_t* raw_full = empty + NS;
  uint64_t* raw_empty = raw_full + NS;

  const int tile0 = blockIdx.x * BQT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / p.n_chunks;
  const int slot = blockIdx.z % p.n_chunks;
  const int chunk = first_chunk(p, b) + slot;
  const int H = p.KV * p.G;
  const int n_rows = p.C * p.G;

  const TileRange tr = tile_range(p, tile0, BQT, b);
  if (tr.empty()) {  // padding rows only: zeros, written once
    if (slot == 0) {
      const int rows = min(BQT, n_rows - tile0);
      for (int i = threadIdx.x; i < rows * HD / 8; i += blockDim.x) {
        const int R = tile0 + i / (HD / 8);
        __nv_bfloat16* o = p.out + (((size_t)b * p.C + R / p.G) * H + kvh * p.G + R % p.G) * HD;
        reinterpret_cast<uint4*>(o)[i % (HD / 8)] = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int c_first = tr.k_lo / CHUNK;
  const int c_last = (tr.k_hi - 1) / CHUNK;
  if (c_last - first_chunk(p, b) >= p.n_chunks) __trap();  // scratch sized too small
  if (chunk < c_first || chunk > c_last) return;
  const bool split = c_last > c_first;
  const int j_lo = max(tr.k_lo, chunk * CHUNK) / BK;
  const int j_hi = (min(tr.k_hi, (chunk + 1) * CHUNK) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, Q8 ? 96 : 32);  // wideners, or the loader's lanes
      mbar_init(empty + s, NC);
      if (Q8) {
        mbar_init(raw_full + s, 32);
        mbar_init(raw_empty + s, 96);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {  // producer
    regs_dealloc<40>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0) {  // loader
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, L::Q_BYTES);
        for (int c = 0; c < NC; ++c)
          for (int half = 0; half < HD / 64; ++half)
            tma_load_3d(smem + c * 64 * HD * 2 + half * 64 * ROW_BYTES, &mq, qbar, half * 64,
                        kvh * p.G, b * p.C + (tile0 + c * 64) / p.G);
      }
      const int* table = p.tables + (size_t)b * p.mp;
      uint64_t* fill = Q8 ? raw_full : full;
      uint64_t* drain = Q8 ? raw_empty : empty;
      int it = 0;
      for (int j = j_lo; j < j_hi; ++j, ++it) {
        const int s = it % NS;
        mbar_wait(drain + s, ((it / NS) & 1) ^ 1);
        unsigned char* dst = Q8 ? raw + s * L::RAW_SB : ring + s * L::SB;
        const int k0 = j * BK;
        if (p.use_tma && k0 + BK <= tr.k_hi) {  // one page segment: TMA
          if (lane == 0) {
            const int row = (kvh * p.n_pages + table[k0 / p.ps]) * p.ps + k0 % p.ps;
            if (Q8) {
              mbar_arrive_expect_tx(fill + s, 2 * BK * HD + 2 * BK * 4);
              tma_load_2d(dst, &mk, fill + s, 0, row);
              tma_load_2d(dst + BK * HD, &mv, fill + s, 0, row);
              bulk_load(dst + 2 * BK * HD, p.ks + row, BK * 4, fill + s);
              bulk_load(dst + 2 * BK * HD + BK * 4, p.vs + row, BK * 4, fill + s);
            } else {
              mbar_arrive_expect_tx(fill + s, 2 * TILE);
              for (int half = 0; half < HD / 64; ++half) {
                tma_load_2d(dst + half * BK * ROW_BYTES, &mk, fill + s, half * 64, row);
                tma_load_2d(dst + TILE + half * BK * ROW_BYTES, &mv, fill + s, half * 64, row);
              }
            }
          } else {
            mbar_arrive(fill + s);
          }
        } else {  // gather: each key row finds its page; past k_hi zero-filled
          constexpr int CH = HD * EB / 16;  // 16-byte chunks per pool row
#pragma unroll 4
          for (int i = lane; i < BK * CH; i += 32) {
            const int r = i / CH, c = i % CH;
            const int key = k0 + r;
            const bool live = key < tr.k_hi;
            const size_t row =
                live ? ((size_t)kvh * p.n_pages + table[key / p.ps]) * p.ps + key % p.ps : 0;
            const size_t src = row * HD * EB + c * 16;
            const int off = Q8 ? r * HD + c * 16 : swizzled(BK, r, c);
            const int kv_off = Q8 ? BK * HD : TILE;
            cp_async16(dst + off, p.k + src, live ? 16 : 0);
            cp_async16(dst + kv_off + off, p.v + src, live ? 16 : 0);
          }
          if (Q8) {
            for (int r = lane; r < BK; r += 32) {
              const int key = k0 + r;
              const bool live = key < tr.k_hi;
              const size_t row =
                  live ? ((size_t)kvh * p.n_pages + table[key / p.ps]) * p.ps + key % p.ps : 0;
              cp_async4(dst + 2 * BK * HD + 4 * r, p.ks + row, live ? 4 : 0);
              cp_async4(dst + 2 * BK * HD + BK * 4 + 4 * r, p.vs + row, live ? 4 : 0);
            }
          }
          cp_async_arrive(fill + s);
        }
      }
      // stay until every stage has been released, so no copy of this warp
      // is still in flight when it exits
      for (int n = 0; n < NS; ++n, ++it) mbar_wait(drain + it % NS, ((it / NS) & 1) ^ 1);
    } else if (Q8) {  // warps 1-3 widen the raw int8 stages into the bf16 ring
      const int wt = threadIdx.x - 32;
      for (int j = j_lo, it = 0; j < j_hi; ++j, ++it) {
        const int s = it % NS;
        const uint32_t ph = (it / NS) & 1;
        mbar_wait(raw_full + s, ph);
        mbar_wait(empty + s, ph ^ 1);
        const unsigned char* src = raw + s * L::RAW_SB;
        unsigned char* stage = ring + s * L::SB;
        constexpr int CH = HD / 16;  // 16-byte raw chunks per row
        for (int i = wt; i < 2 * BK * CH; i += 96) {
          const int kv = i / (BK * CH), r = (i / CH) % BK, c = i % CH;
          const uint4 x = *reinterpret_cast<const uint4*>(src + kv * BK * HD + r * HD + c * 16);
          uint4 lo, hi;
          widen16(x, lo, hi);
          unsigned char* tile = stage + kv * TILE;
          *reinterpret_cast<uint4*>(tile + swizzled(BK, r, 2 * c)) = lo;
          *reinterpret_cast<uint4*>(tile + swizzled(BK, r, 2 * c + 1)) = hi;
        }
        for (int i = wt; i < 2 * BK; i += 96)
          reinterpret_cast<float*>(stage + 2 * TILE)[i] =
              reinterpret_cast<const float*>(src + 2 * BK * HD)[i];
        fence_proxy_async();
        mbar_arrive(full + s);
        mbar_arrive(raw_empty + s);
      }
    }
  } else {  // consumers
    if (NC == 2) regs_alloc<232>();  // one warpgroup keeps what it was launched with
    const int c = wg - 1;
    const int start = p.starts[b];
    const int count = min(p.counts[b], p.C);
    const int R0 = tile0 + c * 64;
    WindowMask<BK> mask;
    mask.p_first = start + R0 / p.G;
    mask.p_last = start + (R0 + 63) / p.G;
    mask.p[0] = start + (R0 + RowState<HD>::row(0)) / p.G;
    mask.p[1] = start + (R0 + RowState<HD>::row(1)) / p.G;
    mask.window = p.window;
    mask.k_hi = tr.k_hi;
    mask.tma = p.use_tma != 0;
    RowState<HD> st;
    st.init();
    mbar_wait(qbar, 0);
    const uint32_t sq = smem_u32(smem + c * 64 * HD * 2);
    if constexpr (NC == 2)
      consume_pingpong<HD, BK, NS, Q8, false>(st, c, sq, ring, full, empty, j_lo, j_hi,
                                              p.scale * LOG2E, mask);
    else
      consume<HD, BK, NS, Q8>(st, sq, ring, full, empty, j_lo, j_hi, p.scale * LOG2E, mask);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = quad_sum(st.l[i]);
      const int R = R0 + RowState<HD>::row(i);
      if (R >= n_rows) continue;
      const int qi = R / p.G;
      const bool live = qi < count;
      const size_t idx = ((size_t)b * p.C + qi) * H + kvh * p.G + R % p.G;
      if (!split) {
        const float inv = 1.f / fmaxf(l, 1e-20f);
        __nv_bfloat16* o = p.out + idx * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(o + RowState<HD>::col(j, 0)) =
              live ? __floats2bfloat162_rn(st.o[4 * j + 2 * i] * inv,
                                           st.o[4 * j + 2 * i + 1] * inv)
                   : __floats2bfloat162_rn(0.f, 0.f);
      } else {  // partials, natural-log units; padding rows are (0, -inf, 0)
        const size_t pidx = (size_t)slot * p.B * p.C * H + idx;
        float* a = p.acc_p + pidx * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(a + RowState<HD>::col(j, 0)) =
              live ? make_float2(st.o[4 * j + 2 * i], st.o[4 * j + 2 * i + 1])
                   : make_float2(0.f, 0.f);
        if ((threadIdx.x & 3) == 0) {
          p.m_p[pidx] = live ? st.m[i] * LN2 : -INFINITY;
          p.l_p[pidx] = live ? l : 0.f;
        }
      }
    }
  }
}

// Fold the chunk partials of every split tile, left to right: one warp per
// output row (HD / 32 columns per lane), eight rows per block; grid
// (tile * rows_per_tile / 8 + row group, KV head, sequence).
template <int HD>
__global__ void __launch_bounds__(256)
window_combine_kernel(const Params p, int rows_per_tile) {
  constexpr int PER = HD / 32;
  const int groups = rows_per_tile / 8;
  const int tile0 = blockIdx.x / groups * rows_per_tile;
  const int R = tile0 + blockIdx.x % groups * 8 + threadIdx.x / 32;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  if (R >= p.C * p.G) return;
  const TileRange tr = tile_range(p, tile0, rows_per_tile, b);
  if (tr.empty()) return;
  const int c_first = tr.k_lo / CHUNK;
  const int c_last = (tr.k_hi - 1) / CHUNK;
  if (c_last == c_first) return;  // written directly
  const int H = p.KV * p.G;
  const size_t N = (size_t)p.B * p.C * H;  // rows per chunk
  const size_t idx = ((size_t)b * p.C + R / p.G) * H + kvh * p.G + R % p.G;
  const int col = (threadIdx.x % 32) * PER;
  const int c0 = first_chunk(p, b);
  size_t j = (size_t)(c_first - c0) * N + idx;
  float m = p.m_p[j], l = p.l_p[j], a[PER], ac[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) a[k] = p.acc_p[j * HD + col + k];
  for (int ch = c_first + 1; ch <= c_last; ++ch) {
    j = (size_t)(ch - c0) * N + idx;
#pragma unroll
    for (int k = 0; k < PER; ++k) ac[k] = p.acc_p[j * HD + col + k];
    fold(m, l, a, PER, p.m_p[j], p.l_p[j], ac);
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int k = 0; k < PER; ++k) p.out[idx * HD + col + k] = __float2bfloat16(a[k] * inv);
}

template <int HD, int NC, bool Q8>
int launch(Params p, const void* q, int layer, cudaStream_t stream) {
  using L = Layout<HD, NC, Q8>;
  constexpr int BK = L::BK;
  constexpr int EB = Q8 ? 1 : 2;
  const int H = p.KV * p.G;
  const size_t rows = (size_t)p.KV * p.n_pages * p.ps;  // pool rows of one layer
  p.k += (size_t)layer * rows * HD * EB;
  p.v += (size_t)layer * rows * HD * EB;
  if (Q8) {
    p.ks += (size_t)layer * rows;
    p.vs += (size_t)layer * rows;
  }
  p.use_tma = p.ps % BK == 0;
  if (p.n_chunks > 1 && (p.acc_p == nullptr || p.m_p == nullptr || p.l_p == nullptr))
    return (int)cudaErrorInvalidValue;

  // q as [B * C][H][HD]: a box of 64 / G queries x G heads x 64 columns
  CUtensorMap mq, mk, mv;
  const cuuint64_t q_dims[3] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)p.B * p.C};
  const cuuint64_t q_strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)H * HD * 2};
  const cuuint32_t q_box[3] = {64, (cuuint32_t)p.G, (cuuint32_t)(64 / p.G)};
  int err = encode_map(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, q, q_dims, q_strides, q_box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  if (!err && p.use_tma) {  // the layer's pool as rows [KV * n_pages * ps][HD]
    const cuuint64_t dims[2] = {(cuuint64_t)HD, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)HD * EB};
    const cuuint32_t box[2] = {(cuuint32_t)(Q8 ? HD : 64), (cuuint32_t)BK};
    const CUtensorMapDataType type =
        Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle swz = Q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
    err = encode_map(&mk, type, 2, p.k, dims, strides, box, swz);
    if (!err) err = encode_map(&mv, type, 2, p.v, dims, strides, box, swz);
  }
  if (err) return err;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_kernel<HD, NC, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_attr_set = true;
  }
  const int n_tiles = (p.C * p.G + 64 * NC - 1) / (64 * NC);
  window_kernel<HD, NC, Q8><<<dim3(n_tiles, p.KV, p.B * p.n_chunks), (NC + 1) * WG_THREADS,
                              L::BYTES, stream>>>(mq, mk, mv, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.n_chunks == 1) return (int)e;
  window_combine_kernel<HD><<<dim3(n_tiles * 8 * NC, p.KV, p.B), 256, 0, stream>>>(p, 64 * NC);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const Params& p, const void* q, int layer, cudaStream_t st) {
  const bool q8 = p.ks != nullptr;
  if (p.C * p.G <= 64)
    return q8 ? launch<HD, 1, true>(p, q, layer, st) : launch<HD, 1, false>(p, q, layer, st);
  return q8 ? launch<HD, 2, true>(p, q, layer, st) : launch<HD, 2, false>(p, q, layer, st);
}

}  // namespace

// bf16 pages when the scales are null, int8 pages otherwise.  acc / m / l
// are the split partials' scratch, [n_chunks, B, C, H, HD] and [n_chunks,
// B, C, H] f32, null when n_chunks is 1; n_chunks is at least the number
// of CHUNK-key chunks that any live sequence's key range touches (a launch
// given fewer traps).
extern "C" int paged_window_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* page_tables, const void* starts,
                                      const void* counts, void* out, void* acc, void* m,
                                      void* l, int B, int C, int KV, int G, int HD,
                                      int n_pages, int ps, int mp, int layer, float scale,
                                      int window, int n_chunks, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || n_pages <= 0 || ps <= 0 || mp <= 0 || n_chunks <= 0 ||
      (G != 1 && G != 2 && G != 4 && G != 8) || (k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.k = static_cast<const unsigned char*>(k_pages);
  p.v = static_cast<const unsigned char*>(v_pages);
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.tables = static_cast<const int*>(page_tables);
  p.starts = static_cast<const int*>(starts);
  p.counts = static_cast<const int*>(counts);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.acc_p = static_cast<float*>(acc);
  p.m_p = static_cast<float*>(m);
  p.l_p = static_cast<float*>(l);
  p.B = B;
  p.C = C;
  p.KV = KV;
  p.G = G;
  p.n_pages = n_pages;
  p.ps = ps;
  p.mp = mp;
  p.window = window;
  p.n_chunks = n_chunks;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch_hd<128>(p, q, layer, st);
  if (HD == 64) return launch_hd<64>(p, q, layer, st);
  return (int)cudaErrorInvalidValue;
}
