// Paged attention over the head-major KV pool, written for Hopper (sm_90a):
// the one-query-per-row page walks.
//
// Replaces three Pallas TPU kernels of fusioninfer_tpu/ops/paged_attention.py:
// ragged_paged_attention (one page walk per token), ragged_paged_attention_
// kvsplit (the walk split over fixed virtual chunks whose f32 (acc, m, l)
// partials are folded left to right by a log-sum-exp combine) and
// paged_decode_attention (one query token per sequence).
//
// Pages are [L, KV, n_pages, ps, Hd], bf16, or int8 with f32 scales
// [L, KV, n_pages, 1, ps] (one per token and head).  With int8 pages the K
// scale multiplies each key's score after the dot and the V scale each
// key's probability before P V (q . (s k8) == s (q . k8)), so a page is
// never dequantized into memory.
//
// Ragged walks: q [T, H, Hd] bf16; page_tables [R, mp] int32; row_starts /
// q_begins / q_lens [R] int32.  Token t belongs to the row whose segment
// [q_begins[r], q_begins[r] + q_lens[r]) holds it, sits at position
// row_starts[r] + t - q_begins[r], and attends causally (and within
// `window` when > 0) over that row's pages.  Tokens in no row produce
// zeros.  Paged decode: q [B, H, Hd]; page_tables [B, mp]; lengths [B], the
// context length including the query token, which sits at lengths[b] - 1;
// lengths[b] = 0 produces zeros.
//
// What bounds them: a decode step's attention reads every live K/V byte
// once per (token, KV head) and does ~2 G flop per byte of K and V (G <= 8
// query heads per KV head), far below the card's ridge, so it is bound by
// bytes; and a step has few (token, KV head) pairs of very different
// lengths, so one block per pair leaves most SMs idle behind the longest.
//
// All three walks run one kernel body, walk_kernel:
//
// * A thread-block cluster of CL blocks per (token or sequence, KV head)
//   carries the G query heads of that KV head.  Which keys rank r walks
//   is the walk's partition rule:
//   - the single walk and paged decode: the r-th share of ceil(n / CL) of
//     the n pages the query sees, counted from the first page its window
//     lets it see (earlier pages are never read).  The caller picks CL
//     from shapes alone (ops/paged_attention.py pick_cluster_size), so
//     the launch reads nothing back from the card;
//   - the split walk: CL = KV_SPLIT_CHUNKS = 8 and rank c is virtual chunk
//     c, pages [c cp, (c + 1) cp) of the row's table with cp = ceil(mp / 8)
//     (chunk_pages), cut to the visible keys: the JAX kernel's fixed
//     chunks, so a row's bits depend on its positions and mp alone, never
//     on T or on the other rows.
//   Each rank's f32 (acc, m, l) is folded with the others' left to right
//   from rank 0, so each output has one fixed order; each rank folds a
//   slice of the outputs.  In the single walk and paged decode a rank
//   with no keys goes straight to the merge as (0, -inf, 0); after a
//   cluster barrier every rank reads all ranks' partials through
//   distributed shared memory (mapa, ld.shared::cluster).  In the split
//   walk, where most ranks of a short row have no keys (before the
//   window, past the row's context or past the table), such a rank
//   arrives on the cluster barrier and leaves at once, freeing its SM
//   slot (its (0, -inf, 0) would fold away exactly); the ranks with keys
//   push their partials of each other's slices into the folding rank's
//   shared memory (st.shared::cluster) and signal its mbarrier, so no
//   rank waits on another to finish reading.  One launch, no scratch, no
//   atomics.
// * A producer warp streams the rank's keys through a ring of STAGES
//   stages of BK keys (16 KB of K and V rows a stage; the split walk two
//   of 32 KB, see walk::Shape): one bulk copy
//   (cp.async.bulk into the stage's "full" mbarrier) per page segment of
//   K and of V, rows [off, off + n) of a page being one contiguous run of
//   the pool, and with int8 pages one per segment of K and of V scales
//   (widened to 4-key alignment: 16-byte copies).  No register holds a
//   load in flight; four blocks of an SM keep ~190 KB in flight.
// * Four consumer warps (the split walk eight, the batches of a stage
//   dealt round-robin) split each stage into batches of 32 / G keys: lane
//   l owns dims [l Hd / 32, (l + 1) Hd / 32) of every K and V row (reads
//   of whole rows, no bank conflicts) and of the G pre-scaled f32 query
//   vectors in registers; the G x 32 / G partial dots are summed across
//   the warp by a reduce-scatter, after which lane l holds the score of
//   (key l / G, head l % G).  The online softmax runs in f32 on those
//   scores (K scale after the dot), and P V accumulates in f32 in each
//   lane's dims, the probabilities (times the V scale) read from shared
//   memory.  A key outside the rank's range (stage edges) scores -inf
//   and weighs 0 against a V row that holds 0 or real values (the V ring
//   is zeroed at the start), so a row no copy wrote cannot poison the
//   sum.  The warps' states merge in shared memory, in warp order, into
//   the rank's partial.  Products and sums stay in f32: Q K^T on the
//   tensor cores (bf16 K by ldmatrix) measured no faster on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// the split walk's fixed virtual chunks: the ranks of its cluster
// (KV_SPLIT_CHUNKS of ops/paged_attention.py)
constexpr int KV_SPLIT_CHUNKS = 8;

// the DPL = Hd / 32 dims one lane owns of a K or V row, raw
template <int BYTES>
struct RawT;
template <>
struct RawT<2> { using type = unsigned short; };
template <>
struct RawT<4> { using type = unsigned; };
template <>
struct RawT<8> { using type = uint2; };

template <int DPL, bool Q8>
using VRaw = typename RawT<DPL * (Q8 ? 1 : 2)>::type;

// -- the page walks: one cluster per (token or sequence, KV head) ---------------------

namespace walk {

// The block of a walk: CONSUMERS consumer warps and one producer warp, a
// ring of STAGES stages of STAGE_KV_BYTES of K and V rows, MIN_BLOCKS of
// them on an SM (which caps each thread's registers).  The split walk's
// block has twice the consumers, on two stages of twice the size, in 72
// registers a thread (its dots in quarters, which spill nothing at G 4):
// a rank's keys stream through half as many batches a warp, while three
// blocks still fit an SM.
template <int G, bool SPLIT>
struct Shape {
  static constexpr int CONSUMERS = SPLIT ? 8 : 4;
  static constexpr int THREADS = 32 * (CONSUMERS + 1);
  static constexpr int STAGES = SPLIT ? 2 : 3;
  static constexpr int STAGE_KV_BYTES = SPLIT ? 32768 : 16384;
  static constexpr int MIN_BLOCKS = G == 8 ? (SPLIT ? 2 : 3) : (SPLIT ? 3 : 4);
};

// A stage: BK K rows, BK V rows, then (int8 pages) BK K and BK V scales.
// The barriers (the split walk's merge barrier after the ring's), each
// consumer warp's 32 probabilities and (split walk) the partials that
// the other ranks push follow the ring; once every stage is consumed the
// ring holds the warps' states and the rank's partial (Merge).
template <int HD, int G, bool Q8, bool SPLIT>
struct Layout {
  using S = Shape<G, SPLIT>;
  static constexpr int ROW = HD * (Q8 ? 1 : 2);  // bytes of one K or V row
  static constexpr int BK = S::STAGE_KV_BYTES / (2 * ROW);
  static constexpr int V_OFF = BK * ROW;
  static constexpr int KS_OFF = 2 * BK * ROW;
  static constexpr int VS_OFF = KS_OFF + (Q8 ? 4 * BK : 0);
  static constexpr int STAGE = VS_OFF + (Q8 ? 4 * BK : 0);
  static constexpr int BARS = S::STAGES * STAGE;
  static constexpr int PROBS = hopper::round_up(BARS + (2 * S::STAGES + (SPLIT ? 1 : 0)) * 8, 16);
  static constexpr int RECV = PROBS + S::CONSUMERS * 32 * 4;
  // received: acc slices (at most G HD + 7 floats), m [8][G], l [8][G]
  static constexpr int RECV_FLOATS = SPLIT ? G * HD + 8 + 16 * G : 0;
  static constexpr int BYTES = RECV + RECV_FLOATS * 4;
};

// f32 views of the ring after the walk: each of the W warps' (o [G][HD],
// m [G], l [G]), then the rank's partial (acc [G][HD], m [G], l [G]),
// which the ranks of the cluster read
template <int HD, int G, int W>
struct Merge {
  float* wo;
  float* wm;
  float* wl;
  float* acc;
  float* m;
  float* l;
  static constexpr int FLOATS = W * G * (HD + 2) + G * (HD + 2);
  __device__ explicit Merge(unsigned char* ring) {
    wo = reinterpret_cast<float*>(ring);
    wm = wo + W * G * HD;
    wl = wm + W * G;
    acc = wl + W * G;
    m = acc + G * HD;
    l = m + G;
  }
};

}  // namespace walk

// Reduce-scatter of N = 2 W values across the warp: each step keeps the
// half of a lane's values that its lane bit W selects and adds its
// partner's copy of that half; afterwards lane l holds in v[0] the sum of
// value l % N over the lanes that agree with l in the bits above W.
template <int W, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = up ? v[i] : v[i + W];
    const float keep = up ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, W);
  }
  if constexpr (W > 1) reduce_scatter<W / 2>(v, lane);
}

// N consecutive floats of shared memory (16-byte aligned when N % 4 == 0)
template <int N>
__device__ __forceinline__ void load_floats(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      dst[i] = x.x;
      dst[i + 1] = x.y;
      dst[i + 2] = x.z;
      dst[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// raw K or V values -> f32, exactly: a bf16 is the top half of its f32;
// an int8 code c becomes the f32 2^23 + 128 + c (its byte, sign bit
// flipped, as the low mantissa byte), less 2^23 + 128 (PRMT and FADD,
// both full rate)
template <int DPL, bool Q8>
__device__ __forceinline__ void widen(const VRaw<DPL, Q8>& raw, float* f) {
  if constexpr (Q8) {
    const unsigned w = (unsigned)raw ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  } else {
    const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
    for (int i = 0; i < DPL / 2; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Partial dots over this lane's DPL dims of the G query heads against the
// K rows of a batch (kr: this lane's dims of its first row; rows ROW bytes
// apart): part[i - I0] = key i / G, head i % G, for i in [I0, I0 + N)
template <int HD, int G, bool Q8, int I0, int N, int ROW>
__device__ __forceinline__ void dots(const unsigned char* kr, const float (&qf)[G][HD / 32],
                                     float (&part)[N]) {
  constexpr int DPL = HD / 32;
#pragma unroll
  for (int kk = I0 / G; kk < (I0 + N) / G; ++kk) {
    float kf[DPL];
    widen<DPL, Q8>(*reinterpret_cast<const VRaw<DPL, Q8>*>(kr + kk * ROW), kf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc = fmaf(qf[g][d], kf[d], acc);
      part[kk * G + g - I0] = acc;
    }
  }
}

struct WalkParams {
  const __nv_bfloat16* q;
  const unsigned char* k;  // pools [L, KV, n_pages, ps, HD]
  const unsigned char* v;
  const float* ks;  // scales [L, KV, n_pages, 1, ps] of int8 pages, else null
  const float* vs;
  const int* tables;  // [R, mp]
  const int* row_starts;  // ragged: [R] each
  const int* q_begins;
  const int* q_lens;
  const int* lengths;  // decode: [B]
  __nv_bfloat16* out;
  int R, KV, n_pages, ps, mp, layer, window, cl;
  int chunk_pages;  // the split walk's pages per rank
  float scale;
};

// The first row whose segment holds token t and the token's position in
// it, or row -1; 32 rows per step, each lane loading its row's three
// descriptors at once (one memory round trip per step).
__device__ __forceinline__ int2 find_row(const WalkParams& p, int t, int lane) {
  for (int r0 = 0; r0 < p.R; r0 += 32) {
    const int r = r0 + lane;
    bool hit = false;
    int pos = 0;
    if (r < p.R) {
      const int qb = p.q_begins[r], n = p.q_lens[r], start = p.row_starts[r];
      hit = t >= qb && t < qb + n;
      pos = start + t - qb;
    }
    const unsigned m = __ballot_sync(FULL, hit);
    if (m) return make_int2(r0 + __ffs(m) - 1, __shfl_sync(FULL, pos, __ffs(m) - 1));
  }
  return make_int2(-1, 0);
}

// grid (items * CL, KV), clusters of CL blocks along x: item blockIdx.x /
// CL (a token, or with DECODE a sequence), KV head blockIdx.y; SPLIT: the
// split walk's fixed chunks (CL 8)
template <int HD, int G, bool Q8, bool DECODE, bool SPLIT>
__global__ void __launch_bounds__(walk::Shape<G, SPLIT>::THREADS,
                                  walk::Shape<G, SPLIT>::MIN_BLOCKS)
walk_kernel(const WalkParams p) {
  using L = walk::Layout<HD, G, Q8, SPLIT>;
  using S = walk::Shape<G, SPLIT>;
  constexpr int W = S::CONSUMERS, NS = S::STAGES, BK = L::BK, THREADS = S::THREADS;
  constexpr int DPL = HD / 32;  // dims per lane
  constexpr int KB = 32 / G;    // keys per batch: one (key, head) score per lane
  constexpr int NB = BK / KB;   // batches per stage
  static_assert(NB >= 1 && BK % KB == 0 && BK % 4 == 0, "stage");
  static_assert(walk::Merge<HD, G, W>::FLOATS * 4 <= L::BARS, "the merge fits the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + NS;
  uint64_t* ready = empty + NS;  // the split walk's merge: every partial pushed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x / p.cl;
  const int kvh = blockIdx.y;
  const uint32_t rank = hopper::cluster_rank();

  // the keys [k_lo, k_hi) the item's query sees; none for an inert item
  int k_lo = 0, k_hi = 0, row = item;
  bool valid;
  if constexpr (DECODE) {
    const int len = p.lengths[item];
    valid = len > 0;
    if (valid) {
      k_lo = p.window > 0 ? max(len - p.window, 0) : 0;
      k_hi = min(len, p.mp * p.ps);
    }
  } else {
    const int2 rp = find_row(p, item, lane);
    row = rp.x;
    valid = row >= 0;
    if (valid) {
      const int pos = rp.y;
      k_lo = p.window > 0 ? max(pos - p.window + 1, 0) : 0;
      k_hi = min(pos + 1, p.mp * p.ps);
    }
  }
  // this rank's keys [lo, hi), none when hi <= lo: with fixed chunks (the
  // split walk) chunk `rank`, pages [rank cp, (rank + 1) cp) of the table;
  // else the rank-th share, pages [pa, pb), of ceil(n / CL) of the n pages
  // that hold [k_lo, k_hi)
  int lo, hi;
  // the ranks that merge: all, or in the split walk the ranks with keys
  // (rank 0 alone when none has any); the others leave at once
  unsigned part = (1u << p.cl) - 1;
  if constexpr (SPLIT) {
    const int keys = p.chunk_pages * p.ps;
    lo = max(k_lo, (int)rank * keys);
    hi = min(k_hi, ((int)rank + 1) * keys);
    unsigned live = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      live |= (unsigned)(min(k_hi, (c + 1) * keys) > max(k_lo, c * keys)) << c;
    part = live ? live : 1u;
  } else {
    const int p_lo = k_lo / p.ps;
    const int p_hi = k_hi > k_lo ? (k_hi + p.ps - 1) / p.ps : p_lo;
    const int per = (p_hi - p_lo + p.cl - 1) / p.cl;
    const int pa = p_lo + (int)rank * per, pb = min(pa + per, p_hi);
    lo = max(k_lo, pa * p.ps);
    hi = min(k_hi, pb * p.ps);
  }
  // stage j holds keys [base + j BK, base + (j + 1) BK), of which [lo, hi)
  // are this rank's; base is 4-aligned for the scales' copies
  const int base = lo & ~3;
  const int n_stages = hi > lo ? (hi - base + BK - 1) / BK : 0;
  const size_t idx = ((size_t)item * p.KV + kvh) * G;  // q head row of the item

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W);
    }
    if constexpr (SPLIT) hopper::mbar_init(ready, __popc(part));
    hopper::mbar_init_fence();
  }
  if constexpr (SPLIT) {
    // every rank arrives on the cluster barrier once its own are set up;
    // a rank outside the merge then leaves, freeing its SM slot (no rank
    // writes to it), and the others wait on that barrier before their
    // first remote write
    __syncthreads();
    hopper::cluster_arrive();
    if (!((part >> rank) & 1)) return;
  }
  // V rows that no copy writes (stage edges) are read with probability 0:
  // zero them once, so they hold 0 or real values from an earlier stage,
  // never a NaN that 0 times it would spread
  for (int i = threadIdx.x; i < NS * BK * L::ROW / 16; i += THREADS) {
    const int s = i / (BK * L::ROW / 16), c = i % (BK * L::ROW / 16);
    reinterpret_cast<uint4*>(smem + s * L::STAGE + L::V_OFF)[c] = make_uint4(0, 0, 0, 0);
  }
  hopper::fence_proxy_async();  // before the copies that overwrite them
  __syncthreads();

  walk::Merge<HD, G, W> mg(smem);
  // the split walk's merge: merging rank q (q-th of n_part, in rank order)
  // folds outputs [q per, (q + 1) per) of the G HD; the others push their
  // partials of those outputs into its `recv`, rank r's acc at r's place
  // times per, its m and l at recv_ml[r G + g] and recv_ml[8 G + r G + g]
  const int n_part = __popc(part), place = __popc(part & ((1u << rank) - 1));
  const int per = (G * HD + n_part - 1) / n_part;
  float* recv = reinterpret_cast<float*>(smem + L::RECV);
  float* recv_ml = recv + G * HD + 8;
  if (warp == W) {
    // producer: every lane walks the stages (page ids by shuffle from a
    // window of 32 table entries), lane 0 issues the copies
    const size_t row0 = ((size_t)p.layer * p.KV + kvh) * p.n_pages * p.ps;
    const int* table = p.tables + (size_t)max(row, 0) * p.mp;
    int win = -32, win_page = 0;
    for (int j = 0; j < n_stages; ++j) {
      const int s = j % NS;
      if (j >= NS) hopper::mbar_wait(&empty[s], (j / NS - 1) & 1);
      unsigned char* st = smem + s * L::STAGE;
      const int s_lo = base + j * BK;
      const int k0 = max(s_lo, lo), k1 = min(s_lo + BK, hi);
      uint32_t bytes = 2u * (k1 - k0) * L::ROW;
      if constexpr (Q8) {
        for (int key = k0; key < k1;) {
          const int off = key % p.ps, n = min(p.ps - off, k1 - key);
          bytes += 8u * (min((off + n + 3) & ~3, p.ps) - (off & ~3));
          key += n;
        }
      }
      if (lane == 0) hopper::mbar_arrive_expect_tx(&full[s], bytes);
      for (int key = k0; key < k1;) {
        const int pg = key / p.ps;
        if (pg >= win + 32) {
          win = pg;
          win_page = pg + lane < p.mp ? __ldg(table + pg + lane) : 0;
        }
        const int page = __shfl_sync(FULL, win_page, pg - win);
        const int off = key - pg * p.ps, n = min(p.ps - off, k1 - key);
        if (lane == 0) {
          const size_t src = row0 + (size_t)page * p.ps + off;  // pool row of key
          const int slot = key - s_lo;
          hopper::bulk_load(st + slot * L::ROW, p.k + src * L::ROW, n * L::ROW, &full[s]);
          hopper::bulk_load(st + L::V_OFF + slot * L::ROW, p.v + src * L::ROW, n * L::ROW,
                            &full[s]);
          if constexpr (Q8) {
            const int a = off & ~3, b = min((off + n + 3) & ~3, p.ps);
            const int sslot = slot - off + a;
            hopper::bulk_load(st + L::KS_OFF + 4 * sslot, p.ks + src - off + a, 4 * (b - a),
                              &full[s]);
            hopper::bulk_load(st + L::VS_OFF + 4 * sslot, p.vs + src - off + a, 4 * (b - a),
                              &full[s]);
          }
        }
        key += n;
      }
    }
  } else {
    // consumers: lane owns dims [lane DPL, lane DPL + DPL) of every row
    float qf[G][DPL], o[G][DPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      widen<DPL, false>(*reinterpret_cast<const VRaw<DPL, false>*>(
                            p.q + (idx + g) * HD + lane * DPL),
                        qf[g]);
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        qf[g][d] *= p.scale;
        o[g][d] = 0.f;
      }
    }
    // running max and (this lane's share of the) sum of head lane % G
    float m = -INFINITY, l = 0.f;
    float* probs = reinterpret_cast<float*>(smem + L::PROBS) + warp * 32;
    for (int j = 0; j < n_stages; ++j) {
      const int s = j % NS;
      hopper::mbar_wait(&full[s], (j / NS) & 1);
      const unsigned char* st = smem + s * L::STAGE;
      const int s_lo = base + j * BK;
      const int k0 = max(s_lo, lo), k1 = min(s_lo + BK, hi);
      // batch b of stage j is warp b's, or in the split walk warp (j NB +
      // b) % W's, so that every warp has work when W does not divide NB
      const int b0 = SPLIT ? ((warp - j * NB) % W + W) % W : warp;
      for (int b = b0; b < NB; b += W) {
        const int b_lo = s_lo + b * KB;
        if (b_lo + KB <= k0 || b_lo >= k1) continue;
        const unsigned char* kr = st + b * KB * L::ROW + lane * DPL * (Q8 ? 1 : 2);
        // lane l's score: the full dot of key l / G, head l % G, from the
        // partial dots over each lane's dims, part[kk G + g] for key kk,
        // head g, summed across the warp
        float sc;
        if constexpr (SPLIT) {
          // in four quarters of 8 (fewer live registers: more warps per
          // SM); quarter i leaves lane l the sum of value 8 i + l % 8 over
          // the lanes that agree with l in bits 8 and 16, which the last
          // two steps add up
          float h0[8], h1[8], h2[8], h3[8];
          dots<HD, G, Q8, 0, 8, L::ROW>(kr, qf, h0);
          reduce_scatter<4>(h0, lane);
          dots<HD, G, Q8, 8, 8, L::ROW>(kr, qf, h1);
          reduce_scatter<4>(h1, lane);
          dots<HD, G, Q8, 16, 8, L::ROW>(kr, qf, h2);
          reduce_scatter<4>(h2, lane);
          dots<HD, G, Q8, 24, 8, L::ROW>(kr, qf, h3);
          reduce_scatter<4>(h3, lane);
          const bool u16 = lane & 16, u8 = lane & 8;
          const float x0 = (u16 ? h2[0] : h0[0]) + __shfl_xor_sync(FULL, u16 ? h0[0] : h2[0], 16);
          const float x1 = (u16 ? h3[0] : h1[0]) + __shfl_xor_sync(FULL, u16 ? h1[0] : h3[0], 16);
          sc = (u8 ? x1 : x0) + __shfl_xor_sync(FULL, u8 ? x0 : x1, 8);
        } else {
          float part[32];
          dots<HD, G, Q8, 0, 32, L::ROW>(kr, qf, part);
          reduce_scatter<16>(part, lane);
          sc = part[0];
        }
        const int key = b_lo + lane / G;
        const bool kv = key >= k0 && key < k1;
        float vsc = 1.f;
        if constexpr (Q8) {
          if (kv) {
            sc *= reinterpret_cast<const float*>(st + L::KS_OFF)[key - s_lo];
            vsc = reinterpret_cast<const float*>(st + L::VS_OFF)[key - s_lo];
          }
        }
        sc = kv ? sc : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int w = G; w < 32; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w));
        const float m_new = fmaxf(m, mx);  // finite: the batch holds a key of the range
        const float alpha = __expf(m - m_new);
        const float pr = kv ? __expf(sc - m_new) : 0.f;
        l = l * alpha + pr;
        m = m_new;
        // the V scale weights the probability, not the sum; a key outside
        // the range weighs 0 against a finite V row
        probs[lane] = pr * vsc;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float a = __shfl_sync(FULL, alpha, g);
#pragma unroll
          for (int d = 0; d < DPL; ++d) o[g][d] *= a;
        }
        __syncwarp();
        const unsigned char* vr = kr + L::V_OFF;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          float pk[G], vf[DPL];
          load_floats<G>(probs + kk * G, pk);
          widen<DPL, Q8>(*reinterpret_cast<const VRaw<DPL, Q8>*>(vr + kk * L::ROW), vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int d = 0; d < DPL; ++d) o[g][d] = fmaf(pk[g], vf[d], o[g][d]);
          }
        }
        __syncwarp();  // the probabilities are read before the next batch writes them
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int w = G; w < 32; w <<= 1) l += __shfl_xor_sync(FULL, l, w);

    // the warps' states, folded in warp order into the rank's partial
    hopper::named_sync(1, W * 32);  // every stage consumed: the ring is free
    if (lane < G) {
      mg.wm[warp * G + lane] = m;
      mg.wl[warp * G + lane] = l;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int d = 0; d < DPL; ++d) mg.wo[(warp * G + g) * HD + lane * DPL + d] = o[g][d];
    }
    hopper::named_sync(1, W * 32);
    if constexpr (SPLIT) hopper::cluster_wait();  // every merging rank's barrier is set up
    for (int i = threadIdx.x; i < G * HD; i += W * 32) {
      const int g = i / HD, c = i % HD;
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < W; ++w) mm = fmaxf(mm, mg.wm[w * G + g]);
      float A = 0.f, Ls = 0.f;
      if (mm != -INFINITY) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float e = __expf(mg.wm[w * G + g] - mm);
          Ls += e * mg.wl[w * G + g];
          A += e * mg.wo[(w * G + g) * HD + c];
        }
      }
      if constexpr (SPLIT) {
        const int q = i / per;  // the place of the rank that folds output i
        const uint32_t to = __fns(part, 0, q + 1);
        hopper::st_cluster(hopper::cluster_map(recv + place * per + i - q * per, to), A);
        if (c == 0) {
          for (int r = 0; r < 8; ++r) {
            if ((part >> r) & 1) {
              hopper::st_cluster(hopper::cluster_map(recv_ml + rank * G + g, r), mm);
              hopper::st_cluster(hopper::cluster_map(recv_ml + 8 * G + rank * G + g, r), Ls);
            }
          }
        }
      } else {
        mg.acc[i] = A;
        if (c == 0) {
          mg.m[g] = mm;
          mg.l[g] = Ls;
        }
      }
    }
    if constexpr (SPLIT) {
      hopper::named_sync(1, W * 32);  // this rank's partial is pushed
      if (threadIdx.x < 8 && ((part >> threadIdx.x) & 1))
        hopper::mbar_arrive_cluster(ready, threadIdx.x);
    }
  }

  if constexpr (SPLIT) {
    // The split walk's merge: once every merging rank has pushed its
    // partials of this rank's slice of the G x HD outputs (one arrival
    // each), the rank folds them from its own shared memory, left to right
    // from the lowest rank, so every output has one fixed order.  A rank
    // that left holds (0, -inf, 0), which the fold would pass over
    // exactly.  No rank reads another's memory, so none waits for the
    // others to finish reading.
    if (warp < W) {
      hopper::mbar_wait_cluster(ready, 0);
      for (int i = place * per + threadIdx.x; i < min((place + 1) * per, G * HD);
           i += W * 32) {
        const int g = i / HD;
        float mm = -INFINITY, Ls = 0.f, A = 0.f;
        for (int r = 0, q = 0; r < 8; ++r) {
          if ((part >> r) & 1) {
            hopper::fold(mm, Ls, &A, 1, recv_ml[r * G + g], recv_ml[8 * G + r * G + g],
                         recv + q * per + i - place * per);
            ++q;
          }
        }
        p.out[idx * HD + i] = __float2bfloat16(valid ? A / fmaxf(Ls, 1e-20f) : 0.f);
      }
    }
  } else {
    // Each rank folds a slice of the G x HD outputs: the ranks' partials,
    // read through distributed shared memory (all loads first), folded
    // left to right from rank 0, so every output has the same fixed order
    // whichever rank computes it.  The second barrier keeps every rank's
    // shared memory alive until all have read it.
    hopper::cluster_sync();
    if (warp < W) {
      const int per_rank = G * HD / p.cl;
      for (int i = (int)rank * per_rank + threadIdx.x; i < ((int)rank + 1) * per_rank;
           i += W * 32) {
        const int g = i / HD;
        float pm[8], pl[8], pa[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r < p.cl) {
            pm[r] = hopper::ld_cluster(hopper::cluster_map(mg.m + g, r));
            pl[r] = hopper::ld_cluster(hopper::cluster_map(mg.l + g, r));
            pa[r] = hopper::ld_cluster(hopper::cluster_map(mg.acc + i, r));
          }
        }
        float mm = pm[0], Ls = pl[0], A = pa[0];
#pragma unroll
        for (int r = 1; r < 8; ++r)
          if (r < p.cl) hopper::fold(mm, Ls, &A, 1, pm[r], pl[r], &pa[r]);
        p.out[idx * HD + i] = __float2bfloat16(valid ? A / fmaxf(Ls, 1e-20f) : 0.f);
      }
    }
    hopper::cluster_sync();
  }
}

// Launch the walk in clusters of p.cl blocks.  Once per cluster size, the
// dynamic shared memory is allowed and the card asked whether such a
// cluster can be placed at all (cudaOccupancyMaxActiveClusters); one that
// cannot is refused here, never run another way.
template <int HD, int G, bool Q8, bool DECODE, bool SPLIT>
int launch_walk(const WalkParams& p, int items, cudaStream_t st) {
  using L = walk::Layout<HD, G, Q8, SPLIT>;
  void (*kern)(const WalkParams) = walk_kernel<HD, G, Q8, DECODE, SPLIT>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items * p.cl, p.KV);
  cfg.blockDim = dim3(walk::Shape<G, SPLIT>::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static bool placed[9] = {};  // set outside any CUDA-graph capture that replays it
  if (!placed[p.cl]) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    placed[p.cl] = true;
  }
  return (int)cudaLaunchKernelEx(&cfg, kern, p);
}

template <bool DECODE, bool SPLIT, int HD, bool Q8>
int walk_g(int G, const WalkParams& p, int items, cudaStream_t st) {
  switch (G) {
    case 1: return launch_walk<HD, 1, Q8, DECODE, SPLIT>(p, items, st);
    case 2: return launch_walk<HD, 2, Q8, DECODE, SPLIT>(p, items, st);
    case 4: return launch_walk<HD, 4, Q8, DECODE, SPLIT>(p, items, st);
    case 8: return launch_walk<HD, 8, Q8, DECODE, SPLIT>(p, items, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 pages when the scales are null, int8 pages (page size a multiple
// of 4, for the scales' 16-byte copies) otherwise
template <bool DECODE, bool SPLIT = false>
int walk_dispatch(int HD, int G, const WalkParams& p, int items, cudaStream_t st) {
  const bool q8 = p.ks != nullptr;
  if ((p.vs != nullptr) != q8 || (q8 && p.ps % 4) ||
      (p.cl != 1 && p.cl != 2 && p.cl != 4 && p.cl != 8))
    return (int)cudaErrorInvalidValue;
  if (HD == 128) return q8 ? walk_g<DECODE, SPLIT, 128, true>(G, p, items, st)
                           : walk_g<DECODE, SPLIT, 128, false>(G, p, items, st);
  if (HD == 64) return q8 ? walk_g<DECODE, SPLIT, 64, true>(G, p, items, st)
                          : walk_g<DECODE, SPLIT, 64, false>(G, p, items, st);
  return (int)cudaErrorInvalidValue;
}

WalkParams walk_params(const void* q, const void* k_pages, const void* v_pages,
                       const void* k_scales, const void* v_scales, const void* page_tables,
                       void* out, int KV, int n_pages, int ps, int mp, int layer, float scale,
                       int window, int cluster) {
  WalkParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const unsigned char*>(k_pages);
  p.v = static_cast<const unsigned char*>(v_pages);
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.tables = static_cast<const int*>(page_tables);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.KV = KV;
  p.n_pages = n_pages;
  p.ps = ps;
  p.mp = mp;
  p.layer = layer;
  p.window = window;
  p.cl = cluster;
  p.scale = scale;
  return p;
}

bool bad_shape(int rows, int R, int KV, int n_pages, int ps, int mp) {
  return rows <= 0 || R <= 0 || KV <= 0 || n_pages <= 0 || ps <= 0 || mp <= 0;
}

// the ragged walks' launch: clusters of `cluster` blocks, rank r walking
// fixed chunks of chunk_pages pages, or with chunk_pages 0 its share of
// the visible pages
int ragged_walk(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                const void* v_scales, const void* page_tables, const void* row_starts,
                const void* q_begins, const void* q_lens, void* out, int T, int R, int KV, int G,
                int HD, int n_pages, int ps, int mp, int layer, float scale, int window,
                int cluster, int chunk_pages, void* stream) {
  if (bad_shape(T, R, KV, n_pages, ps, mp)) return (int)cudaErrorInvalidValue;
  WalkParams p = walk_params(q, k_pages, v_pages, k_scales, v_scales, page_tables, out, KV,
                             n_pages, ps, mp, layer, scale, window, cluster);
  p.row_starts = static_cast<const int*>(row_starts);
  p.q_begins = static_cast<const int*>(q_begins);
  p.q_lens = static_cast<const int*>(q_lens);
  p.R = R;
  p.chunk_pages = chunk_pages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return chunk_pages > 0 ? walk_dispatch<false, true>(HD, G, p, T, st)
                         : walk_dispatch<false>(HD, G, p, T, st);
}

}  // namespace

// cluster: the blocks per (token, KV head), 1, 2, 4 or 8
extern "C" int ragged_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* page_tables, const void* row_starts,
                                      const void* q_begins, const void* q_lens, void* out,
                                      int T, int R, int KV, int G, int HD, int n_pages, int ps,
                                      int mp, int layer, float scale, int window, int cluster,
                                      void* stream) {
  return ragged_walk(q, k_pages, v_pages, k_scales, v_scales, page_tables, row_starts,
                     q_begins, q_lens, out, T, R, KV, G, HD, n_pages, ps, mp, layer, scale,
                     window, cluster, 0, stream);
}

// chunk_pages: the pages of each of the KV_SPLIT_CHUNKS fixed chunks,
// ceil(mp / 8); one cluster of 8 blocks per (token, KV head), rank c
// walking chunk c
extern "C" int ragged_paged_attention_kvsplit(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* page_tables, const void* row_starts,
    const void* q_begins, const void* q_lens, void* out, int T, int R, int KV, int G, int HD,
    int n_pages, int ps, int mp, int layer, float scale, int window, int chunk_pages,
    void* stream) {
  if (chunk_pages <= 0 || chunk_pages * KV_SPLIT_CHUNKS < mp) return (int)cudaErrorInvalidValue;
  return ragged_walk(q, k_pages, v_pages, k_scales, v_scales, page_tables, row_starts,
                     q_begins, q_lens, out, T, R, KV, G, HD, n_pages, ps, mp, layer, scale,
                     window, KV_SPLIT_CHUNKS, chunk_pages, stream);
}

// cluster: the blocks per (sequence, KV head), 1, 2, 4 or 8
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* page_tables, const void* lengths, void* out,
                                      int B, int KV, int G, int HD, int n_pages, int ps, int mp,
                                      int layer, float scale, int window, int cluster,
                                      void* stream) {
  if (bad_shape(B, 1, KV, n_pages, ps, mp)) return (int)cudaErrorInvalidValue;
  WalkParams p = walk_params(q, k_pages, v_pages, k_scales, v_scales, page_tables, out, KV,
                             n_pages, ps, mp, layer, scale, window, cluster);
  p.lengths = static_cast<const int*>(lengths);
  return walk_dispatch<true>(HD, G, p, B, static_cast<cudaStream_t>(stream));
}
