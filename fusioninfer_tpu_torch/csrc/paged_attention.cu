// Paged attention over the head-major KV pool, written for Hopper (sm_90a):
// the one-query-per-row page walks.
//
// Replaces three Pallas TPU kernels of fusioninfer_tpu/ops/paged_attention.py:
// ragged_paged_attention (one page walk per token), ragged_paged_attention_
// kvsplit (the walk split over fixed virtual chunks, f32 (acc, m, l)
// partials, then a left-to-right log-sum-exp combine) and
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
// The single walk and paged decode (walk_kernel, one body for both):
//
// * A thread-block cluster of CL blocks per (token or sequence, KV head)
//   carries the G query heads of that KV head.  Rank r of the cluster
//   walks the r-th share of ceil(n / CL) of the n pages the query sees,
//   counted from the first page its window lets it see (earlier pages are
//   never read); a rank with no keys goes straight to the merge.  The
//   caller picks CL from shapes alone (ops/paged_attention.py
//   pick_cluster_size), so the launch reads nothing back from the card.
//   Each rank's f32 (acc, m, l) stays in its shared memory; after a
//   cluster barrier every rank reads all ranks' partials through
//   distributed shared memory (mapa, ld.shared::cluster) for its slice of
//   the outputs and folds them left to right from rank 0, so each output
//   has one fixed order.  One launch, no scratch, no atomics.
// * A producer warp streams the rank's keys through a ring of STAGES
//   stages of BK keys (16 KB of K and V rows a stage): one bulk copy
//   (cp.async.bulk into the stage's "full" mbarrier) per page segment of
//   K and of V, rows [off, off + n) of a page being one contiguous run of
//   the pool, and with int8 pages one per segment of K and of V scales
//   (widened to 4-key alignment: 16-byte copies).  No register holds a
//   load in flight; four blocks of an SM keep ~190 KB in flight.
// * Four consumer warps split each stage into batches of 32 / G keys: lane
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
//
// The split walk (split_kernel, attend_row, kvsplit_combine_kernel) keeps
// one block of eight warps per (token, KV head, virtual chunk): keys are
// walked 32 at a time, one key per lane, each lane reading its key's K row
// with 16-byte loads against the G pre-scaled query vectors in shared
// memory; for P V, lane l owns Hd/32 output dims of every V row.  All of a
// group's K and V loads are issued before any is used.  Each chunk's block
// writes f32 partials and a second kernel folds them left to right.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_attention.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// the four signed bytes of a word, lowest first -> floats (exact)
__device__ __forceinline__ void i8x4_to_float(unsigned w, float* f) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = (float)b[i];
}

// one 16-byte chunk of a K row: 8 bf16 or 16 int8 values -> floats
template <bool Q8>
__device__ __forceinline__ void chunk_to_float(const uint4& raw, float* f) {
  if constexpr (Q8) {
    i8x4_to_float(raw.x, f);
    i8x4_to_float(raw.y, f + 4);
    i8x4_to_float(raw.z, f + 8);
    i8x4_to_float(raw.w, f + 12);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
}

// the DPL = Hd / 32 output dims one lane owns of a V row, raw
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

template <int DPL, bool Q8>
__device__ __forceinline__ void v_to_float(const VRaw<DPL, Q8>& raw, float* f) {
  if constexpr (Q8) {
    float t[4];
    i8x4_to_float((unsigned)raw, t);
#pragma unroll
    for (int i = 0; i < DPL; ++i) f[i] = t[i];
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < DPL / 2; ++i) {
      const float2 a = __bfloat1622float2(h[i]);
      f[2 * i] = a.x;
      f[2 * i + 1] = a.y;
    }
  }
}

template <bool Q8>
using PageT = std::conditional_t<Q8, int8_t, __nv_bfloat16>;

// one (layer, KV head) slice of the pools; scales are null for bf16 pages
template <bool Q8>
struct Pool {
  const PageT<Q8>* k;
  const PageT<Q8>* v;
  const float* ks;
  const float* vs;
};

template <bool Q8>
__device__ __forceinline__ Pool<Q8> pool_slice(const void* k_pages, const void* v_pages,
                                               const float* k_scales, const float* v_scales,
                                               int layer, int KV, int kvh, int n_pages, int ps,
                                               int HD) {
  const size_t rows = ((size_t)layer * KV + kvh) * (size_t)n_pages * ps;
  Pool<Q8> p;
  p.k = static_cast<const PageT<Q8>*>(k_pages) + rows * HD;
  p.v = static_cast<const PageT<Q8>*>(v_pages) + rows * HD;
  p.ks = Q8 ? k_scales + rows : nullptr;
  p.vs = Q8 ? v_scales + rows : nullptr;
  return p;
}

// The split walk's chunk: attention of one query token (its G heads of KV
// head kvh) over keys [k_lo, k_hi) of one row's pages (table), by the whole
// block, as the raw (acc, m, l) at partial slot pidx = chunk * T * KV * G +
// token * KV * G + kvh * G.
template <int HD, int G, bool Q8>
__device__ __forceinline__ void attend_row(const __nv_bfloat16* __restrict__ qrow,
                                           const Pool<Q8>& pool, const int* table, int ps,
                                           int k_lo, int k_hi, bool valid, float scale,
                                           size_t pidx, float* __restrict__ acc_p,
                                           float* __restrict__ m_p, float* __restrict__ l_p) {
  constexpr int DPL = HD / 32;
  constexpr int EPC = Q8 ? 16 : 8;  // K values per 16-byte chunk
  constexpr int KCH = HD / EPC;     // 16-byte chunks per K row
  __shared__ __align__(16) float sq[G][HD];
  __shared__ float s_m[NWARPS][G];
  __shared__ float s_l[NWARPS][G];
  __shared__ __align__(16) float s_acc[NWARPS][G][HD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < G * HD; i += NTHREADS)
    sq[i / HD][i % HD] = __bfloat162float(qrow[i]) * scale;
  __syncthreads();

  float m[G], lsum[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lsum[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  if (valid && k_lo < k_hi) {
    for (int grp = (k_lo >> 5) + warp; grp * 32 < k_hi; grp += NWARPS) {
      const int kpos = grp * 32 + lane;
      const bool kv = kpos >= k_lo && kpos < k_hi;
      // an invalid lane reads the group's first valid key (weight 0)
      const int kk = kv ? kpos : max(grp * 32, k_lo);
      const long long krow = (long long)table[kk / ps] * ps + (kk % ps);
      // issue every load of the group before using any: this lane's K row
      // (and scales), and dims [lane*DPL, lane*DPL + DPL) of all 32 V rows
      uint4 kraw[KCH];
      const uint4* kp = reinterpret_cast<const uint4*>(pool.k + krow * HD);
#pragma unroll
      for (int c = 0; c < KCH; ++c) kraw[c] = __ldg(kp + c);
      float ksc = 1.f, vsc = 1.f;
      if constexpr (Q8) {
        ksc = __ldg(pool.ks + krow);
        vsc = __ldg(pool.vs + krow);
      }
      VRaw<DPL, Q8> vraw[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const long long rj = __shfl_sync(FULL, krow, j);
        vraw[j] = __ldg(reinterpret_cast<const VRaw<DPL, Q8>*>(pool.v + rj * HD + lane * DPL));
      }
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
      for (int c = 0; c < KCH; ++c) {
        float kf[EPC];
        chunk_to_float<Q8>(kraw[c], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e = 0; e < EPC; e += 4) {
            const float4 qa = *reinterpret_cast<const float4*>(&sq[g][EPC * c + e]);
            s[g] += qa.x * kf[e] + qa.y * kf[e + 1] + qa.z * kf[e + 2] + qa.w * kf[e + 3];
          }
        }
      }
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // every visited group holds at least one valid key, so m_new is finite
        const float sg = kv ? s[g] * ksc : -INFINITY;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = __expf(m[g] - m_new);
        p[g] = kv ? __expf(sg - m_new) : 0.f;
        lsum[g] = lsum[g] * alpha + p[g];
        p[g] *= vsc;  // the V scale weights the probability, not the sum
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float vf[DPL];
        v_to_float<DPL, Q8>(vraw[j], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(FULL, p[g], j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] += pj * vf[i];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lw = warp_sum(lsum[g]);
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = lw;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) s_acc[warp][g][lane * DPL + i] = acc[g][i];
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += NTHREADS) {
    const int g = i / HD, c = i % HD;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, s_m[w][g]);
    float L = 0.f, A = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float sc = __expf(s_m[w][g] - mm);
        L += sc * s_l[w][g];
        A += sc * s_acc[w][g][c];
      }
    }
    acc_p[(pidx + g) * HD + c] = A;
    if (c == 0) {
      m_p[pidx + g] = mm;
      l_p[pidx + g] = L;
    }
  }
}

struct Descriptors {
  const int* page_tables;
  const int* row_starts;
  const int* q_begins;
  const int* q_lens;
  int R;
  int mp;
};

// grid (T, KV, chunks): walks chunk blockIdx.z's pages [c * chunk_pages,
// (c + 1) * chunk_pages) into [C, T, KV, G, (Hd)] f32
template <int HD, int G, bool Q8>
__global__ void __launch_bounds__(NTHREADS, 1)
split_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
             const void* __restrict__ v_pages, const float* __restrict__ k_scales,
             const float* __restrict__ v_scales, Descriptors d, float* __restrict__ acc_p,
             float* __restrict__ m_p, float* __restrict__ l_p, int T, int KV, int n_pages,
             int ps, int layer, float scale, int window, int chunk_pages) {
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int chunk = blockIdx.z;

  int row = -1;
  for (int r = 0; r < d.R; ++r) {
    const int qb = d.q_begins[r];
    if (t >= qb && t < qb + d.q_lens[r]) {
      row = r;
      break;
    }
  }
  int k_lo = 0, k_hi = 0;
  const int* table = d.page_tables;
  if (row >= 0) {
    const int pos = d.row_starts[row] + (t - d.q_begins[row]);
    k_lo = window > 0 ? max(pos - window + 1, 0) : 0;
    k_hi = min(pos + 1, d.mp * ps);
    k_lo = max(k_lo, chunk * chunk_pages * ps);
    k_hi = min(k_hi, (chunk + 1) * chunk_pages * ps);
    table += (size_t)row * d.mp;
  }
  const Pool<Q8> pool =
      pool_slice<Q8>(k_pages, v_pages, k_scales, v_scales, layer, KV, kvh, n_pages, ps, HD);
  const size_t idx = ((size_t)t * KV + kvh) * G;  // q head row of token t
  attend_row<HD, G, Q8>(q + idx * HD, pool, table, ps, k_lo, k_hi, row >= 0, scale,
                        (size_t)chunk * T * KV * G + idx, acc_p, m_p, l_p);
}

// Fixed left-to-right fold of the C chunk partials; one block per
// (token, q head), one thread per output dim.
__global__ void kvsplit_combine_kernel(const float* __restrict__ acc_p,
                                       const float* __restrict__ m_p,
                                       const float* __restrict__ l_p,
                                       __nv_bfloat16* __restrict__ out, int C, int N,
                                       int HD) {
  const size_t idx = blockIdx.x;
  const int c = threadIdx.x;
  float m = m_p[idx], l = l_p[idx], a = acc_p[idx * HD + c];
  for (int ch = 1; ch < C; ++ch) {
    const size_t j = (size_t)ch * N + idx;
    const float mc = m_p[j];
    const float m_new = fmaxf(m, mc);
    const bool dead = m_new == -INFINITY;
    const float alpha = dead ? 0.f : expf(m - m_new);
    const float beta = dead ? 0.f : expf(mc - m_new);
    l = alpha * l + beta * l_p[j];
    a = alpha * a + beta * acc_p[j * HD + c];
    m = m_new;
  }
  out[idx * HD + c] = __float2bfloat16(a / fmaxf(l, 1e-20f));
}


// -- the single walk and paged decode: one cluster per (token, KV head) ---------------

namespace walk {

constexpr int CONSUMERS = 4;                   // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int STAGES = 3;
constexpr int STAGE_KV_BYTES = 16384;  // the K and V rows of one stage

// A stage: BK K rows, BK V rows, then (int8 pages) BK K and BK V scales.
// The barriers and each consumer warp's 32 probabilities follow the
// ring; once every stage is consumed the ring holds the warps' states
// and the rank's partial (Merge).
template <int HD, bool Q8>
struct Layout {
  static constexpr int ROW = HD * (Q8 ? 1 : 2);  // bytes of one K or V row
  static constexpr int BK = STAGE_KV_BYTES / (2 * ROW);
  static constexpr int V_OFF = BK * ROW;
  static constexpr int KS_OFF = 2 * BK * ROW;
  static constexpr int VS_OFF = KS_OFF + (Q8 ? 4 * BK : 0);
  static constexpr int STAGE = VS_OFF + (Q8 ? 4 * BK : 0);
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int PROBS = BARS + 2 * STAGES * 8;
  static constexpr int BYTES = PROBS + CONSUMERS * 32 * 4;
};

// f32 views of the ring after the walk: each warp's (o [G][HD], m [G],
// l [G]), then the rank's partial (acc [G][HD], m [G], l [G]), which
// every rank of the cluster reads
template <int HD, int G>
struct Merge {
  float* wo;
  float* wm;
  float* wl;
  float* acc;
  float* m;
  float* l;
  static constexpr int FLOATS = CONSUMERS * G * (HD + 2) + G * (HD + 2);
  __device__ explicit Merge(unsigned char* ring) {
    wo = reinterpret_cast<float*>(ring);
    wm = wo + CONSUMERS * G * HD;
    wl = wm + CONSUMERS * G;
    acc = wl + CONSUMERS * G;
    m = acc + G * HD;
    l = m + G;
  }
};

}  // namespace walk

// Reduce-scatter of 32 values across the warp: each step keeps the half of
// a lane's values that its lane bit W selects and adds its partner's copy
// of that half; afterwards lane l holds in v[0] the warp's sum of value l.
template <int W>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
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
// CL (a token, or with DECODE a sequence), KV head blockIdx.y
template <int HD, int G, bool Q8, bool DECODE>
__global__ void __launch_bounds__(walk::THREADS, G == 8 ? 3 : 4)
walk_kernel(const WalkParams p) {
  using L = walk::Layout<HD, Q8>;
  constexpr int W = walk::CONSUMERS, NS = walk::STAGES, BK = L::BK;
  constexpr int DPL = HD / 32;  // dims per lane
  constexpr int KB = 32 / G;    // keys per batch: one (key, head) score per lane
  constexpr int NB = BK / KB;   // batches per stage
  static_assert(NB >= 1 && BK % 4 == 0, "stage");
  static_assert(walk::Merge<HD, G>::FLOATS * 4 <= L::BARS, "the merge fits the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + NS;

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
  // this rank's share: pages [pa, pb) of ceil(n / CL), keys [lo, hi)
  const int p_lo = k_lo / p.ps;
  const int p_hi = k_hi > k_lo ? (k_hi + p.ps - 1) / p.ps : p_lo;
  const int per = (p_hi - p_lo + p.cl - 1) / p.cl;
  const int pa = p_lo + (int)rank * per, pb = min(pa + per, p_hi);
  const int lo = max(k_lo, pa * p.ps), hi = min(k_hi, pb * p.ps);
  // stage j holds keys [base + j BK, base + (j + 1) BK), of which [lo, hi)
  // are this rank's; base is 4-aligned for the scales' copies
  const int base = lo & ~3;
  const int n_stages = hi > lo ? (hi - base + BK - 1) / BK : 0;
  const size_t idx = ((size_t)item * p.KV + kvh) * G;  // q head row of the item

  // V rows that no copy writes (stage edges) are read with probability 0:
  // zero them once, so they hold 0 or real values from an earlier stage,
  // never a NaN that 0 times it would spread
  for (int i = threadIdx.x; i < NS * BK * L::ROW / 16; i += walk::THREADS) {
    const int s = i / (BK * L::ROW / 16), c = i % (BK * L::ROW / 16);
    reinterpret_cast<uint4*>(smem + s * L::STAGE + L::V_OFF)[c] = make_uint4(0, 0, 0, 0);
  }
  hopper::fence_proxy_async();  // before the copies that overwrite them
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  walk::Merge<HD, G> mg(smem);
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
      for (int b = warp; b < NB; b += W) {
        const int b_lo = s_lo + b * KB;
        if (b_lo + KB <= k0 || b_lo >= k1) continue;
        const unsigned char* kr = st + b * KB * L::ROW + lane * DPL * (Q8 ? 1 : 2);
        // partial dots over this lane's dims: part[kk G + g] for key kk, head g
        float part[32];
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          float kf[DPL];
          widen<DPL, Q8>(*reinterpret_cast<const VRaw<DPL, Q8>*>(kr + kk * L::ROW), kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float acc = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc = fmaf(qf[g][d], kf[d], acc);
            part[kk * G + g] = acc;
          }
        }
        // lane l's score: the full dot of key l / G, head l % G
        reduce_scatter<16>(part, lane);
        const int key = b_lo + lane / G;
        const bool kv = key >= k0 && key < k1;
        float sc = part[0], vsc = 1.f;
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
      mg.acc[i] = A;
      if (c == 0) {
        mg.m[g] = mm;
        mg.l[g] = Ls;
      }
    }
  }

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

// Launch the walk in clusters of p.cl blocks.  Once per cluster size, the
// dynamic shared memory is allowed and the card asked whether such a
// cluster can be placed at all (cudaOccupancyMaxActiveClusters); one that
// cannot is refused here, never run another way.
template <int HD, int G, bool Q8, bool DECODE>
int launch_walk(const WalkParams& p, int items, cudaStream_t st) {
  using L = walk::Layout<HD, Q8>;
  void (*kern)(const WalkParams) = walk_kernel<HD, G, Q8, DECODE>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items * p.cl, p.KV);
  cfg.blockDim = dim3(walk::THREADS);
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

template <bool DECODE, int HD, bool Q8>
int walk_g(int G, const WalkParams& p, int items, cudaStream_t st) {
  switch (G) {
    case 1: return launch_walk<HD, 1, Q8, DECODE>(p, items, st);
    case 2: return launch_walk<HD, 2, Q8, DECODE>(p, items, st);
    case 4: return launch_walk<HD, 4, Q8, DECODE>(p, items, st);
    case 8: return launch_walk<HD, 8, Q8, DECODE>(p, items, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 pages when the scales are null, int8 pages (page size a multiple
// of 4, for the scales' 16-byte copies) otherwise
template <bool DECODE>
int walk_dispatch(int HD, int G, const WalkParams& p, int items, cudaStream_t st) {
  const bool q8 = p.ks != nullptr;
  if ((p.vs != nullptr) != q8 || (q8 && p.ps % 4) ||
      (p.cl != 1 && p.cl != 2 && p.cl != 4 && p.cl != 8))
    return (int)cudaErrorInvalidValue;
  if (HD == 128) return q8 ? walk_g<DECODE, 128, true>(G, p, items, st)
                           : walk_g<DECODE, 128, false>(G, p, items, st);
  if (HD == 64) return q8 ? walk_g<DECODE, 64, true>(G, p, items, st)
                          : walk_g<DECODE, 64, false>(G, p, items, st);
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

// -- the split walk's launch ----------------------------------------------------------

struct SplitArgs {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  Descriptors d;
  float* acc_p;
  float* m_p;
  float* l_p;
  int T, KV, n_pages, ps, layer, window, chunks, chunk_pages;
  float scale;
};

template <int HD, int G, bool Q8>
void launch_split(const SplitArgs& a, cudaStream_t st) {
  split_kernel<HD, G, Q8><<<dim3(a.T, a.KV, a.chunks), NTHREADS, 0, st>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.d, a.acc_p, a.m_p, a.l_p, a.T, a.KV, a.n_pages, a.ps,
      a.layer, a.scale, a.window, a.chunk_pages);
}

template <int HD, bool Q8>
int split_g(int G, const SplitArgs& a, cudaStream_t st) {
  switch (G) {
    case 1: launch_split<HD, 1, Q8>(a, st); break;
    case 2: launch_split<HD, 2, Q8>(a, st); break;
    case 4: launch_split<HD, 4, Q8>(a, st); break;
    case 8: launch_split<HD, 8, Q8>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int rows, int R, int KV, int n_pages, int ps, int mp) {
  return rows <= 0 || R <= 0 || KV <= 0 || n_pages <= 0 || ps <= 0 || mp <= 0;
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
  if (bad_shape(T, R, KV, n_pages, ps, mp)) return (int)cudaErrorInvalidValue;
  WalkParams p = walk_params(q, k_pages, v_pages, k_scales, v_scales, page_tables, out, KV,
                             n_pages, ps, mp, layer, scale, window, cluster);
  p.row_starts = static_cast<const int*>(row_starts);
  p.q_begins = static_cast<const int*>(q_begins);
  p.q_lens = static_cast<const int*>(q_lens);
  p.R = R;
  return walk_dispatch<false>(HD, G, p, T, static_cast<cudaStream_t>(stream));
}

extern "C" int ragged_paged_attention_kvsplit(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* page_tables, const void* row_starts,
    const void* q_begins, const void* q_lens, void* acc_p, void* m_p, void* l_p, void* out,
    int T, int R, int KV, int G, int HD, int n_pages, int ps, int mp, int layer, float scale,
    int window, int chunks, int chunk_pages, void* stream) {
  if (bad_shape(T, R, KV, n_pages, ps, mp) || chunks <= 0 || chunk_pages <= 0 ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  SplitArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k_pages;
  a.v = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.d = Descriptors{static_cast<const int*>(page_tables), static_cast<const int*>(row_starts),
                    static_cast<const int*>(q_begins), static_cast<const int*>(q_lens), R, mp};
  a.acc_p = static_cast<float*>(acc_p);
  a.m_p = static_cast<float*>(m_p);
  a.l_p = static_cast<float*>(l_p);
  a.T = T;
  a.KV = KV;
  a.n_pages = n_pages;
  a.ps = ps;
  a.layer = layer;
  a.window = window;
  a.chunks = chunks;
  a.chunk_pages = chunk_pages;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool q8 = a.ks != nullptr;
  int err = (int)cudaErrorInvalidValue;
  if (HD == 128) err = q8 ? split_g<128, true>(G, a, st) : split_g<128, false>(G, a, st);
  if (HD == 64) err = q8 ? split_g<64, true>(G, a, st) : split_g<64, false>(G, a, st);
  if (err != 0) return err;
  const int N = T * KV * G;
  kvsplit_combine_kernel<<<N, HD, 0, st>>>(a.acc_p, a.m_p, a.l_p,
                                           static_cast<__nv_bfloat16*>(out), chunks, N, HD);
  return (int)cudaGetLastError();
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
