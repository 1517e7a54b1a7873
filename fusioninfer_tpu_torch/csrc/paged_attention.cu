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
// One block of eight warps per (token or sequence, KV head[, chunk])
// carries the G query heads of that KV head.  Keys are walked 32 at a
// time, one key per lane: each lane reads its key's K row with 16-byte
// loads and scores it against the G pre-scaled query vectors held in
// shared memory; for P V, lane l owns Hd/32 output dims of every V row.
// All of a group's K and V loads are issued before any is used, so a group
// costs one memory round trip.  Each warp keeps its own online-softmax
// state over every eighth 32-key group, starting at the first key the
// window lets the query see (earlier pages are never read); the warp
// states merge in shared memory at the end.  Decode attention is bound by
// bytes: each live K/V row is read once per (token, KV head) and the
// scores never leave the SM.  int8 rows are half as many bytes, which also
// halves the registers the batched loads hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Attention of one query token (its G heads of KV head kvh) over keys
// [k_lo, k_hi) of one row's pages (table), by the whole block.
// PARTIAL=false: normalized bf16 output out[idx * HD + c] for q head row
// idx = token * KV * G + kvh * G + g, zeros when !valid.  PARTIAL=true: the
// raw (acc, m, l) at partial slot pidx = chunk * T * KV * G + idx.
template <int HD, int G, bool Q8, bool PARTIAL>
__device__ __forceinline__ void attend_row(const __nv_bfloat16* __restrict__ qrow,
                                           const Pool<Q8>& pool, const int* table, int ps,
                                           int k_lo, int k_hi, bool valid, float scale,
                                           size_t idx, size_t pidx,
                                           __nv_bfloat16* __restrict__ out,
                                           float* __restrict__ acc_p, float* __restrict__ m_p,
                                           float* __restrict__ l_p) {
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
    if (PARTIAL) {
      acc_p[(pidx + g) * HD + c] = A;
      if (c == 0) {
        m_p[pidx + g] = mm;
        l_p[pidx + g] = L;
      }
    } else {
      out[(idx + g) * HD + c] = __float2bfloat16(valid ? A / fmaxf(L, 1e-20f) : 0.f);
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

// grid (T, KV, chunks); PARTIAL=true walks chunk blockIdx.z's pages
// [c * chunk_pages, (c + 1) * chunk_pages) into [C, T, KV, G, (Hd)] f32
template <int HD, int G, bool Q8, bool PARTIAL>
__global__ void __launch_bounds__(NTHREADS, 1)
ragged_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
              const void* __restrict__ v_pages, const float* __restrict__ k_scales,
              const float* __restrict__ v_scales, Descriptors d,
              __nv_bfloat16* __restrict__ out, float* __restrict__ acc_p,
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
    if (PARTIAL) {
      k_lo = max(k_lo, chunk * chunk_pages * ps);
      k_hi = min(k_hi, (chunk + 1) * chunk_pages * ps);
    }
    table += (size_t)row * d.mp;
  }
  const Pool<Q8> pool =
      pool_slice<Q8>(k_pages, v_pages, k_scales, v_scales, layer, KV, kvh, n_pages, ps, HD);
  const size_t idx = ((size_t)t * KV + kvh) * G;  // q head row of token t
  attend_row<HD, G, Q8, PARTIAL>(q + idx * HD, pool, table, ps, k_lo, k_hi, row >= 0,
                                 scale, idx, (size_t)chunk * T * KV * G + idx, out, acc_p,
                                 m_p, l_p);
}

// grid (B, KV): one query token per sequence
template <int HD, int G, bool Q8>
__global__ void __launch_bounds__(NTHREADS, 1)
decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
              const void* __restrict__ v_pages, const float* __restrict__ k_scales,
              const float* __restrict__ v_scales, const int* __restrict__ page_tables,
              const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int KV,
              int n_pages, int ps, int mp, int layer, float scale, int window) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int len = lengths[b];
  const int pos = len - 1;
  const int k_lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int k_hi = min(len, mp * ps);
  const Pool<Q8> pool =
      pool_slice<Q8>(k_pages, v_pages, k_scales, v_scales, layer, KV, kvh, n_pages, ps, HD);
  const size_t idx = ((size_t)b * KV + kvh) * G;
  attend_row<HD, G, Q8, false>(q + idx * HD, pool, page_tables + (size_t)b * mp, ps, k_lo,
                               k_hi, len > 0, scale, idx, 0, out, nullptr, nullptr, nullptr);
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

// Everything a launch needs besides the template arguments.
struct Args {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  Descriptors d;
  const int* lengths;
  __nv_bfloat16* out;
  float* acc_p;
  float* m_p;
  float* l_p;
  int rows;  // T (ragged) or B (decode)
  int KV, n_pages, ps, layer, window, chunks, chunk_pages;
  float scale;
};

enum class Kind { kSingle, kSplit, kDecode };

template <Kind K, int HD, int G, bool Q8>
void launch(const Args& a, cudaStream_t st) {
  if constexpr (K == Kind::kDecode) {
    decode_kernel<HD, G, Q8><<<dim3(a.rows, a.KV), NTHREADS, 0, st>>>(
        a.q, a.k, a.v, a.ks, a.vs, a.d.page_tables, a.lengths, a.out, a.KV, a.n_pages, a.ps,
        a.d.mp, a.layer, a.scale, a.window);
  } else {
    constexpr bool PARTIAL = K == Kind::kSplit;
    ragged_kernel<HD, G, Q8, PARTIAL><<<dim3(a.rows, a.KV, PARTIAL ? a.chunks : 1), NTHREADS,
                                        0, st>>>(a.q, a.k, a.v, a.ks, a.vs, a.d, a.out,
                                                 a.acc_p, a.m_p, a.l_p, a.rows, a.KV,
                                                 a.n_pages, a.ps, a.layer, a.scale, a.window,
                                                 a.chunk_pages);
  }
}

template <Kind K, int HD, bool Q8>
int launch_g(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: launch<K, HD, 1, Q8>(a, st); break;
    case 2: launch<K, HD, 2, Q8>(a, st); break;
    case 4: launch<K, HD, 4, Q8>(a, st); break;
    case 8: launch<K, HD, 8, Q8>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bf16 pages when the scales are null, int8 pages otherwise
template <Kind K>
int dispatch(int HD, int G, const Args& a, cudaStream_t st) {
  const bool q8 = a.ks != nullptr;
  if ((a.vs != nullptr) != q8) return (int)cudaErrorInvalidValue;
  if (HD == 128) return q8 ? launch_g<K, 128, true>(G, a, st) : launch_g<K, 128, false>(G, a, st);
  if (HD == 64) return q8 ? launch_g<K, 64, true>(G, a, st) : launch_g<K, 64, false>(G, a, st);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int rows, int R, int KV, int n_pages, int ps, int mp) {
  return rows <= 0 || R <= 0 || KV <= 0 || n_pages <= 0 || ps <= 0 || mp <= 0;
}

Args ragged_args(const void* q, const void* k_pages, const void* v_pages,
                 const void* k_scales, const void* v_scales, const void* page_tables,
                 const void* row_starts, const void* q_begins, const void* q_lens, int T, int R,
                 int KV, int n_pages, int ps, int mp, int layer, float scale, int window) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k_pages;
  a.v = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.d = Descriptors{static_cast<const int*>(page_tables), static_cast<const int*>(row_starts),
                    static_cast<const int*>(q_begins), static_cast<const int*>(q_lens), R, mp};
  a.rows = T;
  a.KV = KV;
  a.n_pages = n_pages;
  a.ps = ps;
  a.layer = layer;
  a.scale = scale;
  a.window = window;
  a.chunks = 1;
  a.chunk_pages = mp;
  return a;
}

}  // namespace

extern "C" int ragged_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* page_tables, const void* row_starts,
                                      const void* q_begins, const void* q_lens, void* out,
                                      int T, int R, int KV, int G, int HD, int n_pages, int ps,
                                      int mp, int layer, float scale, int window,
                                      void* stream) {
  if (bad_shape(T, R, KV, n_pages, ps, mp)) return (int)cudaErrorInvalidValue;
  Args a = ragged_args(q, k_pages, v_pages, k_scales, v_scales, page_tables, row_starts,
                       q_begins, q_lens, T, R, KV, n_pages, ps, mp, layer, scale, window);
  a.out = static_cast<__nv_bfloat16*>(out);
  return dispatch<Kind::kSingle>(HD, G, a, static_cast<cudaStream_t>(stream));
}

extern "C" int ragged_paged_attention_kvsplit(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* page_tables, const void* row_starts,
    const void* q_begins, const void* q_lens, void* acc_p, void* m_p, void* l_p, void* out,
    int T, int R, int KV, int G, int HD, int n_pages, int ps, int mp, int layer, float scale,
    int window, int chunks, int chunk_pages, void* stream) {
  if (bad_shape(T, R, KV, n_pages, ps, mp) || chunks <= 0 || chunk_pages <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = ragged_args(q, k_pages, v_pages, k_scales, v_scales, page_tables, row_starts,
                       q_begins, q_lens, T, R, KV, n_pages, ps, mp, layer, scale, window);
  a.acc_p = static_cast<float*>(acc_p);
  a.m_p = static_cast<float*>(m_p);
  a.l_p = static_cast<float*>(l_p);
  a.chunks = chunks;
  a.chunk_pages = chunk_pages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = dispatch<Kind::kSplit>(HD, G, a, st);
  if (err != 0) return err;
  const int N = T * KV * G;
  kvsplit_combine_kernel<<<N, HD, 0, st>>>(a.acc_p, a.m_p, a.l_p,
                                           static_cast<__nv_bfloat16*>(out), chunks, N, HD);
  return (int)cudaGetLastError();
}

extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* page_tables, const void* lengths, void* out,
                                      int B, int KV, int G, int HD, int n_pages, int ps, int mp,
                                      int layer, float scale, int window, void* stream) {
  if (bad_shape(B, 1, KV, n_pages, ps, mp)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k_pages;
  a.v = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.d = Descriptors{static_cast<const int*>(page_tables), nullptr, nullptr, nullptr, B, mp};
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.rows = B;
  a.KV = KV;
  a.n_pages = n_pages;
  a.ps = ps;
  a.layer = layer;
  a.scale = scale;
  a.window = window;
  return dispatch<Kind::kDecode>(HD, G, a, static_cast<cudaStream_t>(stream));
}
