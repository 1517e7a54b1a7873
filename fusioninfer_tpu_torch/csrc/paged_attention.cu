// Ragged paged attention over the head-major KV pool, written for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of fusioninfer_tpu/ops/paged_attention.py:
// ragged_paged_attention (one page walk per token) and
// ragged_paged_attention_kvsplit (the walk split over fixed virtual chunks,
// f32 (acc, m, l) partials, then a left-to-right log-sum-exp combine).
//
// q [T, H, Hd] bf16; pools [L, KV, n_pages, ps, Hd] bf16; page_tables
// [R, mp] int32; row_starts / q_begins / q_lens [R] int32.  Token t belongs
// to the row whose segment [q_begins[r], q_begins[r] + q_lens[r]) holds it,
// sits at position row_starts[r] + t - q_begins[r], and attends causally
// (and within `window` when > 0) over that row's pages.  Tokens in no row
// produce zeros.
//
// One block of eight warps per (token, KV head[, chunk]) carries the
// token's G query heads.  Keys are walked 32 at a time, one key per lane:
// each lane reads its key's K row with 16-byte loads and scores it against
// the G pre-scaled query vectors held in shared memory; for P V, lane l
// owns Hd/32 output dims of every V row.  All of a group's K and V loads
// are issued before any is used, so a group costs one memory round trip.
// Each warp keeps its own online-softmax state over every eighth 32-key
// group; the warp states merge in shared memory at the end.  Decode
// attention is bound by bytes: each live K/V row is read once per (token,
// KV head) and the scores never leave the SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// DPL = Hd / 32 output dims per lane (2 or 4): raw bf16 of one V row slice
template <int DPL>
struct VRawT;
template <>
struct VRawT<4> { using type = uint2; };
template <>
struct VRawT<2> { using type = unsigned; };
template <int DPL>
using VRaw = typename VRawT<DPL>::type;

template <int DPL>
__device__ __forceinline__ VRaw<DPL> load_v_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const VRaw<DPL>*>(p));
}

template <int DPL>
__device__ __forceinline__ void v_to_float(const VRaw<DPL>& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    const float2 a = __bfloat1622float2(h[i]);
    f[2 * i] = a.x;
    f[2 * i + 1] = a.y;
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

// PARTIAL=false: normalized bf16 output [T, H*Hd].
// PARTIAL=true: raw (acc, m, l) of virtual chunk blockIdx.z, pages
// [c * chunk_pages, (c + 1) * chunk_pages), into [C, T, KV, G, (Hd)] f32.
template <int HD, int G, bool PARTIAL>
__global__ void __launch_bounds__(NTHREADS, 1)
ragged_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k_pages,
              const __nv_bfloat16* __restrict__ v_pages, Descriptors d,
              __nv_bfloat16* __restrict__ out, float* __restrict__ acc_p,
              float* __restrict__ m_p, float* __restrict__ l_p, int T, int KV,
              int n_pages, int ps, int layer, float scale, int window,
              int chunk_pages) {
  constexpr int DPL = HD / 32;
  __shared__ __align__(16) float sq[G][HD];
  __shared__ float s_m[NWARPS][G];
  __shared__ float s_l[NWARPS][G];
  __shared__ __align__(16) float s_acc[NWARPS][G][HD];

  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int chunk = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int H = KV * G;

  int row = -1;
  for (int r = 0; r < d.R; ++r) {
    const int qb = d.q_begins[r];
    if (t >= qb && t < qb + d.q_lens[r]) {
      row = r;
      break;
    }
  }

  for (int i = tid; i < G * HD; i += NTHREADS) {
    const int g = i / HD, c = i % HD;
    sq[g][c] = __bfloat162float(q[((size_t)t * H + kvh * G + g) * HD + c]) * scale;
  }
  __syncthreads();

  float m[G], lsum[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lsum[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  if (row >= 0) {
    const int pos = d.row_starts[row] + (t - d.q_begins[row]);
    int k_lo = window > 0 ? max(pos - window + 1, 0) : 0;
    int k_hi = min(pos + 1, d.mp * ps);
    if (PARTIAL) {
      k_lo = max(k_lo, chunk * chunk_pages * ps);
      k_hi = min(k_hi, (chunk + 1) * chunk_pages * ps);
    }
    const int* table = d.page_tables + (size_t)row * d.mp;
    const size_t pool = ((size_t)layer * KV + kvh) * (size_t)n_pages * ps * HD;
    const __nv_bfloat16* kbase = k_pages + pool;
    const __nv_bfloat16* vbase = v_pages + pool;

    if (k_lo < k_hi) {
      for (int grp = (k_lo >> 5) + warp; grp * 32 < k_hi; grp += NWARPS) {
        const int kpos = grp * 32 + lane;
        const bool valid = kpos >= k_lo && kpos < k_hi;
        // an invalid lane reads the group's first valid key (weight 0)
        const int kk = valid ? kpos : max(grp * 32, k_lo);
        const long long roff = ((long long)table[kk / ps] * ps + (kk % ps)) * HD;
        // issue every load of the group before using any: this lane's K
        // row, and dims [lane*DPL, lane*DPL + DPL) of all 32 V rows
        uint4 kraw[HD / 8];
        const uint4* krow = reinterpret_cast<const uint4*>(kbase + roff);
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) kraw[c] = __ldg(krow + c);
        VRaw<DPL> vraw[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const long long rj = __shfl_sync(FULL, roff, j);
          vraw[j] = load_v_raw<DPL>(vbase + rj + lane * DPL);
        }
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          float kf[8];
          bf16x8_to_float(kraw[c], kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qa = *reinterpret_cast<const float4*>(&sq[g][8 * c]);
            const float4 qb = *reinterpret_cast<const float4*>(&sq[g][8 * c + 4]);
            s[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                    qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
          }
        }
        float p[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          // every visited group holds at least one valid key, so m_new is finite
          const float sg = valid ? s[g] : -INFINITY;
          const float m_new = fmaxf(m[g], warp_max(sg));
          const float alpha = __expf(m[g] - m_new);
          p[g] = valid ? __expf(sg - m_new) : 0.f;
          lsum[g] = lsum[g] * alpha + p[g];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
          m[g] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float vf[DPL];
          v_to_float<DPL>(vraw[j], vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pj = __shfl_sync(FULL, p[g], j);
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[g][i] += pj * vf[i];
          }
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
    const size_t idx = ((size_t)t * KV + kvh) * G + g;  // == q head row of token t
    if (PARTIAL) {
      const size_t cidx = (size_t)chunk * T * KV * G + idx;
      acc_p[cidx * HD + c] = A;
      if (c == 0) {
        m_p[cidx] = mm;
        l_p[cidx] = L;
      }
    } else {
      out[idx * HD + c] = __float2bfloat16(row >= 0 ? A / fmaxf(L, 1e-20f) : 0.f);
    }
  }
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

template <bool PARTIAL, int HD, int G>
int launch(const void* q, const void* k, const void* v, const Descriptors& d, void* out,
           float* acc_p, float* m_p, float* l_p, int T, int KV, int n_pages, int ps,
           int layer, float scale, int window, int chunks, int chunk_pages,
           cudaStream_t stream) {
  dim3 grid(T, KV, PARTIAL ? chunks : 1);
  ragged_kernel<HD, G, PARTIAL><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), d, static_cast<__nv_bfloat16*>(out), acc_p,
      m_p, l_p, T, KV, n_pages, ps, layer, scale, window, chunk_pages);
  return (int)cudaGetLastError();
}

template <bool PARTIAL, int HD>
int launch_g(int G, const void* q, const void* k, const void* v, const Descriptors& d,
             void* out, float* acc_p, float* m_p, float* l_p, int T, int KV, int n_pages,
             int ps, int layer, float scale, int window, int chunks, int chunk_pages,
             cudaStream_t stream) {
#define FI_LAUNCH(GG)                                                                    \
  return launch<PARTIAL, HD, GG>(q, k, v, d, out, acc_p, m_p, l_p, T, KV, n_pages, ps, \
                                 layer, scale, window, chunks, chunk_pages, stream)
  switch (G) {
    case 1: FI_LAUNCH(1);
    case 2: FI_LAUNCH(2);
    case 4: FI_LAUNCH(4);
    case 8: FI_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FI_LAUNCH
}

template <bool PARTIAL>
int dispatch(int HD, int G, const void* q, const void* k, const void* v,
             const Descriptors& d, void* out, float* acc_p, float* m_p, float* l_p, int T,
             int KV, int n_pages, int ps, int layer, float scale, int window, int chunks,
             int chunk_pages, cudaStream_t stream) {
  if (HD == 128)
    return launch_g<PARTIAL, 128>(G, q, k, v, d, out, acc_p, m_p, l_p, T, KV, n_pages, ps,
                                  layer, scale, window, chunks, chunk_pages, stream);
  if (HD == 64)
    return launch_g<PARTIAL, 64>(G, q, k, v, d, out, acc_p, m_p, l_p, T, KV, n_pages, ps,
                                 layer, scale, window, chunks, chunk_pages, stream);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int T, int R, int KV, int n_pages, int ps, int mp) {
  return T <= 0 || R <= 0 || KV <= 0 || n_pages <= 0 || ps <= 0 || mp <= 0;
}

}  // namespace

extern "C" int ragged_paged_attention_bf16(const void* q, const void* k_pages,
                                           const void* v_pages, const void* page_tables,
                                           const void* row_starts, const void* q_begins,
                                           const void* q_lens, void* out, int T, int R,
                                           int KV, int G, int HD, int n_pages, int ps,
                                           int mp, int layer, float scale, int window,
                                           void* stream) {
  if (bad_shape(T, R, KV, n_pages, ps, mp)) return (int)cudaErrorInvalidValue;
  const Descriptors d{static_cast<const int*>(page_tables), static_cast<const int*>(row_starts),
                      static_cast<const int*>(q_begins), static_cast<const int*>(q_lens), R,
                      mp};
  return dispatch<false>(HD, G, q, k_pages, v_pages, d, out, nullptr, nullptr, nullptr, T,
                         KV, n_pages, ps, layer, scale, window, 1, mp,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int ragged_paged_attention_kvsplit_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* page_tables,
    const void* row_starts, const void* q_begins, const void* q_lens, void* acc_p,
    void* m_p, void* l_p, void* out, int T, int R, int KV, int G, int HD, int n_pages,
    int ps, int mp, int layer, float scale, int window, int chunks, int chunk_pages,
    void* stream) {
  if (bad_shape(T, R, KV, n_pages, ps, mp) || chunks <= 0 || chunk_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const Descriptors d{static_cast<const int*>(page_tables), static_cast<const int*>(row_starts),
                      static_cast<const int*>(q_begins), static_cast<const int*>(q_lens), R,
                      mp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(acc_p);
  float* m = static_cast<float*>(m_p);
  float* l = static_cast<float*>(l_p);
  int err = dispatch<true>(HD, G, q, k_pages, v_pages, d, nullptr, acc, m, l, T, KV, n_pages,
                           ps, layer, scale, window, chunks, chunk_pages, st);
  if (err != 0) return err;
  const int N = T * KV * G;
  kvsplit_combine_kernel<<<N, HD, 0, st>>>(acc, m, l, static_cast<__nv_bfloat16*>(out),
                                           chunks, N, HD);
  return (int)cudaGetLastError();
}
