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
// One block of four warps per (64-row tile, KV head, sequence).  A tile's
// rows are (query, group head) pairs, row i * G + g for query i and head g
// of the KV head's G query heads, as on the TPU: every K/V tile a block
// reads serves all G heads.  Each warp owns 16 rows for the whole key
// sweep; K/V tiles of 64 keys are read through the page table (each key
// row finds its own page, so a tile may span pages of any size) into a
// two-stage cp.async ring in shared memory.  Both products run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), and the
// scores, the online-softmax statistics (f32, base 2) and the output stay
// in registers, as in csrc/flash_attention.cu.  The causal wavefront bounds
// each tile's sweep: it stops after the last real query's position, and
// under a window starts at the first key the tile's first query sees.
//
// int8 pages are staged raw and widened to bf16 in shared memory (int8
// values are exact in bf16); the K scale multiplies each score after the
// Q K^T product and the V scale each probability before P V, so no page
// is dequantized.  Prefill at C in the hundreds is bound by operations,
// verify at small C by the bytes of the pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // (query, head) rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// bf16 rows padded by 16 bytes so the eight rows one ldmatrix reads fall in
// distinct banks; raw int8 staging rows likewise
template <int HD>
__host__ __device__ constexpr int ld_tile() { return HD + 8; }
template <int HD>
__host__ __device__ constexpr int ld_raw() { return HD + 16; }

template <int HD, bool Q8>
constexpr size_t smem_bytes() {
  // sQ + two K and two V stages (bf16), or sQ + widened K, V + two raw
  // stages of K and V + the tile's scales (int8)
  const size_t tile = sizeof(__nv_bfloat16) * (size_t)BQ * ld_tile<HD>();
  if (!Q8) return 5 * tile;
  return 3 * tile + 4 * (size_t)BK * ld_raw<HD>() + 2 * BK * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// pool row (page * ps + slot) of key kpos of the sequence, -1 past k_hi
__device__ __forceinline__ long long key_row(const int* table, int ps, int kpos, int k_hi) {
  return kpos < k_hi ? (long long)table[kpos / ps] * ps + kpos % ps : -1;
}

// keys [k0, k0 + 64) of one pool (rows of ROW_BYTES) into a tile of rows
// LD_BYTES apart; keys at or past k_hi are zero-filled
template <int ROW_BYTES, int LD_BYTES>
__device__ __forceinline__ void load_keys(unsigned char* dst, const unsigned char* pool,
                                          const int* table, int ps, int k0, int k_hi,
                                          int tid) {
  constexpr int CH = ROW_BYTES / 16;
#pragma unroll
  for (int i = tid; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const long long row = key_row(table, ps, k0 + r, k_hi);
    const unsigned char* src = pool + (row < 0 ? 0 : row) * ROW_BYTES + c * 16;
    cp_async16(dst + r * LD_BYTES + c * 16, src, row < 0 ? 0 : 16);
  }
}

// widen a staged int8 tile to bf16 (exact)
template <int HD>
__device__ __forceinline__ void widen_tile(__nv_bfloat16* dst, const int8_t* src, int tid) {
  constexpr int CH = HD / 16;
#pragma unroll
  for (int i = tid; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ld_raw<HD>() + c * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    unsigned o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = pack_bf16((float)b[2 * k], (float)b[2 * k + 1]);
    uint4* d = reinterpret_cast<uint4*>(dst + r * ld_tile<HD>() + c * 16);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

template <int HD, int G, bool Q8>
__global__ void __launch_bounds__(NTHREADS)
window_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
              const void* __restrict__ v_pages, const float* __restrict__ k_scales,
              const float* __restrict__ v_scales, const int* __restrict__ page_tables,
              const int* __restrict__ starts, const int* __restrict__ counts,
              __nv_bfloat16* __restrict__ out, int C, int KV, int n_pages, int ps, int mp,
              int layer, float scale, int window) {
  constexpr int LDT = ld_tile<HD>();
  constexpr int LDR = ld_raw<HD>();
  constexpr int EB = Q8 ? 1 : 2;  // page element bytes
  constexpr int NT_S = BK / 8;    // n8 score tiles per warp row block
  constexpr int NT_O = HD / 8;    // n8 output tiles
  constexpr int KQ = HD / 16;     // k16 steps over the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LDT;  // bf16: [2][BK][LDT]; int8: widened [BK][LDT]
  __nv_bfloat16* sV = sK + (Q8 ? 1 : 2) * BK * LDT;
  int8_t* rawK = reinterpret_cast<int8_t*>(sV + (Q8 ? 1 : 2) * BK * LDT);  // [2][BK][LDR]
  int8_t* rawV = rawK + 2 * BK * LDR;
  float* sKs = reinterpret_cast<float*>(rawV + 2 * BK * LDR);
  float* sVs = sKs + BK;

  const int tile0 = blockIdx.x * BQ;  // first (query, head) row of the tile
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = KV * G;
  const int n_rows = C * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // row within an 8-row group
  const int t = lane & 3;    // column pair within an n8 tile

  const int start = starts[b];
  const int count = min(counts[b], C);
  const int* table = page_tables + (size_t)b * mp;
  const size_t pool_rows = ((size_t)layer * KV + kvh) * (size_t)n_pages * ps;
  const unsigned char* kpool =
      static_cast<const unsigned char*>(k_pages) + pool_rows * HD * EB;
  const unsigned char* vpool =
      static_cast<const unsigned char*>(v_pages) + pool_rows * HD * EB;

  // keys any real row of this tile can see
  const int i_first = tile0 / G;
  const int i_last = min(min(tile0 + BQ, n_rows) / G, count) - 1;  // last real query
  const int k_hi = i_last >= i_first ? min(start + i_last + 1, mp * ps) : 0;
  const int k_lo = window > 0 ? max(start + i_first - window + 1, 0) : 0;
  const int j_lo = k_lo / BK;
  const int j_hi = k_lo < k_hi ? (k_hi + BK - 1) / BK : j_lo;

  auto load_kv = [&](int j, int stage) {
    if constexpr (Q8) {
      load_keys<HD, LDR>(reinterpret_cast<unsigned char*>(rawK + stage * BK * LDR), kpool,
                         table, ps, j * BK, k_hi, tid);
      load_keys<HD, LDR>(reinterpret_cast<unsigned char*>(rawV + stage * BK * LDR), vpool,
                         table, ps, j * BK, k_hi, tid);
    } else {
      load_keys<2 * HD, 2 * LDT>(reinterpret_cast<unsigned char*>(sK + stage * BK * LDT),
                                 kpool, table, ps, j * BK, k_hi, tid);
      load_keys<2 * HD, 2 * LDT>(reinterpret_cast<unsigned char*>(sV + stage * BK * LDT),
                                 vpool, table, ps, j * BK, k_hi, tid);
    }
  };

  // the tile's q rows: row r is query (tile0 + r) / G, head (tile0 + r) % G
  for (int i = tid; i < BQ * (HD / 8); i += NTHREADS) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const int R = tile0 + r;
    const bool in = R < n_rows;
    const __nv_bfloat16* src =
        q + (((size_t)b * C + (in ? R / G : 0)) * H + kvh * G + (in ? R % G : 0)) * HD + c * 8;
    cp_async16(sQ + r * LDT + c * 8, src, in ? 16 : 0);
  }
  if (j_lo < j_hi) load_kv(j_lo, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  unsigned qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT +
                            kk * 16 + (lane >> 4) * 8);

  // this thread's two rows, their query positions and liveness
  const int R0 = tile0 + warp * 16 + g8;
  const int R1 = R0 + 8;
  const bool live0 = R0 < n_rows && R0 / G < count;
  const bool live1 = R1 < n_rows && R1 / G < count;
  const int p0 = start + R0 / G;
  const int p1 = start + R1 / G;
  const float scale2 = scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int cur = (j - j_lo) & 1;
    const int k0 = j * BK;
    if constexpr (Q8) {
      widen_tile<HD>(sK, rawK + cur * BK * LDR, tid);
      widen_tile<HD>(sV, rawV + cur * BK * LDR, tid);
      if (tid < BK) {
        const long long row = key_row(table, ps, k0 + tid, k_hi);
        sKs[tid] = row < 0 ? 0.f : k_scales[pool_rows + row];
        sVs[tid] = row < 0 ? 0.f : v_scales[pool_rows + row];
      }
      __syncthreads();
    }
    if (j + 1 < j_hi) load_kv(j + 1, cur ^ 1);  // the next tile flies meanwhile
    cp_async_commit();
    const __nv_bfloat16* tK = Q8 ? sK : sK + cur * BK * LDT;
    const __nv_bfloat16* tV = Q8 ? sV : sV + cur * BK * LDT;

    // S = Q K^T for 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, tK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDT + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // K scale, mask, then the online softmax in base 2 (rows R0 and R1)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        const int kpos = k0 + col;
        const float sc = Q8 ? scale2 * sKs[col] : scale2;
        const bool kin = kpos < k_hi;
        const bool keep0 = live0 && kin && kpos <= p0 && (window <= 0 || p0 - kpos < window);
        const bool keep1 = live1 && kin && kpos <= p1 && (window <= 0 || p1 - kpos < window);
        s[n][e] = keep0 ? s[n][e] * sc : -INFINITY;
        s[n][2 + e] = keep1 ? s[n][2 + e] * sc : -INFINITY;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    const float m_new0 = fmaxf(m_run[0], quad_max(mx0));
    const float m_new1 = fmaxf(m_run[1], quad_max(mx1));
    const float mu0 = m_new0 == -INFINITY ? 0.f : m_new0;  // fully masked so far
    const float mu1 = m_new1 == -INFINITY ? 0.f : m_new1;
    const float alpha0 = exp2f(m_run[0] - mu0);
    const float alpha1 = exp2f(m_run[1] - mu1);
    m_run[0] = m_new0;
    m_run[1] = m_new1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2f(s[n][e] - mu0);
        s[n][2 + e] = exp2f(s[n][2 + e] - mu1);
        sum0 += s[n][e];
        sum1 += s[n][2 + e];
        if constexpr (Q8) {  // the V scale weights P V, not the sum
          const float vs = sVs[n * 8 + 2 * t + e];
          s[n][e] *= vs;
          s[n][2 + e] *= vs;
        }
      }
    }
    l_run[0] = l_run[0] * alpha0 + sum0;  // per-thread partial; quad-summed at the end
    l_run[1] = l_run[1] * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: P's accumulator layout is the A-fragment layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }

    cp_async_wait_all();
    __syncthreads();  // next tile landed; every warp is done with this one
  }

  // padding rows and rows that saw no key come out as 0 / 1e-20 = 0
  const float inv0 = 1.f / fmaxf(quad_sum(l_run[0]), 1e-20f);
  const float inv1 = 1.f / fmaxf(quad_sum(l_run[1]), 1e-20f);
  const size_t q_stride = (size_t)H * HD;
  __nv_bfloat16* o0 = out + ((size_t)b * C + R0 / G) * q_stride + (kvh * G + R0 % G) * HD + 2 * t;
  __nv_bfloat16* o1 = out + ((size_t)b * C + R1 / G) * q_stride + (kvh * G + R1 % G) * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    if (R0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(o0 + n * 8) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (R1 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(o1 + n * 8) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD, int G, bool Q8>
int launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
           const int* tables, const int* starts, const int* counts, void* out, int B, int C,
           int KV, int n_pages, int ps, int mp, int layer, float scale, int window,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD, Q8>();
  // set once, outside any CUDA-graph capture that later launches replay
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_kernel<HD, G, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    smem_attr_set = true;
  }
  dim3 grid((C * G + BQ - 1) / BQ, KV, B);
  window_kernel<HD, G, Q8><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, ks, vs, tables, starts, counts,
      static_cast<__nv_bfloat16*>(out), C, KV, n_pages, ps, mp, layer, scale, window);
  return (int)cudaGetLastError();
}

template <int HD, bool Q8>
int launch_g(int G, const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* tables, const int* starts, const int* counts,
             void* out, int B, int C, int KV, int n_pages, int ps, int mp, int layer,
             float scale, int window, cudaStream_t st) {
#define FI_LAUNCH(GG)                                                                   \
  return launch<HD, GG, Q8>(q, k, v, ks, vs, tables, starts, counts, out, B, C, KV,    \
                            n_pages, ps, mp, layer, scale, window, st)
  switch (G) {
    case 1: FI_LAUNCH(1);
    case 2: FI_LAUNCH(2);
    case 4: FI_LAUNCH(4);
    case 8: FI_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FI_LAUNCH
}

}  // namespace

// bf16 pages when the scales are null, int8 pages otherwise
extern "C" int paged_window_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* k_scales, const void* v_scales,
                                      const void* page_tables, const void* starts,
                                      const void* counts, void* out, int B, int C, int KV,
                                      int G, int HD, int n_pages, int ps, int mp, int layer,
                                      float scale, int window, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || n_pages <= 0 || ps <= 0 || mp <= 0 ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(page_tables);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = ks != nullptr;
  if (HD == 128)
    return q8 ? launch_g<128, true>(G, q, k_pages, v_pages, ks, vs, tb, st, ct, out, B, C, KV,
                                    n_pages, ps, mp, layer, scale, window, s)
              : launch_g<128, false>(G, q, k_pages, v_pages, ks, vs, tb, st, ct, out, B, C,
                                     KV, n_pages, ps, mp, layer, scale, window, s);
  if (HD == 64)
    return q8 ? launch_g<64, true>(G, q, k_pages, v_pages, ks, vs, tb, st, ct, out, B, C, KV,
                                   n_pages, ps, mp, layer, scale, window, s)
              : launch_g<64, false>(G, q, k_pages, v_pages, ks, vs, tb, st, ct, out, B, C, KV,
                                    n_pages, ps, mp, layer, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
