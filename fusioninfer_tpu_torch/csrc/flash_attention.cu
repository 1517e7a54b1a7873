// Causal flash attention for prefill, written for Hopper (sm_90a).
//
// Replaces fusioninfer_tpu/ops/flash_attention.py::flash_attention (Pallas
// TPU kernel).  q [B, S, H, Hd], k/v [B, S, KV, Hd] bf16, contiguous;
// out [B, S, H*Hd] bf16.  Query head h reads KV head h / (H / KV).
//
// One block per (64-row q tile, q head, batch row); four warps, each owning
// 16 q rows for the whole key sweep.  K/V tiles of 64 keys stream through a
// two-stage cp.async ring in shared memory, so the next tile's loads fly
// while the current one is computed.  Both products run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), fed by ldmatrix
// (transposed for V).  The scores, the online-softmax statistics (f32,
// base-2 exponent) and the output accumulator stay in registers: a score
// accumulator's layout is exactly the A-operand layout of the P V product,
// so P goes from S to the tensor cores without touching shared memory.
// Tiles wholly above the causal diagonal or below the sliding window are
// never loaded.  Prefill at the served shapes is bound by operations; this
// version does not yet use wgmma/TMA or warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// shared rows padded by 16 bytes so the eight rows one ldmatrix reads
// fall in distinct banks
template <int HD>
__host__ __device__ constexpr int ld_tile() { return HD + 8; }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * ld_tile<HD>();
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

// rows [row0, row0 + 64) of a [S, stride] bf16 matrix into a padded tile;
// rows at or past S are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int row0, int S, int tid) {
  constexpr int LDT = ld_tile<HD>();
  constexpr int CHUNKS = HD / 8;
#pragma unroll
  for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool in = row0 + r < S;
    const __nv_bfloat16* g = src + (size_t)(in ? row0 + r : 0) * stride + c * 8;
    cp_async16(dst + r * LDT + c * 8, g, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S,
                 int H, int KV, float scale, int causal, int window) {
  constexpr int LDT = ld_tile<HD>();
  constexpr int NT_S = BK / 8;  // n8 score tiles per warp row block
  constexpr int NT_O = HD / 8;  // n8 output tiles
  constexpr int KQ = HD / 16;   // k16 steps over the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LDT;      // [2][BK][LDT]
  __nv_bfloat16* sV = sK + 2 * BK * LDT;  // [2][BK][LDT]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within an 8-row group
  const int t = lane & 3;   // column pair within an n8 tile

  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_stride + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_stride + (size_t)kvh * HD;

  // key range any row of this tile can see
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = causal ? q_last + 1 : S;
  const int k_lo = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int j_lo = k_lo / BK;
  const int j_hi = (k_hi + BK - 1) / BK;

  load_tile<HD>(sQ, qb, q_stride, q0, S, tid);
  load_tile<HD>(sK, kb, kv_stride, j_lo * BK, S, tid);
  load_tile<HD>(sV, vb, kv_stride, j_lo * BK, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 q rows as A fragments, for the whole sweep
  unsigned qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT +
                            kk * 16 + (lane >> 4) * 8);

  const int r0 = q0 + warp * 16 + g;  // this thread's two rows: r0, r0 + 8
  const int r1 = r0 + 8;
  const float scale2 = scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int cur = (j - j_lo) & 1;
    if (j + 1 < j_hi) {  // prefetch the next tile into the other stage
      load_tile<HD>(sK + (cur ^ 1) * BK * LDT, kb, kv_stride, (j + 1) * BK, S, tid);
      load_tile<HD>(sV + (cur ^ 1) * BK * LDT, vb, kv_stride, (j + 1) * BK, S, tid);
    }
    cp_async_commit();
    const __nv_bfloat16* tK = sK + cur * BK * LDT;
    const __nv_bfloat16* tV = sV + cur * BK * LDT;
    const int k0 = j * BK;

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

    // mask, then the online softmax in base 2 (rows r0 and r1)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + e;
        const bool kin = kpos < S;
        const bool keep0 = kin && (!causal || kpos <= r0) && (window <= 0 || r0 - kpos < window);
        const bool keep1 = kin && (!causal || kpos <= r1) && (window <= 0 || r1 - kpos < window);
        s[n][e] = keep0 ? s[n][e] * scale2 : -INFINITY;
        s[n][2 + e] = keep1 ? s[n][2 + e] * scale2 : -INFINITY;
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
      s[n][0] = exp2f(s[n][0] - mu0);
      s[n][1] = exp2f(s[n][1] - mu0);
      s[n][2] = exp2f(s[n][2] - mu1);
      s[n][3] = exp2f(s[n][3] - mu1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
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
    __syncthreads();  // next tile landed; every warp is done with this stage
  }

  const float l0 = quad_sum(l_run[0]);
  const float l1 = quad_sum(l_run[1]);
  const float inv0 = 1.f / fmaxf(l0, 1e-20f);
  const float inv1 = 1.f / fmaxf(l1, 1e-20f);
  __nv_bfloat16* o0 = out + ((size_t)b * S + r0) * q_stride + (size_t)h * HD + 2 * t;
  __nv_bfloat16* o1 = out + ((size_t)b * S + r1) * q_stride + (size_t)h * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o0 + n * 8) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o1 + n * 8) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int KV, float scale, int causal, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD>();
  // set once, outside any CUDA-graph capture that later launches replay
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    smem_attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H, KV,
      scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int H, int KV, int HD, float scale,
                                    int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return launch<64>(q, k, v, out, B, S, H, KV, scale, causal, window, st);
    case 128:
      return launch<128>(q, k, v, out, B, S, H, KV, scale, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
