// Row-invariant RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA.  It was
// added because PyTorch's reduction picks how it splits a row by the number
// of rows, so a row's statistics (and every bit after them) could change
// with the batch.  Here a row's sum of squares is reduced in one fixed tree
// that depends on D alone: G threads per row (G from D only), thread t adds
// the squares of its 16-byte chunks t, t + G, ... in order, a butterfly of
// warp shuffles folds the 32 lanes, and the G / 32 warp sums are added in
// warp order.  Statistics in f32; x, w and y bf16, rows of D contiguous
// values.  It serves the final norm, the layer norms and Qwen3's per-head
// q/k norms (rows = tokens x heads, D = head_dim).
//
// What bounds it: it reads each row once (twice from L1) and writes it
// once, a few FLOP per byte, so bytes; 16-byte loads and stores, a block of
// 256 threads, many rows a block where D is small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// G threads (a power of two, 32..256) per row, THREADS / G rows a block
template <int G>
__global__ void __launch_bounds__(THREADS)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ y, int rows, int D, float eps) {
  constexpr int WARPS = G / 32;
  __shared__ float warp_sums[THREADS / 32];
  const int t = threadIdx.x % G, slot = threadIdx.x / G;
  const int row = blockIdx.x * (THREADS / G) + slot;
  const bool live = row < rows;
  const int chunks = D / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(live ? row : 0) * D);
  float ss = 0.f;
  if (live) {
    for (int c = t; c < chunks; c += G) {
      float f[8];
      unpack8(__ldg(xr + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (WARPS > 1) {
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) ss += warp_sums[slot * WARPS + i];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)D + eps);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * D);
  for (int c = t; c < chunks; c += G) {
    float f[8], g[8];
    unpack8(__ldg(xr + c), f);
    unpack8(__ldg(wr + c), g);
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __floats2bfloat162_rn((f[2 * i] * inv) * g[2 * i],
                                   (f[2 * i + 1] * inv) * g[2 * i + 1]);
    yr[c] = out;
  }
}

template <int G>
int launch(const void* x, const void* w, void* y, int rows, int D, float eps, cudaStream_t st) {
  const int per_block = THREADS / G;
  rms_norm_kernel<G><<<(rows + per_block - 1) / per_block, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), rows, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [rows, D] and w [D] bf16, 16-byte aligned, D a multiple of 8.
// Threads per row from D alone: 32 up to D 1024, else 256.  Returns a
// cudaError_t.
extern "C" int rms_norm_bf16(const void* x, const void* w, void* y, int rows, int D, float eps,
                             void* stream) {
  if (rows <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 1024) return launch<32>(x, w, y, rows, D, eps, st);
  return launch<256>(x, w, y, rows, D, eps, st);
}
