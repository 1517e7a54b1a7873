// Row-invariant RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w,
// alone and fused into its neighbours.
//
// Replaces no TPU kernel: the JAX package leaves its norms, the residual
// adds, RoPE and the K/V page write to XLA.  The norm was added because
// PyTorch's reduction picks how it splits a row by the number of rows, so
// a row's statistics (and every bit after them) could change with the
// batch.  Here a row's sum of squares is reduced in one fixed tree that
// depends on D alone: G threads per row (G from D only), thread t adds the
// squares of its 16-byte chunks t, t + G, ... in order, a butterfly of warp
// shuffles folds the 32 lanes, and the G / 32 warp sums are added in warp
// order (`add_squares`, `row_sum`, `inv_rms`, `scale8`, shared by all three
// kernels).  Statistics in f32; x, w and y bf16, rows of D contiguous
// values.
//
// Three entries:
// * rms_norm_bf16: the norm alone (the first layer's attention norm, whose
//   input is the embedding).
// * add_rms_norm_bf16: s = bf16(x + delta), h = norm(s) * w: the residual
//   add before the MLP norm, the next layer's attention norm and the final
//   norm.  s keeps its chunks in registers between the add and the scaling.
// * qk_norm_rope_kv_bf16: per token, Qwen3's per-head q and k norms (D =
//   head_dim), NeoX RoPE from the forward's cos / sin tables, q out in the
//   walk's [N, H, Hd] layout, k out optionally (for flash), and k and v into
//   layer l's head-major pages [L, KV, n_pages, ps, Hd], quantized to int8
//   with a per-(token, head) scale where the pool is int8.  A (token, head)
//   row takes a group of LPR lanes (the power of two >= Hd / 8; 16 at Hd
//   128, two rows a warp), lane t of the group holding chunk t (head_dim <=
//   256), so the RoPE partner of chunk c, c + Hd / 16, is another lane's,
//   exchanged by shuffle; the group's norm is the 32-lane butterfly cut to
//   its lanes, which gives the same bits (the steps it leaves out add
//   zeros).
//
// Bits: each output equals the unfused chain's (this norm, torch's bf16
// add, `rotate`, `kv_quantize` and the index-put page write) for the same
// inputs: the same tree, bf16 rounding between norm and rope, RoPE's
// products and sums as separate round-to-nearest operations (no FMA
// contraction), the quantizer's amax * (1 / 127) (torch divides a CUDA
// tensor by a scalar as a product with its f32 reciprocal), an IEEE
// division and rintf (round half to even).
//
// What bounds them: each reads its inputs once and writes its outputs once,
// a few FLOP per byte, so bytes; at decode row counts, launch latency, which
// is what fusing the norm's neighbours into two launches a layer saves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
// the widest row add_rms_norm keeps in registers: 8 chunks a thread
constexpr int MAX_CHUNKS_PER_THREAD = 8;

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return out;
}

// ss plus the squares of one chunk's 8 values, in order
__device__ __forceinline__ float add_squares(const float (&f)[8], float ss) {
#pragma unroll
  for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
  return ss;
}

// A butterfly of warp shuffles over groups of LANES lanes (every lane of
// the warp calls it).  Over LANES < 32 it gives each group what the
// 32-lane butterfly gives where the warp's other lanes hold zeros: the
// steps it leaves out add an exact 0.
template <int LANES>
__device__ __forceinline__ float lane_sum(float ss) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
  return ss;
}

// A row's sum of squares from the partial sums of its G threads (slot: the
// row's index in the block): a butterfly over the warp's 32 lanes, then the
// G / 32 warp sums in warp order.  Every thread of the block calls it (it
// syncs the block when G > 32).
template <int G>
__device__ __forceinline__ float row_sum(float ss, float* warp_sums, int slot) {
  constexpr int WARPS = G / 32;
  ss = lane_sum<32>(ss);
  if (WARPS > 1) {
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) ss += warp_sums[slot * WARPS + i];
  }
  return ss;
}

__device__ __forceinline__ float inv_rms(float ss, int D, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), eps));
}

// bf16((f * inv) * g), 8 values
__device__ __forceinline__ uint4 scale8(const float (&f)[8], float inv, const uint4 w) {
  float g[8], y[8];
  unpack8(w, g);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = __fmul_rn(__fmul_rn(f[i], inv), g[i]);
  return pack8(y);
}

// G threads (a power of two, 32..256) per row, THREADS / G rows a block
template <int G>
__global__ void __launch_bounds__(THREADS)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ y, int rows, int D, float eps) {
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
      ss = add_squares(f, ss);
    }
  }
  ss = row_sum<G>(ss, warp_sums, slot);
  if (!live) return;
  const float inv = inv_rms(ss, D, eps);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * D);
  for (int c = t; c < chunks; c += G) {
    float f[8];
    unpack8(__ldg(xr + c), f);
    yr[c] = scale8(f, inv, __ldg(wr + c));
  }
}

// The same tree as rms_norm_kernel<G> over s = bf16(x + delta); thread t's
// chunks t, t + G, ... (at most C) stay in registers from the add to the
// scaling.
template <int G, int C>
__global__ void __launch_bounds__(THREADS)
add_rms_norm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ d,
                    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ s,
                    __nv_bfloat16* __restrict__ h, int rows, int D, float eps) {
  __shared__ float warp_sums[THREADS / 32];
  const int t = threadIdx.x % G, slot = threadIdx.x / G;
  const int row = blockIdx.x * (THREADS / G) + slot;
  const bool live = row < rows;
  const int chunks = D / 8;
  const size_t base = (size_t)(live ? row : 0) * D;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* dr = reinterpret_cast<const uint4*>(d + base);
  uint4* sr = reinterpret_cast<uint4*>(s + base);
  uint4 sv[C];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = t + j * G;
    sv[j] = make_uint4(0, 0, 0, 0);
    if (live && c < chunks) {
      float a[8], b[8];
      unpack8(__ldg(xr + c), a);
      unpack8(__ldg(dr + c), b);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = __fadd_rn(a[i], b[i]);
      sv[j] = pack8(a);
      sr[c] = sv[j];
      unpack8(sv[j], a);  // the norm reads the rounded sum
      ss = add_squares(a, ss);
    }
  }
  ss = row_sum<G>(ss, warp_sums, slot);
  if (!live) return;
  const float inv = inv_rms(ss, D, eps);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* hr = reinterpret_cast<uint4*>(h + base);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = t + j * G;
    if (c < chunks) {
      float a[8];
      unpack8(sv[j], a);
      hr[c] = scale8(a, inv, __ldg(wr + c));
    }
  }
}

struct QkvArgs {
  const __nv_bfloat16 *q, *k, *v;      // [N, H, Hd], [N, KV, Hd], [N, KV, Hd]
  const __nv_bfloat16 *q_w, *k_w;      // [Hd] each; NULL: no norm
  const float *cos, *sin;              // [rope_rows, Hd / 2]; token n reads row n % rope_rows
  __nv_bfloat16 *q_out, *k_out;        // [N, H, Hd], [N, KV, Hd] (k_out may be NULL)
  void *k_pages, *v_pages;             // [L, KV, n_pages, ps, Hd] bf16 or int8; NULL: no write
  float *k_scales, *v_scales;          // [L, KV, n_pages, ps] (int8 pages only)
  const int64_t *write_page, *write_slot;  // [N]
  int N, H, KV, Hd, rope_rows, n_pages, ps, layer;
  float eps;
};

// LPR lanes a (token, head) row (a power of two, at least Hd / 8: lane t of
// the group holds chunk t), 32 / LPR rows a warp; a token's rows are its H
// q heads, its KV k heads, then (with pages) its KV v heads.  Every lane
// runs every shuffle whatever its row's kind; lanes without a chunk (or a
// row) carry zeros and store nothing.
template <bool INT8, int LPR>
__global__ void __launch_bounds__(THREADS)
qk_norm_rope_kv_kernel(const QkvArgs p) {
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x % 32, t = lane % LPR;
  const int per_token = p.H + p.KV + (p.k_pages ? p.KV : 0);
  const int g = (blockIdx.x * (THREADS / 32) + threadIdx.x / 32) * RPW + lane / LPR;
  const bool live = g < p.N * per_token;
  const int n = live ? g / per_token : 0, r = live ? g % per_token : 0;
  const int chunks = p.Hd / 8, half = chunks / 2;
  const bool has = live && t < chunks, first = t < half;
  const bool is_q = r < p.H, is_v = r >= p.H + p.KV;
  const int head = is_q ? r : is_v ? r - p.H - p.KV : r - p.H;
  const size_t row = (size_t)n * (is_q ? p.H : p.KV) + head;
  // every load first, so their latencies overlap: the row's chunk and its
  // RoPE table slice
  uint4 x = make_uint4(0, 0, 0, 0);
  float4 c0 = make_float4(0, 0, 0, 0), c1 = c0, s0 = c0, s1 = c0;
  if (has) {
    x = __ldg(reinterpret_cast<const uint4*>((is_q ? p.q : is_v ? p.v : p.k) + row * p.Hd) + t);
    if (!is_v) {
      const size_t at = (size_t)(n % p.rope_rows) * (p.Hd / 2) + 8 * (first ? t : t - half);
      const float4* cp = reinterpret_cast<const float4*>(p.cos + at);
      const float4* sp = reinterpret_cast<const float4*>(p.sin + at);
      c0 = __ldg(cp); c1 = __ldg(cp + 1); s0 = __ldg(sp); s1 = __ldg(sp + 1);
    }
  }
  // the head's norm, the tree rms_norm_bf16 uses at D = Hd (G 32)
  float f[8];
  unpack8(x, f);
  const float ss = lane_sum<LPR>(add_squares(f, 0.f));
  const __nv_bfloat16* w = is_q ? p.q_w : is_v ? nullptr : p.k_w;
  if (w && has) {
    x = scale8(f, inv_rms(ss, p.Hd, p.eps), __ldg(reinterpret_cast<const uint4*>(w) + t));
    unpack8(x, f);
  }
  // RoPE pairs element i with i + Hd / 2: chunk t with chunk t + half
  const int partner = lane - t + (!has ? t : first ? t + half : t - half);
  uint4 y;
  y.x = __shfl_sync(FULL, x.x, partner);
  y.y = __shfl_sync(FULL, x.y, partner);
  y.z = __shfl_sync(FULL, x.z, partner);
  y.w = __shfl_sync(FULL, x.w, partner);
  float o[8], r8[8];
  unpack8(y, o);
  const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    // first half x1·cos − x2·sin, second half x2·cos + x1·sin (this lane's
    // own values are x1 in the first half, x2 in the second)
    r8[i] = first ? __fsub_rn(__fmul_rn(f[i], cs[i]), __fmul_rn(o[i], sn[i]))
                  : __fadd_rn(__fmul_rn(f[i], cs[i]), __fmul_rn(o[i], sn[i]));
  const uint4 out = is_v ? x : pack8(r8);
  if (has && is_q) reinterpret_cast<uint4*>(p.q_out + row * p.Hd)[t] = out;
  if (has && !is_q && !is_v && p.k_out)
    reinterpret_cast<uint4*>(p.k_out + row * p.Hd)[t] = out;
  if (!p.k_pages) return;
  // k and v into their page slot, as kv_quantize and the index-put write
  // leave it: the bf16 values as they are, or int8 codes
  // clip(rint(x / scale), +-127) with scale = max(amax * (1 / 127), 1e-8)
  const bool to_page = has && !is_q;
  const size_t slot = (((size_t)p.layer * p.KV + head) * p.n_pages + p.write_page[n]) * p.ps +
                      p.write_slot[n];
  void* pages = is_v ? p.v_pages : p.k_pages;
  if constexpr (!INT8) {
    if (to_page) reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(pages) + slot * p.Hd)[t] = out;
  } else {
    float v8[8];
    unpack8(out, v8);
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v8[i]));
    m = to_page ? m : 0.f;
#pragma unroll
    for (int step = LPR / 2; step > 0; step >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, step));
    const float scale = fmaxf(__fmul_rn(m, 1.0f / 127.0f), 1e-8f);
    if (!to_page) return;
    uint2 codes;
    int8_t* c8 = reinterpret_cast<int8_t*>(&codes);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      c8[i] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v8[i], scale)), -127.f), 127.f);
    reinterpret_cast<uint2*>(static_cast<int8_t*>(pages) + slot * p.Hd)[t] = codes;
    if (t == 0) (is_v ? p.v_scales : p.k_scales)[slot] = scale;
  }
}

template <int G>
int launch_norm(const void* x, const void* w, void* y, int rows, int D, float eps,
                cudaStream_t st) {
  const int per_block = THREADS / G;
  rms_norm_kernel<G><<<(rows + per_block - 1) / per_block, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), rows, D, eps);
  return (int)cudaGetLastError();
}

template <int G, int C>
int launch_add(const void* x, const void* d, const void* w, void* s, void* h, int rows, int D,
               float eps, cudaStream_t st) {
  const int per_block = THREADS / G;
  add_rms_norm_kernel<G, C><<<(rows + per_block - 1) / per_block, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(s),
      static_cast<__nv_bfloat16*>(h), rows, D, eps);
  return (int)cudaGetLastError();
}

template <int G>
int launch_add_g(const void* x, const void* d, const void* w, void* s, void* h, int rows,
                 int D, float eps, cudaStream_t st) {
  const int per_thread = (D / 8 + G - 1) / G;
  if (per_thread <= 1) return launch_add<G, 1>(x, d, w, s, h, rows, D, eps, st);
  if (per_thread <= 2) return launch_add<G, 2>(x, d, w, s, h, rows, D, eps, st);
  if constexpr (G == 32) {  // D <= 1024: at most 4 chunks a thread
    return launch_add<G, 4>(x, d, w, s, h, rows, D, eps, st);
  } else {
    if (per_thread <= 4) return launch_add<G, 4>(x, d, w, s, h, rows, D, eps, st);
    return launch_add<G, MAX_CHUNKS_PER_THREAD>(x, d, w, s, h, rows, D, eps, st);
  }
}

template <int LPR>
int launch_qk(const QkvArgs& p, int64_t rows, bool int8, cudaStream_t st) {
  const int64_t per_block = (THREADS / 32) * (32 / LPR);
  const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
  if (int8)
    qk_norm_rope_kv_kernel<true, LPR><<<blocks, THREADS, 0, st>>>(p);
  else
    qk_norm_rope_kv_kernel<false, LPR><<<blocks, THREADS, 0, st>>>(p);
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
  if (D <= 1024) return launch_norm<32>(x, w, y, rows, D, eps, st);
  return launch_norm<256>(x, w, y, rows, D, eps, st);
}

// s = bf16(x + delta), h = rms_norm(s) * w: x, delta, s, h [rows, D] and w
// [D] bf16, 16-byte aligned, D a multiple of 8 up to 256 * 8 * 8 (16384).
// The same threads per row as rms_norm_bf16.  Returns a cudaError_t.
extern "C" int add_rms_norm_bf16(const void* x, const void* delta, const void* w, void* s,
                                 void* h, int rows, int D, float eps, void* stream) {
  if (rows <= 0 || D <= 0 || D % 8 || D > 256 * 8 * MAX_CHUNKS_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 1024) return launch_add_g<32>(x, delta, w, s, h, rows, D, eps, st);
  return launch_add_g<256>(x, delta, w, s, h, rows, D, eps, st);
}

// Per token n < N: q [N, H, Hd] and k [N, KV, Hd] through their per-head
// norms (q_w, k_w [Hd]; both NULL for no norm) and RoPE (cos, sin f32
// [rope_rows, Hd / 2], token n at row n % rope_rows) into q_out [N, H, Hd]
// and, if not NULL, k_out [N, KV, Hd]; with k_pages, the rotated k and v
// [N, KV, Hd] into layer `layer` of the pools [L, KV, n_pages, ps, Hd] at
// (write_page[n], write_slot[n]) (int64), int8 with f32 scales [L, KV,
// n_pages, ps] when k_scales is not NULL, else bf16.  Every tensor
// contiguous and 16-byte aligned; Hd a multiple of 16 up to 256.  Returns a
// cudaError_t.
extern "C" int qk_norm_rope_kv_bf16(const void* q, const void* k, const void* v,
                                    const void* q_w, const void* k_w, const void* cos,
                                    const void* sin, void* q_out, void* k_out, void* k_pages,
                                    void* v_pages, void* k_scales, void* v_scales,
                                    const void* write_page, const void* write_slot, int N,
                                    int H, int KV, int Hd, int rope_rows, int n_pages, int ps,
                                    int layer, float eps, void* stream) {
  if (N <= 0 || H <= 0 || KV <= 0 || Hd <= 0 || Hd % 16 || Hd > 256 || rope_rows <= 0 ||
      (!q_w) != (!k_w) || (k_pages && (!v_pages || !write_page || !write_slot)) ||
      (!k_scales) != (!v_scales))
    return (int)cudaErrorInvalidValue;
  QkvArgs p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.q_w = static_cast<const __nv_bfloat16*>(q_w);
  p.k_w = static_cast<const __nv_bfloat16*>(k_w);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.q_out = static_cast<__nv_bfloat16*>(q_out);
  p.k_out = static_cast<__nv_bfloat16*>(k_out);
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scales = static_cast<float*>(k_scales);
  p.v_scales = static_cast<float*>(v_scales);
  p.write_page = static_cast<const int64_t*>(write_page);
  p.write_slot = static_cast<const int64_t*>(write_slot);
  p.N = N; p.H = H; p.KV = KV; p.Hd = Hd; p.rope_rows = rope_rows;
  p.n_pages = n_pages; p.ps = ps; p.layer = layer; p.eps = eps;
  const int64_t rows = (int64_t)N * (H + KV + (k_pages ? KV : 0));
  if (rows > INT32_MAX - THREADS) return (int)cudaErrorInvalidValue;  // 32-bit row index
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = Hd / 8;
  if (chunks <= 2) return launch_qk<2>(p, rows, k_scales != nullptr, st);
  if (chunks <= 4) return launch_qk<4>(p, rows, k_scales != nullptr, st);
  if (chunks <= 8) return launch_qk<8>(p, rows, k_scales != nullptr, st);
  if (chunks <= 16) return launch_qk<16>(p, rows, k_scales != nullptr, st);
  return launch_qk<32>(p, rows, k_scales != nullptr, st);
}
