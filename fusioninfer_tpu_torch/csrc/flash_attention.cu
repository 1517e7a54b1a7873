// Causal flash attention for prefill, written for Hopper (sm_90a).
//
// Replaces fusioninfer_tpu/ops/flash_attention.py::flash_attention (Pallas
// TPU kernel).  q [B, S, H, Hd], k/v [B, S, KV, Hd] bf16, contiguous;
// out [B, S, H*Hd] bf16.  Query head h reads KV head h / (H / KV).
//
// What bounds it: prefill at the served shapes (S in the thousands, Hd 128)
// does ~4 S^2 H Hd / 2 FLOP on ~(2 H + 2 KV) S Hd 2 bytes, far above the
// card's 295 FLOP/byte ridge, so it is bound by the tensor cores, and on
// Hopper only wgmma reaches their full rate.  The design (the shared parts
// in hopper_attention.cuh):
//
// * Work items of one 128-row q tile of one q head and batch row, run by a
//   persistent grid of one block per SM.  Items are numbered heaviest first
//   (reversed tile order: the longest causal sweeps first), with the q
//   heads of one KV head side by side so their K/V reads hit L2, and a
//   block walks its items in alternating bands (item_index), which evens
//   out the causal sweeps across SMs.
// * Three warpgroups.  Warpgroup 0 is the producer: setmaxnreg lowers it to
//   40 registers and one thread issues every load as a TMA copy.
//   Warpgroups 1 and 2 are consumers of 64 q rows each.
// * Loads: three 3-D tensor maps over q [B, S, H*Hd] and k, v [B, S,
//   KV*Hd], 64-column boxes with the 128-byte swizzle that wgmma reads.  A
//   box that runs past S is zero-filled by the hardware and never reads the
//   next batch row.  K/V tiles of 128 keys stream through a three-stage
//   ring of mbarriers, "full" (the producer's expect-tx, completed by the
//   TMA bytes) and "empty" (one arrival per consumer warpgroup), that runs
//   on across items, so the next item's Q and first tiles load while the
//   consumers write the current item's output.  No __syncthreads after
//   the barriers' initialisation.
// * Products: Q K^T as wgmma m64n128k16 from shared memory, P V as wgmma
//   m64nHDk16 with P from registers; softmax statistics in f32 registers,
//   base 2 (ex2.approx).  The consumers take turns on the tensor cores
//   (consume_pingpong with OVERLAP): in its turn a consumer issues tile
//   j's Q K^T and tile j - 1's P V back to back, and its softmax of tile
//   j runs while its own P V and the other consumer's products do.  The
//   block's 384 threads leave a consumer 168 registers (ptxas allocates
//   within the launch bound whatever setmaxnreg later grants), just
//   enough for O, S and P at once.
// * Masking only where needed: a key tile is masked for a warpgroup only if
//   it crosses the causal diagonal of its rows, runs past S, or (under a
//   sliding window) reaches below the window of its last row; interior
//   tiles skip the compares.  Tiles wholly above the diagonal or below the
//   window are never loaded.
//
// Shared memory: Q 128 x Hd + three stages of K and V 128 x Hd (224 KB at
// Hd 128), one block per SM.  At 128 x 128 per step each block reads
// 64 KB of K/V from L2 for 8.4 MFLOP; see PERF.md for what that costs.

#include "hopper_attention.cuh"

namespace {

using namespace hopper;

constexpr int NC = 2;        // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * NC;  // q rows per block
constexpr int BK = 128;      // keys per tile
constexpr int NS = 3;        // K/V ring stages
constexpr int NTHREADS = (NC + 1) * WG_THREADS;

template <int HD>
struct Layout {
  static constexpr int Q_BYTES = BQ * HD * 2;  // NC tiles [HD / 64][64][64]
  static constexpr int SB = stage_bytes<HD, BK, false>();
  static constexpr int RING = Q_BYTES;
  static constexpr int BARS = RING + NS * SB;
  static constexpr int BYTES = BARS + (2 * NS + 2) * 8 + 1024;  // + alignment slack
};

// One consumer warpgroup's mask: its rows are r_lo .. r_lo + 63, this
// thread's rows r[0] and r[1].
struct FlashMask {
  int r_lo, r[2], S, window;
  bool causal;

  __device__ __forceinline__ bool masked(int k0) const {
    return (causal && k0 + BK - 1 > r_lo) || k0 + BK > S ||
           (window > 0 && k0 <= r_lo + 63 - window);
  }
  __device__ __forceinline__ bool keep(int i, int key) const {
    return key < S && (!causal || key <= r[i]) && (window <= 0 || r[i] - key < window);
  }
  __device__ __forceinline__ bool gathered(int) const { return false; }
};

// One work item: a 128-row q tile of one q head and batch row, and the key
// tiles j_lo .. j_hi - 1 any of its rows sees.  Items are numbered
// heaviest first (reversed tile order, the longest causal sweeps first),
// with the q heads of one KV head side by side, so their K/V reads hit L2.
struct Item {
  int q0, b, h, kvh, j_lo, j_hi;

  __device__ __forceinline__ Item(int w, int S, int H, int KV, int B, int n_qt, int causal,
                                  int window) {
    const int tile = n_qt - 1 - w / (H * B);
    b = (w % (H * B)) / H;
    h = w % H;
    kvh = h / (H / KV);
    q0 = tile * BQ;
    const int q_last = min(q0 + BQ, S) - 1;
    const int k_hi = causal ? q_last + 1 : S;
    const int k_lo = window > 0 ? max(q0 - window + 1, 0) : 0;
    j_lo = k_lo / BK;
    j_hi = (k_hi + BK - 1) / BK;
  }
};

// The k-th item of a persistent block: bands of gridDim.x items, walked
// forward in even bands and backward in odd ones, so a block that takes a
// heavy item in one band takes a light one in the next; -1 past the end.
__device__ __forceinline__ int item_index(int k, int n_items) {
  const int w = k * gridDim.x + (k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return w < n_items ? w : -1;
}

// Persistent: each block walks its items (item_index).  The K/V ring and
// its phases run on across items, so the producer loads the next item's Q
// and first tiles while the consumers write the current item's output.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ out,
                 int S, int H, int KV, int B, int n_qt, float scale, int causal, int window) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem + L::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + NS;
  uint64_t* q_full = empty + NS;
  uint64_t* q_empty = q_full + 1;
  const int n_items = n_qt * H * B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NC);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {  // producer
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int k = 0, w; (w = item_index(k, n_items)) >= 0; ++k) {
        const Item item(w, S, H, KV, B, n_qt, causal, window);
        mbar_wait(q_empty, (k & 1) ^ 1);  // the previous item's Q is no longer read
        mbar_arrive_expect_tx(q_full, L::Q_BYTES);
        for (int c = 0; c < NC; ++c)
          for (int half = 0; half < HD / 64; ++half)
            tma_load_3d(smem + c * 64 * HD * 2 + half * 64 * ROW_BYTES, &mq, q_full,
                        item.h * HD + half * 64, item.q0 + c * 64, item.b);
        for (int j = item.j_lo; j < item.j_hi; ++j, ++it) {
          const int s = it % NS;
          mbar_wait(empty + s, ((it / NS) & 1) ^ 1);
          unsigned char* stage = ring + s * L::SB;
          mbar_arrive_expect_tx(full + s, 2 * BK * HD * 2);
          for (int half = 0; half < HD / 64; ++half) {
            tma_load_3d(stage + half * BK * ROW_BYTES, &mk, full + s,
                        item.kvh * HD + half * 64, j * BK, item.b);
            tma_load_3d(stage + BK * HD * 2 + half * BK * ROW_BYTES, &mv, full + s,
                        item.kvh * HD + half * 64, j * BK, item.b);
          }
        }
      }
    }
  } else {  // consumers
    regs_alloc<232>();
    const int c = wg - 1;
    const uint32_t sq = smem_u32(smem + c * 64 * HD * 2);
    int it = 0;
    for (int k = 0, w; (w = item_index(k, n_items)) >= 0; ++k) {
      const Item item(w, S, H, KV, B, n_qt, causal, window);
      FlashMask mask;
      mask.r_lo = item.q0 + c * 64;
      mask.r[0] = mask.r_lo + RowState<HD>::row(0);
      mask.r[1] = mask.r_lo + RowState<HD>::row(1);
      mask.S = S;
      mask.window = window;
      mask.causal = causal != 0;
      RowState<HD> st;
      st.init();
      mbar_wait(q_full, k & 1);
      consume_pingpong<HD, BK, NS, false, true>(st, c, sq, ring, full, empty, item.j_lo,
                                                item.j_hi, scale * LOG2E, mask, it);
      it += item.j_hi - item.j_lo;
      if (threadIdx.x % WG_THREADS == 0) mbar_arrive(q_empty);

      const size_t q_stride = (size_t)H * HD;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float inv = 1.f / fmaxf(quad_sum(st.l[i]), 1e-20f);
        const int r = mask.r[i];
        if (r >= S) continue;
        __nv_bfloat16* o = out + ((size_t)item.b * S + r) * q_stride + (size_t)item.h * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(o + RowState<HD>::col(j, 0)) =
              __floats2bfloat162_rn(st.o[4 * j + 2 * i] * inv, st.o[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int KV, float scale, int causal, int window, cudaStream_t stream) {
  using L = Layout<HD>;
  // 3-D maps, innermost first: [B][S][heads * HD] with 64-column boxes
  CUtensorMap mq, mk, mv;
  const cuuint64_t q_dims[3] = {(cuuint64_t)H * HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t q_strides[2] = {(cuuint64_t)H * HD * 2, (cuuint64_t)S * H * HD * 2};
  const cuuint32_t q_box[3] = {64, 64, 1};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)KV * HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kv_strides[2] = {(cuuint64_t)KV * HD * 2, (cuuint64_t)S * KV * HD * 2};
  const cuuint32_t kv_box[3] = {64, BK, 1};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = encode_map(&mq, bf16, 3, q, q_dims, q_strides, q_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_map(&mk, bf16, 3, k, kv_dims, kv_strides, kv_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode_map(&mv, bf16, 3, v, kv_dims, kv_strides, kv_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  // set once, outside any CUDA-graph capture that later launches replay
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_attr_set = true;
  }
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_items = n_qt * H * B;
  flash_fwd_kernel<HD><<<min(n_items, n_sm), NTHREADS, L::BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), S, H, KV, B, n_qt, scale, causal, window);
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
