// paged_decode: one-query GQA decode attention over a KV pool, addressed by
// slot or by block table, with float or int8 storage.
//
// Replaces: src/repro/kernels/flash_attention/paged.py `paged_decode_pallas`
// (slot pool) and `paged_decode_blocktable_pallas` (block table), each with
// its float pool and its int8 pool (f32 scales per (token, kv head)).  The
// Pallas kernels share one body, `_paged_kernel` (paged.py:47-94), that
// reasons only in logical kv positions; only their index maps know the
// physical address.  So does this file: each kernel below has one body for
// both pools, and only the token -> physical index step (`Tokens`) knows
// the slot or the table.  It serves decode attention of every layer under
// Engine(use_paged_kernel=True): the slot pool, the block-table pool of
// Engine(prefix_cache=True), and either pool with kv_dtype="int8".
//
// What bounds it on the H100: bytes.  Per row it reads the live prefix of
// the row's KV, lengths[b] * nkv * d elements of K and V (2 bytes each in
// bf16, 1 byte plus a 4-byte scale per (token, head) in int8), and does 4 g
// FLOPs per element read (a score and a weighted sum per query head of the
// group): 4-24 FLOP/byte at g = 2-12, far under any compute line.  At the
// serve shape (64 rows, 8 kv heads, ~3,000 live tokens) the whole call is
// 12 MB, 3.7 us at 3.35 TB/s: less than a launch, so what counts there is
// how short each block's chain of dependent loads is.
//
// What the bf16 design does about it (`paged_decode_sm90`, q bf16 over a
// bf16 or an int8 pool):
//   * each (row, kv head) walk is split across the blocks of one thread-
//     block cluster (grid x = splits <= 8, cluster (splits, 1, 1)); block z
//     takes tokens [z split, (z + 1) split) of the pool's capacity (the
//     wrapper picks split from the capacity, never from `lengths`, so the
//     host reads nothing of the device).  A block whose range starts past
//     its row's length copies nothing and parks an empty partial (m = -inf,
//     l = 0).  Every block parks its partial (m, l, acc of its query
//     heads) in its own shared memory; after a cluster barrier the blocks
//     combine the partials of every split in split order through
//     distributed shared memory (each rescaled once by 2^(m_z - M)) and
//     write the output, so the call is one launch with no partials in
//     device memory.  A pool deeper than 8 splits walks several tiles a
//     block.  A walk of one split (the wrapper's pick where the walks alone
//     fill the card: splits cost their cluster's barriers and combine)
//     launches without a cluster and writes its output straight from its
//     registers;
//   * tiles come through a three-slot ring of cp.async copies: tile t + 2's
//     copies are issued right after the barrier that opens tile t, so two
//     tiles are in flight while tile t's products run (one barrier a tile
//     in bf16, two in int8, where the widening needs one).  Each copy resolves
//     its token's physical index when it is issued (one table load per
//     copy for the block table), and positions past the block's range are
//     zero-filled and never read, so table entries past a row's live blocks
//     are never read and any block size works (a tile may span blocks);
//   * the g query heads of the kv head are the rows of one 64-row `wgmma`
//     tile (rows >= g are not stored; a group above 64 heads takes another
//     block per 64): S = Q K^T by `wgmma` into registers (Q and K in
//     shared memory, 128-byte swizzled), the online softmax per row in
//     registers in log2 units (one FFMA and one ex2 a score, as
//     flash_attention.cu; warps without a live query head skip it), and P
//     rounded to bf16 as the register A operand of O += P V, a `wgmma`
//     against V in shared memory.  Each K/V element is read from device
//     memory once for all g heads, and the tensor cores take the g-fold
//     arithmetic that made the CUDA-core loops of the f32 body cost 3.3x
//     at g = 12 what they cost at g = 2;
//   * an int8 pool's tiles are copied as they lie and widened to bf16 in
//     shared memory (exact: |x| <= 127); the K scales multiply the score
//     columns in f32 after the product, the V scales are folded into P
//     before P is rounded to bf16, and q is never quantized.
// The head dim pads to whole 64-column atoms in shared memory only (the
// copies zero-fill the columns past d).
//
// f32 (q f32 over an f32 or int8 pool: the token-identity checks) keeps the
// CUDA-core body `paged_decode_kernel`, unchanged, so the slot and table
// paths keep one summation order: one block per (row, kv head, 16 heads)
// walks the row's whole prefix in tiles of `bkv` tokens staged by 16-byte
// loads, and dequantizes an int8 pool in f32 where it reads it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using sm90::bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;     // head dim
constexpr int DPT = MAX_D / THREADS;  // output columns per thread (<= 2)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int GROUP_ROWS = 64; // query heads of one sm90 block (the wgmma tile's rows)
constexpr int STAGES = 3;      // ring slots of the sm90 kernel: two tiles in flight ahead

// dtype codes: those of csrc/gemm_tile.cuh `DType`, and int8 storage
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2;

// The physical token index of logical position pos of a row: slot * depth
// + pos (slot pool: index = slot_idx, depth = s_max) or table[pos / depth]
// * depth + pos % depth (block table: index = tables (b, max_blocks), depth
// = block_size).
struct Tokens {
  const int* table;     // the row's table entries (block table), else null
  long long slot_base;  // slot * depth (slot pool)
  int depth;
  __device__ __forceinline__ Tokens(const int* index, int row, int depth_, int max_blocks)
      : table(max_blocks > 0 ? index + (size_t)row * max_blocks : nullptr),
        slot_base(max_blocks > 0 ? 0 : (long long)index[row] * depth_),
        depth(depth_) {}
  __device__ __forceinline__ long long operator()(int pos) const {
    if (table) return (long long)__ldg(table + pos / depth) * depth + pos % depth;
    return slot_base + pos;
  }
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q (b, a, d) f32; pools (tokens, nkv, d) TKV (see Tokens); an int8 pool's
// scales (tokens, nkv) f32.  out (b, a, d) f32.  grid (b, nkv, ceil(g /
// GW)): block (b, h, z) serves query heads h g + z GW .. of kv head h, at
// most GW of them.  Dynamic shared memory: the tile's token indices (bkv
// int64), K and V tiles (bkv x d TKV each), q (gs x d f32), scores (gs x
// bkv f32), the tile's K and V scales (bkv f32 each) and the per-head
// running max / sum / rescale (GW each), where gs = min(g, GW).
template <typename TKV, bool TABLE, int GW>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ index,
                    const int* __restrict__ lengths, float* __restrict__ out, int a, int nkv,
                    int d, int depth, int max_blocks, int bkv, float scale) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int z0 = blockIdx.z * GW;
  const int g = min(GW, a / nkv - z0);  // query heads of this block
  const int gs = min(GW, a / nkv);      // ... of the widest block (shared-memory layout)
  const int row = blockIdx.x, h = blockIdx.y;
  long long* tok_s = reinterpret_cast<long long*>(smem);
  TKV* Ks = reinterpret_cast<TKV*>(tok_s + bkv);
  TKV* Vs = Ks + bkv * d;
  float* qs = reinterpret_cast<float*>(Vs + bkv * d);
  float* ss = qs + gs * d;
  float* ksc = ss + gs * bkv;
  float* vsc = ksc + bkv;
  float* m_s = vsc + bkv;
  float* l_s = m_s + GW;
  float* alpha_s = l_s + GW;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* qrow = q + ((size_t)row * a + (size_t)h * (a / nkv) + z0) * d;
  float* orow = out + ((size_t)row * a + (size_t)h * (a / nkv) + z0) * d;
  const int capacity = TABLE ? max_blocks * depth : depth;
  const int len = min(lengths[row], capacity);

  float acc[GW][DPT];
#pragma unroll
  for (int gi = 0; gi < GW; ++gi)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[gi][c] = 0.0f;

  if (len <= 0) {  // dead row: zeros (paged.py:92-94)
    for (int i = tid; i < g * d; i += THREADS) orow[i] = 0.0f;
    return;
  }
  const int* table = index + (size_t)row * max_blocks;  // TABLE only
  const long long slot_base = TABLE ? 0 : (long long)index[row] * depth;
  for (int i = tid; i < g * d; i += THREADS) qs[i] = qrow[i];
  if (tid < g) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }

  constexpr int CH = 16 / sizeof(TKV);
  const int cpr = d / CH;  // 16-byte chunks per token row
  const size_t tok_stride = (size_t)nkv * d;
  const TKV* kbase = k_pool + (size_t)h * d;
  const TKV* vbase = v_pool + (size_t)h * d;

  for (int t0 = 0; t0 < len; t0 += bkv) {
    const int nt = min(bkv, len - t0);
    __syncthreads();  // previous tile fully consumed (and q / m / l staged)
    for (int j = tid; j < nt; j += THREADS) {
      const int pos = t0 + j;
      const long long tok = TABLE ? (long long)table[pos / depth] * depth + pos % depth
                                  : slot_base + pos;
      tok_s[j] = tok;
      if constexpr (QUANT) {
        ksc[j] = k_scale[tok * nkv + h];
        vsc[j] = v_scale[tok * nkv + h];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nt * cpr; idx += THREADS) {
      const int j = idx / cpr, c = (idx % cpr) * CH;
      const size_t off = (size_t)tok_s[j] * tok_stride + c;
      *reinterpret_cast<uint4*>(Ks + j * d + c) = __ldg(reinterpret_cast<const uint4*>(kbase + off));
      *reinterpret_cast<uint4*>(Vs + j * d + c) = __ldg(reinterpret_cast<const uint4*>(vbase + off));
    }
    __syncthreads();

    // scores: warp w takes tokens w, w + WARPS, ...; lanes split the dot
    for (int j = warp; j < nt; j += WARPS) {
      float part[GW];
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) part[gi] = 0.0f;
      for (int e = lane; e < d; e += 32) {
        float kv = to_f(Ks[j * d + e]);
        if constexpr (QUANT) kv *= ksc[j];
#pragma unroll
        for (int gi = 0; gi < GW; ++gi)
          if (gi < g) part[gi] = fmaf(qs[gi * d + e], kv, part[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) {
        if (gi < g) {
          const float s = warp_sum(part[gi]);
          if (lane == 0) ss[gi * bkv + j] = s * scale;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int gi = warp; gi < g; gi += WARPS) {
      float mx = NEG_INF;
      for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, ss[gi * bkv + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < nt; j += 32) {
        const float p = expf(ss[gi * bkv + j] - m_new);
        ss[gi * bkv + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[gi] = alpha;
        l_s[gi] = alpha * l_s[gi] + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V; thread owns columns tid, tid + THREADS
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int e = tid + c * THREADS;
      if (e >= d) break;
      float pv[GW];
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) pv[gi] = 0.0f;
      for (int j = 0; j < nt; ++j) {
        float vv = to_f(Vs[j * d + e]);
        if constexpr (QUANT) vv *= vsc[j];
#pragma unroll
        for (int gi = 0; gi < GW; ++gi)
          if (gi < g) pv[gi] = fmaf(ss[gi * bkv + j], vv, pv[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < GW; ++gi)
        if (gi < g) acc[gi][c] = acc[gi][c] * alpha_s[gi] + pv[gi];
    }
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int e = tid + c * THREADS;
    if (e >= d) break;
#pragma unroll
    for (int gi = 0; gi < GW; ++gi) {
      if (gi < g) {
        float l = l_s[gi];
        l = l == 0.0f ? 1.0f : l;
        orow[gi * d + e] = acc[gi][c] / l;
      }
    }
  }
}

// The block's head-count width for a group of g query heads.
int group_width(int g) { return g <= 8 ? 8 : 16; }

// Shared memory of the f32 body for a tile of bkv tokens; g query heads per
// kv head (kernels/flash_attention/ops.py `paged_launch` mirrors it).
size_t f32_smem(int g, int d, int bkv, int kv_dtype) {
  const int gw = group_width(g), gs = g < gw ? g : gw;
  const size_t kvb = kv_dtype == DT_F32 ? 4 : 1;
  return (size_t)bkv * 8 + 2 * (size_t)bkv * d * kvb + (size_t)gs * d * 4 +
         (size_t)gs * bkv * 4 + 2 * (size_t)bkv * 4 + 3 * (size_t)gw * 4;
}

template <typename TKV, int GW>
int launch_f32(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
               const void* v_scale, const void* index, const void* lengths, void* out, int b,
               int a, int nkv, int d, int depth, int max_blocks, int bkv, float scale,
               size_t smem, cudaStream_t s) {
  auto* kern = max_blocks > 0 ? paged_decode_kernel<TKV, true, GW>
                              : paged_decode_kernel<TKV, false, GW>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<dim3(b, nkv, (a / nkv + GW - 1) / GW), THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(index),
      static_cast<const int*>(lengths), static_cast<float*>(out), a, nkv, d, depth, max_blocks,
      bkv, scale);
  return (int)cudaGetLastError();
}

template <typename TKV>
int launch_f32_g(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                 const void* v_scale, const void* index, const void* lengths, void* out, int b,
                 int a, int nkv, int d, int depth, int max_blocks, int bkv, float scale,
                 size_t smem, cudaStream_t s) {
  if (group_width(a / nkv) == 8)
    return launch_f32<TKV, 8>(q, k_pool, v_pool, k_scale, v_scale, index, lengths, out, b, a,
                              nkv, d, depth, max_blocks, bkv, scale, smem, s);
  return launch_f32<TKV, 16>(q, k_pool, v_pool, k_scale, v_scale, index, lengths, out, b, a,
                             nkv, d, depth, max_blocks, bkv, scale, smem, s);
}

// ---------------------------------------------------------------------------
// bf16: the Hopper body
// ---------------------------------------------------------------------------

struct PagedArgs {
  const bf16* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* index;
  const int* lengths;
  bf16* out;
  int a, nkv, g, d, depth, max_blocks;
  int split;     // tokens of one split (a multiple of the tile)
  int q_rows;    // rows of the staged Q tile: min(g, 64) rounded up to 8
  float sl2;     // scale * log2(e)
};

// Shared-memory layout of paged_decode_sm90<DP, BKV, QUANT> (bytes from the
// 1024-aligned base): Q (q_rows x DP bf16), then in bf16 STAGES ring slots
// of K and V (BKV x DP bf16 each), in int8 the widened K and V tiles (BKV x
// DP bf16 each) and STAGES ring slots of raw K and V (BKV x DP bytes each) and
// their scales (BKV f32 each); the partial (rows x (DP + 8) f32) is parked
// over all of that at the end, and the per-row m and l (64 f32 each) follow
// the larger of the two.  kernels/flash_attention/ops.py `paged_launch`
// mirrors it.
template <int DP, int BKV, bool QUANT> struct Layout {
  static constexpr int LD = DP + 8;  // parked row stride (floats): quads on distinct banks
  static constexpr size_t TILE = (size_t)BKV * DP * 2;
  static constexpr size_t RAW = (size_t)BKV * DP;                  // one int8 tile
  static constexpr size_t RAW_SLOT = 2 * RAW + 2 * (size_t)BKV * 4;  // K, V and their scales
  __host__ __device__ static size_t main_bytes(int q_rows) {
    const size_t qb = (size_t)q_rows * DP * 2;
    return QUANT ? qb + 2 * TILE + STAGES * RAW_SLOT : qb + STAGES * 2 * TILE;
  }
  __host__ __device__ static size_t park_bytes(int q_rows) { return (size_t)q_rows * LD * 4; }
  __host__ __device__ static size_t ml_offset(int q_rows) {
    const size_t m = main_bytes(q_rows), p = park_bytes(q_rows);
    return m > p ? m : p;
  }
  __host__ __device__ static size_t bytes(int q_rows) {
    return 1024 + ml_offset(q_rows) + 2 * GROUP_ROWS * 4;
  }
};

// Element offset of (r, c) in a swizzled tile of R rows (sm90.cuh swz_off,
// R at run time).
__device__ __forceinline__ int swz(int r, int c, int R) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy tokens [t0, t0 + BKV) of kv head h into a ring slot: K and V rows of
// DP columns (bf16: swizzled tiles; int8: raw rows of DP bytes, and the
// rows' scales).  Positions at or past t_end and columns at or past d are
// zero-filled and read nothing.
template <int DP, int BKV, bool QUANT>
__device__ __forceinline__ void issue_tile(const PagedArgs& p, const Tokens& tk, int h, int t0,
                                           int t_end, unsigned char* kdst, unsigned char* vdst,
                                           float* ksd, float* vsd) {
  using T = typename std::conditional<QUANT, int8_t, bf16>::type;
  constexpr int E = 16 / sizeof(T), CPR = DP / E;  // elements per copy, copies per row
  const T* kb = static_cast<const T*>(p.k_pool) + (size_t)h * p.d;
  const T* vb = static_cast<const T*>(p.v_pool) + (size_t)h * p.d;
  const size_t stride = (size_t)p.nkv * p.d;
#pragma unroll 4
  for (int i = threadIdx.x; i < BKV * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * E;
    const int pos = t0 + r;
    const bool ok = pos < t_end && c < p.d;
    const size_t off = ok ? (size_t)tk(pos) * stride + c : 0;
    const int o = QUANT ? r * DP + c : 2 * sm90::swz_off<BKV>(r, c);
    sm90::cp_async<16>(kdst + o, kb + off, ok);
    sm90::cp_async<16>(vdst + o, vb + off, ok);
  }
  if constexpr (QUANT) {
    const int r = threadIdx.x % BKV, pos = t0 + r;
    const bool ok = pos < t_end;
    const size_t off = ok ? (size_t)tk(pos) * p.nkv + h : 0;
    if (threadIdx.x < BKV)
      sm90::cp_async<4>(ksd + r, p.k_scale + off, ok);
    else if (threadIdx.x < 2 * BKV)
      sm90::cp_async<4>(vsd + r, p.v_scale + off, ok);
  }
}

// Widen a raw int8 tile (BKV rows of DP bytes) into a swizzled bf16 tile;
// columns at or past d become zeros.
template <int DP, int BKV>
__device__ __forceinline__ void widen(bf16* dst, const int8_t* src, int d) {
  constexpr int CPR = DP / 16;
#pragma unroll 2
  for (int i = threadIdx.x; i < BKV * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 16;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (c < d) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * DP + c);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t x = w[j / 2] >> (16 * (j % 2));
        o[j] = sm90::pack_bf16((float)(int8_t)(x & 0xff), (float)(int8_t)((x >> 8) & 0xff));
      }
      lo = make_uint4(o[0], o[1], o[2], o[3]);
      hi = make_uint4(o[4], o[5], o[6], o[7]);
    }
    *reinterpret_cast<uint4*>(dst + sm90::swz_off<BKV>(r, c)) = lo;
    *reinterpret_cast<uint4*>(dst + sm90::swz_off<BKV>(r, c + 8)) = hi;
  }
}

// grid (splits, nkv * ceil(g / 64), b), launched as clusters of (splits,
// 1, 1): block (z, y, row) takes the query heads 64 (y % gc) .. of kv head
// y / gc (gc = ceil(g / 64)) over tokens [z split, (z + 1) split) of row
// `row`, and the cluster combines the splits.  DP: the head dim padded to
// whole 64-column atoms; BKV: tokens a tile.
template <int DP, int BKV, bool QUANT>
__global__ void __launch_bounds__(THREADS) paged_decode_sm90(const PagedArgs p) {
  using L = Layout<DP, BKV, QUANT>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const int R = p.q_rows;
  bf16* Qs = reinterpret_cast<bf16*>(base);
  unsigned char* after_q = base + (size_t)R * DP * 2;
  float* m_s = reinterpret_cast<float*>(base + L::ml_offset(R));
  float* l_s = m_s + GROUP_ROWS;
  float* park = reinterpret_cast<float*>(base);

  const int gc = (p.g + GROUP_ROWS - 1) / GROUP_ROWS;
  const int z = blockIdx.x, splits = gridDim.x, row = blockIdx.z;
  const int h = blockIdx.y / gc, g0 = (blockIdx.y % gc) * GROUP_ROWS;
  const int gb = min(GROUP_ROWS, p.g - g0);  // query heads of this block
  const int capacity = p.max_blocks > 0 ? p.max_blocks * p.depth : p.depth;
  const int len = max(0, min(p.lengths[row], capacity));
  const int t_begin = z * p.split, t_end = min(len, t_begin + p.split);
  const Tokens tk(p.index, row, p.depth, p.max_blocks);
  const size_t head0 = (size_t)row * p.a + (size_t)h * p.g + g0;  // first query head's row of q

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = 16 * warp + lane / 4, col = 2 * (lane % 4);  // rows qr, qr + 8
  const bool live_rows = 16 * warp < gb;  // this warp holds a query head

  // ring slot st: K and V (bf16 tiles, or raw int8 tiles and their scales)
  auto slot_k = [&](int st) -> unsigned char* {
    return QUANT ? after_q + 2 * L::TILE + st * L::RAW_SLOT : after_q + st * 2 * L::TILE;
  };
  auto slot_v = [&](int st) -> unsigned char* {
    return QUANT ? slot_k(st) + L::RAW : slot_k(st) + L::TILE;
  };
  auto slot_ks = [&](int st) { return reinterpret_cast<float*>(slot_k(st) + 2 * L::RAW); };
  auto slot_vs = [&](int st) { return slot_ks(st) + BKV; };
  const bf16* Kw = reinterpret_cast<const bf16*>(after_q);  // int8: the widened tiles
  const bf16* Vw = Kw + BKV * DP;

  float acc[DP / 2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  uint32_t pf[BKV / 16][4];
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pf[kk][j] = 0u;

  if (t_begin < t_end) {
    // Q: the block's query heads as the first gb rows of an R-row tile
    // (rows gb .. R zero; the product's rows past R read other data and
    // are never stored)
    for (int i = threadIdx.x; i < R * (DP / 8); i += THREADS) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      const bool ok = r < gb && c < p.d;
      sm90::cp_async<16>(Qs + swz(r, c, R), ok ? p.q + (head0 + r) * p.d + c : p.q, ok);
    }
    // tiles 0 and 1 in flight; each step then waits for its tile and issues
    // the one two ahead into the slot the previous step read
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (t_begin + j * BKV < t_end)
        issue_tile<DP, BKV, QUANT>(p, tk, h, t_begin + j * BKV, t_end, slot_k(j), slot_v(j),
                                   slot_ks(j), slot_vs(j));
      sm90::cp_async_commit();
    }

    int it = 0, st = 0;
    for (int t0 = t_begin; t0 < t_end; t0 += BKV, ++it, st = st == STAGES - 1 ? 0 : st + 1) {
      sm90::cp_async_wait<STAGES - 2>();  // tile it (and Q) landed
      if constexpr (!QUANT) sm90::fence_async_smem();
      __syncthreads();  // ... for every thread; the slot of tile it - 1 is free
      const int nx = st == 0 ? STAGES - 1 : st - 1;  // (it + STAGES - 1) % STAGES
      if (t0 + (STAGES - 1) * BKV < t_end)
        issue_tile<DP, BKV, QUANT>(p, tk, h, t0 + (STAGES - 1) * BKV, t_end, slot_k(nx),
                                   slot_v(nx), slot_ks(nx), slot_vs(nx));
      sm90::cp_async_commit();
      const bf16* Ks = QUANT ? Kw : reinterpret_cast<const bf16*>(slot_k(st));
      const bf16* Vs = QUANT ? Vw : reinterpret_cast<const bf16*>(slot_v(st));
      if constexpr (QUANT) {
        widen<DP, BKV>(const_cast<bf16*>(Kw), reinterpret_cast<const int8_t*>(slot_k(st)), p.d);
        widen<DP, BKV>(const_cast<bf16*>(Vw), reinterpret_cast<const int8_t*>(slot_v(st)), p.d);
        sm90::fence_async_smem();
        __syncthreads();
      }

      // S = Q K^T (the first product overwrites s)
      float s[BKV / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        sm90::Wgmma<BKV, 0, 0>::ss(
            s, sm90::desc(Qs + (kk >> 2) * (R * 64) + (kk & 3) * 16, 16, 1024),
            sm90::desc_k<BKV>(Ks, kk), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<BKV / 2>(s);

      // online softmax in registers, log2 units (flash_attention.cu): register
      // i is query head qr + 8 ((i / 2) % 2), token t0 + 8 (i / 4) + col + i % 2
      if (live_rows) {
        if constexpr (QUANT) {
          const float* ks = slot_ks(st);
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) s[i] *= ks[8 * (i >> 2) + col + (i & 1)];
        }
        if (t0 + BKV > t_end) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i)
            if (t0 + 8 * (i >> 2) + col + (i & 1) >= t_end) s[i] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float alpha[2], mu[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float m_new = fmaxf(m[hh], quad_max(mx[hh]) * p.sl2);
          mu[hh] = m_new == -INFINITY ? 0.0f : m_new;
          alpha[hh] = exp2f(m[hh] - mu[hh]);
          m[hh] = m_new;
          l[hh] *= alpha[hh];
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int hh = (i >> 1) & 1;
          s[i] = exp2f(fmaf(s[i], p.sl2, -mu[hh]));
          l[hh] += s[i];
        }
        if (it > 0) {
#pragma unroll
          for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        }
        if constexpr (QUANT) {  // fold the V scales into P before it rounds
          const float* vs = slot_vs(st);
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) s[i] *= vs[8 * (i >> 2) + col + (i & 1)];
        }
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pf[kk][j] = sm90::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
      }

      // O (+)= P V (the first tile's first product overwrites acc)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        sm90::WgmmaN<DP>::rs(acc, pf[kk], sm90::desc_mn<BKV>(Vs, kk, 0), BKV * 128,
                             it > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<DP / 2>(acc);
      sm90::fence_regs<BKV / 4>(&pf[0][0]);
    }
    if (splits == 1) {  // the whole walk: the output straight from the registers
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float lt = quad_sum(l[hh]);
        const int r = qr + 8 * hh;
        if (r >= gb) continue;
        const float inv = 1.0f / lt;
        bf16* orow = p.out + (head0 + r) * p.d;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
          if (8 * j + col < p.d)
            *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
                sm90::pack_bf16(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
      }
      return;
    }
    __syncthreads();  // every product has read Q and the ring: park over them

    // park this split's partial: rows < gb of m (log2 units), l and acc
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lt = quad_sum(l[hh]);
      const int r = qr + 8 * hh;
      if (r >= gb) continue;
      if (lane % 4 == 0) {
        m_s[r] = m[hh];
        l_s[r] = lt;
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<float2*>(park + r * L::LD + 8 * j + col) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  } else if (splits == 1) {  // a dead row: zeros (paged.py:92-94)
    for (int i = threadIdx.x; i < gb * (p.d / 8); i += THREADS)
      *reinterpret_cast<uint4*>(p.out + (head0 + i / (p.d / 8)) * p.d + (i % (p.d / 8)) * 8) =
          make_uint4(0, 0, 0, 0);
    return;
  } else if (threadIdx.x < gb) {  // an empty split: m = -inf, l = 0
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.0f;
  }

  // combine the cluster's partials in split order, each rescaled once by
  // 2^(m_z - M); a row no split saw (a dead row) gets zeros
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int c4 = p.d / 4;  // 4-column pieces of a row (d is a multiple of 8)
  for (int i = z * THREADS + threadIdx.x; i < gb * c4; i += splits * THREADS) {
    const int r = i / c4, c = (i % c4) * 4;
    float mz[MAX_SPLITS], lz[MAX_SPLITS], M = -INFINITY;
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) {
      if (q >= splits) break;
      mz[q] = cluster.map_shared_rank(m_s, q)[r];
      lz[q] = cluster.map_shared_rank(l_s, q)[r];
    }
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < splits) M = fmaxf(M, mz[q]);
    float lsum = 0.0f;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) {
      if (q >= splits) break;
      const float lq = lz[q];
      if (lq == 0.0f) continue;  // an empty split parked no acc
      const float w = exp2f(mz[q] - M);
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park, q) +
                                                        r * L::LD + c);
      lsum = fmaf(lq, w, lsum);
      o.x = fmaf(v.x, w, o.x);
      o.y = fmaf(v.y, w, o.y);
      o.z = fmaf(v.z, w, o.z);
      o.w = fmaf(v.w, w, o.w);
    }
    const float inv = lsum == 0.0f ? 0.0f : 1.0f / lsum;
    *reinterpret_cast<uint2*>(p.out + (head0 + r) * p.d + c) =
        make_uint2(sm90::pack_bf16(o.x * inv, o.y * inv), sm90::pack_bf16(o.z * inv, o.w * inv));
  }
  cluster.sync();  // every block's partial stays alive until the others have read it
}

template <int DP, int BKV, bool QUANT>
int launch_sm90(const PagedArgs& p, int b, int splits, size_t smem, cudaStream_t s) {
  if (smem < Layout<DP, BKV, QUANT>::bytes(p.q_rows)) return (int)cudaErrorInvalidValue;
  auto* kern = paged_decode_sm90<DP, BKV, QUANT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, p.nkv * ((p.g + GROUP_ROWS - 1) / GROUP_ROWS), b);
  if (splits == 1) {  // no cluster: the block writes its output itself
    kern<<<grid, THREADS, smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BKV, bool QUANT>
int launch_sm90_d(const PagedArgs& p, int b, int splits, size_t smem, cudaStream_t s) {
  switch ((p.d + 63) / 64) {
    case 1: return launch_sm90<64, BKV, QUANT>(p, b, splits, smem, s);
    case 2: return launch_sm90<128, BKV, QUANT>(p, b, splits, smem, s);
    case 3: return launch_sm90<192, BKV, QUANT>(p, b, splits, smem, s);
    case 4: return launch_sm90<256, BKV, QUANT>(p, b, splits, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, a, d), q_dtype 0 = f32, 1 = bf16; k_pool, v_pool (tokens, nkv, d),
// kv_dtype q_dtype or 2 = int8 (then k_scale, v_scale (tokens, nkv) f32,
// else null).  max_blocks == 0: slot pool, index = slot_idx (b,), depth =
// s_max; max_blocks > 0: block table, index = tables (b, max_blocks), depth
// = block_size.  lengths (b,) int32; out (b, a, d).  All contiguous.  The
// geometry is the wrapper's (kernels/flash_attention/ops.py
// `paged_launch`): f32, tile = the body's bkv (split and splits unused);
// bf16, tile = 32 or 64 tokens, split tokens a block (a multiple of the
// tile), splits <= 8 covering the pool's capacity.  smem: the launch's
// dynamic shared memory in bytes.
extern "C" int repro_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale, const void* index,
                                  const void* lengths, void* out, int b, int a, int nkv, int d,
                                  int depth, int max_blocks, int tile, int split, int splits,
                                  int smem, float scale, int q_dtype, int kv_dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kvb = kv_dtype == DT_F32 ? 4 : kv_dtype == DT_BF16 ? 2 : 1;
  if (b <= 0 || nkv <= 0 || a % nkv || d <= 0 || d > MAX_D || tile <= 0 || depth <= 0 ||
      max_blocks < 0 || d % (16 / kvb) || smem <= 0)
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_dtype == DT_INT8;
  if (!quant && kv_dtype != q_dtype) return (int)cudaErrorInvalidValue;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (q_dtype == DT_F32) {
    if (tile % 2 || (size_t)smem < f32_smem(a / nkv, d, tile, kv_dtype))
      return (int)cudaErrorInvalidValue;
    return quant ? launch_f32_g<int8_t>(q, k_pool, v_pool, k_scale, v_scale, index, lengths, out,
                                        b, a, nkv, d, depth, max_blocks, tile, scale, smem, s)
                 : launch_f32_g<float>(q, k_pool, v_pool, k_scale, v_scale, index, lengths, out,
                                       b, a, nkv, d, depth, max_blocks, tile, scale, smem, s);
  }
  if (q_dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  const long long capacity = max_blocks > 0 ? (long long)max_blocks * depth : depth;
  if (b > 65535 || splits < 1 || splits > MAX_SPLITS || split <= 0 || split % tile ||
      (long long)split * splits < capacity || capacity > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int g = a / nkv;
  PagedArgs p{static_cast<const bf16*>(q), k_pool, v_pool, static_cast<const float*>(k_scale),
              static_cast<const float*>(v_scale), static_cast<const int*>(index),
              static_cast<const int*>(lengths), static_cast<bf16*>(out), a, nkv, g, d, depth,
              max_blocks, split, ((g < GROUP_ROWS ? g : GROUP_ROWS) + 7) / 8 * 8,
              scale * LOG2E};
  if (tile == 32)
    return quant ? launch_sm90_d<32, true>(p, b, splits, smem, s)
                 : launch_sm90_d<32, false>(p, b, splits, smem, s);
  if (tile == 64)
    return quant ? launch_sm90_d<64, true>(p, b, splits, smem, s)
                 : launch_sm90_d<64, false>(p, b, splits, smem, s);
  return (int)cudaErrorInvalidValue;
}
