// paged_decode: one-query GQA decode attention over a KV pool, addressed by
// slot or by block table, with float or int8 storage.
//
// Replaces: src/repro/kernels/flash_attention/paged.py `paged_decode_pallas`
// (slot pool) and `paged_decode_blocktable_pallas` (block table), each with
// its float pool and its int8 pool (f32 scales per (token, kv head)).  The
// Pallas kernels share one body, `_paged_kernel` (paged.py:47-94), that
// reasons only in logical kv positions; only their index maps know the
// physical address.  So does this file: one kernel body, templated on the
// query type, the storage type (the query's, or int8) and the KV index
// (slot or table).  It serves decode attention of every layer under
// Engine(use_paged_kernel=True): the slot pool, the block-table pool of
// Engine(prefix_cache=True), and either pool with kv_dtype="int8".
//
// What bounds it on the H100: bytes.  Per row it reads the live prefix of
// the row's KV, lengths[b] * nkv * d elements of K and V (2 bytes each in
// bf16, 1 byte plus a 4-byte scale per (token, head) in int8), and does 4
// FLOPs per element read (a score and a weighted sum per query head of the
// group, g = 2 here): ~2 FLOP/byte, far under any compute line.
//
// What the design does about it: one block per (row b, kv head h) serves
// the g query heads that share the kv head (head i -> kv head i // g, as
// paged.py:121), so each K/V element is read from device memory once for
// all g heads.  The block's head count is a template width, 8 or 16, that
// the launch picks (g <= 8, or g <= 16: command-r-plus and nemotron-4 have
// g = 12); a larger group is split over a third grid dimension in chunks
// of 16 heads, and each chunk reads the row's K/V once (ceil(g / 16)
// reads in all).  The block loads lengths[b] itself and walks kv tiles only up
// to it (a dead row reads nothing and writes zeros); table entries past a
// row's live blocks are never read.  At the top of each tile the block
// resolves every live token's physical index once (slot * s_max + pos, or
// table[b, pos / bs] * bs + pos % bs: one table load per token, so a tile
// may span several physical blocks and any block size works), then stages
// the tile in shared memory with 16-byte loads: 8 bf16 or 16 int8 elements
// per load, 128 B per (token, head) of an int8 pool at d = 128.  An int8
// tile is staged as it lies, with its per-token scales beside it, and
// dequantized in f32 where it is read (one product per element, as
// paged.py:73-75).  The tail tile is masked, so any depth works.  The
// online softmax runs in f32 (paged.py:76-88).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;     // head dim
constexpr int DPT = MAX_D / THREADS;  // output columns per thread (<= 2)
constexpr float NEG_INF = -1e30f;

// dtype codes: those of csrc/gemm_tile.cuh `DType`, and int8 storage
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// q (b, a, d) TQ; pools (tokens, nkv, d) TKV, where a token's index is
// slot * depth + pos (slot pool: index = slot_idx (b,), depth = s_max) or
// table[b, pos / depth] * depth + pos % depth (block table: index = tables
// (b, max_blocks), depth = block_size); an int8 pool's scales (tokens, nkv)
// f32.  out (b, a, d) TQ.  grid (b, nkv, ceil(g / GW)): block (b, h, z)
// serves query heads h g + z GW .. of kv head h, at most GW of them.
// Dynamic shared memory: the tile's token indices (bkv int64), K and V
// tiles (bkv x d TKV each), q (gs x d f32), scores (gs x bkv f32), the
// tile's K and V scales (bkv f32 each) and the per-head running max / sum /
// rescale (GW each), where gs = min(g, GW).
template <typename TQ, typename TKV, bool TABLE, int GW>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ index,
                    const int* __restrict__ lengths, TQ* __restrict__ out, int a, int nkv, int d,
                    int depth, int max_blocks, int bkv, float scale) {
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
  const TQ* qrow = q + ((size_t)row * a + (size_t)h * (a / nkv) + z0) * d;
  TQ* orow = out + ((size_t)row * a + (size_t)h * (a / nkv) + z0) * d;
  const int capacity = TABLE ? max_blocks * depth : depth;
  const int len = min(lengths[row], capacity);

  float acc[GW][DPT];
#pragma unroll
  for (int gi = 0; gi < GW; ++gi)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[gi][c] = 0.0f;

  if (len <= 0) {  // dead row: zeros (paged.py:92-94)
    for (int i = tid; i < g * d; i += THREADS) orow[i] = from_f<TQ>(0.0f);
    return;
  }
  const int* table = index + (size_t)row * max_blocks;  // TABLE only
  const long long slot_base = TABLE ? 0 : (long long)index[row] * depth;
  for (int i = tid; i < g * d; i += THREADS) qs[i] = to_f(qrow[i]);
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
        orow[gi * d + e] = from_f<TQ>(acc[gi][c] / l);
      }
    }
  }
}

size_t kv_bytes(int kv_dtype) { return kv_dtype == DT_F32 ? 4 : kv_dtype == DT_BF16 ? 2 : 1; }

// The block's head-count width for a group of g query heads.
int group_width(int g) { return g <= 8 ? 8 : 16; }

template <typename TQ, typename TKV, int GW>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* index, const void* lengths, void* out, int b, int a,
           int nkv, int d, int depth, int max_blocks, int bkv, float scale, size_t smem,
           cudaStream_t s) {
  auto* kern = max_blocks > 0 ? paged_decode_kernel<TQ, TKV, true, GW>
                              : paged_decode_kernel<TQ, TKV, false, GW>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<dim3(b, nkv, (a / nkv + GW - 1) / GW), THREADS, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(index),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), a, nkv, d, depth, max_blocks,
      bkv, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_g(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* index, const void* lengths, void* out, int b, int a,
             int nkv, int d, int depth, int max_blocks, int bkv, float scale, size_t smem,
             cudaStream_t s) {
  if (group_width(a / nkv) == 8)
    return launch<TQ, TKV, 8>(q, k_pool, v_pool, k_scale, v_scale, index, lengths, out, b, a,
                              nkv, d, depth, max_blocks, bkv, scale, smem, s);
  return launch<TQ, TKV, 16>(q, k_pool, v_pool, k_scale, v_scale, index, lengths, out, b, a,
                             nkv, d, depth, max_blocks, bkv, scale, smem, s);
}

}  // namespace

// Shared memory for a tile of bkv tokens (the wrapper sizes bkv); g query
// heads per kv head.
extern "C" size_t repro_paged_decode_smem(int g, int d, int bkv, int kv_dtype) {
  const int gw = group_width(g), gs = g < gw ? g : gw;
  return (size_t)bkv * 8 + 2 * (size_t)bkv * d * kv_bytes(kv_dtype) + (size_t)gs * d * 4 +
         (size_t)gs * bkv * 4 + 2 * (size_t)bkv * 4 + 3 * (size_t)gw * 4;
}

// q (b, a, d), q_dtype 0 = f32, 1 = bf16; k_pool, v_pool (tokens, nkv, d),
// kv_dtype q_dtype or 2 = int8 (then k_scale, v_scale (tokens, nkv) f32,
// else null).  max_blocks == 0: slot pool, index = slot_idx (b,), depth =
// s_max; max_blocks > 0: block table, index = tables (b, max_blocks), depth
// = block_size.  lengths (b,) int32; out (b, a, d).  All contiguous.
extern "C" int repro_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale, const void* index,
                                  const void* lengths, void* out, int b, int a, int nkv, int d,
                                  int depth, int max_blocks, int bkv, float scale, int q_dtype,
                                  int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || nkv <= 0 || a % nkv || d > MAX_D || bkv <= 0 || bkv % 2 ||
      depth <= 0 || max_blocks < 0 || d % (16 / kv_bytes(kv_dtype)))
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_dtype == DT_INT8;
  if (!quant && kv_dtype != q_dtype) return (int)cudaErrorInvalidValue;
  if (quant != (k_scale != nullptr && v_scale != nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = repro_paged_decode_smem(a / nkv, d, bkv, kv_dtype);
#define REPRO_PAGED_LAUNCH(TQ, TKV)                                                           \
  launch_g<TQ, TKV>(q, k_pool, v_pool, k_scale, v_scale, index, lengths, out, b, a, nkv, d, \
                    depth, max_blocks, bkv, scale, smem, s)
  if (q_dtype == DT_BF16)
    return quant ? REPRO_PAGED_LAUNCH(__nv_bfloat16, int8_t)
                 : REPRO_PAGED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == DT_F32)
    return quant ? REPRO_PAGED_LAUNCH(float, int8_t) : REPRO_PAGED_LAUNCH(float, float);
#undef REPRO_PAGED_LAUNCH
  return (int)cudaErrorInvalidValue;
}
