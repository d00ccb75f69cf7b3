// flash_attention: FlashAttention forward (output and per-row logsumexp),
// GQA, causal or not, over the model layout q (b, sq, a, d), k / v (b, skv,
// nkv, d) read in place, at any head dim d <= 256.  The backward is
// flash_attention_bwd.cu; f32 (a check dtype) takes flash_attention_f32.cu.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
// `flash_attention_pallas` (`_flash_kernel`): attention of every layer
// under attn_impl = "flash" on the training path.
//
// What bounds it on the H100: operations.  At the training slice's shape
// (b 4, s 1024, 16 query / 8 kv heads, d 128, causal) the forward is
// 4*b*a*s^2*d/2 = 17 GFLOP over 42 MB of q, k, v and o (~400 FLOP/byte),
// so the tensor cores must be fed from shared memory and registers, and
// the softmax must not stand between two products in shared memory.
//
// What the design does about it (bf16, sm_90a):
//   * one warpgroup (128 threads) owns a 64-row query tile and walks the
//     kv tiles (64 rows each); S = Q K^T is a `wgmma` m64n64k16 chain with
//     Q and K in shared memory and S in registers.  The accumulator layout
//     puts a row's elements in one quad of lanes (sm90.cuh), so the online
//     softmax runs in registers with two quad shuffles per row, and S never
//     touches shared memory.  It works in log2 units, p = 2^(s scale
//     log2(e) - m): one FFMA and one ex2 a score (kernels/tolerance.py
//     charges the prescale and ex2's error).  P is rounded to bf16 in
//     registers (as FA2 does; the tolerance charges that too) and is the
//     register A operand of O += P V, a `wgmma` against V in shared memory
//     (MN-major, staged as it lies).  O stays in registers and is rescaled
//     there;
//   * K and V come through a two-stage ring of cp.async copies: tile t + 1
//     is in flight while tile t's products run.  Tiles use the 128-byte
//     swizzle (sm90.cuh), so each warp's copies read whole 128-byte lines
//     and write shared memory without bank conflicts; with the unswizzled
//     layout the copies were the bottleneck.  Rows past skv and columns
//     past d arrive as zeros (cp.async's zero fill), so the head dim pads
//     to the instantiated width (flash_attention.cuh `padded_d`: multiples
//     of 16 up to 128, of 32 above) in shared memory only; rows of d not a
//     multiple of 8 stage with 8-, 4- or 2-byte copies;
//   * the causal loop ends at the diagonal tile, and only the diagonal and
//     the ragged last tile are masked (top-left, kv_pos <= q_pos, as
//     kernel.py:42-45).  Blocks are numbered heaviest query tile first, so
//     the short causal tiles fill the last wave.  A row with no live key
//     gets output 0 and lse 0 (kernel.py:101-112);
//   * shared memory holds Q and two stages of K and V, 640 bytes per
//     column of the tile (whole 64-column atoms): 80 KB at d = 128, so two
//     blocks share an SM up to d = 128.
#include <climits>

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace {

using sm90::bf16;

constexpr int DT_F32 = 0, DT_BF16 = 1;  // csrc/gemm_tile.cuh's dtype codes
constexpr int BQ = 64, BKV = 64, NT = 128;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// grid (ceil(sq / BQ) * a * b): block i takes query tile i / (a b), counted
// from the last under the causal mask.  o like q; lse (b, a, sq) f32.
template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int sq,
               int skv, int a, int nkv, int d, int causal, float scale, int nqt) {
  constexpr int TILE = BQ * sm90::tile_width(DP);  // elements of one 64-row tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(sm90::align1024(smem));
  bf16* KVs = Qs + TILE;  // stage st: K at KVs + 2 st TILE, V after it

  const int per = gridDim.x / nqt;  // a * b
  const int rank = blockIdx.x / per, rest = blockIdx.x % per;
  const int q0 = (causal ? nqt - 1 - rank : rank) * BQ;
  const int h = rest % a, bi = rest / a, hk = h / (a / nkv);
  const size_t qs = (size_t)a * d, ks = (size_t)nkv * d;
  const bf16* qb = q + (size_t)bi * sq * qs + (size_t)h * d;
  const bf16* kb = k + (size_t)bi * skv * ks + (size_t)hk * d;
  const bf16* vb = v + (size_t)bi * skv * ks + (size_t)hk * d;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;  // tiles past the diagonal never run
  const int ntiles = (kv_end + BKV - 1) / BKV;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);  // rows row, row + 8

  sm90::stage_rows<BQ, DP, NT>(Qs, qb, qs, q0, sq, d);
  sm90::stage_rows<BKV, DP, NT>(KVs, kb, ks, 0, skv, d);
  sm90::stage_rows<BKV, DP, NT>(KVs + TILE, vb, ks, 0, skv, d);
  sm90::cp_async_commit();

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  // running max m (log2 units) and sum l (this thread's columns only) of rows row, row + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = scale * LOG2E;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {  // the next tile's copies overlap this tile's products
      bf16* nxt = KVs + ((t + 1) & 1) * 2 * TILE;
      sm90::stage_rows<BKV, DP, NT>(nxt, kb, ks, (t + 1) * BKV, skv, d);
      sm90::stage_rows<BKV, DP, NT>(nxt + TILE, vb, ks, (t + 1) * BKV, skv, d);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // tile t (and q) landed
    sm90::fence_async_smem();
    __syncthreads();
    const bf16* Ks = KVs + (t & 1) * 2 * TILE;
    const bf16* Vs = Ks + TILE;

    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      sm90::Wgmma<BKV, 0, 0>::ss(s, sm90::desc_k<BQ>(Qs, kk), sm90::desc_k<BKV>(Ks, kk), kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BKV / 2>(s);

    // online softmax in registers (kernel.py:79-94), in log2 units: p =
    // 2^(s scale log2(e) - m), one FFMA and one ex2 a score
    // (kernels/tolerance.py charges the prescale and ex2's error).  Register
    // i is row row + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + col + i % 2; only
    // the diagonal and ragged tiles mask (-inf, so p = 0).
    const int k0 = t * BKV;
    if (k0 + BKV > skv || (causal && k0 + BKV - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = k0 + 8 * (i >> 2) + col + (i & 1);
        if (c >= skv || (causal && c > q0 + row + 8 * ((i >> 1) & 1))) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mu[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]) * sl2);
      mu[hh] = m_new == -INFINITY ? 0.0f : m_new;  // no live key yet: p = 0, alpha = 0
      alpha[hh] = exp2f(m[hh] - mu[hh]);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int hh = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], sl2, -mu[hh]));
      l[hh] += s[i];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    uint32_t pf[BKV / 16][4];  // P as the A operand, one k16 step per 16 keys
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pf[kk][j] = sm90::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      sm90::WgmmaN<DP>::rs(acc, pf[kk], sm90::desc_mn<BKV>(Vs, kk, 0), BKV * 128, 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<DP / 2>(acc);
    sm90::fence_regs<BKV / 4>(&pf[0][0]);
    __syncthreads();  // stage t & 1 free for tile t + 2
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt = quad_sum(l[hh]);
    const int r = q0 + row + 8 * hh;
    if (r >= sq) continue;
    const float ls = lt == 0.0f ? 1.0f : lt;  // a row with no live key -> 0
    bf16* orow = o + ((size_t)bi * sq + r) * qs + (size_t)h * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      const float v0 = acc[4 * j + 2 * hh] / ls, v1 = acc[4 * j + 2 * hh + 1] / ls;
      if ((d & 1) == 0) {
        if (c < d) *reinterpret_cast<uint32_t*>(orow + c) = sm90::pack_bf16(v0, v1);
      } else {
        if (c < d) orow[c] = __float2bfloat16_rn(v0);
        if (c + 1 < d) orow[c + 1] = __float2bfloat16_rn(v1);
      }
    }
    if (lane % 4 == 0) lse[((size_t)bi * a + h) * sq + r] = lt == 0.0f ? 0.0f : m[hh] * LN2 + logf(ls);
  }
}

template <int DP>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int b,
                       int sq, int skv, int a, int nkv, int d, int causal, float scale,
                       cudaStream_t s) {
  constexpr size_t SMEM = 5 * BQ * sm90::tile_width(DP) * sizeof(bf16) + 1024;
  auto* kern = flash_fwd_sm90<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const int nqt = (sq + BQ - 1) / BQ;
  const long long blocks = (long long)nqt * a * b;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NT, SMEM, s>>>(q, k, v, o, lse, sq, skv, a, nkv, d, causal, scale, nqt);
  return cudaGetLastError();
}

cudaError_t fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int b,
                     int sq, int skv, int a, int nkv, int d, int causal, float scale,
                     cudaStream_t s) {
  switch (flash::padded_d(d)) {
#define FLASH_FWD_CASE(DP) \
  case DP: return launch_fwd<DP>(q, k, v, o, lse, b, sq, skv, a, nkv, d, causal, scale, s);
    FLASH_FOR_EACH_DP(FLASH_FWD_CASE)
#undef FLASH_FWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, sq, a, d), k / v (b, skv, nkv, d), o like q: contiguous, 16-byte
// aligned.  lse (b, a, sq) f32.  1 <= d <= 256.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int b, int sq, int skv, int a, int nkv, int d, int causal,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash::shape_ok(b, sq, skv, a, nkv, d)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)fwd_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(o),
                         static_cast<float*>(lse), b, sq, skv, a, nkv, d, causal, scale, s);
  if (dtype == DT_F32)
    return (int)flash::fwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<float*>(o),
                               static_cast<float*>(lse), b, sq, skv, a, nkv, d, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
