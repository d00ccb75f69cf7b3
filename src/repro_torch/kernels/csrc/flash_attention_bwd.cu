// flash_attention_bwd: FlashAttention backward (dq, dk, dv) in one pass,
// GQA, causal or not, over the model layout (flash_attention.cu), at any
// head dim d <= 256.  f32 (a check dtype) takes flash_attention_f32.cu.
//
// Replaces: src/repro/kernels/flash_attention/backward.py
// `flash_attention_bwd_pallas` (`_dq_kernel`, `_dkv_kernel`): the gradient
// of every layer's attention under attn_impl = "flash".
//
// What bounds it on the H100: operations.  At the training slice's shape
// the backward is 2.5x the forward's FLOPs (five products of the forward's
// size over two), 43 GFLOP, over ~2x its bytes.
//
// What the design does about it (bf16, sm_90a):
//   * one pass, five products: a warpgroup owns one kv head's 64-row kv
//     tile and walks the g query heads of its group and their 64-row query
//     tiles (the TPU kernels' dq and dk/dv passes recompute S and dP each,
//     seven products).  S^T = K Q^T and dP^T = V dO^T are `wgmma` chains
//     into registers; P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - di)
//     scale are formed there, rounded to bf16 (as FA2; kernels/tolerance.py
//     charges it) and kept as register A operands of dV += P^T dO and
//     dK += dS^T Q, whose accumulators stay in registers for the whole
//     walk.  dS^T also goes to shared memory once, the MN-major A operand
//     of dQ = dS K, which is added with f32 atomics into a scratch buffer
//     (zeroed here, converted to the output dtype by a second small
//     kernel).  Under GQA the group's sum of dk and dv happens in the
//     accumulators: no (g * skv * d) temporary.  di = rowsum(dO o O) comes
//     from a pre-pass kernel (one warp a row, both dtypes), which reads o
//     and dO once in the input dtype;
//   * Q, dO and their lse and di rows come through a two-stage ring of
//     cp.async copies, the next query tile's in flight while this one's
//     products run; K and V are staged once.  Tiles use the 128-byte
//     swizzle of sm90.cuh; rows and columns past the edges arrive as zeros,
//     as in the forward;
//   * dq's atomics are float4 (quad lanes swap a pair, so each lane adds
//     four neighbouring columns): a quarter of the scalar atomics, which
//     the L2 serves one at a time;
//   * registers: dK and dV for 64 kv rows at width w take w f32 registers
//     a thread, S^T and dP^T 64 more.  Up to a padded d of 128 a launch
//     keeps all of d; above it one launch keeps columns [0, 128) of dk, dv
//     and dq and a second the rest, each recomputing S^T and dP^T over the
//     full d (seven products' work at d > 128 only);
//   * causal: a kv tile's walk starts at its diagonal query tile, and only
//     the diagonal and ragged tiles are masked; blocks are numbered
//     heaviest kv tile (the first) first.
#include <climits>

#include "flash_attention.cuh"
#include "sm90.cuh"

namespace {

using sm90::bf16;

constexpr int DT_F32 = 0, DT_BF16 = 1;  // csrc/gemm_tile.cuh's dtype codes
constexpr int BQ = 64, BKV = 64, NT = 128;

template <int DP> struct BwdSmem {
  static constexpr int TILE = 64 * sm90::tile_width(DP);  // elements of one 64-row tile
  // K, V; two stages of (Q, dO); dS^T (64 x 64); two stages of (lse, di);
  // slack to align the tiles to 1024 bytes
  static constexpr size_t BYTES =
      (6 * (size_t)TILE + 64 * 64) * sizeof(bf16) + 4 * 64 * sizeof(float) + 1024;
};

// grid (ceil(skv / BKV) * nkv * b): block i takes kv tile i / (nkv b), the
// first (heaviest under the causal mask) first, and columns [c0, c0 + DC)
// of dk, dv and dq (c0 a multiple of 64).  lse, di (b, a, sq) f32; dq_acc
// like q, f32, zeroed; dk, dv like k.
template <int DP, int DC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
               int skv, int a, int nkv, int d, int causal, float scale, int nkt, int c0) {
  constexpr int TILE = BwdSmem<DP>::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(sm90::align1024(smem));
  bf16* Vs = Ks + TILE;
  bf16* QDs = Vs + TILE;            // stage st: Q at QDs + 2 st TILE, dO after it
  bf16* dSs = QDs + 4 * TILE;       // dS^T, 64 kv rows x 64 query columns
  float* rows_s = reinterpret_cast<float*>(dSs + 64 * 64);  // stage st: lse, di at + 128 st

  const int per = gridDim.x / nkt;  // nkv * b
  const int kt = blockIdx.x / per, rest = blockIdx.x % per;
  const int hk = rest % nkv, bi = rest / nkv;
  const int k0 = kt * BKV, g = a / nkv;
  const size_t qs = (size_t)a * d, ks = (size_t)nkv * d;
  const size_t koff = (size_t)bi * skv * ks + (size_t)hk * d;

  // steps: (query head gi, query tile) pairs, gi-major; causal starts at
  // the diagonal tile
  const int q_begin = causal ? k0 : 0;
  const int nq = q_begin < sq ? (sq - q_begin + BQ - 1) / BQ : 0;
  const int steps = g * nq;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);  // kv rows row, row + 8

  auto stage_step = [&](int i, int st) {
    const int h = hk * g + i / nq, q0 = q_begin + (i % nq) * BQ;
    const size_t qoff = (size_t)bi * sq * qs + (size_t)h * d;
    bf16* dst = QDs + st * 2 * TILE;
    sm90::stage_rows<BQ, DP, NT>(dst, q + qoff, qs, q0, sq, d);
    sm90::stage_rows<BQ, DP, NT>(dst + TILE, dout + qoff, qs, q0, sq, d);
    const size_t roff = ((size_t)bi * a + h) * sq;
    if (threadIdx.x < 2 * BQ) {  // lse then di, one float a thread
      const int j = threadIdx.x % BQ;
      const float* src = (threadIdx.x < BQ ? lse : di) + roff;
      const bool ok = q0 + j < sq;
      sm90::cp_async<4>(rows_s + st * 2 * BQ + threadIdx.x, ok ? src + q0 + j : src, ok);
    }
  };

  sm90::stage_rows<BKV, DP, NT>(Ks, k + koff, ks, k0, skv, d);
  sm90::stage_rows<BKV, DP, NT>(Vs, v + koff, ks, k0, skv, d);
  if (steps > 0) stage_step(0, 0);
  sm90::cp_async_commit();

  float dk_acc[DC / 2], dv_acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    if (i + 1 < steps) stage_step(i + 1, st ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // step i (and K, V) landed
    sm90::fence_async_smem();
    __syncthreads();
    const int h = hk * g + i / nq, q0 = q_begin + (i % nq) * BQ;
    const bf16* Qs = QDs + st * 2 * TILE;
    const bf16* dOs = Qs + TILE;
    const float* lse_s = rows_s + st * 2 * BQ;
    const float* di_s = lse_s + BQ;

    // S^T = K Q^T, dP^T = V dO^T (kv rows x query columns)
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) s[j] = dp[j] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      sm90::Wgmma<BQ, 0, 0>::ss(s, sm90::desc_k<BKV>(Ks, kk), sm90::desc_k<BQ>(Qs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      sm90::Wgmma<BQ, 0, 0>::ss(dp, sm90::desc_k<BKV>(Vs, kk), sm90::desc_k<BQ>(dOs, kk), kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BQ / 2>(s);
    sm90::fence_regs<BQ / 2>(dp);

    // P^T and dS^T (backward.py:59-62); register j is kv row row + 8 ((j /
    // 2) % 2), query column 8 (j / 4) + col + j % 2
    const bool edge = q0 + BQ > sq || k0 + BKV > skv || (causal && q0 < k0 + BKV - 1);
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];  // P^T, dS^T as A operands
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float p2[2], ds2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * kk + 2 * jj + e;
          const int c = 8 * (j >> 2) + col + (j & 1), r = row + 8 * ((j >> 1) & 1);
          const bool live = !edge || (q0 + c < sq && k0 + r < skv && (!causal || k0 + r <= q0 + c));
          const float p = live ? expf(s[j] * scale - lse_s[c]) : 0.0f;
          p2[e] = p;
          ds2[e] = p * (dp[j] - di_s[c]) * scale;
        }
        pa[kk][jj] = sm90::pack_bf16(p2[0], p2[1]);
        sa[kk][jj] = sm90::pack_bf16(ds2[0], ds2[1]);
      }
    }

    // dV += P^T dO, dK += dS^T Q over this block's columns (backward.py:97-103)
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::WgmmaN<DC>::rs(dv_acc, pa[kk], sm90::desc_mn<BQ>(dOs, kk, c0), BQ * 128, 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::WgmmaN<DC>::rs(dk_acc, sa[kk], sm90::desc_mn<BQ>(Qs, kk, c0), BQ * 128, 1);
    sm90::wgmma_commit();

    // dS^T to shared memory: pa / sa register jj of step kk is (row + 8 (jj
    // % 2), columns 16 kk + 8 (jj / 2) + col, + 1)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<uint32_t*>(
            dSs + sm90::swz_off<BKV>(row + 8 * (jj & 1), 16 * kk + 8 * (jj >> 1) + col)) =
            sa[kk][jj];
    sm90::fence_async_smem();
    __syncthreads();

    // dQ[q0.., c0..] += dS K[:, c0..]: A = dS (MN-major: dS^T's rows are
    // its k axis), B = K (MN-major), 64 columns at a time
    float* dq_rows = dq_acc + (size_t)bi * sq * qs + (size_t)h * d;
#pragma unroll
    for (int n0 = 0; n0 < DC; n0 += 64) {
      constexpr int NC_MAX = DC < 64 ? DC : 64;
      float dq[NC_MAX / 2];
#pragma unroll
      for (int j = 0; j < NC_MAX / 2; ++j) dq[j] = 0.0f;
      sm90::wgmma_fence();
      if (DC - n0 >= 64 || DC < 64) {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          sm90::Wgmma<NC_MAX, 1, 1>::ss(dq, sm90::desc_mn<BKV>(dSs, kk, 0),
                                        sm90::desc_mn<BKV>(Ks, kk, c0 + n0), kk);
      } else {  // the last, narrower piece of a slice wider than 64
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          sm90::Wgmma<(DC % 64 == 0 ? 64 : DC % 64), 1, 1>::ss(
              dq, sm90::desc_mn<BKV>(dSs, kk, 0), sm90::desc_mn<BKV>(Ks, kk, c0 + n0), kk);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<NC_MAX / 2>(dq);
      const int width = DC - n0 < 64 ? DC - n0 : 64;
      if ((d & 3) == 0) {
        // float4 atomics: lanes 2i and 2i + 1 of a quad swap a pair, so the
        // even lane adds columns 8 J + 2 tq .. + 3 of row `row`, the odd one
        // columns 8 J + 2 (tq - 1) .. + 3 of row + 8
        const bool odd = lane & 1;
        const int r = q0 + row + (odd ? 8 : 0);
#pragma unroll
        for (int J = 0; J < NC_MAX / 8; ++J) {
          const float sx = odd ? dq[4 * J] : dq[4 * J + 2], sy = odd ? dq[4 * J + 1] : dq[4 * J + 3];
          const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
          const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
          const int cc = 8 * J + col - (odd ? 2 : 0), c = c0 + n0 + cc;
          const float4 v4 = odd ? make_float4(rx, ry, dq[4 * J + 2], dq[4 * J + 3])
                                : make_float4(dq[4 * J], dq[4 * J + 1], rx, ry);
          if (cc < width && r < sq && c < d)
            atomicAdd(reinterpret_cast<float4*>(dq_rows + (size_t)r * qs + c), v4);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NC_MAX / 2; ++j) {
          const int r = q0 + row + 8 * ((j >> 1) & 1);
          const int cc = 8 * (j >> 2) + col + (j & 1);
          const int c = c0 + n0 + cc;
          if (cc < width && r < sq && c < d) atomicAdd(dq_rows + (size_t)r * qs + c, dq[j]);
        }
      }
    }
    // dV and dK read pa / sa from registers until their wait: keep them
    // (and the accumulators) in place until here
    sm90::fence_regs<BQ / 4>(&pa[0][0]);
    sm90::fence_regs<BQ / 4>(&sa[0][0]);
    sm90::fence_regs<DC / 2>(dk_acc);
    sm90::fence_regs<DC / 2>(dv_acc);
    __syncthreads();  // stage st and dS^T free for the next step
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = k0 + row + 8 * hh;
    if (r >= skv) continue;
    const size_t o = koff + (size_t)r * ks;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int c = c0 + 8 * j + col;
      const float k0v = dk_acc[4 * j + 2 * hh], k1v = dk_acc[4 * j + 2 * hh + 1];
      const float v0v = dv_acc[4 * j + 2 * hh], v1v = dv_acc[4 * j + 2 * hh + 1];
      if ((d & 1) == 0) {
        if (c < d) {
          *reinterpret_cast<uint32_t*>(dk + o + c) = sm90::pack_bf16(k0v, k1v);
          *reinterpret_cast<uint32_t*>(dv + o + c) = sm90::pack_bf16(v0v, v1v);
        }
      } else {
        if (c < d) {
          dk[o + c] = __float2bfloat16_rn(k0v);
          dv[o + c] = __float2bfloat16_rn(v0v);
        }
        if (c + 1 < d) {
          dk[o + c + 1] = __float2bfloat16_rn(k1v);
          dv[o + c + 1] = __float2bfloat16_rn(v1v);
        }
      }
    }
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// The pre-pass: di = rowsum(dO o O) in f32 (backward.py:137-138), (b, a,
// sq), from o and dout in the model layout (b, sq, a, d): one warp a row.
template <typename T>
__global__ void attention_di(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ di, int sq, int a, int d, long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(o[row * d + c]), to_f(dout[row * d + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % a, pos = (row / a) % sq, bi = row / ((long long)a * sq);
    di[(bi * a + h) * sq + pos] = acc;
  }
}

template <typename T>
cudaError_t launch_di(const void* o, const void* dout, float* di, int b, int sq, int a, int d,
                      cudaStream_t s) {
  const long long rows = (long long)b * sq * a, blocks = (rows + 3) / 4;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  attention_di<T><<<(unsigned)blocks, 128, 0, s>>>(static_cast<const T*>(o),
                                                     static_cast<const T*>(dout), di, sq, a, d,
                                                     rows);
  return cudaGetLastError();
}

// dq = dq_acc rounded to bf16.
__global__ void dq_convert(const float* __restrict__ src, bf16* __restrict__ dst, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

template <int DP, int DC>
cudaError_t launch_slice(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                         const float* lse, const float* di, float* dq_acc, bf16* dk, bf16* dv,
                         int b, int sq, int skv, int a, int nkv, int d, int causal, float scale,
                         int c0, cudaStream_t s) {
  constexpr size_t SMEM = BwdSmem<DP>::BYTES;
  auto* kern = flash_bwd_sm90<DP, DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const int nkt = (skv + BKV - 1) / BKV;
  const long long blocks = (long long)nkt * nkv * b;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, NT, SMEM, s>>>(q, k, v, dout, lse, di, dq_acc, dk, dv, sq, skv, a,
                                          nkv, d, causal, scale, nkt, c0);
  return cudaGetLastError();
}

// Up to a padded d of 128 one launch keeps all columns; above it, one
// launch keeps columns [0, 128) and a second [128, DP).
template <int DP>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* di, float* dq_acc, bf16* dk, bf16* dv,
                       int b, int sq, int skv, int a, int nkv, int d, int causal, float scale,
                       cudaStream_t s) {
  if constexpr (DP <= 128) {
    return launch_slice<DP, DP>(q, k, v, dout, lse, di, dq_acc, dk, dv, b, sq, skv, a, nkv, d,
                                causal, scale, 0, s);
  } else {
    cudaError_t err = launch_slice<DP, 128>(q, k, v, dout, lse, di, dq_acc, dk, dv, b, sq, skv,
                                            a, nkv, d, causal, scale, 0, s);
    if (err != cudaSuccess) return err;
    return launch_slice<DP, DP - 128>(q, k, v, dout, lse, di, dq_acc, dk, dv, b, sq, skv, a,
                                      nkv, d, causal, scale, 128, s);
  }
}

cudaError_t bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                     const float* lse, const float* di, bf16* dq, float* dq_acc, bf16* dk,
                     bf16* dv, int b, int sq, int skv, int a, int nkv, int d, int causal,
                     float scale, cudaStream_t s) {
  const size_t n = (size_t)b * sq * a * d;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return err;
  switch (flash::padded_d(d)) {
#define FLASH_BWD_CASE(DP)                                                                      \
  case DP:                                                                                      \
    err = launch_bwd<DP>(q, k, v, dout, lse, di, dq_acc, dk, dv, b, sq, skv, a, nkv, d, causal, \
                         scale, s);                                                             \
    break;
    FLASH_FOR_EACH_DP(FLASH_BWD_CASE)
#undef FLASH_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t blocks = (n + 255) / 256;
  dq_convert<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(dq_acc, dq, n);
  return cudaGetLastError();
}

}  // namespace

// o, dout, dq like q; lse (b, a, sq) f32; di (b, a, sq) f32 scratch, which
// the pre-pass fills; dk, dv like k; dq_acc (bf16 only; may be null for
// f32): b * sq * a * d f32 of scratch.  All contiguous.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* di, void* dq,
                               void* dq_acc, void* dk, void* dv, int b, int sq, int skv, int a,
                               int nkv, int d, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash::shape_ok(b, sq, skv, a, nkv, d)) return (int)cudaErrorInvalidValue;
  float* dif = static_cast<float*>(di);
  if (dtype == DT_BF16) {
    if (dq_acc == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = launch_di<bf16>(o, dout, dif, b, sq, a, d, s);
    if (err != cudaSuccess) return (int)err;
    return (int)bwd_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                         static_cast<const float*>(lse), dif, static_cast<bf16*>(dq),
                         static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
                         static_cast<bf16*>(dv), b, sq, skv, a, nkv, d, causal, scale, s);
  }
  if (dtype == DT_F32) {
    cudaError_t err = launch_di<float>(o, dout, dif, b, sq, a, d, s);
    if (err != cudaSuccess) return (int)err;
    return (int)flash::bwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<const float*>(dout),
                               static_cast<const float*>(lse), dif, static_cast<float*>(dq),
                               static_cast<float*>(dk), static_cast<float*>(dv), b, sq, skv, a,
                               nkv, d, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
