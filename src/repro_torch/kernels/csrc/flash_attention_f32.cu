// flash_attention_f32: the f32 flash-attention forward and backward (a
// check dtype: full-f32 FMA products, no TF32), for the entry points of
// flash_attention.cu and flash_attention_bwd.cu.  Same contract as the bf16
// kernels: q (b, sq, a, d), k / v (b, skv, nkv, d) read in place, GQA,
// causal (top-left) or not, any d <= 256 (padded in shared memory to
// flash_attention.cuh `padded_d`, zeros past d).
//
// Simple first, as it is off the bf16 main path: one block of 4 warps owns
// a 32-row query tile (forward, dq) or a 32-row kv tile (dk/dv) and loops
// over the other axis; tiles past the causal diagonal never run.  Every
// tile, score and accumulator lives in shared memory, and the products are
// plain FMA loops (`SmemMma`): thread t owns rows (t / 16) * M / 8 + i and
// columns t % 16 + 16 j of the output.  dq and dk/dv are two kernels that
// each recompute S and dP; dk/dv sums the g query heads of its kv head in
// its accumulator.  Up to 213 KB of shared memory (dk/dv at padded d 256).
#include <cuda_runtime.h>

#include "flash_attention.cuh"

namespace {

constexpr int NT = 128, NWARPS = NT / 32;
constexpr int BQ = 32, BKV = 32;
constexpr float NEG_INF = -1e30f;

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

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory geometry: leading dims (padded rows) and buffer sizes.
template <int DP> struct FlashSmem {
  static constexpr int LDT = DP + 4;   // q / k / v / do tiles
  static constexpr int LDS = BKV + 4;  // S, dP, P, dS tiles
  static constexpr int LDO = DP + 4;   // o / dq / dk / dv accumulators
  static constexpr size_t Q_T = align128(sizeof(float) * BQ * LDT);
  static constexpr size_t KV_T = align128(sizeof(float) * BKV * LDT);
  static constexpr size_t S_F = align128(sizeof(float) * BQ * LDS);
  static constexpr size_t ACC_Q = align128(sizeof(float) * BQ * LDO);
  static constexpr size_t ACC_KV = align128(sizeof(float) * BKV * LDO);
  static constexpr size_t ROW = align128(sizeof(float) * BQ);
  static constexpr size_t FWD = Q_T + 2 * KV_T + 2 * S_F + ACC_Q;
  static constexpr size_t DQ = 2 * Q_T + 2 * KV_T + 3 * S_F + ACC_Q + 2 * ROW;
  static constexpr size_t DKV = 2 * Q_T + 2 * KV_T + 4 * S_F + 2 * ACC_KV + 2 * ROW;
};

template <typename U> __device__ __forceinline__ U* take(unsigned char*& p, size_t bytes) {
  U* out = reinterpret_cast<U*>(p);
  p += bytes;
  return out;
}

// C (M x N, ldc) = [C +] A (M x K) . B (K x N), all in shared memory.
// A_COL: A(i, kk) at A[kk * lda + i] (a transposed tile); B_COL: B(kk, j)
// at B[j * ldb + kk].
template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC> struct SmemMma {
  static __device__ __forceinline__ void run(float* C, int ldc, const float* A, int lda,
                                             const float* B, int ldb) {
    constexpr int RPT = M / 8, CPT = N / 16;
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = ACC ? C[(tr * RPT + i) * ldc + tc + 16 * j] : 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      float a[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = A_COL ? A[kk * lda + tr * RPT + i] : A[(tr * RPT + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float b = B_COL ? B[(tc + 16 * j) * ldb + kk] : B[kk * ldb + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) C[(tr * RPT + i) * ldc + tc + 16 * j] = acc[i][j];
  }
};

// Stage rows [r0, r0 + ROWS) of a (rows, stride) matrix, d elements each,
// into DP columns: rows >= nrows and columns >= d read as zero.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(float* dst, int lds, const float* __restrict__ src,
                                          size_t stride, int r0, int nrows, int d) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
    const int r = idx / DP, c = idx % DP;
    dst[r * lds + c] = r0 + r < nrows && c < d ? __ldg(src + (size_t)(r0 + r) * stride + c) : 0.0f;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int nrows) {
  for (int r = threadIdx.x; r < ROWS; r += NT) dst[r] = r0 + r < nrows ? src[r0 + r] : 0.0f;
}

__device__ __forceinline__ bool live_at(int qpos, int kpos, int sq, int skv, int causal) {
  return qpos < sq && kpos < skv && (!causal || kpos <= qpos);
}

// grid (ceil(sq / BQ), a, b).  o like q; lse (b, a, sq).
template <int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int sq,
              int skv, int a, int nkv, int d, int causal, float scale) {
  using S = FlashSmem<DP>;
  constexpr int RPW = BQ / NWARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* Qs = take<float>(p, S::Q_T);
  float* Ks = take<float>(p, S::KV_T);
  float* Vs = take<float>(p, S::KV_T);
  float* Ss = take<float>(p, S::S_F);
  float* Ps = take<float>(p, S::S_F);
  float* Os = take<float>(p, S::ACC_Q);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a / nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qs = (size_t)a * d, ks = (size_t)nkv * d;
  const float* qb = q + (size_t)bi * sq * qs + (size_t)h * d;
  const float* kb = k + (size_t)bi * skv * ks + (size_t)hk * d;
  const float* vb = v + (size_t)bi * skv * ks + (size_t)hk * d;

  load_rows<BQ, DP>(Qs, S::LDT, qb, qs, q0, sq, d);
  for (int i = threadIdx.x; i < BQ * DP; i += NT) Os[(i / DP) * S::LDO + i % DP] = 0.0f;
  float m_r[RPW], l_r[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.0f;
  }
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's P and V consumed; q and o staged
    load_rows<BKV, DP>(Ks, S::LDT, kb, ks, k0, skv, d);
    load_rows<BKV, DP>(Vs, S::LDT, vb, ks, k0, skv, d);
    __syncthreads();
    SmemMma<BQ, BKV, DP, false, true, false>::run(Ss, S::LDS, Qs, S::LDT, Ks, S::LDT);
    __syncthreads();
    // online softmax, one warp per row (kernel.py:79-94)
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, qpos = q0 + r;
      const int c = lane;  // BKV == 32: one key per lane
      const float sv = live_at(qpos, k0 + c, sq, skv, causal) ? Ss[r * S::LDS + c] * scale : NEG_INF;
      const float m_new = fmaxf(m_r[rr], warp_max(sv));
      const bool any = m_new > 0.5f * NEG_INF;  // a live key seen so far
      const float alpha = any ? expf(m_r[rr] - m_new) : 1.0f;
      const float pv = sv > 0.5f * NEG_INF ? expf(sv - m_new) : 0.0f;
      Ps[r * S::LDS + c] = pv;
      l_r[rr] = alpha * l_r[rr] + warp_sum(pv);
      m_r[rr] = m_new;
      for (int cc = lane; cc < DP; cc += 32) Os[r * S::LDO + cc] *= alpha;
    }
    __syncthreads();
    SmemMma<BQ, DP, BKV, false, false, true>::run(Os, S::LDO, Ps, S::LDS, Vs, S::LDT);
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr, qpos = q0 + r;
    if (qpos >= sq) continue;
    const float l = l_r[rr];
    const float l_safe = l == 0.0f ? 1.0f : l;  // a row with no live key -> 0
    float* orow = o + ((size_t)bi * sq + qpos) * qs + (size_t)h * d;
    for (int c = lane; c < d; c += 32) orow[c] = Os[r * S::LDO + c] / l_safe;
    if (lane == 0) lse[((size_t)bi * a + h) * sq + qpos] = l == 0.0f ? 0.0f : m_r[rr] + logf(l_safe);
  }
}

// p = exp(s * scale - lse) and dS = p (dP - di) scale for one (q, kv) tile
// pair (backward.py:59-62); P only when wanted.
__device__ __forceinline__ void grad_tile(const float* Ss, const float* dPs, const float* lse_s,
                                          const float* di_s, float* Ps, float* dSs, int ld, int q0,
                                          int k0, int sq, int skv, int causal, float scale) {
  for (int idx = threadIdx.x; idx < BQ * BKV; idx += NT) {
    const int r = idx / BKV, c = idx % BKV;
    const float pv = live_at(q0 + r, k0 + c, sq, skv, causal)
                         ? expf(Ss[r * ld + c] * scale - lse_s[r])
                         : 0.0f;
    if (Ps != nullptr) Ps[r * ld + c] = pv;
    dSs[r * ld + c] = pv * (dPs[r * ld + c] - di_s[r]) * scale;
  }
}

// grid (ceil(sq / BQ), a, b).  lse, di (b, a, sq); dq like q.
template <int DP>
__global__ void __launch_bounds__(NT)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dq,
             int sq, int skv, int a, int nkv, int d, int causal, float scale) {
  using S = FlashSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* Qs = take<float>(p, S::Q_T);
  float* dOs = take<float>(p, S::Q_T);
  float* Ks = take<float>(p, S::KV_T);
  float* Vs = take<float>(p, S::KV_T);
  float* Ss = take<float>(p, S::S_F);
  float* dPs = take<float>(p, S::S_F);
  float* dSs = take<float>(p, S::S_F);
  float* dQs = take<float>(p, S::ACC_Q);
  float* lse_s = take<float>(p, S::ROW);
  float* di_s = take<float>(p, S::ROW);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a / nkv);
  const size_t qs = (size_t)a * d, ks = (size_t)nkv * d;
  const size_t qoff = (size_t)bi * sq * qs + (size_t)h * d;
  const float* kb = k + (size_t)bi * skv * ks + (size_t)hk * d;
  const float* vb = v + (size_t)bi * skv * ks + (size_t)hk * d;
  const size_t row = ((size_t)bi * a + h) * sq;

  load_rows<BQ, DP>(Qs, S::LDT, q + qoff, qs, q0, sq, d);
  load_rows<BQ, DP>(dOs, S::LDT, dout + qoff, qs, q0, sq, d);
  load_vec<BQ>(lse_s, lse + row, q0, sq);
  load_vec<BQ>(di_s, di + row, q0, sq);
  for (int i = threadIdx.x; i < BQ * DP; i += NT) dQs[(i / DP) * S::LDO + i % DP] = 0.0f;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();
    load_rows<BKV, DP>(Ks, S::LDT, kb, ks, k0, skv, d);
    load_rows<BKV, DP>(Vs, S::LDT, vb, ks, k0, skv, d);
    __syncthreads();
    SmemMma<BQ, BKV, DP, false, true, false>::run(Ss, S::LDS, Qs, S::LDT, Ks, S::LDT);
    SmemMma<BQ, BKV, DP, false, true, false>::run(dPs, S::LDS, dOs, S::LDT, Vs, S::LDT);
    __syncthreads();
    grad_tile(Ss, dPs, lse_s, di_s, nullptr, dSs, S::LDS, q0, k0, sq, skv, causal, scale);
    __syncthreads();
    SmemMma<BQ, DP, BKV, false, false, true>::run(dQs, S::LDO, dSs, S::LDS, Ks, S::LDT);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    if (q0 + r < sq && c < d) dq[qoff + (size_t)(q0 + r) * qs + c] = dQs[r * S::LDO + c];
  }
}

// grid (ceil(skv / BKV), nkv, b): the block owns one kv head's tile and
// walks the g query heads of its group and their query tiles.  dk, dv like k.
template <int DP>
__global__ void __launch_bounds__(NT)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dk,
              float* __restrict__ dv, int sq, int skv, int a, int nkv, int d, int causal,
              float scale) {
  using S = FlashSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* Qs = take<float>(p, S::Q_T);
  float* dOs = take<float>(p, S::Q_T);
  float* Ks = take<float>(p, S::KV_T);
  float* Vs = take<float>(p, S::KV_T);
  float* Ss = take<float>(p, S::S_F);
  float* dPs = take<float>(p, S::S_F);
  float* Ps = take<float>(p, S::S_F);
  float* dSs = take<float>(p, S::S_F);
  float* dKs = take<float>(p, S::ACC_KV);
  float* dVs = take<float>(p, S::ACC_KV);
  float* lse_s = take<float>(p, S::ROW);
  float* di_s = take<float>(p, S::ROW);

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, bi = blockIdx.z;
  const int g = a / nkv;
  const size_t qs = (size_t)a * d, ks = (size_t)nkv * d;
  const size_t koff = (size_t)bi * skv * ks + (size_t)hk * d;

  load_rows<BKV, DP>(Ks, S::LDT, k + koff, ks, k0, skv, d);
  load_rows<BKV, DP>(Vs, S::LDT, v + koff, ks, k0, skv, d);
  for (int i = threadIdx.x; i < BKV * DP; i += NT) {
    dKs[(i / DP) * S::LDO + i % DP] = 0.0f;
    dVs[(i / DP) * S::LDO + i % DP] = 0.0f;
  }
  // causal: query tiles whose last row lies before k0 see none of this tile
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    const size_t qoff = (size_t)bi * sq * qs + (size_t)h * d;
    const size_t row = ((size_t)bi * a + h) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += BQ) {
      __syncthreads();  // the previous tile's products done
      load_rows<BQ, DP>(Qs, S::LDT, q + qoff, qs, q0, sq, d);
      load_rows<BQ, DP>(dOs, S::LDT, dout + qoff, qs, q0, sq, d);
      load_vec<BQ>(lse_s, lse + row, q0, sq);
      load_vec<BQ>(di_s, di + row, q0, sq);
      __syncthreads();
      SmemMma<BQ, BKV, DP, false, true, false>::run(Ss, S::LDS, Qs, S::LDT, Ks, S::LDT);
      SmemMma<BQ, BKV, DP, false, true, false>::run(dPs, S::LDS, dOs, S::LDT, Vs, S::LDT);
      __syncthreads();
      grad_tile(Ss, dPs, lse_s, di_s, Ps, dSs, S::LDS, q0, k0, sq, skv, causal, scale);
      __syncthreads();
      // dV += P^T . dO and dK += dS^T . Q (backward.py:97-103)
      SmemMma<BKV, DP, BQ, true, false, true>::run(dVs, S::LDO, Ps, S::LDS, dOs, S::LDT);
      SmemMma<BKV, DP, BQ, true, false, true>::run(dKs, S::LDO, dSs, S::LDS, Qs, S::LDT);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BKV * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    if (k0 + r < skv && c < d) {
      const size_t o = koff + (size_t)(k0 + r) * ks + c;
      dk[o] = dKs[r * S::LDO + c];
      dv[o] = dVs[r * S::LDO + c];
    }
  }
}

template <typename K> cudaError_t allow_smem(K* kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int b,
                       int sq, int skv, int a, int nkv, int d, int causal, float scale,
                       cudaStream_t s) {
  using S = FlashSmem<DP>;
  auto* kern = flash_fwd_f32<DP>;
  cudaError_t err = allow_smem(kern, S::FWD);
  if (err != cudaSuccess) return err;
  kern<<<dim3((sq + BQ - 1) / BQ, a, b), NT, S::FWD, s>>>(q, k, v, o, lse, sq, skv, a, nkv, d,
                                                          causal, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* di, float* dq, float* dk, float* dv, int b,
                       int sq, int skv, int a, int nkv, int d, int causal, float scale,
                       cudaStream_t s) {
  using S = FlashSmem<DP>;
  auto* kdq = flash_dq_f32<DP>;
  auto* kdkv = flash_dkv_f32<DP>;
  cudaError_t err = allow_smem(kdq, S::DQ);
  if (err == cudaSuccess) err = allow_smem(kdkv, S::DKV);
  if (err != cudaSuccess) return err;
  kdq<<<dim3((sq + BQ - 1) / BQ, a, b), NT, S::DQ, s>>>(q, k, v, dout, lse, di, dq, sq, skv, a,
                                                        nkv, d, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<dim3((skv + BKV - 1) / BKV, nkv, b), NT, S::DKV, s>>>(q, k, v, dout, lse, di, dk, dv, sq,
                                                               skv, a, nkv, d, causal, scale);
  return cudaGetLastError();
}

}  // namespace

namespace flash {

cudaError_t fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse, int b,
                    int sq, int skv, int a, int nkv, int d, int causal, float scale,
                    cudaStream_t s) {
  switch (padded_d(d)) {
#define FLASH_F32_FWD(DP) \
  case DP: return launch_fwd<DP>(q, k, v, o, lse, b, sq, skv, a, nkv, d, causal, scale, s);
    FLASH_FOR_EACH_DP(FLASH_F32_FWD)
#undef FLASH_F32_FWD
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* di, float* dq, float* dk, float* dv, int b,
                    int sq, int skv, int a, int nkv, int d, int causal, float scale,
                    cudaStream_t s) {
  switch (padded_d(d)) {
#define FLASH_F32_BWD(DP)                                                                    \
  case DP:                                                                                   \
    return launch_bwd<DP>(q, k, v, dout, lse, di, dq, dk, dv, b, sq, skv, a, nkv, d, causal, \
                          scale, s);
    FLASH_FOR_EACH_DP(FLASH_F32_BWD)
#undef FLASH_F32_BWD
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
