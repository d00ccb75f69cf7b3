// flash_attention: FlashAttention-2 forward (output and per-row logsumexp)
// and backward (dq; dk and dv), GQA, causal or not, over the model layout
// q (b, sq, a, d), k / v (b, skv, nkv, d) read in place.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
// `flash_attention_pallas` (`_flash_kernel`) and backward.py
// `flash_attention_bwd_pallas` (`_dq_kernel`, `_dkv_kernel`): attention of
// every layer under attn_impl = "flash" on the training path.
//
// What bounds it on the H100: operations.  At the training slice's shape
// (b 4, s 1024, 16 query / 8 kv heads, d 128, causal) the forward is
// 4*b*a*s^2*d/2 = 17 GFLOP over 42 MB of q, k, v and o (~400 FLOP/byte),
// the backward 2.5x the FLOPs over ~2x the bytes.
//
// What the design does about it, and what differs from the TPU kernels:
//   * one block of 4 warps owns a 64-row query tile (forward, dq) or a
//     64-row kv tile (dk/dv) and loops over the other axis inside the
//     block (the TPU's sequential grid axis); tiles above the causal
//     diagonal are never visited (the loop bound, not a per-tile skip);
//   * products run on the tensor cores through WMMA with f32 accumulators,
//     and the score tile S = q.k^T goes through shared memory: a WMMA
//     accumulator has no documented element layout, and the online softmax
//     needs whole rows.  The output accumulator lives in shared memory too,
//     so each row is rescaled in place.  P (forward, dk/dv) and dS (dq,
//     dk) round to the input dtype before their products, as FA2 does;
//     kernels/tolerance.py charges that rounding;
//   * the tiles (q, k, v, do, S, P, dS and the f32 accumulators) pass 48 KB,
//     so the kernels take dynamic shared memory (up to 187 KB for dk/dv at
//     d = 128) after cudaFuncSetAttribute;
//   * dk/dv: the TPU kernel emits dk and dv per query head and ops.py sums
//     the g heads of a group afterwards (ops.py:108-113).  Here the block
//     owns one kv head's tile and loops over the g query heads of its group,
//     so the group sum happens in the accumulator: no (g*skv*d) temporary,
//     no atomics;
//   * the causal mask is top-left (kv_pos <= q_pos), as the Pallas kernel's
//     (kernel.py:42-45); columns >= skv are masked (the ragged edge), rows
//     >= sq are not written.  A row with no live key gets output 0 and
//     lse 0 (kernel.py:101-112).
// bf16 takes 64-row tiles; f32 (full-f32 FMA products, no TF32) 32-row
// tiles, so its larger elements fit the same shared memory.  Simple first:
// no TMA, no wgmma, one block per SM for dk/dv.
#include "gemm_tile.cuh"

using namespace repro;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = NTHREADS / 32;

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

template <typename T> struct FlashTile;
template <> struct FlashTile<__nv_bfloat16> { static constexpr int BQ = 64, BKV = 64; };
template <> struct FlashTile<float> { static constexpr int BQ = 32, BKV = 32; };

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory geometry: leading dims (padded rows) and buffer sizes.
template <typename T, int D> struct FlashSmem {
  static constexpr int BQ = FlashTile<T>::BQ, BKV = FlashTile<T>::BKV;
  static constexpr int LDT = D + Pad<T>::v;    // q / k / v / do tiles (T)
  static constexpr int LDS = BKV + 4;          // S, dP tiles (f32)
  static constexpr int LDP = BKV + Pad<T>::v;  // P, dS tiles (T)
  static constexpr int LDO = D + 4;            // o / dq / dk / dv accumulators (f32)
  static constexpr size_t Q_T = align128(sizeof(T) * BQ * LDT);
  static constexpr size_t KV_T = align128(sizeof(T) * BKV * LDT);
  static constexpr size_t S_F = align128(sizeof(float) * BQ * LDS);
  static constexpr size_t P_T = align128(sizeof(T) * BQ * LDP);
  static constexpr size_t ACC_Q = align128(sizeof(float) * BQ * LDO);
  static constexpr size_t ACC_KV = align128(sizeof(float) * BKV * LDO);
  static constexpr size_t ROW = align128(sizeof(float) * BQ);
  static constexpr size_t FWD = Q_T + 2 * KV_T + S_F + P_T + ACC_Q;
  static constexpr size_t DQ = 2 * Q_T + 2 * KV_T + 2 * S_F + P_T + ACC_Q + 2 * ROW;
  static constexpr size_t DKV = 2 * Q_T + 2 * KV_T + 2 * S_F + 2 * P_T + 2 * ACC_KV + 2 * ROW;
};

template <typename U> __device__ __forceinline__ U* take(unsigned char*& p, size_t bytes) {
  U* out = reinterpret_cast<U*>(p);
  p += bytes;
  return out;
}

// C (M x N, f32, ldc) = [C +] A (M x K) . B (K x N), all in shared memory.
// A_COL: A(i, kk) at A[kk * lda + i] (a transposed tile); B_COL: B(kk, j)
// at B[j * ldb + kk].
template <typename T, int M, int N, int K, bool A_COL, bool B_COL, bool ACC> struct SmemMma;

template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
struct SmemMma<__nv_bfloat16, M, N, K, A_COL, B_COL, ACC> {
  static __device__ __forceinline__ void run(float* C, int ldc, const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B, int ldb) {
    using namespace nvcuda;
    using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    constexpr int TN = N / 16, TILES = (M / 16) * TN;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < TILES; t += NWARPS) {
      const int i = t / TN, j = t % TN;
      float* cp = C + i * 16 * ldc + j * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC)
        wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
        wmma::load_matrix_sync(a, A_COL ? A + kk * lda + i * 16 : A + i * 16 * lda + kk, lda);
        wmma::load_matrix_sync(b, B_COL ? B + j * 16 * ldb + kk : B + kk * ldb + j * 16, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    }
  }
};

// f32: thread t owns rows (t/16)*RPT + i and columns t%16 + 16*j.
template <int M, int N, int K, bool A_COL, bool B_COL, bool ACC>
struct SmemMma<float, M, N, K, A_COL, B_COL, ACC> {
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

// Stage rows [r0, r0 + ROWS) of a (rows, stride) matrix, D contiguous
// elements each, with 16-byte loads; rows >= nrows read as zero.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(T* dst, int lds, const T* __restrict__ src,
                                          size_t stride, int r0, int nrows) {
  constexpr int CH = 16 / sizeof(T), CPR = D / CH;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = (idx % CPR) * CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + c));
    *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int nrows) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) dst[r] = r0 + r < nrows ? src[r0 + r] : 0.0f;
}

__device__ __forceinline__ bool live_at(int qpos, int kpos, int sq, int skv, int causal) {
  return qpos < sq && kpos < skv && (!causal || kpos <= qpos);
}

// grid (ceil(sq / BQ), a, b).  o like q; lse (b, a, sq) f32.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int a, int nkv,
                 int causal, float scale) {
  using S = FlashSmem<T, D>;
  constexpr int BQ = S::BQ, BKV = S::BKV, RPW = BQ / NWARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* Qs = take<T>(p, S::Q_T);
  T* Ks = take<T>(p, S::KV_T);
  T* Vs = take<T>(p, S::KV_T);
  float* Ss = take<float>(p, S::S_F);
  T* Ps = take<T>(p, S::P_T);
  float* Os = take<float>(p, S::ACC_Q);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a / nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qs = (size_t)a * D, ks = (size_t)nkv * D;
  const T* qb = q + (size_t)bi * sq * qs + (size_t)h * D;
  const T* kb = k + (size_t)bi * skv * ks + (size_t)hk * D;
  const T* vb = v + (size_t)bi * skv * ks + (size_t)hk * D;

  load_rows<T, BQ, D>(Qs, S::LDT, qb, qs, q0, sq);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) Os[(i / D) * S::LDO + i % D] = 0.0f;
  float m_r[RPW], l_r[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.0f;
  }
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;  // tiles past the diagonal never run
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's P and V consumed; q and o staged
    load_rows<T, BKV, D>(Ks, S::LDT, kb, ks, k0, skv);
    load_rows<T, BKV, D>(Vs, S::LDT, vb, ks, k0, skv);
    __syncthreads();
    SmemMma<T, BQ, BKV, D, false, true, false>::run(Ss, S::LDS, Qs, S::LDT, Ks, S::LDT);
    __syncthreads();
    // online softmax, one warp per row (kernel.py:79-94)
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, qpos = q0 + r;
      float sv[BKV / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int cc = 0; cc < BKV / 32; ++cc) {
        const int c = lane + 32 * cc;
        sv[cc] = live_at(qpos, k0 + c, sq, skv, causal) ? Ss[r * S::LDS + c] * scale : NEG_INF;
        mx = fmaxf(mx, sv[cc]);
      }
      const float m_new = fmaxf(m_r[rr], warp_max(mx));
      const bool any = m_new > 0.5f * NEG_INF;  // a live key seen so far
      const float alpha = any ? expf(m_r[rr] - m_new) : 1.0f;
      float sum = 0.0f;
#pragma unroll
      for (int cc = 0; cc < BKV / 32; ++cc) {
        const float pv = sv[cc] > 0.5f * NEG_INF ? expf(sv[cc] - m_new) : 0.0f;
        Ps[r * S::LDP + lane + 32 * cc] = from_f<T>(pv);
        sum += pv;
      }
      l_r[rr] = alpha * l_r[rr] + warp_sum(sum);
      m_r[rr] = m_new;
      for (int c = lane; c < D; c += 32) Os[r * S::LDO + c] *= alpha;
    }
    __syncthreads();
    SmemMma<T, BQ, D, BKV, false, false, true>::run(Os, S::LDO, Ps, S::LDP, Vs, S::LDT);
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr, qpos = q0 + r;
    if (qpos >= sq) continue;
    const float l = l_r[rr];
    const float l_safe = l == 0.0f ? 1.0f : l;  // a row with no live key -> 0
    T* orow = o + ((size_t)bi * sq + qpos) * qs + (size_t)h * D;
    for (int c = lane; c < D; c += 32) orow[c] = from_f<T>(Os[r * S::LDO + c] / l_safe);
    if (lane == 0) lse[((size_t)bi * a + h) * sq + qpos] = l == 0.0f ? 0.0f : m_r[rr] + logf(l_safe);
  }
}

// p = exp(s * scale - lse) and dS = p (dP - di) scale for one (q, kv) tile
// pair: P (when wanted) and dS in the input dtype (backward.py:59-62).
template <typename T, int D>
__device__ __forceinline__ void grad_tile(const float* Ss, const float* dPs, const float* lse_s,
                                          const float* di_s, T* Ps, T* dSs, int q0, int k0, int sq,
                                          int skv, int causal, float scale) {
  using S = FlashSmem<T, D>;
  for (int idx = threadIdx.x; idx < S::BQ * S::BKV; idx += NTHREADS) {
    const int r = idx / S::BKV, c = idx % S::BKV;
    const float pv = live_at(q0 + r, k0 + c, sq, skv, causal)
                         ? expf(Ss[r * S::LDS + c] * scale - lse_s[r])
                         : 0.0f;
    if (Ps != nullptr) Ps[r * S::LDP + c] = from_f<T>(pv);
    dSs[r * S::LDP + c] = from_f<T>(pv * (dPs[r * S::LDS + c] - di_s[r]) * scale);
  }
}

// grid (ceil(sq / BQ), a, b).  lse, di (b, a, sq) f32; dq like q.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ di, T* __restrict__ dq, int sq, int skv, int a, int nkv,
                int causal, float scale) {
  using S = FlashSmem<T, D>;
  constexpr int BQ = S::BQ, BKV = S::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* Qs = take<T>(p, S::Q_T);
  T* dOs = take<T>(p, S::Q_T);
  T* Ks = take<T>(p, S::KV_T);
  T* Vs = take<T>(p, S::KV_T);
  float* Ss = take<float>(p, S::S_F);
  float* dPs = take<float>(p, S::S_F);
  T* dSs = take<T>(p, S::P_T);
  float* dQs = take<float>(p, S::ACC_Q);
  float* lse_s = take<float>(p, S::ROW);
  float* di_s = take<float>(p, S::ROW);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a / nkv);
  const size_t qs = (size_t)a * D, ks = (size_t)nkv * D;
  const size_t qoff = (size_t)bi * sq * qs + (size_t)h * D;
  const T* kb = k + (size_t)bi * skv * ks + (size_t)hk * D;
  const T* vb = v + (size_t)bi * skv * ks + (size_t)hk * D;
  const size_t row = ((size_t)bi * a + h) * sq;

  load_rows<T, BQ, D>(Qs, S::LDT, q + qoff, qs, q0, sq);
  load_rows<T, BQ, D>(dOs, S::LDT, dout + qoff, qs, q0, sq);
  load_vec<BQ>(lse_s, lse + row, q0, sq);
  load_vec<BQ>(di_s, di + row, q0, sq);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) dQs[(i / D) * S::LDO + i % D] = 0.0f;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();
    load_rows<T, BKV, D>(Ks, S::LDT, kb, ks, k0, skv);
    load_rows<T, BKV, D>(Vs, S::LDT, vb, ks, k0, skv);
    __syncthreads();
    SmemMma<T, BQ, BKV, D, false, true, false>::run(Ss, S::LDS, Qs, S::LDT, Ks, S::LDT);
    SmemMma<T, BQ, BKV, D, false, true, false>::run(dPs, S::LDS, dOs, S::LDT, Vs, S::LDT);
    __syncthreads();
    grad_tile<T, D>(Ss, dPs, lse_s, di_s, static_cast<T*>(nullptr), dSs, q0, k0, sq, skv, causal,
                    scale);
    __syncthreads();
    SmemMma<T, BQ, D, BKV, false, false, true>::run(dQs, S::LDO, dSs, S::LDP, Ks, S::LDT);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < sq) dq[qoff + (size_t)(q0 + r) * qs + c] = from_f<T>(dQs[r * S::LDO + c]);
  }
}

// grid (ceil(skv / BKV), nkv, b): the block owns one kv head's tile and
// walks the g query heads of its group and their query tiles.  dk, dv like k.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int sq,
                 int skv, int a, int nkv, int causal, float scale) {
  using S = FlashSmem<T, D>;
  constexpr int BQ = S::BQ, BKV = S::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* Qs = take<T>(p, S::Q_T);
  T* dOs = take<T>(p, S::Q_T);
  T* Ks = take<T>(p, S::KV_T);
  T* Vs = take<T>(p, S::KV_T);
  float* Ss = take<float>(p, S::S_F);
  float* dPs = take<float>(p, S::S_F);
  T* Ps = take<T>(p, S::P_T);
  T* dSs = take<T>(p, S::P_T);
  float* dKs = take<float>(p, S::ACC_KV);
  float* dVs = take<float>(p, S::ACC_KV);
  float* lse_s = take<float>(p, S::ROW);
  float* di_s = take<float>(p, S::ROW);

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, bi = blockIdx.z;
  const int g = a / nkv;
  const size_t qs = (size_t)a * D, ks = (size_t)nkv * D;
  const size_t koff = (size_t)bi * skv * ks + (size_t)hk * D;

  load_rows<T, BKV, D>(Ks, S::LDT, k + koff, ks, k0, skv);
  load_rows<T, BKV, D>(Vs, S::LDT, v + koff, ks, k0, skv);
  for (int i = threadIdx.x; i < BKV * D; i += NTHREADS) {
    dKs[(i / D) * S::LDO + i % D] = 0.0f;
    dVs[(i / D) * S::LDO + i % D] = 0.0f;
  }
  // causal: query tiles whose last row lies before k0 see none of this tile
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    const size_t qoff = (size_t)bi * sq * qs + (size_t)h * D;
    const size_t row = ((size_t)bi * a + h) * sq;
    for (int q0 = q_begin; q0 < sq; q0 += BQ) {
      __syncthreads();  // the previous tile's products done
      load_rows<T, BQ, D>(Qs, S::LDT, q + qoff, qs, q0, sq);
      load_rows<T, BQ, D>(dOs, S::LDT, dout + qoff, qs, q0, sq);
      load_vec<BQ>(lse_s, lse + row, q0, sq);
      load_vec<BQ>(di_s, di + row, q0, sq);
      __syncthreads();
      SmemMma<T, BQ, BKV, D, false, true, false>::run(Ss, S::LDS, Qs, S::LDT, Ks, S::LDT);
      SmemMma<T, BQ, BKV, D, false, true, false>::run(dPs, S::LDS, dOs, S::LDT, Vs, S::LDT);
      __syncthreads();
      grad_tile<T, D>(Ss, dPs, lse_s, di_s, Ps, dSs, q0, k0, sq, skv, causal, scale);
      __syncthreads();
      // dV += P^T . dO and dK += dS^T . Q (backward.py:97-103)
      SmemMma<T, BKV, D, BQ, true, false, true>::run(dVs, S::LDO, Ps, S::LDP, dOs, S::LDT);
      SmemMma<T, BKV, D, BQ, true, false, true>::run(dKs, S::LDO, dSs, S::LDP, Qs, S::LDT);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BKV * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (k0 + r < skv) {
      const size_t o = koff + (size_t)(k0 + r) * ks + c;
      dk[o] = from_f<T>(dKs[r * S::LDO + c]);
      dv[o] = from_f<T>(dVs[r * S::LDO + c]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K* kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                       int sq, int skv, int a, int nkv, int causal, float scale, cudaStream_t s) {
  using S = FlashSmem<T, D>;
  auto* kern = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, S::FWD);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + S::BQ - 1) / S::BQ, a, b);
  kern<<<grid, NTHREADS, S::FWD, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o),
                                      static_cast<float*>(lse), sq, skv, a, nkv, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* dq, void* dk, void* dv, int b,
                       int sq, int skv, int a, int nkv, int causal, float scale, cudaStream_t s) {
  using S = FlashSmem<T, D>;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dip = static_cast<const float*>(di);
  auto* kdq = flash_dq_kernel<T, D>;
  auto* kdkv = flash_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kdq, S::DQ);
  if (err == cudaSuccess) err = allow_smem(kdkv, S::DKV);
  if (err != cudaSuccess) return err;
  dim3 gq((sq + S::BQ - 1) / S::BQ, a, b);
  kdq<<<gq, NTHREADS, S::DQ, s>>>(qp, kp, vp, dop, lp, dip, static_cast<T*>(dq), sq, skv, a, nkv,
                                  causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv((skv + S::BKV - 1) / S::BKV, nkv, b);
  kdkv<<<gkv, NTHREADS, S::DKV, s>>>(qp, kp, vp, dop, lp, dip, static_cast<T*>(dk),
                                     static_cast<T*>(dv), sq, skv, a, nkv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_by_d(int d, const void* q, const void* k, const void* v, void* o, void* lse, int b,
                     int sq, int skv, int a, int nkv, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_fwd<T, 16>(q, k, v, o, lse, b, sq, skv, a, nkv, causal, scale, s);
    case 32: return launch_fwd<T, 32>(q, k, v, o, lse, b, sq, skv, a, nkv, causal, scale, s);
    case 64: return launch_fwd<T, 64>(q, k, v, o, lse, b, sq, skv, a, nkv, causal, scale, s);
    case 128: return launch_fwd<T, 128>(q, k, v, o, lse, b, sq, skv, a, nkv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_by_d(int d, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dq, void* dk, void* dv, int b, int sq,
                     int skv, int a, int nkv, int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, dout, lse, di, dq, dk, dv, b, sq, skv, a, nkv, causal,
                               scale, s);
    case 32:
      return launch_bwd<T, 32>(q, k, v, dout, lse, di, dq, dk, dv, b, sq, skv, a, nkv, causal,
                               scale, s);
    case 64:
      return launch_bwd<T, 64>(q, k, v, dout, lse, di, dq, dk, dv, b, sq, skv, a, nkv, causal,
                               scale, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, dout, lse, di, dq, dk, dv, b, sq, skv, a, nkv, causal,
                                scale, s);
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(int b, int sq, int skv, int a, int nkv) {
  return b > 0 && sq > 0 && skv > 0 && nkv > 0 && a % nkv == 0;
}

}  // namespace

// q (b, sq, a, d), k / v (b, skv, nkv, d), o like q: contiguous, 16-byte
// aligned.  lse (b, a, sq) f32.  d in {16, 32, 64, 128}.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int b, int sq, int skv, int a, int nkv, int d, int causal,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, sq, skv, a, nkv)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)fwd_by_d<__nv_bfloat16>(d, q, k, v, o, lse, b, sq, skv, a, nkv, causal, scale, s);
  if (dtype == DT_F32)
    return (int)fwd_by_d<float>(d, q, k, v, o, lse, b, sq, skv, a, nkv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dout like q; lse, di (b, a, sq) f32; dq like q; dk, dv like k.  Launches
// the dq kernel, then the dk/dv kernel, on one stream.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dq, void* dk, void* dv,
                               int b, int sq, int skv, int a, int nkv, int d, int causal,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, sq, skv, a, nkv)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)bwd_by_d<__nv_bfloat16>(d, q, k, v, dout, lse, di, dq, dk, dv, b, sq, skv, a, nkv,
                                        causal, scale, s);
  if (dtype == DT_F32)
    return (int)bwd_by_d<float>(d, q, k, v, dout, lse, di, dq, dk, dv, b, sq, skv, a, nkv, causal,
                                scale, s);
  return (int)cudaErrorInvalidValue;
}
