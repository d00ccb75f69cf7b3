// The bf16 GEMM mainloop for Hopper (sm_90a), behind the tile GEMM
// (matmul.cu: the forward, the dgrad and wgrad on transposed views, the
// dgrad pair), the fused MLP forward (fused_mlp.cu) and the fused-MLP
// backward's recompute (fused_mlp_bwd.cu).  Their f32 branches stay on
// gemm_tile.cuh's FMA path.
//
// A block owns a TM x TN output tile: TM = 128 rows for two consumer
// warpgroups of 64 rows each, TM = 64 for one (decode and prefill rows of
// at most 64).  It walks k in steps of GEMM_BK = 64 columns, one 128-byte
// swizzle atom (sm90.cuh).  Each step's A tile and B tile(s) are copied
// with cp.async (16-byte chunks, zero fill past the ragged edge; plain
// element copies where a row is not whole 16-byte chunks) into a ring of
// GEMM_STAGES = 4 slots in dynamic shared memory, GEMM_AHEAD = 2 steps
// ahead of the step being multiplied.  Each warpgroup multiplies with
// `wgmma.mma_async`, both operands in shared memory, one m64nTNk16
// instruction per B operand and k16 step, and keeps one group in flight
// (wgmma_wait<1>) while the next steps land.  All threads copy and
// multiply; there is no producer warp.
//
// Ring: step t lives in slot t % 4.  At step t every thread waits for its
// own copies of step t, fences them into the async proxy and meets the
// others at one barrier; then it issues the copies of step t + 2 into slot
// (t + 2) % 4, which step t - 2 used last: every thread passed
// wgmma_wait<1> at step t - 1 (so its warpgroup finished step t - 2) before
// that barrier.  Then it issues step t's products.  Deeper rings bought
// nothing on the card: six slots (four steps ahead) ran the dgrad within
// 2% and made ptxas serialize the products of every instantiation with an
// MN-major B (C7515); refilling step t - 1's slot three steps ahead, behind
// a second barrier, serialized most of them and ran 4-14% slower.
//
// Layouts, carried by the descriptors so that no operand is copied to
// transpose it: A (m, k) row-major is a K-major tile (TM rows x 64), its
// transpose At (k, m) (TA, the wgrad's x^T) an MN-major one (64 rows x TM
// columns); B (k, n) row-major is MN-major (64 rows x TN), its transpose
// Bt (n, k) (TB, the dgrad's w^T) K-major (TN rows x 64).  PAIRS = 2 runs
// the steps of A1 . B1 after those of A . B0 through the same ring into the
// same accumulators (the fused-MLP backward's dx = dg.Wg^T + du.Wu^T).
// NB = 2 (the gated MLP) stages two B tiles per step, x once for both, and
// keeps two accumulator sets in the same threads.
//
// Epilogue, straight from the accumulator registers (layout at the head of
// sm90.cuh: a thread holds two rows, and two adjacent columns in each
// 8-column block): the bf16 store masked at the edge, or the f32 split-k
// partial (splitk_reduce_kernel sums them), or the activation
// (silu(g) u, gelu_tanh, relu2), or, for the backward, dh read at the same
// (row, column) and dg, du written.
#pragma once

#include "gemm_tile.cuh"
#include "sm90.cuh"

namespace repro {

constexpr int GEMM_BK = 64;                  // k per step: one 128-byte swizzle atom
constexpr int GEMM_STAGES = 4;               // ring slots
constexpr int GEMM_AHEAD = GEMM_STAGES - 2;  // steps copied ahead of the one multiplied

// One launch's operands.  Every matrix is row-major with its row length as
// its leading dimension.
struct GemmArgs {
  const __nv_bfloat16* a;   // A (m, k), or At (k, m) when TA
  const __nv_bfloat16* a1;  // the second pair's A (PAIRS = 2)
  const __nv_bfloat16* b0;  // B (k, n), or Bt (n, k) when TB; the gate when NB = 2
  const __nv_bfloat16* b1;  // the up projection (NB = 2), or the second pair's B
  __nv_bfloat16* c;         // C (m, n)
  float* work;              // split-k partials (splits, m, n)
  const __nv_bfloat16* dh;  // backward: dh (m, n)
  __nv_bfloat16* dg;        // backward: dg (m, n), gated only
  __nv_bfloat16* du;        // backward: du (m, n)
  int m, n, k, k_split;
  int vec;  // every base 16-byte aligned, every row length a multiple of 8
};

template <int TM, int TN, int NB> struct GemmSmem {
  static constexpr int A_ELEMS = TM * GEMM_BK;
  static constexpr int B_ELEMS = GEMM_BK * TN;
  static constexpr int STAGE_ELEMS = A_ELEMS + NB * B_ELEMS;
  // the ring, and room to align it to 1024 bytes (the swizzle's period)
  static constexpr int BYTES = GEMM_STAGES * STAGE_ELEMS * 2 + 1024;
};

// Stage rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix
// (row length `stride`, valid extent nrows x ncols) into a swizzled tile of
// R rows and C columns (whole 64-column atoms); the rest is zero.
template <int R, int C, int NT>
__device__ __forceinline__ void gemm_stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int stride, int r0, int nrows, int c0, int ncols,
                                           int vec) {
  if (vec) {
    sm90::stage_chunks<R, C, 16, NT>(dst, src + c0, (size_t)stride, r0, nrows, ncols - c0);
  } else {
    for (int i = threadIdx.x; i < R * C; i += NT) {
      const int r = i / C, c = i % C;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      dst[sm90::swz_off<R>(r, c)] =
          ok ? src[(size_t)(r0 + r) * stride + c0 + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// The ring over nk steps (its argument at the head of this file), shared
// by the bf16 and the int8 mainloops (gemm_sm90_s8.cuh): load(slot, t)
// issues step t's copies into ring slot `slot`, mma(slot) the products of
// the step held there.  Returns with every copy and product complete.
template <typename Load, typename Mma>
__device__ __forceinline__ void ring_mainloop(int nk, Load&& load, Mma&& mma) {
#pragma unroll
  for (int s = 0; s < GEMM_AHEAD; ++s) {
    if (s < nk) load(s, s);
    sm90::cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    sm90::cp_async_wait<GEMM_AHEAD - 1>();  // this thread's copies of step t landed
    sm90::fence_async_smem();
    __syncthreads();
    const int next = t + GEMM_AHEAD;
    if (next < nk) load(next % GEMM_STAGES, next);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    mma(t % GEMM_STAGES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
  }
  sm90::wgmma_wait<0>();
  sm90::cp_async_wait<0>();
}

template <int TM, int TN, int NB, bool TA, bool TB, int PAIRS> struct GemmMainloop {
  static constexpr int NT = TM / 64 * 128;
  using S = GemmSmem<TM, TN, NB>;

  // Copy step t (pair t / nkp, k columns from k0 + (t % nkp) * 64) into a slot.
  static __device__ __forceinline__ void load(__nv_bfloat16* slot, const GemmArgs& g, int t,
                                              int nkp, int k0, int k1, int row0, int col0) {
    const int p = PAIRS == 2 && t >= nkp;
    const int kt = k0 + (t - p * nkp) * GEMM_BK;
    const __nv_bfloat16* A = p ? g.a1 : g.a;
    if (TA)
      gemm_stage<GEMM_BK, TM, NT>(slot, A, g.m, kt, k1, row0, g.m, g.vec);
    else
      gemm_stage<TM, GEMM_BK, NT>(slot, A, g.k, row0, g.m, kt, k1, g.vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const __nv_bfloat16* B = (nb + p) ? g.b1 : g.b0;
      __nv_bfloat16* Bs = slot + S::A_ELEMS + nb * S::B_ELEMS;
      if (TB)
        gemm_stage<TN, GEMM_BK, NT>(Bs, B, g.k, col0, g.n, kt, k1, g.vec);
      else
        gemm_stage<GEMM_BK, TN, NT>(Bs, B, g.n, kt, k1, col0, g.n, g.vec);
    }
  }

  // acc[nb] += (this warpgroup's 64 rows of A) . B[nb] over one slot's 64 k.
  static __device__ __forceinline__ void mma(float (&acc)[NB][TN / 2],
                                             const __nv_bfloat16* slot, int wg) {
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      const uint64_t da = TA ? sm90::desc_mn<GEMM_BK>(slot, kk, 64 * wg)
                             : sm90::desc_k<64>(slot + wg * 64 * GEMM_BK, kk);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const __nv_bfloat16* Bs = slot + S::A_ELEMS + nb * S::B_ELEMS;
        const uint64_t db = TB ? sm90::desc_k<TN>(Bs, kk) : sm90::desc_mn<GEMM_BK>(Bs, kk, 0);
        sm90::Wgmma<TN, TA ? 1 : 0, TB ? 0 : 1>::ss(acc[nb], da, db, 1);
      }
    }
  }

  // acc[nb] += A . B[nb] (+ A1 . B1) over k in [k0, k1) for the tile at (row0, col0).
  static __device__ __forceinline__ void run(float (&acc)[NB][TN / 2], __nv_bfloat16* ring,
                                             const GemmArgs& g, int k0, int k1, int row0,
                                             int col0) {
    const int nkp = (k1 - k0 + GEMM_BK - 1) / GEMM_BK;
    const int wg = threadIdx.x / 128;
    ring_mainloop(
        PAIRS * nkp,
        [&](int slot, int t) {
          load(ring + slot * S::STAGE_ELEMS, g, t, nkp, k0, k1, row0, col0);
        },
        [&](int slot) { mma(acc, ring + slot * S::STAGE_ELEMS, wg); });
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) sm90::fence_regs<TN / 2>(acc[nb]);
  }
};

// Two adjacent bf16 outputs at p[o], p[o + 1] (the second only if `two`):
// one 4-byte store where the pair is aligned (an even row length; the
// outputs are fresh allocations).
__device__ __forceinline__ void gemm_put2(__nv_bfloat16* p, size_t o, float v0, float v1,
                                          bool two, bool even) {
  if (two && even) {
    *reinterpret_cast<uint32_t*>(p + o) = sm90::pack_bf16(v0, v1);
  } else {
    p[o] = __float2bfloat16_rn(v0);
    if (two) p[o + 1] = __float2bfloat16_rn(v1);
  }
}

// C = epilogue(A . B0 [, A . B1]), or C = A . B0 + A1 . B1 (PAIRS = 2).
// grid (ceil(m / TM), ceil(n / TN), splits): the row tile varies fastest,
// so the blocks in flight share B's column tiles and A stays in L2.  With
// splits > 1 (ACT_NONE) block z covers k in [z k_split, min(k, (z + 1)
// k_split)) and writes its f32 partial to work[z].  BWD: the fused MLP's
// backward epilogue (dh in, dg and du out) on the pre-activations.
template <int TM, int TN, bool TA, bool TB, int PAIRS, int ACT, bool BWD>
__global__ void __launch_bounds__(TM / 64 * 128, 1) gemm_sm90_kernel(const GemmArgs g) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(sm90::align1024(smem));

  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  const int k0 = blockIdx.z * g.k_split, k1 = min(g.k, k0 + g.k_split);

  float acc[NB][TN / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[nb][i] = 0.0f;
  GemmMainloop<TM, TN, NB, TA, TB, PAIRS>::run(acc, ring, g, k0, k1, row0, col0);

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int rb = row0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int cb = col0 + 2 * (t % 4);
  const bool even = (g.n & 1) == 0;
  const bool split = !BWD && ACT == ACT_NONE && gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int gc = cb + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = rb + 8 * h;
      if (gr >= g.m || gc >= g.n) continue;
      const bool two = gc + 1 < g.n;
      const size_t o = (size_t)gr * g.n + gc;
      const int i = 4 * j + 2 * h;  // registers i, i + 1: columns gc, gc + 1
      if (split) {
        float* w = g.work + (size_t)blockIdx.z * g.m * g.n + o;
        if (two && even) {
          *reinterpret_cast<float2*>(w) = make_float2(acc[0][i], acc[0][i + 1]);
        } else {
          w[0] = acc[0][i];
          if (two) w[1] = acc[0][i + 1];
        }
      } else if (BWD) {
        float dh[2];
        dh[0] = to_f(g.dh[o]);
        dh[1] = two ? to_f(g.dh[o + 1]) : 0.0f;
        float dg[2], du[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float u = acc[NB - 1][i + e];
          if (ACT == ACT_SWIGLU) {
            const float gv = acc[0][i + e];
            dg[e] = dh[e] * u * dsilu(gv);
            du[e] = dh[e] * silu(gv);
          } else if (ACT == ACT_GELU) {
            du[e] = dh[e] * dgelu_tanh(u);
          } else {
            du[e] = dh[e] * drelu2(u);
          }
        }
        if (ACT == ACT_SWIGLU) gemm_put2(g.dg, o, dg[0], dg[1], two, even);
        gemm_put2(g.du, o, du[0], du[1], two, even);
      } else {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[0][i + e];
          if (ACT == ACT_SWIGLU) v[e] = silu(v[e]) * acc[NB - 1][i + e];
          if (ACT == ACT_GELU) v[e] = gelu_tanh(v[e]);
          if (ACT == ACT_RELU2) v[e] = relu2(v[e]);
        }
        gemm_put2(g.c, o, v[0], v[1], two, even);
      }
    }
  }
}

// Launch one instantiation: its dynamic shared memory, then the grid.
template <int TM, int TN, bool TA, bool TB, int PAIRS, int ACT, bool BWD>
cudaError_t gemm_sm90_launch(const GemmArgs& g, int splits, cudaStream_t s) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  constexpr int SMEM = GemmSmem<TM, TN, NB>::BYTES;
  const long long ny = (g.n + TN - 1) / TN;
  if (ny > 65535 || splits > 65535) return cudaErrorInvalidValue;
  auto* kern = gemm_sm90_kernel<TM, TN, TA, TB, PAIRS, ACT, BWD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.m + TM - 1) / TM, (unsigned)ny, splits);
  kern<<<grid, TM / 64 * 128, SMEM, s>>>(g);
  return cudaGetLastError();
}

}  // namespace repro
