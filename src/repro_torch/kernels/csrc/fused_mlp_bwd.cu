// fused_mlp_bwd: the cotangents of the gate/up pre-activations of the fused
// MLP hidden op, recomputed from (x, W):
//   swiglu:       g = x.Wg, u = x.Wu;  dg = dh * u * silu'(g),  du = dh * silu(g)
//   gelu / relu2: u = x.Wu;            du = dh * act'(u)
// The wrapper (fused_mlp/ops.py) then finishes the backward with the tile
// GEMM: dx = dg.Wg^T + du.Wu^T (one launch, B transposed, both pairs in one
// f32 accumulator), dWg = x^T.dg and dWu = x^T.du (A transposed).
//
// Replaces: src/repro/kernels/fused_mlp/backward.py `fused_mlp_bwd_pallas`
// (`_dx_kernel`, `_dw_kernel`), the backward of every MLP block under
// linear_impl = "fused".
//
// What bounds it on the H100: operations.  At the training slice's shape
// (m = 4096 tokens, h = 2048, f = 8192) the backward is six products of
// 2*m*h*f FLOPs (g and u recomputed, dx over both pairs, dWg, dWu): 824.6
// GFLOP over ~0.3 GB of operands, ~2,700 FLOP/byte.
//
// What the design does about it: the TPU kernel keeps a (block_m, h) f32
// dx accumulator in VMEM across the f grid (backward.py:139); at h = 2048
// that is 512 KB per 64 rows, and a block has 227 KB of shared memory.  So
// the work is cut where it fits an SM: this kernel recomputes g and u per
// 128 x 128 (m, f) tile (64 x 64 at most 64 rows) on gemm_sm90.cuh's
// mainloop with two accumulator sets (x staged once for both, `wgmma` fed
// by a cp.async ring), and its epilogue reads dh at each accumulator's
// (row, column) and writes dg and du in the compute dtype (2 x 64 MB in
// bf16 at the slice's shape, freed within the backward), straight from the
// registers.  The three GEMMs that follow run on the same mainloop (the nt
// pair and two tn products, operands read in place).  The forward still
// saves only its inputs, as in JAX; dg and du round to the compute dtype
// before the dx / dW GEMMs, which kernels/tolerance.py charges.  f32 (a
// check dtype) stays on gemm_tile.cuh's FMA path.
#include "gemm_sm90.cuh"

using namespace repro;

// f32: gemm_tile.cuh's FMA mainloop, the epilogue through shared memory.
template <typename T, int ACT>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_bwd_kernel(const T* __restrict__ X, const T* __restrict__ Wg, const T* __restrict__ Wu,
                     const T* __restrict__ DH, T* __restrict__ DG, T* __restrict__ DU, int m,
                     int f, int h, int vec) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  using G = TileGeom<T, NB, false, false>;
  __shared__ __align__(128) unsigned char smem[G::BYTES];

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const T* Bg[NB];
  Bg[0] = NB == 2 ? Wg : Wu;
  if (NB == 2) Bg[NB - 1] = Wu;

  TileMma<T, NB, false, false> mma;
  mma.zero();
  gemm_mainloop<T, NB, false, false>(mma, smem, X, Bg, m, f, h, 0, h, row0, col0, vec);

  float* Cs[NB];
  Cs[0] = reinterpret_cast<float*>(smem);
  if (NB == 2) Cs[NB - 1] = Cs[0] + BM * G::LDC;
  mma.store(Cs, G::LDC);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= m || gc >= f) continue;
    const size_t o = (size_t)gr * f + gc;
    const float dh = to_f(DH[o]);
    const float u = Cs[NB - 1][r * G::LDC + c];
    if (ACT == ACT_SWIGLU) {
      const float g = Cs[0][r * G::LDC + c];
      DG[o] = from_f<T>(dh * u * dsilu(g));
      DU[o] = from_f<T>(dh * silu(g));
    } else if (ACT == ACT_GELU) {
      DU[o] = from_f<T>(dh * dgelu_tanh(u));
    } else {
      DU[o] = from_f<T>(dh * drelu2(u));
    }
  }
}

template <int ACT>
static cudaError_t launch_f32(const float* x, const float* wg, const float* wu, const float* dh,
                              float* dg, float* du, int m, int f, int h, int vec,
                              cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM, 1);
  fused_mlp_bwd_kernel<float, ACT><<<grid, NTHREADS, 0, stream>>>(x, wg, wu, dh, dg, du, m, f, h,
                                                                  vec);
  return cudaGetLastError();
}

template <int ACT>
static cudaError_t launch_bf16(const GemmArgs& g, int tm, int tn, cudaStream_t stream) {
  if (tm == 64 && tn == 64)
    return gemm_sm90_launch<64, 64, false, false, 1, ACT, true>(g, 1, stream);
  if (tm == 128 && tn == 128)
    return gemm_sm90_launch<128, 128, false, false, 1, ACT, true>(g, 1, stream);
  return cudaErrorInvalidValue;
}

// x (m, h); wg (swiglu only), wu (h, f); dh, dg (swiglu only), du (m, f);
// all row-major, contiguous.  (tm, tn): the tile, as repro_fused_mlp's.
extern "C" int repro_fused_mlp_bwd(const void* x, const void* wg, const void* wu, const void* dh,
                                   void* dg, void* du, int m, int f, int h, int act, int dtype,
                                   int vec, int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || f <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  if (act != ACT_SWIGLU && act != ACT_GELU && act != ACT_RELU2) return (int)cudaErrorInvalidValue;
  if (act == ACT_SWIGLU && (wg == nullptr || dg == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) {
    using bf = __nv_bfloat16;
    // the gated path reads the gate as B0 and up as B1; the others up as B0
    const GemmArgs g{static_cast<const bf*>(x), nullptr,
                     static_cast<const bf*>(act == ACT_SWIGLU ? wg : wu),
                     static_cast<const bf*>(act == ACT_SWIGLU ? wu : nullptr), nullptr, nullptr,
                     static_cast<const bf*>(dh), static_cast<bf*>(dg), static_cast<bf*>(du), m, f,
                     h, h, vec};
    if (act == ACT_SWIGLU) return (int)launch_bf16<ACT_SWIGLU>(g, tm, tn, s);
    if (act == ACT_GELU) return (int)launch_bf16<ACT_GELU>(g, tm, tn, s);
    return (int)launch_bf16<ACT_RELU2>(g, tm, tn, s);
  }
  if (dtype != DT_F32 || tm != BM || tn != BN) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(wg);
  const float* up = static_cast<const float*>(wu);
  const float* dhp = static_cast<const float*>(dh);
  float* dgp = static_cast<float*>(dg);
  float* dup = static_cast<float*>(du);
  if (act == ACT_SWIGLU)
    return (int)launch_f32<ACT_SWIGLU>(xp, gp, up, dhp, dgp, dup, m, f, h, vec, s);
  if (act == ACT_GELU)
    return (int)launch_f32<ACT_GELU>(xp, nullptr, up, dhp, nullptr, dup, m, f, h, vec, s);
  return (int)launch_f32<ACT_RELU2>(xp, nullptr, up, dhp, nullptr, dup, m, f, h, vec, s);
}
