// fused_mlp_hidden: h = silu(x . Wg) * (x . Wu) (swiglu), or act(x . Wu)
// for gelu (tanh form) and relu2, in one pass.
//
// Replaces: src/repro/kernels/fused_mlp/kernel.py `fused_mlp_pallas`
// (`_gated_kernel`, `_plain_kernel`), the gate/up pair of every MLP block
// under linear_impl = "fused".
//
// What bounds it on the H100: at the serving slice's shape, x (64, 2048)
// against two (2048, 8192) bf16 weights, bytes: 2 * 32 MB of weights for
// 4.3 GFLOP is ~64 FLOP/byte, under the ~295 FLOP/byte tensor-core line.
//
// What the design does about it: one block computes the gate and up tiles
// of the same 64x64 output region into two f32 accumulator sets, so x is
// staged once for both products, each weight element is read once, and the
// (m, f) gate/up activations never reach device memory: only silu(g) * u is
// written (with the exact `_silu` of fused_mlp/ref.py: z * sigmoid(z)).  At
// f = 8192 the grid holds 128 blocks, one per SM, so no split of k is needed
// (a split would have to write the pre-activation partials out).  Simple
// first: no TMA, no wgmma, no multi-stage pipeline — later PRs.
#include "gemm_tile.cuh"

using namespace repro;

template <typename T>
static cudaError_t launch_fused(const void* x, const void* wg, const void* wu, void* h, int m,
                                int f, int k, int act, int vec, cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM, 1);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  T* hp = static_cast<T*>(h);
  switch (act) {
    case ACT_SWIGLU:
      gemm_tile_kernel<T, ACT_SWIGLU><<<grid, NTHREADS, 0, stream>>>(xp, gp, up, hp, nullptr, m, f,
                                                                     k, k, vec);
      break;
    case ACT_GELU:
      gemm_tile_kernel<T, ACT_GELU><<<grid, NTHREADS, 0, stream>>>(xp, up, nullptr, hp, nullptr, m,
                                                                   f, k, k, vec);
      break;
    case ACT_RELU2:
      gemm_tile_kernel<T, ACT_RELU2><<<grid, NTHREADS, 0, stream>>>(xp, up, nullptr, hp, nullptr, m,
                                                                    f, k, k, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x (m, k); wg (swiglu only), wu (k, f); h (m, f); all row-major, contiguous.
extern "C" int repro_fused_mlp(const void* x, const void* wg, const void* wu, void* h, int m,
                               int f, int k, int act, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) return (int)launch_fused<__nv_bfloat16>(x, wg, wu, h, m, f, k, act, vec, s);
  if (dtype == DT_F32) return (int)launch_fused<float>(x, wg, wu, h, m, f, k, act, vec, s);
  return (int)cudaErrorInvalidValue;
}
