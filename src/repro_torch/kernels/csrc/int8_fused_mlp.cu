// int8_fused_mlp: h = silu(gate) * up (swiglu), or act(up) for gelu (tanh
// form) and relu2, where gate / up = (f32(x_q . w_q) * x_scale[row]) *
// w_scale[col] from exact int32 sums, in one pass.
//
// Replaces: src/repro/kernels/quantized/kernel.py `int8_fused_mlp_pallas`
// (`_int8_gated_kernel`, `_int8_plain_kernel`), the gate/up pair of every
// MLP block under linear_impl="quantized" (src/repro/models/linear.py:
// 296-320 `quantized_mlp`).
//
// What bounds it on the H100: at the serving path's shape, x (64, 2048)
// against two (2048, 8192) int8 weights, bytes: 2 x 16 MB of weights for
// 4.3 G operations is ~128 ops a byte, under the ~590 at which the int8
// tensor cores become the limit.
//
// What the design does about it: one block owns the gate and up 64x64
// tiles of the same output region in two int32 accumulator sets, so x is
// staged once for both products, each weight byte is read once, and the
// (m, f) gate / up values never reach device memory: the de-scale and the
// activation run at the last k step on the accumulators (the activations
// of gemm_tile.cuh).  No split of k: a split would have to write the
// pre-activation partials out.  At f = 8192 the grid holds 128 blocks, one
// per SM.  Simple first: no cp.async/TMA pipeline, no wgmma — later PRs.
#include "int8_tile.cuh"

using namespace repro;

template <typename T>
static cudaError_t launch_int8_fused(const void* x, const void* wg, const void* wu,
                                     const void* xs, const void* gs, const void* us, void* h,
                                     int m, int f, int k, int act, int vec,
                                     cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM, 1);
  const signed char* xp = static_cast<const signed char*>(x);
  const signed char* gp = static_cast<const signed char*>(wg);
  const signed char* up = static_cast<const signed char*>(wu);
  const float* xsp = static_cast<const float*>(xs);
  const float* gsp = static_cast<const float*>(gs);
  const float* usp = static_cast<const float*>(us);
  T* hp = static_cast<T*>(h);
  switch (act) {
    case ACT_SWIGLU:
      if (wg == nullptr || gs == nullptr) return cudaErrorInvalidValue;
      int8_tile_kernel<T, ACT_SWIGLU><<<grid, NTHREADS, 0, stream>>>(
          xp, gp, up, xsp, gsp, usp, hp, nullptr, m, f, k, k, vec);
      break;
    case ACT_GELU:
      int8_tile_kernel<T, ACT_GELU><<<grid, NTHREADS, 0, stream>>>(
          xp, up, nullptr, xsp, usp, nullptr, hp, nullptr, m, f, k, k, vec);
      break;
    case ACT_RELU2:
      int8_tile_kernel<T, ACT_RELU2><<<grid, NTHREADS, 0, stream>>>(
          xp, up, nullptr, xsp, usp, nullptr, hp, nullptr, m, f, k, k, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x (m, k) int8; wg (swiglu only), wu (k, f) int8; xs (m), gs (swiglu
// only), us (f) f32; h (m, f) in `dtype`; all row-major, contiguous.
extern "C" int repro_int8_fused_mlp(const void* x, const void* wg, const void* wu,
                                    const void* xs, const void* gs, const void* us, void* h,
                                    int m, int f, int k, int act, int dtype, int vec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)launch_int8_fused<__nv_bfloat16>(x, wg, wu, xs, gs, us, h, m, f, k, act, vec, s);
  if (dtype == DT_F32)
    return (int)launch_int8_fused<float>(x, wg, wu, xs, gs, us, h, m, f, k, act, vec, s);
  return (int)cudaErrorInvalidValue;
}
