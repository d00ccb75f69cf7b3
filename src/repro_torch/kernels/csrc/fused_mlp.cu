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
// At the training slice's 4096 rows, operations (~2,000 FLOP/byte).
//
// What the design does about it (bf16, gemm_sm90.cuh's mainloop, no design
// of its own yet): one block computes the gate and up tiles of the same
// output region into two f32 accumulator sets in the same threads, so x is
// staged once for both products, each weight element is read once, and the
// (m, f) gate/up activations never reach device memory: the epilogue
// applies the activation in registers (the exact `_silu` of
// fused_mlp/ref.py: z * sigmoid(z)) and writes only h.  At most 64 rows
// take a 64 x 64 tile of one warpgroup, so f = 8192 still gives 128 blocks,
// about one per SM (a split of k would have to write the pre-activation
// partials out); more rows take 128 x 128 tiles of two warpgroups, whose
// two accumulator sets fill 128 registers a thread.  f32 (a check dtype)
// stays on gemm_tile.cuh's FMA path.
#include "gemm_sm90.cuh"

using namespace repro;

template <int ACT>
static cudaError_t launch_bf16(const GemmArgs& g, int tm, int tn, cudaStream_t stream) {
  if (tm == 64 && tn == 64)
    return gemm_sm90_launch<64, 64, false, false, 1, ACT, false>(g, 1, stream);
  if (tm == 128 && tn == 128)
    return gemm_sm90_launch<128, 128, false, false, 1, ACT, false>(g, 1, stream);
  return cudaErrorInvalidValue;
}

template <int ACT>
static cudaError_t launch_f32(const float* x, const float* b0, const float* b1, float* h, int m,
                              int f, int k, int vec, cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM, 1);
  gemm_tile_kernel<float, ACT><<<grid, NTHREADS, 0, stream>>>(x, nullptr, b0, b1, h, nullptr, m,
                                                              f, k, k, vec, TileBatch{});
  return cudaGetLastError();
}

// x (m, k); wg (swiglu only), wu (k, f); h (m, f); all row-major, contiguous.
// (tm, tn): the output tile, 64 x 64 or 128 x 128 in bf16, 64 x 64 in f32.
extern "C" int repro_fused_mlp(const void* x, const void* wg, const void* wu, void* h, int m,
                               int f, int k, int act, int dtype, int vec, int tm, int tn,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (act != ACT_SWIGLU && act != ACT_GELU && act != ACT_RELU2) return (int)cudaErrorInvalidValue;
  // the gated path reads the gate as B0 and up as B1; the others up as B0
  const void* b0 = act == ACT_SWIGLU ? wg : wu;
  const void* b1 = act == ACT_SWIGLU ? wu : nullptr;
  if (dtype == DT_BF16) {
    using bf = __nv_bfloat16;
    const GemmArgs g{static_cast<const bf*>(x), nullptr, static_cast<const bf*>(b0),
                     static_cast<const bf*>(b1), static_cast<bf*>(h), nullptr, nullptr, nullptr,
                     nullptr, m, f, k, k, vec};
    if (act == ACT_SWIGLU) return (int)launch_bf16<ACT_SWIGLU>(g, tm, tn, s);
    if (act == ACT_GELU) return (int)launch_bf16<ACT_GELU>(g, tm, tn, s);
    return (int)launch_bf16<ACT_RELU2>(g, tm, tn, s);
  }
  if (dtype != DT_F32 || tm != BM || tn != BN) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* b0p = static_cast<const float*>(b0);
  const float* b1p = static_cast<const float*>(b1);
  float* hp = static_cast<float*>(h);
  if (act == ACT_SWIGLU) return (int)launch_f32<ACT_SWIGLU>(xp, b0p, b1p, hp, m, f, k, vec, s);
  if (act == ACT_GELU) return (int)launch_f32<ACT_GELU>(xp, b0p, b1p, hp, m, f, k, vec, s);
  return (int)launch_f32<ACT_RELU2>(xp, b0p, b1p, hp, m, f, k, vec, s);
}

// The expert-batched hidden behind the MoE layer under linear_impl =
// "fused": h[z] = silu(x[z] . Wg[z]) * (x[z] . Wu[z]), or gelu(x[z] .
// Wu[z]), for every expert z in one launch (the grid's z axis), each at the
// 2-D kernel's tile.
//
// Replaces: src/repro/models/linear.py `expert_fused_hidden` (:323-341),
// one `fused_mlp_pallas` per expert under `jax.lax.map`.  Bound by bytes,
// as the batched matmul (matmul.cu `repro_matmul_expert`): every expert's
// gate and up weights are read, 256 x 2 x 29 MB for deepseek-v3 and 128 x 2
// x 84 MB for llama4-maverick, whatever the rows.  The MoE layer maps every
// un-gated MLP to gelu (repro/models/moe.py:87-90), so relu2 has no
// batched instantiation.
template <int ACT>
static cudaError_t launch_expert_bf16(const GemmArgs& g, int experts, int tm, int tn,
                                      cudaStream_t stream) {
  if (tm == 64 && tn == 64)
    return gemm_sm90_launch<64, 64, false, false, 1, ACT, false, true>(g, experts, stream);
  if (tm == 128 && tn == 128)
    return gemm_sm90_launch<128, 128, false, false, 1, ACT, false, true>(g, experts, stream);
  return cudaErrorInvalidValue;
}

template <int ACT>
static cudaError_t launch_expert_f32(const float* x, const float* b0, const float* b1, float* h,
                                     int e, int m, int f, int k, int vec, TileBatch bt,
                                     cudaStream_t stream) {
  dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM, e);
  gemm_tile_kernel<float, ACT, false, false, 1, true>
      <<<grid, NTHREADS, 0, stream>>>(x, nullptr, b0, b1, h, nullptr, m, f, k, k, vec, bt);
  return cudaGetLastError();
}

// x (e, m, k); wg (swiglu only), wu (e, k, f); h (e, m, f); all row-major,
// contiguous.  act: swiglu or gelu.  (tm, tn) as repro_fused_mlp's.
extern "C" int repro_fused_mlp_expert(const void* x, const void* wg, const void* wu, void* h,
                                      int e, int m, int f, int k, int act, int dtype, int vec,
                                      int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 0 || e > 65535 || m <= 0 || f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (act != ACT_SWIGLU && act != ACT_GELU) return (int)cudaErrorInvalidValue;
  const void* b0 = act == ACT_SWIGLU ? wg : wu;
  const void* b1 = act == ACT_SWIGLU ? wu : nullptr;
  const long long sa = (long long)m * k, sb = (long long)k * f, sc = (long long)m * f;
  if (dtype == DT_BF16) {
    using bf = __nv_bfloat16;
    const GemmArgs g{static_cast<const bf*>(x), nullptr, static_cast<const bf*>(b0),
                     static_cast<const bf*>(b1), static_cast<bf*>(h), nullptr, nullptr, nullptr,
                     nullptr, m, f, k, k, vec, sa, sb, sc};
    if (act == ACT_SWIGLU) return (int)launch_expert_bf16<ACT_SWIGLU>(g, e, tm, tn, s);
    return (int)launch_expert_bf16<ACT_GELU>(g, e, tm, tn, s);
  }
  if (dtype != DT_F32 || tm != BM || tn != BN) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* b0p = static_cast<const float*>(b0);
  const float* b1p = static_cast<const float*>(b1);
  float* hp = static_cast<float*>(h);
  const TileBatch bt{sa, sb, sc};
  if (act == ACT_SWIGLU)
    return (int)launch_expert_f32<ACT_SWIGLU>(xp, b0p, b1p, hp, e, m, f, k, vec, bt, s);
  return (int)launch_expert_f32<ACT_GELU>(xp, b0p, b1p, hp, e, m, f, k, vec, bt, s);
}
