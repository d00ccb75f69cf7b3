// int8_matmul: C = (f32(A_q . B_q) * a_scale[row]) * b_scale[col], the int8
// products summed exactly in int32, output bf16 or f32.
//
// Replaces: src/repro/kernels/quantized/kernel.py `int8_matmul_pallas`
// (`_int8_matmul_kernel`), every projection under linear_impl="quantized"
// (src/repro/models/linear.py:194-202) and the down projection of
// `quantized_mlp`.
//
// What bounds it on the H100: at the serving path's rows (m <= 64 at
// decode and prefill, int8 weights of 2-16 MB and the 190 MB lm_head) every
// call is bound by bytes: 2 m k n operations over ~k n bytes is ~128 ops a
// byte, far under the ~590 at which the int8 tensor cores (1,979 TOP/s)
// become the limit.  The weight read is the cost, half the bf16 GEMM's.  At
// thousands of rows (a long prefill) it is bound by the tensor cores.
//
// What the design does about it (gemm_sm90_s8.cuh): s8 `wgmma` from
// swizzled shared-memory tiles fed by a four-slot cp.async ring two
// 128-column k steps ahead, the weight held K-major (n, k) as s8 `wgmma`
// requires.  At most 64 rows take a 64 x 128 tile of one warpgroup that
// covers every row, so each weight byte is read once; two such blocks share
// an SM, and where n / 128 tiles leave SMs idle the wrapper splits k across
// gridDim.z, the splits of a tile one cluster that sums its int32 partials
// in distributed shared memory before the de-scale: bit-identical to one
// exact integer sum (f32 partials of de-scaled values would round per
// split), with no partials in device memory and no second kernel.  More
// rows take 128 x 256 tiles of two warpgroups (each staged byte feeds 85
// products; the fastest tile at 4096 rows on the card, the bf16 path's
// 128 x 128 9-25% slower there: tuning/int8_tiles.py).  The ragged edge
// is zero-filled by the copies (the Pallas wrapper pads).
#include "gemm_sm90_s8.cuh"

using namespace repro;

template <typename T>
static cudaError_t launch_int8_matmul(const I8Args& g, int splits, int tm, int tn,
                                      cudaStream_t stream) {
  if (tm == 64 && tn == 128) return int8_sm90_launch<64, 128, ACT_NONE, T>(g, splits, stream);
  if (tm == 128 && tn == 256) return int8_sm90_launch<128, 256, ACT_NONE, T>(g, splits, stream);
  return cudaErrorInvalidValue;
}

// a (m, k) int8 row-major; bt (n, k) int8 row-major (the weight B (k, n)
// K-major); a_scale (m) and b_scale (n) f32; c (m, n) in `dtype`; (tm, tn)
// one of the instantiated tiles; k_split a multiple of 128, at most 8
// splits.
extern "C" int repro_int8_matmul(const void* a, const void* bt, const void* a_scale,
                                 const void* b_scale, void* c, int m, int n, int k, int k_split,
                                 int dtype, int vec, int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || k_split <= 0 || k_split % I8_BK)
    return (int)cudaErrorInvalidValue;
  const int splits = (k + k_split - 1) / k_split;
  const I8Args g{static_cast<const signed char*>(a), static_cast<const signed char*>(bt), nullptr,
                 static_cast<const float*>(a_scale), static_cast<const float*>(b_scale), nullptr,
                 c, m, n, k, k_split, vec};
  if (dtype == DT_BF16) return (int)launch_int8_matmul<__nv_bfloat16>(g, splits, tm, tn, s);
  if (dtype == DT_F32) return (int)launch_int8_matmul<float>(g, splits, tm, tn, s);
  return (int)cudaErrorInvalidValue;
}

// The expert-batched int8 GEMM behind the MoE layer's expert stacks under
// linear_impl = "quantized": c[z] = (f32(a_q[z] . b_q[z]) * a_scale[z][row])
// * b_scale[z][col] for every expert z in one launch (the grid's z axis), no
// cluster and no split, each expert at the 2-D kernel's tile.
//
// Replaces: src/repro/kernels/quantized/kernel.py `int8_matmul_pallas` per
// expert, which JAX runs through `_quantized_linear` under `jax.lax.map`
// (src/repro/models/linear.py `expert_linear`, :225-231): per-expert
// dynamic quantization, every expert at one (m, k, n) cache key.  Bound by
// bytes as the batched bf16 GEMM (matmul.cu `repro_matmul_expert`) at the
// serving capacities, with half its weight bytes; the experts times the
// column tiles fill the card, so no split of k is needed.
template <typename T>
static cudaError_t launch_int8_expert(const I8Args& g, int experts, int tm, int tn,
                                      cudaStream_t stream) {
  if (tm == 64 && tn == 128)
    return int8_sm90_launch<64, 128, ACT_NONE, T, true>(g, experts, stream);
  if (tm == 128 && tn == 256)
    return int8_sm90_launch<128, 256, ACT_NONE, T, true>(g, experts, stream);
  return cudaErrorInvalidValue;
}

// a (e, m, k) int8 row-major; bt (e, n, k) int8 row-major (each expert's
// weight B (k, n) K-major); a_scale (e, m) and b_scale (e, n) f32; c (e, m,
// n) in `dtype`; (tm, tn) one of the instantiated tiles.
extern "C" int repro_int8_matmul_expert(const void* a, const void* bt, const void* a_scale,
                                        const void* b_scale, void* c, int e, int m, int n, int k,
                                        int dtype, int vec, int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 0 || e > 65535 || m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const I8Args g{static_cast<const signed char*>(a), static_cast<const signed char*>(bt), nullptr,
                 static_cast<const float*>(a_scale), static_cast<const float*>(b_scale), nullptr,
                 c, m, n, k, k, vec, (long long)m * k, (long long)n * k, (long long)m * n};
  if (dtype == DT_BF16) return (int)launch_int8_expert<__nv_bfloat16>(g, e, tm, tn, s);
  if (dtype == DT_F32) return (int)launch_int8_expert<float>(g, e, tm, tn, s);
  return (int)cudaErrorInvalidValue;
}
