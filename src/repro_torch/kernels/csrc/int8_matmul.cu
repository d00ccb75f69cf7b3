// int8_matmul: C = (f32(A_q . B_q) * a_scale[row]) * b_scale[col], the int8
// products summed exactly in int32, output bf16 or f32.
//
// Replaces: src/repro/kernels/quantized/kernel.py `int8_matmul_pallas`
// (`_int8_matmul_kernel`), every projection under linear_impl="quantized"
// (src/repro/models/linear.py:194-202) and the down projection of
// `quantized_mlp`.
//
// What bounds it on the H100: at the serving path's shapes (m = 64 rows at
// decode and prefill, int8 weights of 1-16 MB and the 190 MB lm_head) every
// call is bound by bytes: 2 m k n operations over ~k n bytes is ~128 ops a
// byte, far under the ~590 at which the int8 tensor cores (1,979 TOP/s)
// become the limit.  The weight read is the cost, half the bf16 GEMM's.
//
// What the design does about it: each weight byte is read once (one
// 64-row tile covers all 64 rows), in 16-byte loads.  A 64x64 tile grid
// gives only n / 64 blocks for a 64-row product (16-32 for the attention
// projections, against 132 SMs), so the wrapper splits k across gridDim.z
// until the grid holds a few blocks per SM.  The partials are int32, so
// the reduce sums them exactly and applies the de-scale after, keeping the
// result bit-identical to one exact integer sum (f32 partials of de-scaled
// values would round per split).  The ragged edge is masked in the kernel
// (the Pallas wrapper pads).  Simple first: no cp.async/TMA pipeline, no
// wgmma — later PRs.
#include "int8_tile.cuh"

using namespace repro;

template <typename T>
static cudaError_t launch_int8_matmul(const void* a, const void* b, const void* a_scale,
                                      const void* b_scale, void* c, void* work, int m, int n,
                                      int k, int k_split, int vec, cudaStream_t stream) {
  const int splits = (k + k_split - 1) / k_split;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  const float* as = static_cast<const float*>(a_scale);
  const float* bs = static_cast<const float*>(b_scale);
  T* cp = static_cast<T*>(c);
  int* wp = static_cast<int*>(work);
  int8_tile_kernel<T, ACT_NONE><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const signed char*>(a), static_cast<const signed char*>(b), nullptr, as, bs,
      nullptr, cp, wp, m, n, k, k_split, vec);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    int blocks = (int)((mn + 255) / 256);
    if (blocks > 4 * 132) blocks = 4 * 132;
    i8_splitk_reduce_kernel<T><<<blocks, 256, 0, stream>>>(wp, as, bs, cp, m, n, splits);
  }
  return cudaGetLastError();
}

// a (m, k) int8, b (k, n) int8, row-major and contiguous; a_scale (m) and
// b_scale (n) f32; c (m, n) in `dtype`; work holds ceil(k / k_split) * m * n
// int32 when k_split < k (else unused).
extern "C" int repro_int8_matmul(const void* a, const void* b, const void* a_scale,
                                 const void* b_scale, void* c, void* work, int m, int n, int k,
                                 int k_split, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || k_split <= 0 || k_split % I8_BK)
    return (int)cudaErrorInvalidValue;
  if (k_split < k && work == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)launch_int8_matmul<__nv_bfloat16>(a, b, a_scale, b_scale, c, work, m, n, k,
                                                  k_split, vec, s);
  if (dtype == DT_F32)
    return (int)launch_int8_matmul<float>(a, b, a_scale, b_scale, c, work, m, n, k, k_split,
                                          vec, s);
  return (int)cudaErrorInvalidValue;
}
