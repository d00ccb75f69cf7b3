// matmul: C = A . B with f32 accumulation, output in A's dtype.
//
// Replaces: src/repro/kernels/matmul/kernel.py `matmul_pallas`
// (`_matmul_kernel`), the tile GEMM behind every projection under
// linear_impl in {pallas, tuned, fused}.
//
// What bounds it on the H100: at the serving slice's shapes (m = 64 rows
// at decode and at prefill, k x n weights of 2-16 MB, and the 379 MB
// lm_head) every call is bound by bytes: 2*m*k*n FLOPs over (m*k + k*n +
// m*n)*2 bytes is ~64 FLOP/byte, far under the ~295 FLOP/byte at which the
// bf16 tensor cores become the limit.  The weight read is the cost.
//
// What the design does about it: each weight element is read from device
// memory once (one 64-row tile covers all m = 64 rows), in 16-byte loads.
// A 64x64 output tile gives only n/64 blocks for a 64-row problem (16-32 for
// the attention projections, far under the 132 SMs), so the wrapper splits
// k across gridDim.z until the grid holds a few blocks per SM; the f32
// partials (a few MB, resident in the 50 MB L2) are summed by a second,
// small kernel.  The ragged edge is masked in the kernel instead of padding
// operands with copies (the Pallas wrapper pads, ops.py:44-48).  Simple
// first: no TMA, no wgmma, no multi-stage pipeline — later PRs.
#include "gemm_tile.cuh"

using namespace repro;

template <typename T>
static cudaError_t launch_matmul(const void* a, const void* b, void* c, void* work, int m, int n,
                                 int k, int k_split, int vec, cudaStream_t stream) {
  const int splits = (k + k_split - 1) / k_split;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  gemm_tile_kernel<T, ACT_NONE><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), nullptr, static_cast<T*>(c),
      static_cast<float*>(work), m, n, k, k_split, vec);
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    int blocks = (int)((mn + 255) / 256);
    if (blocks > 4 * 132) blocks = 4 * 132;
    splitk_reduce_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(work),
                                                        static_cast<T*>(c), mn, splits);
  }
  return cudaGetLastError();
}

// a (m, k), b (k, n), c (m, n) row-major and contiguous; work holds
// ceil(k / k_split) * m * n floats when k_split < k (else unused).
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* work, int m, int n,
                            int k, int k_split, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || k_split <= 0 || k_split % BK) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) return (int)launch_matmul<__nv_bfloat16>(a, b, c, work, m, n, k, k_split, vec, s);
  if (dtype == DT_F32) return (int)launch_matmul<float>(a, b, c, work, m, n, k, k_split, vec, s);
  return (int)cudaErrorInvalidValue;
}
