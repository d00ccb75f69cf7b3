// matmul: C = A . B with f32 accumulation, output in A's dtype; A and B
// each row-major or a transposed view, and optionally a second product
// summed into the same accumulator (C = A . B + A1 . B1).
//
// Replaces: src/repro/kernels/matmul/kernel.py `matmul_pallas`
// (`_matmul_kernel`), the tile GEMM behind every projection under
// linear_impl in {pallas, tuned, fused}, and the dgrad / wgrad GEMMs of its
// custom VJP (src/repro/models/linear.py:85-94: dx = g . w^T, dw = x^T . g).
//
// What bounds it on the H100: at the serving slice's shapes (m = 64 rows
// at decode and at prefill, k x n weights of 2-16 MB, and the 379 MB
// lm_head) every call is bound by bytes: 2*m*k*n FLOPs over (m*k + k*n +
// m*n)*2 bytes is ~64 FLOP/byte, far under the ~295 FLOP/byte at which the
// bf16 tensor cores become the limit.  The weight read is the cost.  At the
// training slice's shapes (m = 4096 tokens; dgrad contracts over the output
// width, wgrad over the 4096 tokens) every GEMM is bound by operations:
// ~1,000-1,400 FLOP/byte.
//
// What the design does about it: each weight element is read from device
// memory once (one 64-row tile covers all m = 64 rows), in 16-byte loads.
// A 64x64 output tile gives only n/64 blocks for a 64-row problem (16-32 for
// the attention projections, far under the 132 SMs), so the wrapper splits
// k across gridDim.z until the grid holds a few blocks per SM; the f32
// partials (a few MB, resident in the 50 MB L2) are summed by a second,
// small kernel.  The ragged edge is masked in the kernel instead of padding
// operands with copies (the Pallas wrapper pads, ops.py:44-48).  The
// gradient GEMMs read `w.T` and `x.T` in place (gemm_tile.cuh TA / TB): a
// transposed tile is staged as it lies and read with column-major WMMA
// fragments, so no weight is copied to transpose it.  Simple first: no TMA,
// no wgmma, no multi-stage pipeline — later PRs.
#include "gemm_tile.cuh"

using namespace repro;

template <typename T, bool TA, bool TB, int PAIRS>
static void launch_tile(dim3 grid, const T* a, const T* a1, const T* b, const T* b1, T* c,
                        float* work, int m, int n, int k, int k_split, int vec,
                        cudaStream_t stream) {
  gemm_tile_kernel<T, ACT_NONE, TA, TB, PAIRS>
      <<<grid, NTHREADS, 0, stream>>>(a, a1, b, b1, c, work, m, n, k, k_split, vec);
}

template <typename T>
static cudaError_t launch_matmul(const void* a, const void* b, const void* a1, const void* b1,
                                 void* c, void* work, int m, int n, int k, int k_split, int ta,
                                 int tb, int vec, cudaStream_t stream) {
  const int splits = (k + k_split - 1) / k_split;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  const T* a1p = static_cast<const T*>(a1);
  const T* b1p = static_cast<const T*>(b1);
  T* cp = static_cast<T*>(c);
  float* wp = static_cast<float*>(work);
  const bool pair = a1 != nullptr;
  if (!ta && !tb && !pair)
    launch_tile<T, false, false, 1>(grid, ap, a1p, bp, b1p, cp, wp, m, n, k, k_split, vec, stream);
  else if (!ta && tb && !pair)
    launch_tile<T, false, true, 1>(grid, ap, a1p, bp, b1p, cp, wp, m, n, k, k_split, vec, stream);
  else if (!ta && tb && pair)
    launch_tile<T, false, true, 2>(grid, ap, a1p, bp, b1p, cp, wp, m, n, k, k_split, vec, stream);
  else if (ta && !tb && !pair)
    launch_tile<T, true, false, 1>(grid, ap, a1p, bp, b1p, cp, wp, m, n, k, k_split, vec, stream);
  else
    return cudaErrorInvalidValue;  // layouts no caller uses are not instantiated
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    int blocks = (int)((mn + 255) / 256);
    if (blocks > 4 * 132) blocks = 4 * 132;
    splitk_reduce_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(work), cp, mn,
                                                        splits);
  }
  return cudaGetLastError();
}

// a (m, k) row-major, or (ta) its transpose stored (k, m) row-major; b (k, n)
// row-major, or (tb) stored (n, k).  a1, b1: an optional second pair with
// the same shapes and layouts (null: none).  c (m, n) row-major; work holds
// ceil(k / k_split) * m * n floats when k_split < k (else unused).
extern "C" int repro_matmul(const void* a, const void* b, const void* a1, const void* b1, void* c,
                            void* work, int m, int n, int k, int k_split, int dtype, int ta,
                            int tb, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || k_split <= 0 || k_split % BK) return (int)cudaErrorInvalidValue;
  if ((a1 == nullptr) != (b1 == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)launch_matmul<__nv_bfloat16>(a, b, a1, b1, c, work, m, n, k, k_split, ta, tb, vec, s);
  if (dtype == DT_F32)
    return (int)launch_matmul<float>(a, b, a1, b1, c, work, m, n, k, k_split, ta, tb, vec, s);
  return (int)cudaErrorInvalidValue;
}
