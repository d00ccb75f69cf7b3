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
// What the design does about it (bf16, gemm_sm90.cuh): the products are
// `wgmma` from swizzled shared-memory tiles, fed by a four-slot cp.async
// ring that keeps two k steps of 64 in flight while a third is multiplied,
// and the epilogue stores from the accumulator registers.  For the
// operation-bound rows (m > 64) a block of two warpgroups owns a 128 x 128
// tile, so each byte staged in shared memory feeds 64 products (a 128 x
// 256 tile, 85, ran slower on the card).  For the byte-bound
// rows (m <= 64) one warpgroup owns a 64 x 128 tile covering every row, so
// each weight element is read from device memory once; two such blocks fit
// an SM, and where n / 128 tiles leave SMs idle the wrapper splits k across
// gridDim.z (f32 partials, a few MB resident in the 50 MB L2, summed by a
// second small kernel) so the rings of every SM keep ~64 KB of weight in
// flight.  The gradient GEMMs read `w.T` and `x.T` in place: the
// descriptors take a K-major or an MN-major tile of either operand, so no
// operand is copied to transpose it.  The ragged edge is zero-filled by
// the copies instead of padding operands (the Pallas wrapper pads,
// ops.py:44-48).  f32 (a check dtype) stays on gemm_tile.cuh's FMA path,
// full f32 with no TF32.
#include "gemm_sm90.cuh"

using namespace repro;

template <bool TA, bool TB, int PAIRS>
static cudaError_t launch_f32(const float* a, const float* a1, const float* b, const float* b1,
                              float* c, float* work, int m, int n, int k, int k_split,
                              int splits, int vec, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  gemm_tile_kernel<float, ACT_NONE, TA, TB, PAIRS>
      <<<grid, NTHREADS, 0, stream>>>(a, a1, b, b1, c, work, m, n, k, k_split, vec);
  return cudaGetLastError();
}

// The bf16 tiles (rows x columns) kernels/matmul/ops.py `pick_tile` chooses.
template <bool TA, bool TB, int PAIRS>
static cudaError_t launch_bf16(const GemmArgs& g, int splits, int tm, int tn,
                               cudaStream_t stream) {
  if (tm == 64 && tn == 128)
    return gemm_sm90_launch<64, 128, TA, TB, PAIRS, ACT_NONE, false>(g, splits, stream);
  if (tm == 128 && tn == 128)
    return gemm_sm90_launch<128, 128, TA, TB, PAIRS, ACT_NONE, false>(g, splits, stream);
  return cudaErrorInvalidValue;
}

static cudaError_t launch_matmul(const void* a, const void* b, const void* a1, const void* b1,
                                 void* c, void* work, int m, int n, int k, int k_split, int dtype,
                                 int ta, int tb, int vec, int tm, int tn, cudaStream_t stream) {
  const int splits = (k + k_split - 1) / k_split;
  const bool pair = a1 != nullptr;
  // layouts no caller uses are not instantiated: nn, nt, the nt pair, tn
  const int layout = !ta && !tb && !pair ? 0 : !ta && tb && !pair ? 1 : !ta && tb ? 2
                     : ta && !tb && !pair ? 3 : -1;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DT_BF16) {
    using bf = __nv_bfloat16;
    const GemmArgs g{static_cast<const bf*>(a), static_cast<const bf*>(a1),
                     static_cast<const bf*>(b), static_cast<const bf*>(b1), static_cast<bf*>(c),
                     static_cast<float*>(work), nullptr, nullptr, nullptr, m, n, k, k_split, vec};
    if (layout == 0) err = launch_bf16<false, false, 1>(g, splits, tm, tn, stream);
    if (layout == 1) err = launch_bf16<false, true, 1>(g, splits, tm, tn, stream);
    if (layout == 2) err = launch_bf16<false, true, 2>(g, splits, tm, tn, stream);
    if (layout == 3) err = launch_bf16<true, false, 1>(g, splits, tm, tn, stream);
  } else {
    if (tm != BM || tn != BN) return cudaErrorInvalidValue;
    const float* ap = static_cast<const float*>(a);
    const float* bp = static_cast<const float*>(b);
    const float* a1p = static_cast<const float*>(a1);
    const float* b1p = static_cast<const float*>(b1);
    float* cp = static_cast<float*>(c);
    float* wp = static_cast<float*>(work);
#define F32_CASE(L, TA, TB, P) \
  if (layout == L)             \
    err = launch_f32<TA, TB, P>(ap, a1p, bp, b1p, cp, wp, m, n, k, k_split, splits, vec, stream);
    F32_CASE(0, false, false, 1)
    F32_CASE(1, false, true, 1)
    F32_CASE(2, false, true, 2)
    F32_CASE(3, true, false, 1)
#undef F32_CASE
  }
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const size_t mn = (size_t)m * n;
    int blocks = (int)((mn + 255) / 256);
    if (blocks > 4 * 132) blocks = 4 * 132;
    const float* wp = static_cast<const float*>(work);
    if (dtype == DT_BF16)
      splitk_reduce_kernel<__nv_bfloat16>
          <<<blocks, 256, 0, stream>>>(wp, static_cast<__nv_bfloat16*>(c), mn, splits);
    else
      splitk_reduce_kernel<float>
          <<<blocks, 256, 0, stream>>>(wp, static_cast<float*>(c), mn, splits);
  }
  return cudaGetLastError();
}

// a (m, k) row-major, or (ta) its transpose stored (k, m) row-major; b (k, n)
// row-major, or (tb) stored (n, k).  a1, b1: an optional second pair with
// the same shapes and layouts (null: none).  c (m, n) row-major; work holds
// ceil(k / k_split) * m * n floats when k_split < k (else unused).  (tm, tn):
// the output tile, one of bf16's instantiated tiles, or 64 x 64 for f32;
// k_split a multiple of the tile's k step (64 bf16, 32 f32).
extern "C" int repro_matmul(const void* a, const void* b, const void* a1, const void* b1, void* c,
                            void* work, int m, int n, int k, int k_split, int dtype, int ta,
                            int tb, int vec, int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != DT_BF16 && dtype != DT_F32) return (int)cudaErrorInvalidValue;
  const int step = dtype == DT_BF16 ? GEMM_BK : BK;
  if (m <= 0 || n <= 0 || k <= 0 || k_split <= 0 || k_split % step)
    return (int)cudaErrorInvalidValue;
  if ((a1 == nullptr) != (b1 == nullptr)) return (int)cudaErrorInvalidValue;
  if (k_split < k && work == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_matmul(a, b, a1, b1, c, work, m, n, k, k_split, dtype, ta, tb, vec, tm, tn,
                            s);
}
