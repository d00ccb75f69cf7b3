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
      <<<grid, NTHREADS, 0, stream>>>(a, a1, b, b1, c, work, m, n, k, k_split, vec, TileBatch{});
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

// The layouts instantiated, by code: 0 nn, 1 nt, 2 the nt pair, 3 tn; -1
// for any other (no caller uses them).
static int layout_code(int ta, int tb, bool pair) {
  return !ta && !tb && !pair ? 0 : !ta && tb && !pair ? 1 : !ta && tb ? 2
         : ta && !tb && !pair ? 3 : -1;
}

static cudaError_t launch_matmul(const void* a, const void* b, const void* a1, const void* b1,
                                 void* c, void* work, int m, int n, int k, int k_split, int dtype,
                                 int ta, int tb, int vec, int tm, int tn, cudaStream_t stream) {
  const int splits = (k + k_split - 1) / k_split;
  const int layout = layout_code(ta, tb, a1 != nullptr);
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

// The expert-batched product behind the MoE layer's expert GEMMs and their
// gradients: c[z] = a[z] . b[z] (+ a1[z] . b1[z]) for every expert z in one
// launch (the grid's z axis), each expert at the 2-D kernel's tile and
// unsplit, in the 2-D kernel's layouts: nn (the forward), nt (the dgrad
// g[z] . w[z]^T, and its two-pair form dg[z] . Wg[z]^T + du[z] . Wu[z]^T
// for the fused-MLP backward's dx) and tn (the wgrad x[z]^T . g[z]).  This
// grid-z launch is the route of f32 stacks and of bf16 stacks whose bases
// or rows are not whole 16 bytes; every other bf16 stack takes the TMA
// route (matmul_expert.cu `repro_matmul_expert_tma`, gemm_sm90_tma.cuh's
// warp-specialized persistent mainloop), which the wrapper picks
// (kernels/matmul/ops.py `expert_route`); its times are matmul_expert.cu's.
//
// Replaces: src/repro/models/linear.py `expert_linear` (:212-235), which
// runs one `matmul_pallas` per expert under `jax.lax.map`: a sequential
// grid inside one TPU program, differentiated through `_pallas_linear`'s
// custom VJP (:85-94) per expert.  Eager, that would be one wrapper call
// per expert (256 for deepseek-v3, 128 for llama4-maverick), each paying
// the host's 24-77 us; here the experts are blocks of one launch.
//
// What bounds it on the H100: at decode, bytes.  The capacity buffer holds
// every expert, so every expert's weights are read: at decode (8-row
// capacity) ~2 FLOP per weight byte, at a 4 x 1024-token prefill (160
// rows) ~160, both under the ~295 at which the tensor cores become the
// limit.  At the training capacities (640-2560 rows an expert) the forward,
// dgrad and wgrad are bound by operations (~600-1,500 FLOP per byte).  The
// experts times the tiles give hundreds to thousands of blocks (256 x 56
// for deepseek-v3's w_down at decode), so no split of k is needed to fill
// the card.  The transposed operands are `.mT` views of row-major (E, ., .)
// stacks, read in place by the descriptors as in the 2-D kernel; the wgrad
// contracts over the capacity rows.  Each block owns one tile, copies with
// all its threads two steps ahead and stores from the accumulators, so a
// tile's prologue and epilogue are never hidden (the 8-row wgrad ran 8.0 ms
// here against a 2.25 ms bound, PERF.md row 1b).
template <int TM, int TN, bool TA, bool TB, int PAIRS>
static cudaError_t launch_expert_bf16(const GemmArgs& g, int experts, cudaStream_t stream) {
  return gemm_sm90_launch<TM, TN, TA, TB, PAIRS, ACT_NONE, false, true>(g, experts, stream);
}

template <bool TA, bool TB, int PAIRS>
static cudaError_t launch_expert_tile(const GemmArgs& g, int experts, int tm, int tn,
                                      cudaStream_t stream) {
  if (tm == 64 && tn == 128) return launch_expert_bf16<64, 128, TA, TB, PAIRS>(g, experts, stream);
  if (tm == 128 && tn == 128)
    return launch_expert_bf16<128, 128, TA, TB, PAIRS>(g, experts, stream);
  return cudaErrorInvalidValue;
}

template <bool TA, bool TB, int PAIRS>
static cudaError_t launch_expert_f32(const float* a, const float* a1, const float* b,
                                     const float* b1, float* c, int e, int m, int n, int k,
                                     int vec, TileBatch bt, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, e);
  gemm_tile_kernel<float, ACT_NONE, TA, TB, PAIRS, true>
      <<<grid, NTHREADS, 0, stream>>>(a, a1, b, b1, c, nullptr, m, n, k, k, vec, bt);
  return cudaGetLastError();
}

// a (e, m, k) row-major, or (ta) each expert's transpose stored (e, k, m);
// b (e, k, n) row-major, or (tb) stored (e, n, k); a1, b1: an optional
// second pair with the shapes and layouts of a and b (null: none; nt only);
// c (e, m, n) row-major.  (tm, tn) one of bf16's instantiated tiles, or
// 64 x 64 for f32.  Every expert's operands are whole at the same
// per-expert strides (m k, k n, m n elements) in either layout.
extern "C" int repro_matmul_expert(const void* a, const void* b, const void* a1, const void* b1,
                                   void* c, int e, int m, int n, int k, int dtype, int ta, int tb,
                                   int vec, int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 0 || e > 65535 || m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if ((a1 == nullptr) != (b1 == nullptr)) return (int)cudaErrorInvalidValue;
  const int layout = layout_code(ta, tb, a1 != nullptr);
  if (layout < 0) return (int)cudaErrorInvalidValue;
  const long long sa = (long long)m * k, sb = (long long)k * n, sc = (long long)m * n;
  if (dtype == DT_BF16) {
    using bf = __nv_bfloat16;
    const GemmArgs g{static_cast<const bf*>(a), static_cast<const bf*>(a1),
                     static_cast<const bf*>(b), static_cast<const bf*>(b1), static_cast<bf*>(c),
                     nullptr, nullptr, nullptr, nullptr, m, n, k, k, vec, sa, sb, sc};
    if (layout == 0) return (int)launch_expert_tile<false, false, 1>(g, e, tm, tn, s);
    if (layout == 1) return (int)launch_expert_tile<false, true, 1>(g, e, tm, tn, s);
    if (layout == 2) return (int)launch_expert_tile<false, true, 2>(g, e, tm, tn, s);
    return (int)launch_expert_tile<true, false, 1>(g, e, tm, tn, s);
  }
  if (dtype != DT_F32 || tm != BM || tn != BN) return (int)cudaErrorInvalidValue;
  const float* ap = static_cast<const float*>(a);
  const float* a1p = static_cast<const float*>(a1);
  const float* bp = static_cast<const float*>(b);
  const float* b1p = static_cast<const float*>(b1);
  float* cp = static_cast<float*>(c);
  const TileBatch bt{sa, sb, sc};
  if (layout == 0)
    return (int)launch_expert_f32<false, false, 1>(ap, a1p, bp, b1p, cp, e, m, n, k, vec, bt, s);
  if (layout == 1)
    return (int)launch_expert_f32<false, true, 1>(ap, a1p, bp, b1p, cp, e, m, n, k, vec, bt, s);
  if (layout == 2)
    return (int)launch_expert_f32<false, true, 2>(ap, a1p, bp, b1p, cp, e, m, n, k, vec, bt, s);
  return (int)launch_expert_f32<true, false, 1>(ap, a1p, bp, b1p, cp, e, m, n, k, vec, bt, s);
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
