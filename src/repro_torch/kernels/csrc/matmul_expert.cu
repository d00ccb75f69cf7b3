// matmul_expert, the TMA route: c[z] = a[z] . b[z] (+ a1[z] . b1[z]) for
// every expert z of bf16 stacks the TMA can describe, in one persistent
// launch of gemm_sm90_tma.cuh's warp-specialized mainloop, in the layouts
// of csrc/matmul.cu `repro_matmul_expert`: nn (the forward), nt (the dgrad
// g[z] . w[z]^T, and its two-pair form for the fused-MLP backward's dx)
// and tn (the wgrad x[z]^T . g[z]), `.mT` operands read in place.  Stacks
// it cannot describe, and f32, stay on `repro_matmul_expert` (the BATCH
// instantiation of gemm_sm90.cuh; gemm_tile.cuh); the wrapper
// (kernels/matmul/ops.py `_matmul_expert_cuda`) picks the route.
//
// Replaces: src/repro/models/linear.py `expert_linear` (:212-235), one
// `matmul_pallas` per expert under `jax.lax.map`, as repro_matmul_expert.
//
// What bounds it on the H100, and what the design does about it: at decode
// capacities (8 rows) bytes, the weights (nn, nt) or the 7.5 GB output
// (tn, k = 8: each 128 x 128 tile is one k step and a 32 KB store); at
// the training capacities operations.  The BATCH launch gave each output
// tile its own block, a cp.async ring two steps ahead behind a barrier
// each step, and 4-byte stores straight from the accumulators, so a tile's
// prologue and epilogue were never hidden: the 8-row wgrad ran 3.2x
// torch.bmm, the training nt / tn 1.7-2.3x.  Here a persistent grid walks
// the tiles, a producer warp keeps up to 8 TMA steps in flight across tile
// boundaries, and the epilogue leaves through a double-buffered staging
// tile by TMA stores that drain under the next tile's products.  On the
// H100 (PERF.md row 1b, against the grid-z launch in turns): the 8-row
// wgrad 8.00 -> 2.50 ms (torch.bmm 2.55), deepseek-v3's training dgrad /
// wgrad 2.54 / 3.17 -> 1.93 / 2.21 ms (bmm 1.52: the 128 x 128 tile that
// bit-identity fixes), decode nn 2.444 -> 2.434 (bmm 2.46).
#include "gemm_sm90_tma.cuh"

using namespace repro;

template <int TM, int TN, bool TA, bool TB, int PAIRS>
static cudaError_t launch_tma(const void* const* ptrs, const long long* desc, TmaArgs& p, int sms,
                              cudaStream_t s) {
  // A K-major (nn, nt): one box of TM rows (fewer at decode: tma_a_rows);
  // MN-major (tn): 64-row boxes.  B K-major (nt): TN rows; MN-major (nn,
  // tn): 64.  C: 64 x 64 boxes.
  const int a_rows = TA ? 64 : tma_a_rows(p.m, TM);
  const int boxes[TS_SLOTS] = {a_rows, a_rows, TB ? TN : 64, TB ? TN : 64, 64};
  const int kmaj[TS_SLOTS] = {!TA, !TA, TB, TB, 0};
  for (int i = 0; i <= TS_C; ++i) {
    if (PAIRS == 1 && (i == TS_A1 || i == TS_B1)) continue;
    const cudaError_t err = tma_encode(&p.map[i], ptrs[i], desc + i * TD_FIELDS, boxes[i], kmaj[i]);
    if (err != cudaSuccess) return err;
  }
  return expert_gemm_tma_launch<TM, TN, TA, TB, PAIRS, ACT_NONE, false>(p, sms, s);
}

template <bool TA, bool TB, int PAIRS>
static cudaError_t launch_tile(const void* const* ptrs, const long long* desc, TmaArgs& p, int tm,
                               int tn, int sms, cudaStream_t s) {
  if (tm == 64 && tn == 128) return launch_tma<64, 128, TA, TB, PAIRS>(ptrs, desc, p, sms, s);
  if (tm == 128 && tn == 128) return launch_tma<128, 128, TA, TB, PAIRS>(ptrs, desc, p, sms, s);
  return cudaErrorInvalidValue;
}

// a (e, m, k), b (e, k, n) as the GEMM sees them, a1 / b1 an optional
// second pair (nt only; null: none), c (e, m, n); desc holds TS_C + 1
// descriptions of TD_FIELDS int64s (slots A, A1, B0, B1, C) of their
// stored layouts, bf16; counter: one int of scratch (the tile queue's,
// zeroed here).  (ta, tb): a / b read transposed; (tm, tn): 64 x 128 or
// 128 x 128; sms: the card's SMs (the persistent grid is CTAS blocks an SM).
extern "C" int repro_matmul_expert_tma(const void* a, const void* b, const void* a1,
                                       const void* b1, void* c, const long long* desc,
                                       int* counter, int e, int m, int n, int k, int ta, int tb,
                                       int tm, int tn, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 0 || m <= 0 || n <= 0 || k <= 0 || desc == nullptr || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((a1 == nullptr) != (b1 == nullptr)) return (int)cudaErrorInvalidValue;
  const void* ptrs[TS_SLOTS] = {a, a1, b, b1, c};
  TmaArgs p{};
  p.m = m;
  p.n = n;
  p.k = k;
  p.experts = e;
  p.counter = counter;
  const bool pair = a1 != nullptr;
  if (!ta && !tb && !pair) return (int)launch_tile<false, false, 1>(ptrs, desc, p, tm, tn, sms, s);
  if (!ta && tb && !pair) return (int)launch_tile<false, true, 1>(ptrs, desc, p, tm, tn, sms, s);
  if (!ta && tb && pair) return (int)launch_tile<false, true, 2>(ptrs, desc, p, tm, tn, sms, s);
  if (ta && !tb && !pair) return (int)launch_tile<true, false, 1>(ptrs, desc, p, tm, tn, sms, s);
  return (int)cudaErrorInvalidValue;
}
