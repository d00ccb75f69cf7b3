// fused_mlp_bwd_expert, the TMA route of the batched recompute: dg[z], du[z]
// from x[z], Wg[z], Wu[z] and dh[z] for every expert z of bf16 stacks the
// TMA can describe, in one persistent launch of gemm_sm90_tma.cuh's
// warp-specialized mainloop with two B tiles a step (gated: the gate and
// up products into two accumulator sets, x staged once for both) and the
// backward epilogue (dh loaded by TMA with the operands, dg and du stored
// by TMA).  Other stacks, and f32, stay on csrc/fused_mlp_bwd.cu
// `repro_fused_mlp_bwd_expert`; the wrapper (kernels/fused_mlp/ops.py
// `_recompute_expert_cuda`) picks the route, then finishes the backward
// with matmul_expert's nt pair and two tn launches (matmul_expert.cu).
//
// Replaces: src/repro/kernels/fused_mlp/backward.py `fused_mlp_bwd_pallas`
// per expert under `jax.lax.map` (src/repro/models/linear.py
// `expert_fused_hidden`, :323-341), as repro_fused_mlp_bwd_expert.
//
// What bounds it on the H100: operations at the training capacities
// (640-2560 rows an expert), bytes at decode (8 rows: both weight stacks).
// The gated 128 x 128 tile takes 48 KB a ring step and 64 KB of epilogue
// buffers, so its ring is 3 steps deep; the gated 64 x 64 decode tiles go
// two to a block (40 KB a step, 4 steps), reading each weight row 256
// bytes wide.  On the H100 (PERF.md row 7b, against the grid-z launch in
// turns): deepseek-v3's training recompute 5.68 -> 3.50 ms (686 TFLOP/s),
// its decode recompute 4.97 -> 4.87 (bound 4.50), and the whole expert
// backward 17.9 -> 12.6 / 26.19 -> 14.70 ms.
#include "gemm_sm90_tma.cuh"

using namespace repro;

template <int TM, int TN, int ACT>
static cudaError_t launch_tma(const void* const* ptrs, const long long* desc, TmaArgs& p, int sms,
                              cudaStream_t s) {
  constexpr bool GATED = ACT == ACT_SWIGLU;
  // x K-major (one box of TM rows, fewer at decode: tma_a_rows), the
  // weights MN-major, dh one box of TM rows a 64-column atom, dg and du
  // 64 x 64 boxes
  const int boxes[TS_SLOTS] = {tma_a_rows(p.m, TM), 0, 64, 64, 0, TM, 64, 64};
  const int kmaj[TS_SLOTS] = {1, 0, 0, 0, 0, 0, 0, 0};
  for (int i : {(int)TS_A, (int)TS_B0, (int)TS_B1, (int)TS_DH, (int)TS_DG, (int)TS_DU}) {
    if (!GATED && (i == TS_B1 || i == TS_DG)) continue;
    const cudaError_t err = tma_encode(&p.map[i], ptrs[i], desc + i * TD_FIELDS, boxes[i], kmaj[i]);
    if (err != cudaSuccess) return err;
  }
  return expert_gemm_tma_launch<TM, TN, false, false, 1, ACT, true>(p, sms, s);
}

template <int ACT>
static cudaError_t launch_tile(const void* const* ptrs, const long long* desc, TmaArgs& p, int tm,
                               int tn, int sms, cudaStream_t s) {
  if (tm == 64 && tn == 64) return launch_tma<64, 64, ACT>(ptrs, desc, p, sms, s);
  if (tm == 128 && tn == 128) return launch_tma<128, 128, ACT>(ptrs, desc, p, sms, s);
  return cudaErrorInvalidValue;
}

// x (e, m, h); wg (swiglu only), wu (e, h, f); dh, dg (swiglu only), du
// (e, m, f); desc holds TS_SLOTS descriptions of TD_FIELDS int64s (slots
// A = x, B0 = wg or wu, B1 = wu, DH, DG, DU; A1 and C unused), bf16;
// counter: one int of scratch (zeroed here).  act: swiglu or gelu; (tm,
// tn): 64 x 64 or 128 x 128; sms: the card's SMs.
extern "C" int repro_fused_mlp_bwd_expert_tma(const void* x, const void* wg, const void* wu,
                                              const void* dh, void* dg, void* du,
                                              const long long* desc, int* counter, int e, int m,
                                              int f, int h, int act, int tm, int tn, int sms,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e <= 0 || m <= 0 || f <= 0 || h <= 0 || desc == nullptr || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool gated = act == ACT_SWIGLU;
  if (gated && (wg == nullptr || dg == nullptr)) return (int)cudaErrorInvalidValue;
  // the gated path reads the gate as B0 and up as B1; gelu up as B0
  const void* ptrs[TS_SLOTS] = {x, nullptr, gated ? wg : wu, gated ? wu : nullptr,
                                nullptr, dh, gated ? dg : nullptr, du};
  TmaArgs p{};
  p.m = m;
  p.n = f;
  p.k = h;
  p.experts = e;
  p.counter = counter;
  if (gated) return (int)launch_tile<ACT_SWIGLU>(ptrs, desc, p, tm, tn, sms, s);
  if (act == ACT_GELU) return (int)launch_tile<ACT_GELU>(ptrs, desc, p, tm, tn, sms, s);
  return (int)cudaErrorInvalidValue;
}
