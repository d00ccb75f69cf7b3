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
// What the design does about it (gemm_sm90_s8.cuh's mainloop: s8 `wgmma`
// from a four-slot swizzled cp.async ring, the weights K-major): one
// warpgroup owns the gate and up 64 x 32 tiles of the same output region
// in two int32 accumulator sets, so x is staged once for both products,
// each weight byte is read once at up to 64 rows, and the (m, f) gate / up
// values never reach device memory: the de-scale and the activation run on
// the accumulator registers.  No split of k: a split would have to write
// the pre-activation partials out.  At f = 8192 the grid holds 256 blocks
// a 64-row tile, two per SM, so one block's barrier wait overlaps the
// other's copies.  Above 64 rows the tile is 128 x 32, two warpgroups
// sharing each staged weight tile.  Of the 64 / 128 x 32 / 64 tiles these
// two ran fastest at every row count from 16 to 4096 on the card
// (tuning/int8_tiles.py).
#include "gemm_sm90_s8.cuh"

using namespace repro;

template <int TM, typename T>
static cudaError_t launch_int8_fused(const I8Args& g, int act, cudaStream_t s) {
  switch (act) {
    case ACT_SWIGLU: return int8_sm90_launch<TM, 32, ACT_SWIGLU, T>(g, 1, s);
    case ACT_GELU: return int8_sm90_launch<TM, 32, ACT_GELU, T>(g, 1, s);
    case ACT_RELU2: return int8_sm90_launch<TM, 32, ACT_RELU2, T>(g, 1, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t launch_int8_fused(const I8Args& g, int act, int tm, cudaStream_t s) {
  if (tm == 64) return launch_int8_fused<64, T>(g, act, s);
  if (tm == 128) return launch_int8_fused<128, T>(g, act, s);
  return cudaErrorInvalidValue;
}

// x (m, k) int8 row-major; wgt (swiglu only), wut (f, k) int8 row-major (the
// weights (k, f) K-major); xs (m), gs (swiglu only), us (f) f32; h (m, f)
// in `dtype`; tm the tile's rows, 64 or 128 (32 columns).
extern "C" int repro_int8_fused_mlp(const void* x, const void* wgt, const void* wut,
                                    const void* xs, const void* gs, const void* us, void* h,
                                    int m, int f, int k, int act, int dtype, int vec, int tm,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || f <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (act == ACT_SWIGLU && (wgt == nullptr || gs == nullptr)) return (int)cudaErrorInvalidValue;
  // the gated path reads the gate as B0 and up as B1; the others up as B0
  const bool gated = act == ACT_SWIGLU;
  const I8Args g{static_cast<const signed char*>(x),
                 static_cast<const signed char*>(gated ? wgt : wut),
                 static_cast<const signed char*>(gated ? wut : nullptr),
                 static_cast<const float*>(xs), static_cast<const float*>(gated ? gs : us),
                 static_cast<const float*>(gated ? us : nullptr), h, m, f, k, k, vec};
  if (dtype == DT_BF16) return (int)launch_int8_fused<__nv_bfloat16>(g, act, tm, s);
  if (dtype == DT_F32) return (int)launch_int8_fused<float>(g, act, tm, s);
  return (int)cudaErrorInvalidValue;
}
