// Shared by the flash-attention sources: the head-dim padding, the entry
// points' shape check, and the f32 route (flash_attention_f32.cu).
#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int MAX_D = 256;

// The padded head dim a kernel is instantiated at: d up to 128 rounds up to
// a multiple of 16 (the bf16 k16 step), d above 128 to a multiple of 32
// (half the instantiations where no registered config has a head dim).
// 0 when d is out of range.
inline int padded_d(int d) {
  if (d < 1 || d > MAX_D) return 0;
  return d <= 128 ? (d + 15) / 16 * 16 : (d + 31) / 32 * 32;
}

inline bool shape_ok(int b, int sq, int skv, int a, int nkv, int d) {
  return b > 0 && sq > 0 && skv > 0 && nkv > 0 && a % nkv == 0 && padded_d(d) > 0;
}

// Expands F(DP) for every padded head dim (padded_d's values).
#define FLASH_FOR_EACH_DP(F) \
  F(16) F(32) F(48) F(64) F(80) F(96) F(112) F(128) F(160) F(192) F(224) F(256)

cudaError_t fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse, int b,
                    int sq, int skv, int a, int nkv, int d, int causal, float scale,
                    cudaStream_t s);
cudaError_t bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                    const float* lse, const float* di, float* dq, float* dk, float* dv, int b,
                    int sq, int skv, int a, int nkv, int d, int causal, float scale,
                    cudaStream_t s);

}  // namespace flash
