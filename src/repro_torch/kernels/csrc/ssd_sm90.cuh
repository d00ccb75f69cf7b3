// The SSD kernels' shared Hopper pieces (csrc/ssd_chunk.cu, the chunk
// step; csrc/ssd_chunk_bwd.cu, its gradient): 64-row bf16 tiles in
// sm90.cuh's swizzle, the score product, the seg vectors, a warpgroup's own
// barrier and the f32 accumulator's store.
#pragma once

#include "sm90.cuh"

namespace ssd {

constexpr int T64 = 64;  // rows of a query tile, a key tile, a warpgroup's state rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Bytes of a 64-row bf16 tile of `cols` columns (whole 64-column atoms).
__host__ __device__ constexpr int tile_bytes(int cols) { return T64 * 2 * ((cols + 63) / 64 * 64); }

// The barrier of this thread's warpgroup alone (named barrier 1 + its index).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)threadIdx.x / 128) : "memory");
}

// seg[k0 .. k0 + 64) (stride ss), zeros past Q, by threads [first, first + 64)
__device__ __forceinline__ void stage_seg(float* dst, const float* sg, long long ss, int k0, int Q,
                                          int first) {
  const int i = threadIdx.x - first;
  if (i >= 0 && i < T64) {
    const bool ok = k0 + i < Q;
    sm90::cp_async<4>(dst + i, ok ? sg + (k0 + i) * ss : sg, ok);
  }
}

// s (64 x 64 f32, the accumulator layout) = A B^T over np columns, both
// 64-row tiles K-major (the first product overwrites s).
__device__ __forceinline__ void score(float* s, const sm90::bf16* As, const sm90::bf16* Bs,
                                      int np) {
  sm90::wgmma_fence();
  for (int kk = 0; kk < np / 16; ++kk)
    sm90::Wgmma<T64, 0, 0>::ss(s, sm90::desc_k<T64>(As, kk), sm90::desc_k<T64>(Bs, kk), kk);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs<T64 / 2>(s);
}

// A 64 x W f32 accumulator (rows r0 + row, + 8) to rows [r0, nrows) x
// columns [0, ncols) of a bf16 matrix (row stride rs): bf16 pairs where
// alignment allows.
template <int W>
__device__ __forceinline__ void store_tile(sm90::bf16* out, long long rs, const float* acc, int r0,
                                           int nrows, int ncols, int row, int col) {
  const bool pair =
      (ncols & 1) == 0 && (rs & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + row + 8 * hh;
    if (r >= nrows) continue;
    sm90::bf16* o = out + r * rs;
#pragma unroll
    for (int J = 0; J < W / 8; ++J) {
      const int c = 8 * J + col;
      const float v0 = acc[4 * J + 2 * hh], v1 = acc[4 * J + 2 * hh + 1];
      if (pair) {
        if (c < ncols) *reinterpret_cast<uint32_t*>(o + c) = sm90::pack_bf16(v0, v1);
      } else {
        if (c < ncols) o[c] = __float2bfloat16_rn(v0);
        if (c + 1 < ncols) o[c + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

}  // namespace ssd
