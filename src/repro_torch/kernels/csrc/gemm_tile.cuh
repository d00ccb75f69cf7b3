// Shared tiled-GEMM core of the matmul and fused-MLP kernels (sm_90a).
//
// One thread block of 128 threads (4 warps) owns a 64x64 output tile and
// walks the k range in steps of 32: each step stages an A tile (64x32) and
// NB B tiles (32x64) in shared memory, masked and zero-filled at the ragged
// edge (no padded operand copies), and accumulates in f32 registers:
//   * bf16: WMMA 16x16x16 tensor-core products (mma.sync), one 16-row
//     stripe of the tile per warp, 4 accumulator fragments per B operand;
//   * f32:  plain FMA, 8x4 outputs per thread per B operand (full f32, no
//     TF32 rounding — the same numbers as an f32 CPU product up to order).
// The epilogue parks the accumulators in shared memory (reusing the operand
// buffers) and writes the tile out with coalesced, masked stores, applying
// the activation (fused MLP) or writing an f32 split-K partial (matmul).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace repro {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NTHREADS = 128;

enum Act { ACT_NONE = 0, ACT_SWIGLU = 1, ACT_GELU = 2, ACT_RELU2 = 3 };

// Shared-memory row padding (elements): keeps every row 16-byte aligned for
// vector stores, WMMA leading dimensions legal, and spreads banks.
template <typename T> struct Pad;
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round-to-nearest-even, as XLA's f32 -> bf16 convert
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Activations of kernels/fused_mlp/ref.py, in f32 on the accumulators.
__device__ __forceinline__ float silu(float z) { return z * (1.0f / (1.0f + expf(-z))); }
__device__ __forceinline__ float gelu_tanh(float z) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  return 0.5f * z * (1.0f + tanhf(c * (z + a * z * z * z)));
}
__device__ __forceinline__ float relu2(float z) {
  const float r = fmaxf(z, 0.0f);
  return r * r;
}

// Stage rows [row0, row0+ROWS) x cols [col0, col0+COLS) of a row-major
// matrix (leading dim ld, valid extent nrows x ncols) into shared memory
// (leading dim lds).  Out-of-range elements read as zero.  `vec` (decided
// on the host: 16-byte aligned base, ld a multiple of the chunk) allows one
// 16-byte load per in-range chunk.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int lds, const T* __restrict__ src, int ld,
                                          int row0, int col0, int nrows, int ncols, bool vec) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int CPR = COLS / CH;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = (idx % CPR) * CH;
    const int gr = row0 + r, gc = col0 + c;
    T* d = dst + r * lds + c;
    if (vec && gr < nrows && gc + CH <= ncols) {
      *reinterpret_cast<uint4*>(d) =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc));
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        d[e] = (gr < nrows && gc + e < ncols) ? src[(size_t)gr * ld + gc + e] : from_f<T>(0.0f);
    }
  }
}

// Tensor-core accumulation (bf16 operands, f32 accumulators).
template <typename T, int NB> struct TileMma;

template <int NB> struct TileMma<__nv_bfloat16, NB> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[NB][BN / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) nvcuda::wmma::fill_fragment(acc[nb][j], 0.0f);
  }

  __device__ __forceinline__ void step(const __nv_bfloat16* As, int lda,
                                       const __nv_bfloat16* const* Bs, int ldb) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + warp * 16 * lda + kk, lda);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs[nb] + kk * ldb + j * 16, ldb);
          wmma::mma_sync(acc[nb][j], a, b, acc[nb][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* const* Cs, int ldc) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        nvcuda::wmma::store_matrix_sync(Cs[nb] + warp * 16 * ldc + j * 16, acc[nb][j], ldc,
                                        nvcuda::wmma::mem_row_major);
  }
};

// FMA accumulation (f32 operands): thread t owns rows (t/16)*8 + i and
// columns t%16 + 16*j of the tile.
template <int NB> struct TileMma<float, NB> {
  float acc[NB][8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nb][i][j] = 0.0f;
  }

  __device__ __forceinline__ void step(const float* As, int lda, const float* const* Bs, int ldb) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(tr * 8 + i) * lda + kk];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = Bs[nb][kk * ldb + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[nb][i][j] = fmaf(a[i], b, acc[nb][i][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* const* Cs, int ldc) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Cs[nb][(tr * 8 + i) * ldc + tc + 16 * j] = acc[nb][i][j];
  }
};

// C (m x n) = epilogue(A (m x k) . B0 (k x n) [, A . B1]).
// grid = (ceil(n/BN), ceil(m/BM), splits).  With splits > 1 (ACT_NONE only)
// block z covers k in [z*k_split, min(k, (z+1)*k_split)) and writes its f32
// partial to work[z] (m x n); splitk_reduce then sums the partials.
template <typename T, int ACT>
__global__ void __launch_bounds__(NTHREADS)
gemm_tile_kernel(const T* __restrict__ A, const T* __restrict__ B0, const T* __restrict__ B1,
                 T* __restrict__ C, float* __restrict__ work, int m, int n, int k, int k_split,
                 int vec) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  constexpr int P = Pad<T>::v;
  constexpr int LDA = BK + P, LDB = BN + P, LDC = BN + 4;
  constexpr int IN_BYTES = (BM * LDA + NB * BK * LDB) * (int)sizeof(T);
  constexpr int OUT_BYTES = NB * BM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char smem[IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES];

  T* As = reinterpret_cast<T*>(smem);
  T* Bs[NB];
  Bs[0] = As + BM * LDA;
  if (NB == 2) Bs[NB - 1] = Bs[0] + BK * LDB;
  const T* Bg[NB];
  Bg[0] = B0;
  if (NB == 2) Bg[NB - 1] = B1;

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * k_split;
  const int k1 = min(k, k0 + k_split);

  TileMma<T, NB> mma;
  mma.zero();
  for (int kt = k0; kt < k1; kt += BK) {
    load_tile<T, BM, BK>(As, LDA, A, k, row0, kt, m, k1, vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) load_tile<T, BK, BN>(Bs[nb], LDB, Bg[nb], n, kt, col0, k1, n, vec);
    __syncthreads();
    mma.step(As, LDA, Bs, LDB);
    __syncthreads();
  }

  float* Cs[NB];
  Cs[0] = reinterpret_cast<float*>(smem);
  if (NB == 2) Cs[NB - 1] = Cs[0] + BM * LDC;
  mma.store(Cs, LDC);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= m || gc >= n) continue;
    float v = Cs[0][r * LDC + c];
    if (ACT == ACT_NONE && gridDim.z > 1) {
      work[((size_t)blockIdx.z * m + gr) * n + gc] = v;
      continue;
    }
    if (ACT == ACT_SWIGLU) v = silu(v) * Cs[NB - 1][r * LDC + c];
    if (ACT == ACT_GELU) v = gelu_tanh(v);
    if (ACT == ACT_RELU2) v = relu2(v);
    C[(size_t)gr * n + gc] = from_f<T>(v);
  }
}

template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ work, T* __restrict__ C,
                                     size_t mn, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += work[(size_t)z * mn + i];
    C[i] = from_f<T>(s);
  }
}

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType { DT_F32 = 0, DT_BF16 = 1 };

}  // namespace repro
