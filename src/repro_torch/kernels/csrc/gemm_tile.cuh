// Shared helpers of the port's tiled kernels, and the f32 tiled-GEMM core
// of the matmul and fused-MLP kernels (sm_90a).  Their bf16 branches run on
// gemm_sm90.cuh; the int8 kernels (gemm_sm90_s8.cuh) use from_f, the
// activations, Act and DType from here, and the SSD kernel's f32 branch
// NTHREADS, Pad and DType.
//
// f32 (a check dtype): one thread block of 128 threads (4 warps) owns a
// 64x64 output tile and walks the k range in steps of 32: each step stages
// an A tile (64x32) and NB B tiles (32x64) in shared memory, masked and
// zero-filled at the ragged edge (no padded operand copies), and
// accumulates with plain FMA, 8x4 outputs per thread per B operand (full
// f32, no TF32 rounding — the same numbers as an f32 CPU product up to
// order).  The epilogue parks the accumulators in shared memory (reusing
// the operand buffers) and writes the tile out with coalesced, masked
// stores, applying the activation (fused MLP) or writing an f32 split-K
// partial (matmul).
//
// Operand layouts (the gradient GEMMs): TA = A arrives as its transpose At
// (k x m, row-major), TB = B as Bt (n x k, row-major) — `w.T` and `x.T`
// views, read in place: a transposed tile is staged as it lies in memory
// (BK x BM, or BN x BK), so no operand is copied.  PAIRS = 2 sums two
// products A0.B0 + A1.B1 into one accumulator (the fused-MLP backward's
// dx = dg.Wg^T + du.Wu^T).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NTHREADS = 128;

enum Act { ACT_NONE = 0, ACT_SWIGLU = 1, ACT_GELU = 2, ACT_RELU2 = 3 };

// Shared-memory row padding (elements): keeps every row 16-byte aligned for
// vector stores, and spreads banks.
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
// ... and their derivatives (ref.py `_dsilu`, `_dgelu`, `_drelu2`)
__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.0f / (1.0f + expf(-z));
  return s * (1.0f + z * (1.0f - s));
}
__device__ __forceinline__ float dgelu_tanh(float z) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (z + a * z * z * z));
  return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * c * (1.0f + 3.0f * a * z * z);
}
__device__ __forceinline__ float drelu2(float z) { return 2.0f * fmaxf(z, 0.0f); }

// Shared-memory geometry of one k step: the A tile and NB B tiles, each as
// it lies in memory (transposed operands stage transposed tiles).
template <typename T, int NB, bool TA, bool TB> struct TileGeom {
  static constexpr int P = Pad<T>::v;
  static constexpr int LDA = TA ? BM + P : BK + P;
  static constexpr int LDB = TB ? BK + P : BN + P;
  static constexpr int LDC = BN + 4;
  static constexpr int A_ELEMS = TA ? BK * LDA : BM * LDA;
  static constexpr int B_ELEMS = TB ? BN * LDB : BK * LDB;
  static constexpr int IN_BYTES = (A_ELEMS + NB * B_ELEMS) * (int)sizeof(T);
  static constexpr int OUT_BYTES = NB * BM * LDC * (int)sizeof(float);
  static constexpr int BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
};

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

// Accumulation of one k step (f32 below; bf16 runs on gemm_sm90.cuh).
template <typename T, int NB, bool TA = false, bool TB = false> struct TileMma;

// FMA accumulation (f32 operands): thread t owns rows (t/16)*8 + i and
// columns t%16 + 16*j of the tile.
template <int NB, bool TA, bool TB> struct TileMma<float, NB, TA, TB> {
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
      for (int i = 0; i < 8; ++i) a[i] = TA ? As[kk * lda + tr * 8 + i] : As[(tr * 8 + i) * lda + kk];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = TB ? Bs[nb][(tc + 16 * j) * ldb + kk] : Bs[nb][kk * ldb + tc + 16 * j];
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

// Accumulate A . B[nb] over k in [k0, k1) for the output tile at (row0,
// col0) into `mma`.  A is m x k (At: k x m when TA), B[nb] is k x n (Bt:
// n x k when TB); every operand's leading dimension is its row length.
template <typename T, int NB, bool TA, bool TB>
__device__ __forceinline__ void gemm_mainloop(TileMma<T, NB, TA, TB>& mma, unsigned char* smem,
                                              const T* __restrict__ A, const T* const* Bg, int m,
                                              int n, int k, int k0, int k1, int row0, int col0,
                                              int vec) {
  using G = TileGeom<T, NB, TA, TB>;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) Bs[nb] = As + G::A_ELEMS + nb * G::B_ELEMS;
  for (int kt = k0; kt < k1; kt += BK) {
    if (TA)
      load_tile<T, BK, BM>(As, G::LDA, A, m, kt, row0, k1, m, vec);
    else
      load_tile<T, BM, BK>(As, G::LDA, A, k, row0, kt, m, k1, vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (TB)
        load_tile<T, BN, BK>(Bs[nb], G::LDB, Bg[nb], k, col0, kt, n, k1, vec);
      else
        load_tile<T, BK, BN>(Bs[nb], G::LDB, Bg[nb], n, kt, col0, k1, n, vec);
    }
    __syncthreads();
    mma.step(As, G::LDA, Bs, G::LDB);
    __syncthreads();
  }
}

// Per-expert strides (elements) of an expert-batched launch: expert z's A,
// B0 and B1, and C start z * a, z * b and z * c elements after the bases.
struct TileBatch {
  long long a, b, c;
};

// C (m x n) = epilogue(A (m x k) . B0 (k x n) [, A . B1]), or with PAIRS = 2
// C = A . B0 + A1 . B1 (both pairs m x k by k x n, one accumulator).
// grid = (ceil(n/BN), ceil(m/BM), splits).  With splits > 1 (ACT_NONE only)
// block z covers k in [z*k_split, min(k, (z+1)*k_split)) and writes its f32
// partial to work[z] (m x n); splitk_reduce then sums the partials.  BATCH:
// grid = (ceil(n/BN), ceil(m/BM), experts), unsplit; block z runs expert
// z's product at the strides `bt`, the whole k range.
template <typename T, int ACT, bool TA = false, bool TB = false, int PAIRS = 1,
          bool BATCH = false>
__global__ void __launch_bounds__(NTHREADS)
gemm_tile_kernel(const T* __restrict__ A, const T* __restrict__ A1, const T* __restrict__ B0,
                 const T* __restrict__ B1, T* __restrict__ C, float* __restrict__ work, int m,
                 int n, int k, int k_split, int vec, TileBatch bt) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  using G = TileGeom<T, NB, TA, TB>;
  __shared__ __align__(128) unsigned char smem[G::BYTES];

  if (BATCH) {
    const long long z = blockIdx.z;
    A += z * bt.a;
    B0 += z * bt.b;
    if (B1) B1 += z * bt.b;
    C += z * bt.c;
  }
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k0 = BATCH ? 0 : blockIdx.z * k_split;
  const int k1 = BATCH ? k : min(k, k0 + k_split);

  TileMma<T, NB, TA, TB> mma;
  mma.zero();
  if (PAIRS == 2) {
    const T* b0[1] = {B0};
    const T* b1[1] = {B1};
    gemm_mainloop<T, NB, TA, TB>(mma, smem, A, b0, m, n, k, k0, k1, row0, col0, vec);
    gemm_mainloop<T, NB, TA, TB>(mma, smem, A1, b1, m, n, k, k0, k1, row0, col0, vec);
  } else {
    const T* Bg[NB];
    Bg[0] = B0;
    if (NB == 2) Bg[NB - 1] = B1;
    gemm_mainloop<T, NB, TA, TB>(mma, smem, A, Bg, m, n, k, k0, k1, row0, col0, vec);
  }

  float* Cs[NB];
  Cs[0] = reinterpret_cast<float*>(smem);
  if (NB == 2) Cs[NB - 1] = Cs[0] + BM * G::LDC;
  mma.store(Cs, G::LDC);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= m || gc >= n) continue;
    float v = Cs[0][r * G::LDC + c];
    if (!BATCH && ACT == ACT_NONE && gridDim.z > 1) {
      work[((size_t)blockIdx.z * m + gr) * n + gc] = v;
      continue;
    }
    if (ACT == ACT_SWIGLU) v = silu(v) * Cs[NB - 1][r * G::LDC + c];
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
