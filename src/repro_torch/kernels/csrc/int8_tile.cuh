// Shared int8 tile core of the int8 GEMM and the int8 fused-MLP kernels
// (sm_90a).
//
// The shape of gemm_tile.cuh: one block of 128 threads (4 warps) owns a
// 64x64 output tile and walks k in steps of I8_BK = 64 (four 16-byte
// chunks a row), staging the A tile (64 x 64 int8) and NB B tiles (64 x 64
// int8) in shared memory, masked and zero-filled at the ragged edge (no
// padded operand copies), and accumulating on the tensor cores with WMMA
// 16x16x16 `signed char` fragments into `int` accumulators: every product
// and every sum is exact in int32 (|sum| <= k * 127^2 < 2^31 for k < 133k).
//
// Layout in shared memory: chunk-major.  A's plane c holds the tile's 64
// rows x k columns [16c, 16c + 16); B's plane j holds its 64 k rows x n
// columns [16j, 16j + 16): B stays in the (k, n) row-major layout of the
// JAX package's weights, read by row-major `matrix_b` fragments.  Every
// fragment is then 256 contiguous bytes at a 32-byte aligned address
// (WMMA's rule), and a 16-byte load lands whole in one slot; planes are 32
// bytes longer than their 1024 so the 8 stores of a quarter warp fall in 8
// different bank groups.
//
// The epilogue parks the int32 accumulators in shared memory and writes
// the tile with coalesced, masked stores: an int32 split-K partial, or the
// de-scale (f32(acc) * a_scale[row]) * b_scale[col] — i32 -> f32 rounded
// to nearest, then two f32 products in the JAX kernel's order — and the
// activation, rounded once to the output type.
#pragma once

#include "gemm_tile.cuh"

namespace repro {

constexpr int I8_BK = 64;                       // k per step
constexpr int I8_CH = 16;                       // int8 elements in 16 bytes
constexpr int I8_PLANE = 64 * I8_CH + 32;       // bytes of one 64-row chunk plane
constexpr int I8_LDC = BN + 4;                  // epilogue row (ints)

template <int NB> struct I8Geom {
  static constexpr int A_BYTES = (I8_BK / I8_CH) * I8_PLANE;
  static constexpr int B_BYTES = (BN / I8_CH) * I8_PLANE;
  static constexpr int IN_BYTES = A_BYTES + NB * B_BYTES;
  static constexpr int OUT_BYTES = NB * BM * I8_LDC * (int)sizeof(int);
  static constexpr int BYTES = IN_BYTES > OUT_BYTES ? IN_BYTES : OUT_BYTES;
};

// Stage rows [row0, row0 + 64) x cols [col0, col0 + 64) of a row-major int8
// matrix (leading dim ld, valid extent nrows x ncols) as four chunk planes.
// Out-of-range elements read as zero; `vec` (16-byte aligned base, ld a
// multiple of 16) allows one 16-byte load per in-range chunk.  Four
// neighbouring threads read one row's 64 contiguous bytes.
__device__ __forceinline__ void i8_load_tile(signed char* dst, const signed char* __restrict__ src,
                                             int ld, int row0, int col0, int nrows, int ncols,
                                             bool vec) {
  constexpr int CPR = 64 / I8_CH;
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const int gr = row0 + r, gc = col0 + c * I8_CH;
    signed char* d = dst + c * I8_PLANE + r * I8_CH;
    if (vec && gr < nrows && gc + I8_CH <= ncols) {
      *reinterpret_cast<uint4*>(d) =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc));
    } else {
#pragma unroll
      for (int e = 0; e < I8_CH; ++e)
        d[e] = (gr < nrows && gc + e < ncols) ? src[(size_t)gr * ld + gc + e] : (signed char)0;
    }
  }
}

// Tensor-core accumulation: warp w owns rows [16w, 16w + 16) of the tile,
// 4 int32 accumulator fragments per B operand.
template <int NB> struct I8Mma {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> acc[NB][BN / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) nvcuda::wmma::fill_fragment(acc[nb][j], 0);
  }

  __device__ __forceinline__ void step(const signed char* As, const signed char* const* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int kc = 0; kc < I8_BK / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + kc * I8_PLANE + warp * 16 * I8_CH, I8_CH);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs[nb] + j * I8_PLANE + kc * 16 * I8_CH, I8_CH);
          wmma::mma_sync(acc[nb][j], a, b, acc[nb][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(int* const* Cs) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        nvcuda::wmma::store_matrix_sync(Cs[nb] + warp * 16 * I8_LDC + j * 16, acc[nb][j], I8_LDC,
                                        nvcuda::wmma::mem_row_major);
  }
};

// The de-scale of one exact int32 sum, as the JAX kernel's epilogue.
__device__ __forceinline__ float i8_descale(int acc, float a_scale, float b_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), a_scale), b_scale);
}

// C (m x n) = epilogue(A (m x k) . B0 (k x n) [, A . B1]) with int8
// operands; a_scale (m), b0_scale / b1_scale (n) f32.  NB = 2 only for
// ACT_SWIGLU (B0 the gate, B1 the up weight).  grid = (ceil(n / BN),
// ceil(m / BM), splits); with splits > 1 (ACT_NONE only) block z covers k
// in [z k_split, min(k, (z + 1) k_split)) and writes its int32 partial to
// work[z] (m x n) for i8_splitk_reduce_kernel.
template <typename T, int ACT>
__global__ void __launch_bounds__(NTHREADS)
int8_tile_kernel(const signed char* __restrict__ A, const signed char* __restrict__ B0,
                 const signed char* __restrict__ B1, const float* __restrict__ a_scale,
                 const float* __restrict__ b0_scale, const float* __restrict__ b1_scale,
                 T* __restrict__ C, int* __restrict__ work, int m, int n, int k, int k_split,
                 int vec) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  using G = I8Geom<NB>;
  __shared__ __align__(128) unsigned char smem[G::BYTES];

  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * k_split;
  const int k1 = min(k, k0 + k_split);
  signed char* As = reinterpret_cast<signed char*>(smem);
  signed char* Bs[NB];
  const signed char* Bg[NB];
  Bs[0] = As + G::A_BYTES;
  Bg[0] = B0;
  if (NB == 2) {
    Bs[NB - 1] = Bs[0] + G::B_BYTES;
    Bg[NB - 1] = B1;
  }

  I8Mma<NB> mma;
  mma.zero();
  for (int kt = k0; kt < k1; kt += I8_BK) {
    i8_load_tile(As, A, k, row0, kt, m, k1, vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) i8_load_tile(Bs[nb], Bg[nb], n, kt, col0, k1, n, vec);
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }

  int* Cs[NB];
  Cs[0] = reinterpret_cast<int*>(smem);
  if (NB == 2) Cs[NB - 1] = Cs[0] + BM * I8_LDC;
  mma.store(Cs);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= m || gc >= n) continue;
    const int acc = Cs[0][r * I8_LDC + c];
    if (ACT == ACT_NONE && gridDim.z > 1) {
      work[((size_t)blockIdx.z * m + gr) * n + gc] = acc;
      continue;
    }
    const float xs = a_scale[gr];
    float v = i8_descale(acc, xs, b0_scale[gc]);
    if (ACT == ACT_SWIGLU) v = silu(v) * i8_descale(Cs[NB - 1][r * I8_LDC + c], xs, b1_scale[gc]);
    if (ACT == ACT_GELU) v = gelu_tanh(v);
    if (ACT == ACT_RELU2) v = relu2(v);
    C[(size_t)gr * n + gc] = from_f<T>(v);
  }
}

// Sum the int32 split-K partials exactly, then de-scale and round once.
template <typename T>
__global__ void i8_splitk_reduce_kernel(const int* __restrict__ work,
                                        const float* __restrict__ a_scale,
                                        const float* __restrict__ b_scale, T* __restrict__ C,
                                        int m, int n, int splits) {
  const size_t mn = (size_t)m * n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    int s = 0;
    for (int z = 0; z < splits; ++z) s += work[(size_t)z * mn + i];
    C[i] = from_f<T>(i8_descale(s, a_scale[i / n], b_scale[i % n]));
  }
}

}  // namespace repro
