// ssd_chunk: Mamba2's SSD intra-chunk step.  For one sequence-head and one
// chunk of Q steps (x already scaled by dt, seg the within-chunk cumulative
// sum of dt * A):
//   Y = ((C B^T) o L) X     L[i, j] = exp(seg_i - seg_j) for j <= i, else 0
//   S = B^T (decay o X)     decay_q = exp(seg_{Q-1} - seg_q)
// x (lead, nc, Q, P), B / C (lead, nc, Q, N) in bf16 or f32, seg (lead, nc,
// Q) f32; Y like x, S (lead, nc, N, P) in x's type.
//
// Replaces: src/repro/kernels/ssd/kernel.py `ssd_chunk_pallas`
// (`_ssd_chunk_kernel`): the intra-chunk block of every SSM layer's prefill
// (models/ssm.py `apply_ssm`), one launch per layer per prefill pass.
//
// What bounds it on the H100: bytes.  At mamba2-780m's prefill shape (b 4,
// s 1024: 192 sequence-heads, 4 chunks of 256, P 64, N 128, bf16) the
// function is 12.9 GFLOP (the causal half of C B^T and of the Y product,
// and S) over 65.8 MB when B and C are read once per group; 0.020 ms at
// 3.35 TB/s against 0.013 ms at 989 TFLOP/s.
//
// What the design does about it, and what differs from the TPU kernel:
//   * the TPU kernel holds a whole chunk in VMEM, with the f32 Q x Q score
//     tile (256 KB at Q = 256) that 227 KB of shared memory cannot hold.
//     Here a block owns 64 query rows of one chunk and walks the 64-row key
//     tiles up to its diagonal only: the tiles above it are exact zeros and
//     never visited;
//   * each key step computes the 64 x 64 score tile C_q B_k^T, applies the
//     decay with the mask inside the exponent (exp(-1e30) = 0: a masked
//     entry never takes exp of a positive difference), and adds
//     (C B^T o L) X_k to a 64 x P f32 accumulator.  bf16 runs the products
//     on the tensor cores (WMMA, f32 accumulators) and rounds C B^T o L to
//     bf16 before the second; f32 runs full-f32 FMA (no TF32).  The score
//     tile and the accumulator live in shared memory (WMMA fragments have no
//     documented element layout, and the mask is per element);
//   * the chunk state S is computed by separate blocks of the same launch
//     (grid x past the query tiles), 64 state rows each, summing over the
//     chunk's key tiles; in bf16, decay o X rounds to bf16 before the
//     product;
//   * operands are read in place through element strides (three leading
//     dims, the chunk, the row; the last dim contiguous): B and C may be
//     `expand`ed over the heads of a group (stride 0), x and Y permuted
//     views of the model's (b, s, heads, P) layout.  No repeat, no copy;
//   * every edge of Q, N and P is masked: tiles stage zeros past the edge
//     (N and P padded to 16 in shared memory), stores stop at it.
// Simple first: no TMA, no wgmma, no multi-stage pipeline.
#include <cstring>

#include "gemm_tile.cuh"

using namespace repro;

namespace {

constexpr int T64 = 64;  // query rows per Y block, key rows per step, state rows per S block
constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_N = 256, MAX_P = 128;

// Element strides of each operand: three leading dims, the chunk, the row
// (seg: the step).  The last dim of x, B, C, Y and S is contiguous.
struct Strides {
  long long x[5], b[5], c[5], seg[5], y[5], s[5];
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t al128(size_t n) { return (n + 127) / 128 * 128; }

// Shared-memory geometry for N state columns and P head columns: the C and
// B tiles (64 rows, at least 64 columns so a state block can stage 64 of
// B's), the X tile, the f32 score tile, the rounded score tile (bf16 only),
// the f32 accumulator and two 64-entry f32 row vectors.
template <typename T> struct Layout {
  int ldn, ldx, ldp, lds, lda;
  size_t c, b, x, s, p, acc, rows, bytes;
  __host__ __device__ Layout(int N, int P) {
    const int np = round16(N) > T64 ? round16(N) : T64;
    const int pp = round16(P);
    ldn = np + Pad<T>::v;
    ldx = pp + Pad<T>::v;
    ldp = T64 + Pad<T>::v;
    lds = T64 + 4;
    lda = pp + 4;
    size_t o = 0;
    c = o;
    o += al128(sizeof(T) * T64 * ldn);
    b = o;
    o += al128(sizeof(T) * T64 * ldn);
    x = o;
    o += al128(sizeof(T) * T64 * ldx);
    s = o;
    o += al128(sizeof(float) * T64 * lds);
    p = o;
    o += std::is_same<T, float>::value ? 0 : al128(sizeof(T) * T64 * ldp);
    acc = o;
    o += al128(sizeof(float) * T64 * lda);
    rows = o;
    o += al128(sizeof(float) * 2 * T64);
    bytes = o;
  }
};

// Stage rows [r0, r0 + 64) x columns [0, cols) of a matrix whose (r, j)
// element lies at src[r * rs + j] into dst (leading dim ld).  Rows >= nrows
// and columns >= ncols read as zero.  `vec` (decided on the host: aligned
// base, strides multiples of 16 bytes) allows 16-byte loads.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src, long long rs,
                                      int r0, int nrows, int ncols, int cols, bool vec) {
  constexpr int CH = 16 / sizeof(T);
  const int cpr = cols / CH;
  for (int idx = threadIdx.x; idx < T64 * cpr; idx += NTHREADS) {
    const int r = idx / cpr, c = (idx % cpr) * CH, gr = r0 + r;
    T* d = dst + r * ld + c;
    if (gr < nrows && vec && c + CH <= ncols) {
      *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(src + gr * rs + c));
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        d[e] = (gr < nrows && c + e < ncols) ? src[gr * rs + c + e] : from_f<T>(0.0f);
    }
  }
}

// C (64 x ncols, f32, ldc) [+]= A (64 x K) . B (K x ncols), all in shared
// memory.  A(i, k) at A[i * lda + k] (A_COL: A[k * lda + i]); B(k, j) at
// B[k * ldb + j] (B_COL: B[j * ldb + k]).  ncols and K multiples of 16.
// bf16: WMMA tensor-core products, f32 accumulators.
template <bool A_COL, bool B_COL>
__device__ void tile_mma(float* C, int ldc, const __nv_bfloat16* A, int lda,
                         const __nv_bfloat16* B, int ldb, int ncols, int K, bool acc) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  const int tn = ncols / 16, tiles = (T64 / 16) * tn, warp = threadIdx.x / 32;
  for (int t = warp; t < tiles; t += NWARPS) {
    const int i = t / tn, j = t % tn;
    float* cp = C + i * 16 * ldc + j * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc)
      wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      wmma::load_matrix_sync(a, A_COL ? A + kk * lda + i * 16 : A + i * 16 * lda + kk, lda);
      wmma::load_matrix_sync(b, B_COL ? B + j * 16 * ldb + kk : B + kk * ldb + j * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

// f32: full-f32 FMA.  Thread t owns rows (t / 16) * 8 + i and columns
// t % 16 + 16 * j of each 64-column stripe.
template <bool A_COL, bool B_COL>
__device__ void tile_mma(float* C, int ldc, const float* A, int lda, const float* B, int ldb,
                         int ncols, int K, bool acc) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  for (int j0 = 0; j0 < ncols; j0 += T64) {
    const int nj = min(4, (ncols - j0) / 16);
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = (acc && j < nj) ? C[(tr * 8 + i) * ldc + j0 + tc + 16 * j] : 0.0f;
    for (int kk = 0; kk < K; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = A_COL ? A[kk * lda + tr * 8 + i] : A[(tr * 8 + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tc + 16 * j;
        b[j] = j < nj ? (B_COL ? B[col * ldb + kk] : B[kk * ldb + col]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nj) C[(tr * 8 + i) * ldc + j0 + tc + 16 * j] = s[i][j];
  }
}

// grid (ceil(Q / 64) + ceil(N / 64), nc, l0 * l1 * l2).  Blocks x < nqt own
// 64 rows of Y; the rest own 64 rows of S.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ seg, T* __restrict__ y, T* __restrict__ st,
                 Strides sd, int l1, int l2, int Q, int P, int N, int nqt, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> g(N, P);
  T* Cs = reinterpret_cast<T*>(smem + g.c);
  T* Bs = reinterpret_cast<T*>(smem + g.b);
  T* Xs = reinterpret_cast<T*>(smem + g.x);
  float* Ss = reinterpret_cast<float*>(smem + g.s);
  float* Acc = reinterpret_cast<float*>(smem + g.acc);
  float* rq = reinterpret_cast<float*>(smem + g.rows);
  float* rk = rq + T64;
  constexpr bool BF16 = !std::is_same<T, float>::value;
  // the tile the second product reads: C B^T o L rounded to bf16, or in place in f32
  T* Ps = BF16 ? reinterpret_cast<T*>(smem + g.p) : reinterpret_cast<T*>(Ss);
  const int ldp = BF16 ? g.ldp : g.lds;

  const int li = blockIdx.z, chunk = blockIdx.y;
  const long long i0 = li / (l1 * l2), i1 = (li / l2) % l1, i2 = li % l2;
  auto at = [&](const long long* s5) {
    return i0 * s5[0] + i1 * s5[1] + i2 * s5[2] + (long long)chunk * s5[3];
  };
  const T* xb = x + at(sd.x);
  const T* bb = bm + at(sd.b);
  const T* cb = cm + at(sd.c);
  const float* sg = seg + at(sd.seg);
  const long long ss = sd.seg[4];
  const int pp = round16(P), np = round16(N);
  const bool v = vec != 0;

  if ((int)blockIdx.x < nqt) {
    // ---- Y rows [q0, q0 + 64): key tiles up to the diagonal ----
    const int q0 = blockIdx.x * T64;
    stage(Cs, g.ldn, cb, sd.c[4], q0, Q, N, np, v);
    for (int r = threadIdx.x; r < T64; r += NTHREADS) rq[r] = q0 + r < Q ? sg[(q0 + r) * ss] : 0.0f;
    const int kend = min(q0 + T64, Q);
    for (int k0 = 0; k0 < kend; k0 += T64) {
      __syncthreads();
      stage(Bs, g.ldn, bb, sd.b[4], k0, Q, N, np, v);
      stage(Xs, g.ldx, xb, sd.x[4], k0, Q, P, pp, v);
      for (int r = threadIdx.x; r < T64; r += NTHREADS)
        rk[r] = k0 + r < Q ? sg[(k0 + r) * ss] : 0.0f;
      __syncthreads();
      tile_mma<false, true>(Ss, g.lds, Cs, g.ldn, Bs, g.ldn, T64, np, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < T64 * T64; idx += NTHREADS) {
        const int r = idx / T64, j = idx % T64, qi = q0 + r, kj = k0 + j;
        // the mask inside the exponent; kj < Q follows from kj <= qi < Q
        const bool live = kj <= qi && qi < Q;
        const float w = Ss[r * g.lds + j] * expf(live ? rq[r] - rk[j] : NEG_INF);
        Ps[r * ldp + j] = from_f<T>(w);
      }
      __syncthreads();
      tile_mma<false, false>(Acc, g.lda, Ps, ldp, Xs, g.ldx, pp, T64, k0 > 0);
    }
    __syncthreads();
    T* yb = y + at(sd.y);
    for (int idx = threadIdx.x; idx < T64 * P; idx += NTHREADS) {
      const int r = idx / P, c = idx % P;
      if (q0 + r < Q) yb[(q0 + r) * sd.y[4] + c] = from_f<T>(Acc[r * g.lda + c]);
    }
  } else {
    // ---- S rows [n0, n0 + 64): every key tile of the chunk ----
    const int n0 = (blockIdx.x - nqt) * T64;
    const float last = sg[(Q - 1) * ss];
    for (int k0 = 0; k0 < Q; k0 += T64) {
      __syncthreads();
      stage(Bs, g.ldn, bb + n0, sd.b[4], k0, Q, N - n0, T64, v);
      stage(Xs, g.ldx, xb, sd.x[4], k0, Q, P, pp, v);
      for (int r = threadIdx.x; r < T64; r += NTHREADS)
        rq[r] = k0 + r < Q ? expf(last - sg[(k0 + r) * ss]) : 0.0f;
      __syncthreads();
      for (int idx = threadIdx.x; idx < T64 * pp; idx += NTHREADS) {
        const int r = idx / pp, c = idx % pp;
        Xs[r * g.ldx + c] = from_f<T>(to_f(Xs[r * g.ldx + c]) * rq[r]);
      }
      __syncthreads();
      tile_mma<true, false>(Acc, g.lda, Bs, g.ldn, Xs, g.ldx, pp, T64, k0 > 0);
    }
    __syncthreads();
    T* sb = st + at(sd.s);
    for (int idx = threadIdx.x; idx < T64 * P; idx += NTHREADS) {
      const int r = idx / P, c = idx % P;
      if (n0 + r < N) sb[(n0 + r) * sd.s[4] + c] = from_f<T>(Acc[r * g.lda + c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* b, const void* c, const void* seg, void* y, void* st,
                   const Strides& sd, int l0, int l1, int l2, int nc, int Q, int P, int N, int vec,
                   cudaStream_t s) {
  const Layout<T> g(N, P);
  auto* k = ssd_chunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g.bytes);
  if (err != cudaSuccess) return err;
  const int nqt = (Q + T64 - 1) / T64, nnt = (N + T64 - 1) / T64;
  dim3 grid(nqt + nnt, nc, l0 * l1 * l2);
  k<<<grid, NTHREADS, g.bytes, s>>>(static_cast<const T*>(x), static_cast<const T*>(b),
                                    static_cast<const T*>(c), static_cast<const float*>(seg),
                                    static_cast<T*>(y), static_cast<T*>(st), sd, l1, l2, Q, P, N,
                                    nqt, vec);
  return cudaGetLastError();
}

}  // namespace

// x (l0, l1, l2, nc, Q, P), B / C (l0, l1, l2, nc, Q, N) bf16 or f32 with
// the element strides of `strides` (30: x, B, C, seg, Y, S; each three
// leading dims, the chunk and the row); seg (l0, l1, l2, nc, Q) f32; Y like
// x; S (l0, l1, l2, nc, N, P).  N <= 256, P <= 128, nc and l0 l1 l2 <= 65535.
extern "C" int repro_ssd_chunk(const void* x, const void* b, const void* c, const void* seg,
                               void* y, void* st, const long long* strides, int l0, int l1,
                               int l2, int nc, int Q, int P, int N, int dtype, int vec,
                               void* stream) {
  if (l0 <= 0 || l1 <= 0 || l2 <= 0 || nc <= 0 || Q <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      P > MAX_P || nc > 65535 || (long long)l0 * l1 * l2 > 65535)
    return (int)cudaErrorInvalidValue;
  Strides sd;
  std::memcpy(&sd, strides, sizeof(sd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, b, c, seg, y, st, sd, l0, l1, l2, nc, Q, P, N, vec, s);
  if (dtype == DT_F32)
    return (int)launch<float>(x, b, c, seg, y, st, sd, l0, l1, l2, nc, Q, P, N, vec, s);
  return (int)cudaErrorInvalidValue;
}
