// ssd_chunk_bwd: the gradient of Mamba2's SSD intra-chunk step
// (csrc/ssd_chunk.cu).  For one sequence-head and one chunk of Q steps, with
// A = (C B^T) o L, L_ij = exp(seg_i - seg_j) for j <= i and d_k =
// exp(seg_{Q-1} - seg_k), from the cotangents dY of Y = A X and dS of
// S = B^T (d o X):
//   dX = A^T dY + d o (B dS)
//   dC = (dA o L) B                  dA = mask o (dY X^T)
//   dB = (dA o L)^T C + (d o X) dS^T
//   dseg_i = sum_j G_ij - sum_j G_ji - e_i (+ sum_k e_k at i = Q - 1)
//            G = dA o A,  e_k = d_k sum_p X_kp (B dS)_kp
// x, dY (lead, nc, Q, P), B / C (lead, nc, Q, N) in bf16 or f32, seg (lead,
// nc, Q) f32, dS (lead, nc, N, P); dX, dB, dC in the operands' type (dB and
// dC per head: where B and C are expanded over the heads, autograd's expand
// backward sums the heads), dseg f32.
//
// Replaces: no Pallas kernel.  The JAX package takes this gradient by XLA's
// autodiff of the model's einsums (src/repro/models/ssm.py:136-145); its
// Pallas kernel (src/repro/kernels/ssd/kernel.py `ssd_chunk_pallas`) has no
// backward.  One launch per SSM layer per training step, behind
// kernels/ssd/ops.py `_SSDChunk`.
//
// What bounds it on the H100: bytes.  At mamba2-780m's training shape (b 4,
// s 1024: 192 sequence-heads, 4 chunks of 256, P 64, N 128, bf16) the
// gradient is 26.0 GFLOP (the causal half of C B^T once per group, of dY
// X^T, dC, dB and dX per head, and the chunk-state products) over 192 MB,
// 101 MB of it the per-head dB and dC; 0.057 ms at 3.35 TB/s against 0.026
// ms at 989 TFLOP/s.  This first kernel is the simple one: CUDA-core f32
// FMA (67 TFLOP/s at best), the scores formed twice and C B^T per head, so
// the FMA pipes and shared-memory loads bound it, at 4.24 ms 74x the bytes'
// bound (H100 80GB HBM3, 700 W; PERF.md, section 6).
//
// Design (both types; no tensor-core product, no atomics, deterministic):
//   * one block of 256 threads owns one (sequence-head, chunk) and computes
//     all its outputs, so no sum crosses blocks: dseg's row sums, column
//     sums and the chunk-state term meet in the block (the row sums parked
//     in dseg itself between the two phases, by the thread that reads them
//     back);
//   * phase A walks the query tiles (64 rows): for each key tile up to the
//     diagonal it forms C_q B_k^T and dY_q X_k^T in f32, weighs dY X^T by L
//     (the mask skips the exponential: no exp of a positive difference),
//     sums G's rows and accumulates dC_q += (dA o L) B_k;
//   * phase B walks the key tiles: for each query tile from the diagonal on
//     it forms the same two tiles again, keeps A and dA o L, sums G's
//     columns and accumulates dX_k += A^T dY_q and dB_k += (dA o L)^T C_q;
//     then the chunk-state terms of its rows, with dS staged 64 state rows
//     at a time: B_k dS, dB_k += d o (X_k dS^T), dX_k += d o (B_k dS), e_k;
//   * operands are staged from their strides (three leading dims, the
//     chunk, the row; the last dim contiguous) into shared memory in their
//     own type, rows past Q and columns past N or P as zeros, rows padded
//     to an odd number of 32-bit words so that column reads do not collide
//     in a bank; products and sums are full f32 FMA from shared memory (no
//     TF32), each thread owning a 4 x 4 piece of every 64-column stripe;
//     the outputs round once, as the plain version's do.
// The wrapper (kernels/ssd/ops.py) reads the shared memory a launch takes
// (`repro_ssd_chunk_bwd_smem`) and refuses shapes past the card's 227 KB.
#include <cstring>

#include "gemm_tile.cuh"

using namespace repro;

namespace {

constexpr int T64 = 64;        // rows of a query tile, a key tile, a slice of dS
constexpr int NT = 256;        // threads a block
constexpr int LDT = T64 + 1;   // the f32 score tiles' leading dim: odd, column reads hit 32 banks
constexpr int NVEC = 10;       // 64-float vectors: rq, rk, d, four partial sums, row/column sums, e
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t al128(size_t n) { return (n + 127) / 128 * 128; }
__host__ __device__ inline size_t mx(size_t a, size_t b) { return a > b ? a : b; }

// Element strides of each operand: three leading dims, the chunk, the row
// (seg, dseg: the step).  The last dim of the matrices is contiguous.
struct BwdStrides {
  long long x[5], b[5], c[5], seg[5], dy[5], ds[5], dx[5], db[5], dc[5], dseg[5];
};

// Shared memory of a block (byte offsets), for N state and P head columns
// of esize-byte operands.  Operand tiles C, B, X, dY (T, rows padded to an
// odd number of words); the f32 tiles S and D (64 x 64), whose space the
// chunk-state step reuses for a 64-row slice of dS (T) and B dS (f32); the
// f32 accumulators, dC in phase A, dX and dB in phase B; the vectors.
struct BwdLayout {
  int ldn, ldp, lan, lap;
  size_t c, b, x, dy, s, d, ds, bds, acc, acc2, vec, bytes;
  __host__ __device__ BwdLayout(int N, int P, int esize) {
    const int np = round16(N), pp = round16(P), pad = esize == 4 ? 1 : 2;
    ldn = np + pad;
    ldp = pp + pad;
    lan = np + 1;
    lap = pp + 1;
    const size_t tn = al128((size_t)T64 * ldn * esize), tp = al128((size_t)T64 * ldp * esize);
    const size_t tile = al128(sizeof(float) * T64 * LDT);
    const size_t an = al128(sizeof(float) * T64 * lan), ap = al128(sizeof(float) * T64 * lap);
    size_t o = 0;
    c = o;
    o += tn;
    b = o;
    o += tn;
    x = o;
    o += tp;
    dy = o;
    o += tp;
    s = o;
    d = o + tile;
    ds = o;
    bds = o + tp;
    o += mx(2 * tile, tp + ap);
    acc = o;
    acc2 = o + ap;
    o += mx(an, ap + an);
    vec = o;
    o += al128(sizeof(float) * T64 * NVEC);
    bytes = o;
  }
};

template <typename T> struct BwdArgs {
  const T *x, *b, *c;
  const float* seg;
  const T *dy, *ds;
  T *dx, *db, *dc;
  float* dseg;
  BwdStrides sd;
  int l1, l2, nc, Q, P, N;
};

// Rows [r0, r0 + 64) x columns [0, cols) of a row-strided matrix (row i at
// src + i * rs, d valid columns) into dst (leading dim ld); rows >= nrows
// and columns >= d as zeros.  Consecutive threads along a row.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long rs, int r0,
                                      int nrows, int d, int cols) {
  for (int i = threadIdx.x; i < T64 * cols; i += NT) {
    const int r = i / cols, c = i % cols, g = r0 + r;
    dst[r * ld + c] = (g < nrows && c < d) ? src[g * rs + c] : from_f<T>(0.0f);
  }
}

// Rows [r0, min(r0 + 64, nrows)) x columns [0, d) of an f32 tile (leading
// dim ld) rounded into a row-strided output.
template <typename T>
__device__ __forceinline__ void store(T* out, long long rs, const float* acc, int ld, int r0,
                                      int nrows, int d) {
  for (int i = threadIdx.x; i < T64 * d; i += NT) {
    const int r = i / d, c = i % d;
    if (r0 + r < nrows) out[(r0 + r) * rs + c] = from_f<T>(acc[r * ld + c]);
  }
}

// C (64 x ncols, f32, leading dim ldc) = [C +] rscale o (A . B) over K:
// A(i, k) at A[i * lda + k] (AT: A[k * lda + i]), B(k, j) at B[k * ldb + j]
// (BT: B[j * ldb + k]); rscale (optional) weighs the product's rows.
// ncols is a multiple of 16.  Thread t owns rows 4 (t / 16) + i and columns
// t % 16 + 16 j of every 64-column stripe: the same elements in every call
// with the same ncols stripes, so a thread accumulates its own.
template <bool AT, bool BT, typename TA, typename TB>
__device__ __forceinline__ void mm(float* C, int ldc, const TA* A, int lda, const TB* B, int ldb,
                                   int ncols, int K, bool acc, const float* rscale = nullptr) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  for (int j0 = 0; j0 < ncols; j0 += T64) {
    const int nj = min(4, (ncols - j0) / 16);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int kk = 0; kk < K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        av[i] = to_f(AT ? A[kk * lda + r] : A[r * lda + kk]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tc + 16 * j;
        bv[j] = j < nj ? to_f(BT ? B[col * ldb + kk] : B[kk * ldb + col]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const float w = rscale ? rscale[r] : 1.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= nj) continue;
        float& o = C[r * ldc + j0 + tc + 16 * j];
        o = acc ? o + w * s[i][j] : w * s[i][j];
      }
    }
  }
}

// grid: l0 l1 l2 x nc blocks, one (sequence-head, chunk) each
template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout g(a.N, a.P, sizeof(T));
  T* Cs = reinterpret_cast<T*>(smem + g.c);
  T* Bs = reinterpret_cast<T*>(smem + g.b);
  T* Xs = reinterpret_cast<T*>(smem + g.x);
  T* dYs = reinterpret_cast<T*>(smem + g.dy);
  float* S = reinterpret_cast<float*>(smem + g.s);
  float* D = reinterpret_cast<float*>(smem + g.d);
  T* dSs = reinterpret_cast<T*>(smem + g.ds);
  float* BdS = reinterpret_cast<float*>(smem + g.bds);
  float* dC = reinterpret_cast<float*>(smem + g.acc);
  float* dX = dC;
  float* dB = reinterpret_cast<float*>(smem + g.acc2);
  float* rq = reinterpret_cast<float*>(smem + g.vec);
  float* rk = rq + T64;
  float* dd = rk + T64;
  float* part = dd + T64;       // 4 x 64 partial sums
  float* sums = part + 4 * T64; // G's row sums (phase A), column sums (phase B)
  float* ev = sums + T64;       // e of the key tile's rows

  const BwdStrides& sd = a.sd;
  const int chunk = blockIdx.x % a.nc, li = blockIdx.x / a.nc;
  const long long i2 = li % a.l2, i1 = li / a.l2 % a.l1, i0 = li / (a.l2 * a.l1);
  auto at = [&](const long long* s5) {
    return i0 * s5[0] + i1 * s5[1] + i2 * s5[2] + (long long)chunk * s5[3];
  };
  const T *xb = a.x + at(sd.x), *bb = a.b + at(sd.b), *cb = a.c + at(sd.c);
  const T *dyb = a.dy + at(sd.dy), *dsb = a.ds + at(sd.ds);
  const float* sg = a.seg + at(sd.seg);
  T *dxb = a.dx + at(sd.dx), *dbb = a.db + at(sd.db), *dcb = a.dc + at(sd.dc);
  float* dsegb = a.dseg + at(sd.dseg);
  const long long ss = sd.seg[4], sds = sd.dseg[4];
  const int Q = a.Q, P = a.P, N = a.N, np = round16(N), pp = round16(P);
  const int nqt = (Q + T64 - 1) / T64, t = threadIdx.x;

  // ---- phase A: query tile qt; key tiles 0 .. qt ----
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * T64;
    __syncthreads();  // the previous tile's readers are done
    stage(Cs, g.ldn, cb, sd.c[4], q0, Q, N, np);
    stage(dYs, g.ldp, dyb, sd.dy[4], q0, Q, P, pp);
    if (t < T64) {
      rq[t] = q0 + t < Q ? sg[(q0 + t) * ss] : 0.0f;
      sums[t] = 0.0f;
    }
    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * T64;
      if (kt > 0) __syncthreads();  // the previous step's readers of B, X, S, D are done
      stage(Bs, g.ldn, bb, sd.b[4], k0, Q, N, np);
      stage(Xs, g.ldp, xb, sd.x[4], k0, Q, P, pp);
      if (t < T64) rk[t] = k0 + t < Q ? sg[(k0 + t) * ss] : 0.0f;
      __syncthreads();
      mm<false, true>(S, LDT, Cs, g.ldn, Bs, g.ldn, T64, np, false);   // C_q B_k^T
      mm<false, true>(D, LDT, dYs, g.ldp, Xs, g.ldp, T64, pp, false);  // dY_q X_k^T
      __syncthreads();
      {
        // D <- dA o L; G's row sums: row t % 64, columns 16 (t / 64) + [0, 16)
        const int r = t % T64, c0 = t / T64 * 16, qi = q0 + r;
        float sum = 0.0f;
        for (int c = c0; c < c0 + 16; ++c) {
          float dal = 0.0f;
          if (k0 + c <= qi && qi < Q) {  // live: the mask skips the exponential
            dal = D[r * LDT + c] * expf(rq[r] - rk[c]);
            sum = fmaf(dal, S[r * LDT + c], sum);
          }
          D[r * LDT + c] = dal;
        }
        part[t / T64 * T64 + r] = sum;
      }
      __syncthreads();
      if (t < T64) sums[t] += part[t] + part[T64 + t] + part[2 * T64 + t] + part[3 * T64 + t];
      mm<false, false>(dC, g.lan, D, LDT, Bs, g.ldn, np, T64, kt > 0);  // dC_q += (dA o L) B_k
    }
    __syncthreads();
    store(dcb, sd.dc[4], dC, g.lan, q0, Q, N);
    if (t < T64 && q0 + t < Q) dsegb[(q0 + t) * sds] = sums[t];  // read back by thread t in phase B
  }

  // ---- phase B: key tile kt; query tiles kt .. nqt - 1, then the chunk state ----
  const float last = sg[(Q - 1) * ss];
  float esum = 0.0f;  // thread 0's sum of every row's e
  for (int kt = 0; kt < nqt; ++kt) {
    const int k0 = kt * T64;
    __syncthreads();
    stage(Bs, g.ldn, bb, sd.b[4], k0, Q, N, np);
    stage(Xs, g.ldp, xb, sd.x[4], k0, Q, P, pp);
    if (t < T64) {
      rk[t] = k0 + t < Q ? sg[(k0 + t) * ss] : 0.0f;
      sums[t] = 0.0f;
    }
    for (int qt = kt; qt < nqt; ++qt) {
      const int q0 = qt * T64;
      if (qt > kt) __syncthreads();
      stage(Cs, g.ldn, cb, sd.c[4], q0, Q, N, np);
      stage(dYs, g.ldp, dyb, sd.dy[4], q0, Q, P, pp);
      if (t < T64) rq[t] = q0 + t < Q ? sg[(q0 + t) * ss] : 0.0f;
      __syncthreads();
      mm<false, true>(S, LDT, Cs, g.ldn, Bs, g.ldn, T64, np, false);
      mm<false, true>(D, LDT, dYs, g.ldp, Xs, g.ldp, T64, pp, false);
      __syncthreads();
      {
        // S <- A, D <- dA o L; G's column sums: column t % 64, rows 16 (t / 64) + [0, 16)
        const int c = t % T64, r0 = t / T64 * 16, kj = k0 + c;
        float sum = 0.0f;
        for (int r = r0; r < r0 + 16; ++r) {
          const int qi = q0 + r;
          float av = 0.0f, dal = 0.0f;
          if (kj <= qi && qi < Q) {
            const float L = expf(rq[r] - rk[c]), sc = S[r * LDT + c];
            av = sc * L;
            dal = D[r * LDT + c] * L;
            sum = fmaf(dal, sc, sum);
          }
          S[r * LDT + c] = av;
          D[r * LDT + c] = dal;
        }
        part[t / T64 * T64 + c] = sum;
      }
      __syncthreads();
      if (t < T64) sums[t] += part[t] + part[T64 + t] + part[2 * T64 + t] + part[3 * T64 + t];
      mm<true, false>(dX, g.lap, S, LDT, dYs, g.ldp, pp, T64, qt > kt);  // dX_k += A^T dY_q
      mm<true, false>(dB, g.lan, D, LDT, Cs, g.ldn, np, T64, qt > kt);   // dB_k += (dA o L)^T C_q
    }
    __syncthreads();  // S, D, C, dY free: their space takes dS and B dS
    if (t < T64) dd[t] = k0 + t < Q ? expf(last - rk[t]) : 0.0f;
    for (int n0 = 0; n0 < np; n0 += T64) {
      const int nw = min(T64, np - n0);
      if (n0 > 0) __syncthreads();
      stage(dSs, g.ldp, dsb, sd.ds[4], n0, N, P, pp);  // dS rows [n0, n0 + 64)
      __syncthreads();
      mm<false, false>(BdS, g.lap, Bs + n0, g.ldn, dSs, g.ldp, pp, nw, n0 > 0);  // B_k dS
      mm<false, true>(dB + n0, g.lan, Xs, g.ldp, dSs, g.ldp, nw, pp, true, dd);  // d o (X_k dS^T)
    }
    __syncthreads();
    {
      // e's partial sums: row t % 64, columns pp / 4 (t / 64) + [0, pp / 4)
      const int r = t % T64, w = pp / 4, c0 = t / T64 * w;
      float sum = 0.0f;
      for (int c = c0; c < c0 + w; ++c)
        sum = fmaf(to_f(Xs[r * g.ldp + c]), BdS[r * g.lap + c], sum);
      part[t / T64 * T64 + r] = sum;
    }
    __syncthreads();
    if (t < T64) {
      const float e = dd[t] * (part[t] + part[T64 + t] + part[2 * T64 + t] + part[3 * T64 + t]);
      ev[t] = e;
      if (k0 + t < Q) dsegb[(k0 + t) * sds] -= sums[t] + e;
    }
    for (int i = t; i < T64 * pp; i += NT) {
      const int r = i / pp, c = i % pp;
      dX[r * g.lap + c] = fmaf(dd[r], BdS[r * g.lap + c], dX[r * g.lap + c]);
    }
    __syncthreads();
    if (t == 0)
      for (int r = 0; r < T64; ++r) esum += ev[r];
    store(dxb, sd.dx[4], dX, g.lap, k0, Q, P);
    store(dbb, sd.db[4], dB, g.lan, k0, Q, N);
  }
  __syncthreads();
  if (t == 0) dsegb[(Q - 1) * sds] += esum;
}

template <typename T>
cudaError_t launch(const BwdArgs<T>& a, long long blocks, cudaStream_t st) {
  const BwdLayout g(a.N, a.P, sizeof(T));
  if (g.bytes > (size_t)MAX_SMEM || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* k = ssd_chunk_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g.bytes);
  if (err != cudaSuccess) return err;
  k<<<(unsigned)blocks, NT, g.bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* b, const void* c, const void* seg,
                         const void* dy, const void* ds, void* dx, void* db, void* dc, void* dseg,
                         const BwdStrides& sd, int l0, int l1, int l2, int nc, int Q, int P, int N,
                         cudaStream_t st) {
  BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
               static_cast<const float*>(seg), static_cast<const T*>(dy),
               static_cast<const T*>(ds), static_cast<T*>(dx), static_cast<T*>(db),
               static_cast<T*>(dc), static_cast<float*>(dseg), sd, l1, l2, nc, Q, P, N};
  return launch(a, (long long)l0 * l1 * l2 * nc, st);
}

}  // namespace

// The shared memory a launch takes (kernels/ssd/ops.py refuses a shape past
// the card's limit before launching).
extern "C" long long repro_ssd_chunk_bwd_smem(int N, int P, int dtype) {
  return (long long)BwdLayout(N, P, dtype == DT_F32 ? 4 : 2).bytes;
}

// x, dY (l0, l1, l2, nc, Q, P), B / C (l0, l1, l2, nc, Q, N), dS (l0, l1,
// l2, nc, N, P) in bf16 or f32, seg (l0, l1, l2, nc, Q) f32, with the
// element strides of `strides` (50: x, B, C, seg, dY, dS, dX, dB, dC, dseg;
// each three leading dims, the chunk and the row).  dX like x, dB and dC
// like B (per head), dseg like seg, f32.
extern "C" int repro_ssd_chunk_bwd(const void* x, const void* b, const void* c, const void* seg,
                                   const void* dy, const void* ds, void* dx, void* db, void* dc,
                                   void* dseg, const long long* strides, int l0, int l1, int l2,
                                   int nc, int Q, int P, int N, int dtype, void* stream) {
  if (l0 <= 0 || l1 <= 0 || l2 <= 0 || nc <= 0 || Q <= 0 || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  BwdStrides sd;
  std::memcpy(&sd, strides, sizeof(sd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch_typed<float>(x, b, c, seg, dy, ds, dx, db, dc, dseg, sd, l0, l1, l2, nc,
                                    Q, P, N, s);
  if (dtype == DT_BF16)
    return (int)launch_typed<__nv_bfloat16>(x, b, c, seg, dy, ds, dx, db, dc, dseg, sd, l0, l1,
                                            l2, nc, Q, P, N, s);
  return (int)cudaErrorInvalidValue;
}
