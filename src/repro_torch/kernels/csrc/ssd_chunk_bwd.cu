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
// backward.  One wrapper call per SSM layer per training step, behind
// kernels/ssd/ops.py `_SSDChunk`.
//
// What bounds it on the H100: bytes.  At mamba2-780m's training shape (b 4,
// s 1024: 192 sequence-heads, 4 chunks of 256, P 64, N 128, bf16) the
// gradient is 25.98 GFLOP (the causal half of C B^T once per group, of dY
// X^T, dC, dB and dX per head, and the chunk-state products) over 93.8 MB
// (B, C, dB and dC once per group); 0.0280 ms at 3.35 TB/s against 0.0263
// ms at 989 TFLOP/s.  The per-head dB and dC this kernel writes are 98.6 MB
// more (0.029 ms).  The first port (CUDA-core f32 FMA, the scores formed
// twice and per head) took 4.20 ms, 150x that bound (PERF.md, section 6).
//
// What the design does about it (bf16, sm_90a: `ssd_bwd_keys`, then
// `ssd_bwd_queries` on the same stream; one wrapper call):
//   * two walks on `wgmma`, as flash's backward, so that no sum crosses a
//     block.  The key walk: a warpgroup owns one key tile of one head and
//     walks the query tiles from its diagonal; S^T = B_k C_q^T and dP^T =
//     X_k dY_q^T are `wgmma` chains into f32 registers, each thread weighs
//     its own elements by L^T (as the forward: 2^(seg_q log2(e) - seg_k
//     log2(e)), one FFMA and one ex2, the mask inside the exponent on the
//     diagonal and ragged tiles only), and A^T and (dA o L)^T, rounded to
//     bf16, are the register A operands of dX += A^T dY_q and dB += (dA o
//     L)^T C_q, whose accumulators stay in registers for the walk; G's
//     column sums are taken in f32 from the f32 tiles.  Its accumulators
//     take 96 registers a thread, so a query step runs in two halves of 32
//     query columns, each waited before the next (with both in flight ptxas
//     lacks registers and serializes every product, C7511).  A head's first
//     step is the chunk state: B_k dS by `wgmma` into dX's layout, e_k from
//     it and X_k, dX = d o (B_k dS) and dB = d o (X_k dS^T), exact in f32.  The
//     query walk: a warpgroup owns one query tile of one head and walks the
//     key tiles up to its diagonal: S = C_q B_k^T, dP = dY_q X_k^T, dA o L
//     (bf16) the register A operand of dC += (dA o L) B_k; G's row sums;
//   * dseg without atomics: the key walk writes -(column sums) - e and each
//     key tile's sum of e (a scratch vector); the query walk, in stream
//     order, adds its row sums and, at row Q - 1, the tiles' sums of e in
//     order.  Each element is written by one block, so two calls give the
//     same bits;
//   * C B^T once per slab of heads where B and C have stride 0 over the
//     heads (the model's expanded views): a block's two warpgroups first
//     compute its tile's score tiles (at most four of 16 KB at Q = 256)
//     into shared memory, each thread keeping its own accumulator elements
//     in place, then take the slab's heads in turn, each head weighing the
//     same f32 scores by its own L (both warpgroups issue every score
//     product: a product under a branch on the warpgroup makes ptxas
//     serialize them all, C7520).  Elsewhere (the flat (bh, ...) layout,
//     Q > 256, or a shape whose shared scores do not fit) each warpgroup
//     forms its head's scores by the same products in the same order, so
//     both layouts give the same bits;
//   * every tile comes through a ring of cp.async copies in sm90.cuh's
//     128-byte swizzle, the next step in flight while this one computes,
//     one barrier of the warpgroup a step; a head's own tiles (X_k, or dY_q)
//     alternate between two buffers so the next head's stage early.
//     Copies are 16 bytes wide where the operand's alignment allows (the
//     host decides; each thread's swizzle fixed, its index arithmetic
//     hoisted), else element by element; rows past Q and columns past N or
//     P arrive as zeros and are never stored.  What a head's end needs from
//     device memory (seg_{Q-1}; dseg as the key walk left it, e's sums) is
//     read at its start, so no step waits on a dependent load;
//   * blocks: (key or query tile) x column slice x slab x chunk x leading
//     dims, the longest walks first; dX comes in 64-column slices and dB
//     and dC in 64- or 128-column ones (P <= 128, N <= 256: a wider shape
//     takes more blocks, each forming the scores and dP over all of N and
//     P).  The slab, the grid and the shared memory come from the wrapper
//     (kernels/ssd/ops.py `bwd_launch_shape`; the slab from
//     `tuning/ssd_bwd_tiles.py`'s sweep on the card).
//
// f32 (a check dtype; `ssd_chunk_bwd_kernel<float>`) keeps the first
// port's design: CUDA-core f32 FMA from shared memory (no TF32), one block
// of 256 threads per (sequence-head, chunk), which owns all its outputs:
//   * phase A walks the query tiles (64 rows): for each key tile up to the
//     diagonal it forms C_q B_k^T and dY_q X_k^T in f32, weighs dY X^T by L
//     (the mask skips the exponential: no exp of a positive difference),
//     sums G's rows and accumulates dC_q += (dA o L) B_k;
//   * phase B walks the key tiles: for each query tile from the diagonal on
//     it forms the same two tiles again, keeps A and dA o L, sums G's
//     columns and accumulates dX_k += A^T dY_q and dB_k += (dA o L)^T C_q;
//     then the chunk-state terms of its rows, with dS staged 64 state rows
//     at a time: B_k dS, dB_k += d o (X_k dS^T), dX_k += d o (B_k dS), e_k;
//     dseg's row sums are parked in dseg itself between the two phases;
//   * operands are staged from their strides into shared memory, rows past
//     Q and columns past N or P as zeros, rows padded to an odd number of
//     32-bit words so that column reads do not collide in a bank; each
//     thread owns a 4 x 4 piece of every 64-column stripe; the outputs
//     round once, as the plain version's do.
// The wrapper computes the f32 kernel's shared memory (kernels/ssd/ops.py
// `bwd_smem_f32` mirrors `BwdLayout`; the entry re-checks it) and refuses
// shapes past the card's 227 KB.
#include <cstring>

#include "gemm_tile.cuh"
#include "ssd_sm90.cuh"

using namespace repro;
using namespace ssd;

namespace {

constexpr int NT = 256;        // threads a block of the f32 kernel
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

// ---- f32: ssd_chunk_bwd_kernel<float> ----------------------------------------------------

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


// ---- bf16: ssd_bwd_keys, then ssd_bwd_queries (sm_90a) ------------------------------------

using sm90::bf16;

constexpr int WG = 2;                  // warpgroups a block
constexpr int NT90 = 128 * WG;
constexpr int STAGES = 2;              // ring slots: the next step's copies in flight
constexpr int MAX_SHARED_TILES = 4;    // score tiles a block keeps: Q <= 256
constexpr int SCORE_BYTES = T64 * T64 * 4;
constexpr int SEG_AREA = 2048;         // a region's seg vectors (two heads, two slots) and sums

// The bf16 launch's geometry (kernels/ssd/ops.py `bwd_smem` computes the
// same).  x and dY stage px columns (P in whole 64-column atoms: dX in
// 64-column slices); B and C stage nb columns and dS nb rows (N in whole
// dnw-column slices, dnw 64 or 128: dB and dC in dnw-column slices); a
// block owns one slice of each (nslice blocks a tile).  A warpgroup's
// region: two head buffers (alternating by head, so the next head's stage
// while this one's last step computes), STAGES ring slots, the seg vectors.
//   keys (ssd_bwd_keys): head buffer X_k (+ B_k per head), slot C_q and
//     dY_q or dS; shared scores: nqt f32 score tiles and B_k once a block;
//   queries (ssd_bwd_queries): head buffer dY_q (+ C_q per head), slot X_k
//     and B_k; shared scores: nqt score tiles, and while they are made C_q
//     and two B tiles in the regions' space.
// Slack of 1024 bytes aligns the tiles.
struct BwdGeom {
  int nqt, px, dnw, nb, nxs, nns, nslice;
  size_t khead, kslot, kregion, qhead, qslot, qregion, keys, queries;
  __host__ __device__ BwdGeom(int Q, int P, int N, bool shared, int nwg) {
    nqt = (Q + T64 - 1) / T64;
    px = (P + 63) / 64 * 64;
    dnw = N <= 64 ? 64 : 128;
    nns = (N + dnw - 1) / dnw;
    nb = nns * dnw;
    nxs = px / 64;
    nslice = nxs > nns ? nxs : nns;
    const size_t tx = tile_bytes(px), tb = tile_bytes(nb), ds = (size_t)nb * px * 2;
    khead = tx + (shared ? 0 : tb);
    kslot = mx(tb + tx, ds);
    kregion = 2 * khead + STAGES * kslot + SEG_AREA;
    keys = (shared ? (size_t)nqt * SCORE_BYTES + tb : 0) + nwg * kregion + 1024;
    qhead = tx + (shared ? 0 : tb);
    qslot = tb + tx;
    qregion = 2 * qhead + STAGES * qslot + SEG_AREA;
    queries = (shared ? (size_t)nqt * SCORE_BYTES + mx(3 * tb, nwg * qregion) : nwg * qregion) + 1024;
  }
};

struct Bwd90Args {
  const bf16 *x, *b, *c;
  const float* seg;
  const bf16 *dy, *ds;
  bf16 *dx, *db, *dc;
  float *dseg, *esum;
  BwdStrides sd;
  int l1, l2, l01, nc, Q, P, N;
  int heads, nslab, nwg;
  int wx, wb, wc, wdy, wds;  // copy widths (bytes) of x, B, C, dY, dS
};

// A warpgroup's ring of STAGES slots over `steps` steps: fill(i, slot)
// issues step i's copies, body(i, slot) computes step i while step i + 1's
// copies are in flight.  One barrier of the warpgroup a step, after which
// the slot (and the head buffer) read in the step before is refilled.
template <typename Fill, typename Body>
__device__ __forceinline__ void ring(int steps, Fill&& fill, Body&& body) {
  if (steps > 0) fill(0, 0);
  sm90::cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    sm90::cp_async_wait<0>();  // this thread's copies of step i landed
    sm90::fence_async_smem();
    wg_sync();
    if (i + 1 < steps) fill(i + 1, (i + 1) % STAGES);
    sm90::cp_async_commit();
    body(i, i % STAGES);
  }
}

// Element offset of (r, c) in a swizzled tile of R rows (sm90.cuh swz_off).
__device__ __forceinline__ int swz(int R, int r, int c) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}
// A swizzled tile of R rows as a K-major operand at k step kk from row r0
// (a multiple of 8), or as an MN-major one from column c0 (a multiple of 64).
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int R, int kk, int r0) {
  return sm90::desc(tile + (kk >> 2) * (R * 64) + r0 * 64 + (kk & 3) * 16, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int R, int kk, int c0) {
  return sm90::desc(tile + (c0 >> 6) * (R * 64) + kk * 16 * 64, R * 128, 1024);
}

// Stage rows [r0, r0 + R) x columns [0, cols) (a multiple of 64) of a
// row-strided matrix (row i at src + i * rs, d valid columns) into a
// swizzled tile of R rows; rows >= nrows and columns >= d arrive as zeros.
// Threads t, t + nt, ... take part.  16-byte copies (the host's width: d,
// rs and src in whole 16-byte units): thread t copies chunk t % 8 of rows
// t / 8 + (nt / 8) k of every atom (R a multiple of nt / 8, itself a
// multiple of 8), so its swizzle is fixed and each copy is two pointer
// steps.  Otherwise element by element, consecutive threads along a row.
__device__ __forceinline__ void stage16(bf16* dst, int R, const bf16* src, long long rs, int r0,
                                        int nrows, int d, int cols, int t, int nt) {
  const int rr = t / 8, step = nt / 8, cc = (t % 8) * 8, sw = ((t % 8) ^ (rr & 7)) << 3;
  for (int c = cc; c < cols; c += 64) {
    const bf16* g = src + (r0 + rr) * rs + c;
    bf16* p = dst + (c >> 6) * (R * 64) + rr * 64 + sw;
    for (int r = rr; r < R; r += step, g += step * rs, p += step * 64) {
      const bool ok = r0 + r < nrows && c < d;
      sm90::cp_async<16>(p, ok ? g : src, ok);
    }
  }
}
__device__ __forceinline__ void stage_elems(bf16* dst, int R, const bf16* src, long long rs,
                                            int r0, int nrows, int d, int cols, int t, int nt) {
  for (int i = t; i < cols * R; i += nt) {
    const int r = (i / 64) % R, c = (i / (R * 64)) * 64 + i % 64;
    const bool ok = r0 + r < nrows && c < d;
    dst[swz(R, r, c)] = ok ? src[(r0 + r) * rs + c] : __float2bfloat16_rn(0.0f);
  }
}
__device__ __forceinline__ void stage(bf16* dst, int R, const bf16* src, long long rs, int r0,
                                      int nrows, int d, int cols, int w, int t, int nt) {
  if (w == 16)
    stage16(dst, R, src, rs, r0, nrows, d, cols, t, nt);
  else
    stage_elems(dst, R, src, rs, r0, nrows, d, cols, t, nt);
}
// s (64 x 32 f32) = A B^T over np columns for B's rows [32 half, 32 half +
// 32), issued (the key walk's scores, in halves in both routes: the same
// products give the same bits).
__device__ __forceinline__ void score_half(float* s, const bf16* As, const bf16* Bs, int half,
                                           int np) {
  for (int kk = 0; kk < np / 16; ++kk)
    sm90::Wgmma<T64 / 2, 0, 0>::ss(s, sm90::desc_k<T64>(As, kk), desc_k(Bs, T64, kk, 32 * half),
                                   kk);
}
// A score tile in shared memory: each thread's accumulator elements in place.
__device__ __forceinline__ void put_scores(float4* tile, const float* s, int tid) {
#pragma unroll
  for (int i = 0; i < T64 / 8; ++i)
    tile[i * 128 + tid] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
}
// ... read back: all of it (PARTS 2), or the half `half` (PARTS 1: the
// registers of 32 columns, the tile's [16 half, 16 half + 16)).
template <int PARTS>
__device__ __forceinline__ void get_scores(float* s, const float4* tile, int half, int tid) {
#pragma unroll
  for (int i = 0; i < PARTS * T64 / 16; ++i) {
    const float4 v = tile[(i + 4 * half) * 128 + tid];
    s[4 * i] = v.x;
    s[4 * i + 1] = v.y;
    s[4 * i + 2] = v.z;
    s[4 * i + 3] = v.w;
  }
}

// 2^x (MUFU.EX2; subnormal results flush to zero, far below any bound the
// products carry; kernels/tolerance.py charges its 2 ulps as the forward's).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sum of v over the four lanes of a quad (a row's lanes), in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Where a block is: the launch's tile (heaviest first), the slice, the
// slab of heads, the chunk and the leading dims.
struct BlockPos {
  int tile, slice, h0, nh, chunk, i0, i1;
  __device__ BlockPos(const Bwd90Args& a, int nslice) {
    const int per = a.nc * a.l01 * a.nslab * nslice;
    int rest = blockIdx.x % per;
    tile = blockIdx.x / per;
    slice = rest % nslice;
    rest /= nslice;
    const int slab = rest % a.nslab;
    rest /= a.nslab;
    chunk = rest % a.nc;
    const int li = rest / a.nc;
    i0 = li / a.l1;
    i1 = li % a.l1;
    h0 = slab * a.heads;
    nh = min(a.heads, a.l2 - h0);
  }
  // The element offset of head h's chunk in an operand of strides s5, formed
  // where it is used: the position passes through an empty asm, so the
  // compiler cannot hold the ten operands' offsets in registers across a
  // walk, whose accumulators need them (they spilled).
  __device__ long long at(const long long* s5, int h) const {
    int p0 = i0, p1 = i1, c = chunk;
    asm volatile("" : "+r"(p0), "+r"(p1), "+r"(c));
    return p0 * s5[0] + p1 * s5[1] + h * s5[2] + c * s5[3];
  }
  // esum's entry of (leading dims, head h, chunk, tile t)
  __device__ long long esum_at(const Bwd90Args& a, int h, int t, int nqt) const {
    return (((long long)(i0 * a.l1 + i1) * a.l2 + h) * a.nc + chunk) * nqt + t;
  }
};

// Key walk: key tile kt of each head of a slab (the warpgroups take the
// slab's heads in turn, each on its own ring).  A head's first step is the
// chunk state (dS staged in the slot): B_k dS, e_k, and dX = d o (B_k dS),
// dB = d o (X_k dS^T); then query tiles kt .. nqt - 1 (the diagonal
// first): S^T = B_k C_q^T (shared scores, or a product), dP^T = X_k dY_q^T,
// A^T = S^T o L^T and dA^T o L^T as register A operands of dX += A^T dY_q
// and dB += (dA o L)^T C_q; G's column sums in f32.  Writes dX, dB, dseg_k
// = -(column sum) - e_k and the tile's sum of e into esum.
template <int DNW, bool SHARED>
__global__ void __launch_bounds__(NT90, 1) ssd_bwd_keys(const Bwd90Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = sm90::align1024(smem);
  const BwdGeom g(a.Q, a.P, a.N, SHARED, a.nwg);
  const BlockPos bp(a, g.nslice);
  const BwdStrides& sd = a.sd;
  const int Q = a.Q, P = a.P, N = a.N, np = round16(N), pp = round16(P), nqt = g.nqt;
  const int kt = bp.tile, k0 = kt * T64, nsteps = 1 + nqt - kt;  // the chunk state, query tiles
  const long long ss = sd.seg[4];
  const int tx = tile_bytes(g.px), tb = tile_bytes(g.nb);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row = 16 * (tid / 32) + tid % 32 / 4, col = 2 * (tid % 4);  // rows row, row + 8
  const bool own_x = bp.slice < g.nxs, own_n = bp.slice < g.nns, own_seg = bp.slice == 0;
  const int cx = 64 * bp.slice, cn = DNW * bp.slice;

  float4* scores = reinterpret_cast<float4*>(base);
  bf16* Bblk = reinterpret_cast<bf16*>(base + (SHARED ? nqt * SCORE_BYTES : 0));
  unsigned char* regions = reinterpret_cast<unsigned char*>(Bblk) + (SHARED ? tb : 0);
  unsigned char* reg = regions + wg * g.kregion;
  auto Xh = [&](int par) { return reinterpret_cast<bf16*>(reg + par * g.khead); };
  auto Bh = [&](int par) { return reinterpret_cast<bf16*>(reg + par * g.khead + tx); };
  auto slot = [&](int st) { return reinterpret_cast<bf16*>(reg + 2 * g.khead + st * g.kslot); };
  float* segs = reinterpret_cast<float*>(reg + 2 * g.khead + STAGES * g.kslot);
  float* wsum = segs + 4 * T64;  // the warps' sums of e, then each head buffer's seg_{Q-1}

  if constexpr (SHARED) {
    // S^T = B_k C_q^T of the slab, once: query tiles kt .. nqt - 1, one a
    // warpgroup at a time, C_q staged in the regions' space
    const long long hb = bp.at(sd.b, bp.h0), hc = bp.at(sd.c, bp.h0);
    stage(Bblk, T64, a.b + hb, sd.b[4], k0, Q, N, g.nb, a.wb, threadIdx.x, NT90);
    for (int q = kt; q < nqt; q += WG) {
      for (int w = 0; w < WG && q + w < nqt; ++w)
        stage(reinterpret_cast<bf16*>(regions + w * tb), T64, a.c + hc, sd.c[4], (q + w) * T64, Q,
              N, g.nb, a.wc, threadIdx.x, NT90);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      sm90::fence_async_smem();
      __syncthreads();
      // both warpgroups issue the products (a warpgroup past the last tile
      // on a tile not staged, its result unused): a product under a branch
      // on the warpgroup makes ptxas serialize every product (C7520)
      float s[T64 / 2];
      const bf16* Cs = reinterpret_cast<bf16*>(regions + wg * tb);
      sm90::wgmma_fence();
      score_half(s, Bblk, Cs, 0, np);
      score_half(s + T64 / 4, Bblk, Cs, 1, np);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<T64 / 2>(s);
      if (q + wg < nqt) put_scores(scores + (q + wg) * (T64 / 8) * 128, s, tid);
      __syncthreads();  // the C tiles read: their space takes the rings
    }
  }

  float dx[T64 / 2], db[DNW / 2], e[2] = {0.0f, 0.0f}, gs[2] = {0.0f, 0.0f};
  const int nhw = bp.nh > wg ? (bp.nh - wg + WG - 1) / WG : 0;  // this warpgroup's heads
  ring(
      nhw * nsteps,
      [&](int i, int st) {
        const int j = i / nsteps, s = i % nsteps, h = bp.h0 + wg + WG * j, par = j & 1;
        const float* sg = a.seg + bp.at(sd.seg, h);
        if (s == 0) {
          stage(Xh(par), T64, a.x + bp.at(sd.x, h), sd.x[4], k0, Q, P, g.px, a.wx, tid, 128);
          if constexpr (!SHARED)
            stage(Bh(par), T64, a.b + bp.at(sd.b, h), sd.b[4], k0, Q, N, g.nb, a.wb, tid, 128);
          stage_seg(segs + T64 * par, sg, ss, k0, Q, 128 * wg);
          if (tid == T64) sm90::cp_async<4>(wsum + 4 + par, sg + (Q - 1) * ss, true);
          stage(slot(st), g.nb, a.ds + bp.at(sd.ds, h), sd.ds[4], 0, N, P, g.px, a.wds, tid, 128);
        } else {
          const int q0 = (kt + s - 1) * T64;
          stage(slot(st), T64, a.c + bp.at(sd.c, h), sd.c[4], q0, Q, N, g.nb, a.wc, tid, 128);
          stage(slot(st) + tb / 2, T64, a.dy + bp.at(sd.dy, h), sd.dy[4], q0, Q, P, g.px, a.wdy,
                tid, 128);
          stage_seg(segs + T64 * (2 + st), sg, ss, q0, Q, 128 * wg);
        }
      },
      [&](int i, int st) {
        const int j = i / nsteps, s = i % nsteps, h = bp.h0 + wg + WG * j, par = j & 1;
        const bf16* Xk = Xh(par);
        const bf16* Bk = SHARED ? Bblk : Bh(par);
        const float* sk = segs + T64 * par;
        if (s == 0) {
          // ---- the chunk state ----
          const float last = wsum[4 + par];
          float dd[2], ex[2] = {0.0f, 0.0f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            dd[hh] = k0 + row + 8 * hh < Q ? expf(last - sk[row + 8 * hh]) : 0.0f;
          const bf16* dS = slot(st);
          for (int gx = 0; gx < g.nxs; ++gx) {  // B_k dS, 64 columns at a time
            float t[T64 / 2];
            sm90::wgmma_fence();
            for (int kk = 0; kk < np / 16; ++kk)
              sm90::Wgmma<T64, 0, 1>::ss(t, sm90::desc_k<T64>(Bk, kk), desc_mn(dS, g.nb, kk, 64 * gx),
                                         kk);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs<T64 / 2>(t);
#pragma unroll
            for (int J = 0; J < T64 / 8; ++J)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    Xk + swz(T64, row + 8 * hh, 64 * gx + 8 * J + col)));
                ex[hh] = fmaf(xv.y, t[4 * J + 2 * hh + 1], fmaf(xv.x, t[4 * J + 2 * hh], ex[hh]));
              }
            if (gx == bp.slice)
#pragma unroll
              for (int q = 0; q < T64 / 2; ++q) dx[q] = dd[(q >> 1) & 1] * t[q];
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) e[hh] = dd[hh] * quad_sum(ex[hh]);
          if (own_n) {  // dB = d o (X_k dS^T) over this block's columns
            sm90::wgmma_fence();
            for (int kk = 0; kk < pp / 16; ++kk)
              sm90::Wgmma<DNW, 0, 0>::ss(db, sm90::desc_k<T64>(Xk, kk), desc_k(dS, g.nb, kk, cn),
                                         kk);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs<DNW / 2>(db);
#pragma unroll
            for (int q = 0; q < DNW / 2; ++q) db[q] *= dd[(q >> 1) & 1];
          }
          gs[0] = gs[1] = 0.0f;
          return;
        }
        // ---- query tile qt: S^T, dP^T, weighing, dX and dB, in two halves
        // of 32 query columns (the f32 tiles of one half at a time: the walk's
        // accumulators take 96 registers a thread) ----
        const int qt = kt + s - 1, q0 = qt * T64;
        const bf16* Cq = slot(st);
        const bf16* dYq = slot(st) + tb / 2;
        const float* sq = segs + T64 * (2 + st);
        const bool mask = qt == kt || q0 + T64 > Q;
        const float rk[2] = {sk[row], sk[row + 8]};
        uint32_t pa[T64 / 16][4], pd[T64 / 16][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float sc[T64 / 4], dp[T64 / 4];
          if constexpr (SHARED) get_scores<1>(sc, scores + qt * (T64 / 8) * 128, half, tid);
          sm90::wgmma_fence();
          if constexpr (!SHARED) score_half(sc, Bk, Cq, half, np);
          for (int kk = 0; kk < pp / 16; ++kk)
            sm90::Wgmma<T64 / 2, 0, 0>::ss(dp, sm90::desc_k<T64>(Xk, kk),
                                           desc_k(dYq, T64, kk, 32 * half), kk);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs<T64 / 4>(sc);
          sm90::fence_regs<T64 / 4>(dp);
          // register (kk, jj, e) of the tile: key row row + 8 (jj % 2), query
          // column 16 kk + 8 (jj / 2) + col + e, this half's at 8 kk + 2 jj +
          // e - 16 half; L^T = 2^(seg_q log2(e) - seg_k log2(e)) as the
          // forward's, the mask inside the exponent on the diagonal and a
          // ragged last query tile
#pragma unroll
          for (int kk = 2 * half; kk < 2 * half + 2; ++kk)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int hh = jj & 1, r = k0 + row + 8 * hh, c0 = 16 * kk + 8 * (jj >> 1) + col;
              const float2 sqv = *reinterpret_cast<const float2*>(sq + c0);
              float av[2], dv[2];
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                const int idx = 8 * kk + 2 * jj + e2 - 16 * half, qc = q0 + c0 + e2;
                float x2 = fmaf(rk[hh], -LOG2E, (e2 ? sqv.y : sqv.x) * LOG2E);
                if (mask && !(r <= qc && qc < Q)) x2 = NEG_INF;
                const float L = ex2(x2);
                av[e2] = sc[idx] * L;
                dv[e2] = dp[idx] * L;
                gs[hh] = fmaf(dv[e2], sc[idx], gs[hh]);
              }
              pa[kk][jj] = sm90::pack_bf16(av[0], av[1]);
              pd[kk][jj] = sm90::pack_bf16(dv[0], dv[1]);
            }
          sm90::wgmma_fence();
          if (own_x)
#pragma unroll
            for (int kk = 2 * half; kk < 2 * half + 2; ++kk)
              sm90::WgmmaN<T64>::rs(dx, pa[kk], sm90::desc_mn<T64>(dYq, kk, cx), T64 * 128, 1);
          if (own_n)
#pragma unroll
            for (int kk = 2 * half; kk < 2 * half + 2; ++kk)
              sm90::WgmmaN<DNW>::rs(db, pd[kk], sm90::desc_mn<T64>(Cq, kk, cn), T64 * 128, 1);
          sm90::wgmma_commit();
          // waited here, not under the next half's products: with both in
          // flight ptxas lacks the registers and serializes every product
          // (C7511)
          sm90::wgmma_wait<0>();
          sm90::fence_regs<T64 / 2>(dx);
          sm90::fence_regs<DNW / 2>(db);
          sm90::fence_regs<T64 / 8>(&pa[2 * half][0]);
          sm90::fence_regs<T64 / 8>(&pd[2 * half][0]);
        }
        if (s < nsteps - 1) return;
        // ---- the head's outputs ----
        if (own_x) store_tile<T64>(a.dx + bp.at(sd.dx, h) + cx, sd.dx[4], dx, k0, Q, P - cx, row, col);
        if (own_n) store_tile<DNW>(a.db + bp.at(sd.db, h) + cn, sd.db[4], db, k0, Q, N - cn, row, col);
        if (!own_seg) return;
        float* dseg = a.dseg + bp.at(sd.dseg, h);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float gsum = quad_sum(gs[hh]);
          const int r = k0 + row + 8 * hh;
          if (tid % 4 == 0 && r < Q) dseg[r * sd.dseg[4]] = -gsum - e[hh];
        }
        // the tile's sum of e (rows past Q hold 0): quads, then warps, in order
        float v = e[0] + e[1];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (tid % 32 == 0) wsum[tid / 32] = v;
        wg_sync();
        if (tid == 0) a.esum[bp.esum_at(a, h, kt, nqt)] = ((wsum[0] + wsum[1]) + wsum[2]) + wsum[3];
      });
}

// Query walk: query tile qt of each head of a slab, after ssd_bwd_keys (the
// same stream).  Key tiles qt .. 0 (the diagonal first): S = C_q B_k^T
// (shared scores, or a product), dP = dY_q X_k^T, dA o L as the register A
// operand of dC += (dA o L) B_k; G's row sums in f32.  Writes dC and adds
// the row sums to dseg (and, at row Q - 1, the sum of e over the chunk's
// tiles, in order).
template <int DNW, bool SHARED>
__global__ void __launch_bounds__(NT90, 1) ssd_bwd_queries(const Bwd90Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = sm90::align1024(smem);
  const BwdGeom g(a.Q, a.P, a.N, SHARED, a.nwg);
  const BlockPos bp(a, g.nslice);
  const BwdStrides& sd = a.sd;
  const int Q = a.Q, P = a.P, N = a.N, np = round16(N), pp = round16(P), nqt = g.nqt;
  const int qt = nqt - 1 - bp.tile, q0 = qt * T64, nsteps = qt + 1;
  const long long ss = sd.seg[4];
  const int tx = tile_bytes(g.px), tb = tile_bytes(g.nb);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row = 16 * (tid / 32) + tid % 32 / 4, col = 2 * (tid % 4);  // rows row, row + 8
  const bool own_n = bp.slice < g.nns, own_seg = bp.slice == 0;
  const int cn = DNW * bp.slice;

  float4* scores = reinterpret_cast<float4*>(base);
  unsigned char* regions = base + (SHARED ? nqt * SCORE_BYTES : 0);
  unsigned char* reg = regions + wg * g.qregion;
  auto Yh = [&](int par) { return reinterpret_cast<bf16*>(reg + par * g.qhead); };
  auto Ch = [&](int par) { return reinterpret_cast<bf16*>(reg + par * g.qhead + tx); };
  auto slot = [&](int st) { return reinterpret_cast<bf16*>(reg + 2 * g.qhead + st * g.qslot); };
  float* segs = reinterpret_cast<float*>(reg + 2 * g.qhead + STAGES * g.qslot);

  if constexpr (SHARED) {
    // S = C_q B_k^T of the slab, once: key tiles 0 .. qt, one a warpgroup at
    // a time; C_q and two B tiles in the regions' space
    const long long hb = bp.at(sd.b, bp.h0), hc = bp.at(sd.c, bp.h0);
    bf16* Cs = reinterpret_cast<bf16*>(regions);
    stage(Cs, T64, a.c + hc, sd.c[4], q0, Q, N, g.nb, a.wc, threadIdx.x, NT90);
    for (int k = 0; k <= qt; k += WG) {
      for (int w = 0; w < WG && k + w <= qt; ++w)
        stage(reinterpret_cast<bf16*>(regions + (1 + w) * tb), T64, a.b + hb, sd.b[4],
              (k + w) * T64, Q, N, g.nb, a.wb, threadIdx.x, NT90);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      sm90::fence_async_smem();
      __syncthreads();
      float s[T64 / 2];  // both warpgroups issue the products, as the key walk's
      score(s, Cs, reinterpret_cast<bf16*>(regions + (1 + wg) * tb), np);
      if (k + wg <= qt) put_scores(scores + (k + wg) * (T64 / 8) * 128, s, tid);
      __syncthreads();
    }
  }

  float dc[DNW / 2], gs[2] = {0.0f, 0.0f}, rq[2] = {0.0f, 0.0f};
  float dsv[2] = {0.0f, 0.0f}, es[2] = {0.0f, 0.0f};  // dseg as the key walk left it; e's sum
  const int nhw = bp.nh > wg ? (bp.nh - wg + WG - 1) / WG : 0;
  ring(
      nhw * nsteps,
      [&](int i, int st) {
        const int j = i / nsteps, s = i % nsteps, h = bp.h0 + wg + WG * j, par = j & 1;
        const int k0 = (qt - s) * T64;
        const float* sg = a.seg + bp.at(sd.seg, h);
        if (s == 0) {
          stage(Yh(par), T64, a.dy + bp.at(sd.dy, h), sd.dy[4], q0, Q, P, g.px, a.wdy, tid, 128);
          if constexpr (!SHARED)
            stage(Ch(par), T64, a.c + bp.at(sd.c, h), sd.c[4], q0, Q, N, g.nb, a.wc, tid, 128);
          stage_seg(segs + T64 * par, sg, ss, q0, Q, 128 * wg);
        }
        stage(slot(st), T64, a.x + bp.at(sd.x, h), sd.x[4], k0, Q, P, g.px, a.wx, tid, 128);
        stage(slot(st) + tx / 2, T64, a.b + bp.at(sd.b, h), sd.b[4], k0, Q, N, g.nb, a.wb, tid,
              128);
        stage_seg(segs + T64 * (2 + st), sg, ss, k0, Q, 128 * wg);
      },
      [&](int i, int st) {
        const int j = i / nsteps, s = i % nsteps, h = bp.h0 + wg + WG * j, par = j & 1;
        const int kt = qt - s, k0 = kt * T64;
        const bf16* dYq = Yh(par);
        const bf16* Xk = slot(st);
        const bf16* Bk = slot(st) + tx / 2;
        const float* sk = segs + T64 * (2 + st);
        const bf16* Cq = SHARED ? nullptr : Ch(par);
        if (s == 0) {
          const float* sq = segs + T64 * par;
          rq[0] = sq[row] * LOG2E;
          rq[1] = sq[row + 8] * LOG2E;
          gs[0] = gs[1] = 0.0f;
          if (own_seg && tid % 4 == 0) {  // read now, added at the head's end
            const float* dseg = a.dseg + bp.at(sd.dseg, h);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = q0 + row + 8 * hh;
              if (r < Q) dsv[hh] = dseg[r * sd.dseg[4]];
              if (r == Q - 1) {
                float t = 0.0f;
                for (int tt = 0; tt < nqt; ++tt) t += a.esum[bp.esum_at(a, h, tt, nqt)];
                es[hh] = t;
              }
            }
          }
        }
        float sc[T64 / 2], dp[T64 / 2];
        if constexpr (SHARED) get_scores<2>(sc, scores + kt * (T64 / 8) * 128, 0, tid);
        sm90::wgmma_fence();
        if constexpr (!SHARED)
          for (int kk = 0; kk < np / 16; ++kk)
            sm90::Wgmma<T64, 0, 0>::ss(sc, sm90::desc_k<T64>(Cq, kk), sm90::desc_k<T64>(Bk, kk), kk);
        for (int kk = 0; kk < pp / 16; ++kk)
          sm90::Wgmma<T64, 0, 0>::ss(dp, sm90::desc_k<T64>(dYq, kk), sm90::desc_k<T64>(Xk, kk), kk);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs<T64 / 2>(sc);
        sm90::fence_regs<T64 / 2>(dp);
        // register (kk, jj, e): query row row + 8 (jj % 2), key column 16 kk
        // + 8 (jj / 2) + col + e; L as the forward's weigh
        const bool mask = s == 0 || q0 + T64 > Q;
        uint32_t pf[T64 / 16][4];
#pragma unroll
        for (int kk = 0; kk < T64 / 16; ++kk)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int hh = jj & 1, qi = q0 + row + 8 * hh, c0 = 16 * kk + 8 * (jj >> 1) + col;
            const float2 skv = *reinterpret_cast<const float2*>(sk + c0);
            float dv[2];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int idx = 8 * kk + 2 * jj + e2;
              float x2 = fmaf(e2 ? skv.y : skv.x, -LOG2E, rq[hh]);
              // k0 + c < Q follows from k0 + c <= qi < Q
              if (mask && !(k0 + c0 + e2 <= qi && qi < Q)) x2 = NEG_INF;
              dv[e2] = dp[idx] * ex2(x2);
              gs[hh] = fmaf(dv[e2], sc[idx], gs[hh]);
            }
            pf[kk][jj] = sm90::pack_bf16(dv[0], dv[1]);
          }
        if (own_n) {
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < T64 / 16; ++kk)
            sm90::WgmmaN<DNW>::rs(dc, pf[kk], sm90::desc_mn<T64>(Bk, kk, cn), T64 * 128,
                                  s > 0 || kk > 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs<DNW / 2>(dc);
          sm90::fence_regs<T64 / 4>(&pf[0][0]);
        }
        if (s < nsteps - 1) return;
        // ---- the head's outputs ----
        if (own_n) store_tile<DNW>(a.dc + bp.at(sd.dc, h) + cn, sd.dc[4], dc, q0, Q, N - cn, row, col);
        if (!own_seg) return;
        float* dseg = a.dseg + bp.at(sd.dseg, h);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float gsum = quad_sum(gs[hh]);
          const int r = q0 + row + 8 * hh;
          if (tid % 4 == 0 && r < Q) {
            float v = dsv[hh] + gsum;
            if (r == Q - 1) v += es[hh];
            dseg[r * sd.dseg[4]] = v;
          }
        }
      });
}

template <int DNW, bool SHARED>
cudaError_t launch_sm90(const Bwd90Args& a, const BwdGeom& g, cudaStream_t st) {
  const long long blocks = (long long)g.nqt * a.nc * a.l01 * a.nslab * g.nslice;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* kk = ssd_bwd_keys<DNW, SHARED>;
  auto* kq = ssd_bwd_queries<DNW, SHARED>;
  cudaError_t err =
      cudaFuncSetAttribute(kk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.keys);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.queries);
  if (err != cudaSuccess) return err;
  kk<<<(unsigned)blocks, NT90, g.keys, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kq<<<(unsigned)blocks, NT90, g.queries, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, dY (l0, l1, l2, nc, Q, P), B / C (l0, l1, l2, nc, Q, N), dS (l0, l1,
// l2, nc, N, P) in bf16 or f32, seg (l0, l1, l2, nc, Q) f32, with the
// element strides of `strides` (50: x, B, C, seg, dY, dS, dX, dB, dC, dseg;
// each three leading dims, the chunk and the row).  dX like x, dB and dC
// like B (per head), dseg like seg, f32.
// f32: `smem` the kernel's dynamic shared memory (kernels/ssd/ops.py
// `bwd_smem_f32`); heads, shared, widths and esum unused.
// bf16: `heads` heads per block (a slab), `shared` forms C B^T once per
// slab (B and C stride 0 over l2, Q <= 256), `widths` the operands' 16-byte
// copies (bits: x 1, B 2, C 4, dY 8, dS 16), `smem` the larger kernel's
// dynamic shared memory, as kernels/ssd/ops.py `bwd_launch_shape` decides
// them; esum l0 l1 l2 nc ceil(Q / 64) f32 of scratch.  N <= 256, P <= 128.
extern "C" int repro_ssd_chunk_bwd(const void* x, const void* b, const void* c, const void* seg,
                                   const void* dy, const void* ds, void* dx, void* db, void* dc,
                                   void* dseg, const long long* strides, int l0, int l1, int l2,
                                   int nc, int Q, int P, int N, int dtype, int heads, int shared,
                                   int widths, long long smem, void* esum, void* stream) {
  if (l0 <= 0 || l1 <= 0 || l2 <= 0 || nc <= 0 || Q <= 0 || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  BwdStrides sd;
  std::memcpy(&sd, strides, sizeof(sd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    if (smem != (long long)BwdLayout(N, P, 4).bytes) return (int)cudaErrorInvalidValue;
    return (int)launch_typed<float>(x, b, c, seg, dy, ds, dx, db, dc, dseg, sd, l0, l1, l2, nc,
                                    Q, P, N, s);
  }
  if (dtype != DT_BF16 || N > 256 || P > 128) return (int)cudaErrorInvalidValue;
  const int nqt = (Q + T64 - 1) / T64, nwg = heads < WG ? heads : WG;
  if (heads <= 0 || (shared && nqt > MAX_SHARED_TILES) || (!shared && heads > WG))
    return (int)cudaErrorInvalidValue;
  const BwdGeom g(Q, P, N, shared != 0, nwg);
  const size_t need = mx(g.keys, g.queries);
  if ((size_t)smem != need || need > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto w = [&](int bit) { return widths & bit ? 16 : 2; };
  const Bwd90Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                    static_cast<const bf16*>(c), static_cast<const float*>(seg),
                    static_cast<const bf16*>(dy), static_cast<const bf16*>(ds),
                    static_cast<bf16*>(dx), static_cast<bf16*>(db), static_cast<bf16*>(dc),
                    static_cast<float*>(dseg), static_cast<float*>(esum), sd, l1, l2, l0 * l1, nc,
                    Q, P, N, heads, (l2 + heads - 1) / heads, nwg, w(1), w(2), w(4), w(8), w(16)};
  if (g.dnw == 64)
    return (int)(shared ? launch_sm90<64, true>(a, g, s) : launch_sm90<64, false>(a, g, s));
  return (int)(shared ? launch_sm90<128, true>(a, g, s) : launch_sm90<128, false>(a, g, s));
}
