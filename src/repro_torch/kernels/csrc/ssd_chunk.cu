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
// 3.35 TB/s against 0.013 ms at 989 TFLOP/s.  So the products must not wait
// on their copies, and the 48 heads of a group must not each recompute the
// group's C B^T (8 of the 15 GFLOP the first port issued).  What holds the
// kernel back at 4-5x that bound is latency: each warpgroup's step is a
// chain of copy wait, barrier, score load, weighing and product, and two
// blocks of two warpgroups fill an SM (PERF.md, section 7).
//
// What the design does about it (bf16, sm_90a; `ssd_chunk_sm90`):
//   * Y is causal attention with a decay in place of the softmax.  A
//     warpgroup (128 threads) owns 64 query rows of one chunk and walks the
//     64-row key tiles up to its diagonal, the diagonal first; the tiles
//     above it are exact zeros and never visited.  The score tile C_q B_k^T
//     is a `wgmma` chain into f32 registers; each thread weighs its own
//     accumulator elements (the documented layout, sm90.cuh) by L =
//     2^(seg_row log2(e) - seg_col log2(e)), one FFMA and one ex2 a score
//     (kernels/tolerance.py charges the prescale), with the mask inside the
//     exponent on the diagonal and ragged tiles only (2^(-1e30) = 0: a
//     masked entry never takes the exponential of a positive difference);
//     the weighted scores round to bf16 in registers and are the A operand
//     of Y += (C B^T o L) X_k, a `wgmma` against X_k in shared memory, as
//     flash's P V.  Y stays in f32 registers until its store;
//   * C B^T is computed once per (sequence, group, chunk, query tile) and
//     shared by a slab of heads wherever B and C have stride 0 over the
//     heads (the model's expanded views): the block's two warpgroups first
//     compute its query tile's score tiles (at most four of 16 KB at Q =
//     256) into shared memory, each thread keeping its own accumulator
//     elements in place, then take the slab's heads in turn, applying each
//     head's decay to the same f32 scores.  Where B is not stride 0 over
//     the heads (the flat (bh, ...) layout) or Q > 256, each warpgroup
//     takes one head and its score tile never leaves registers.  Both
//     routes issue the same products in the same order, so the same inputs
//     give bit-identical outputs.  The slab, the grid and the shared memory
//     come from the wrapper (kernels/ssd/ops.py `launch_shape`; the slab
//     was picked by `tuning/ssd_tiles.py`'s sweep on the card);
//   * S = B^T (decay o X) runs by `wgmma` in blocks of the same launch (128
//     state rows of one slab, two 64-row accumulators a warpgroup, the
//     warpgroups taking the slab's heads in turn): B_k^T is an MN-major A
//     operand of the staged B tile (staged once a block where B is shared),
//     decay o X is rounded to bf16 in place in the staged X tile.  Blocks
//     are numbered heaviest first (S blocks, then query tiles from the
//     last);
//   * every tile comes through a ring of cp.async copies in sm90.cuh's
//     128-byte swizzle, the next step in flight while this one computes,
//     one barrier a step.  Where the warpgroups walk heads of their own
//     (the shared Y walk, the S blocks) each has its own ring and barrier,
//     so neither waits on the other's step.  Copies are 16 bytes wide
//     where the operand's alignment allows (the host decides), else element
//     by element; rows past Q and columns past N or P arrive as zeros;
//   * operands are read in place through element strides (three leading
//     dims, the chunk, the row; the last dim contiguous): B and C may be
//     `expand`ed over the heads of a group (stride 0), x and Y permuted
//     views of the model's (b, s, heads, P) layout.  No repeat, no copy.
// P pads to 16, 32, 64 or 128 (the instantiations, each with and without
// shared scores), N to a multiple of 16.
//
// f32 (a check dtype; `ssd_chunk_f32`) keeps the first port's design: full
// f32 FMA products (no TF32) and expf on tiles in shared memory, S in
// separate blocks of the same launch.
#include <cstring>

#include "gemm_tile.cuh"
#include "ssd_sm90.cuh"

using namespace repro;
using namespace ssd;

namespace {

constexpr int MAX_N = 256, MAX_P = 128;

// Element strides of each operand: three leading dims, the chunk, the row
// (seg: the step).  The last dim of x, B, C, Y and S is contiguous.
struct Strides {
  long long x[5], b[5], c[5], seg[5], y[5], s[5];
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t al128(size_t n) { return (n + 127) / 128 * 128; }

// ---- bf16: ssd_chunk_sm90 ------------------------------------------------------------------

using sm90::bf16;

constexpr int WG = 2;                    // warpgroups a block
constexpr int NT = 128 * WG;
constexpr int MAX_SHARED_TILES = 4;      // score tiles a block keeps: Q <= 256
constexpr int SCORE_BYTES = T64 * T64 * 4;
constexpr int SEG_BYTES = T64 * 4;       // one stage of 64 seg values
constexpr int S_ROWS = T64 * WG;         // state rows of an S block, 64 a warpgroup
constexpr int STAGES = 2;                // ring slots: the next step's copies in flight

// Dynamic shared memory of a launch (kernels/ssd/ops.py `launch_shape`
// computes the same), the larger of its two roles and slack to align the
// tiles to 1024 bytes.  Shared C B^T: the Y role keeps nqt score tiles,
// then C and two B tiles, whose space a ring of (X, seg) a warpgroup takes
// once the scores are made; the S role keeps B's S_ROWS columns over the
// whole chunk and a ring of (X, seg) a warpgroup.  Per head (`heads`
// warpgroups, one head each): the Y role keeps C and a ring of (B, X, seg)
// a warpgroup; the S role a ring of (B, X, seg) a warpgroup.
__host__ __device__ inline size_t ssd_smem(int N, int PP, int nqt, bool shared, int heads) {
  const size_t tc = tile_bytes(round16(N)), tx = tile_bytes(PP), tb = tile_bytes(S_ROWS);
  size_t y, s;
  if (shared) {
    const size_t xs = (size_t)STAGES * WG * (tx + SEG_BYTES);
    y = (size_t)nqt * SCORE_BYTES + (3 * tc > xs ? 3 * tc : xs);
    s = nqt * tb + xs;
  } else {
    y = heads * (tc + STAGES * (tc + tx + SEG_BYTES));
    s = STAGES * WG * (tb + tx + SEG_BYTES);
  }
  return (y > s ? y : s) + 1024;
}

// A ring of STAGES slots over `steps` steps: fill(i, slot) issues step i's
// copies, body(i, slot) computes step i while step i + 1's copies are in
// flight (copies issued before the call join step 0's).  One barrier a
// step (the block's, or with WG_ONLY the warpgroup's, whose ring it then
// is), after which the slot read in the step before is refilled.
template <bool WG_ONLY = false, typename Fill, typename Body>
__device__ __forceinline__ void ring(int steps, Fill&& fill, Body&& body) {
  if (steps > 0) fill(0, 0);
  sm90::cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    sm90::cp_async_wait<0>();  // this thread's copies of step i landed
    sm90::fence_async_smem();
    if constexpr (WG_ONLY)
      wg_sync();
    else
      __syncthreads();
    if (i + 1 < steps) fill(i + 1, (i + 1) % STAGES);
    sm90::cp_async_commit();
    body(i, i % STAGES);
  }
}

struct SsdArgs {
  const bf16 *x, *b, *c;
  const float* seg;
  bf16 *y, *s;
  Strides sd;
  int l1, l2, l01, nc, Q, P, N;  // l01 = l0 l1
  int heads, nslab, nqt, nnt;
  int wx, wb, wc;  // copy widths (bytes) of x, B and C
};

// Stage rows [r0, r0 + 64) x columns [0, cols) of a row-strided matrix (row
// i at src + i * rs, d valid columns) into a swizzled 64-row tile; rows >=
// nrows and columns >= d arrive as zeros.  Threads t, t + nt, ... take
// part (the block's, or one warpgroup's), consecutive ones along an atom's
// row (128 contiguous bytes).  16-byte copies need d, rs and src in whole
// 16-byte units (the host's width); W = 2 loads element by element.
template <int W>
__device__ __forceinline__ void stage_w(bf16* dst, const bf16* src, long long rs, int r0,
                                        int nrows, int d, int cols, int t, int nt) {
  constexpr int E = W / 2, CPA = 64 / E;  // elements per copy, copies per atom row
  const int atoms = (cols + 63) / 64;
  for (int i = t; i < atoms * T64 * CPA; i += nt) {
    const int r = (i / CPA) % T64, c = (i / (T64 * CPA)) * 64 + (i % CPA) * E;
    if (c >= cols) continue;
    const bool ok = r0 + r < nrows && c < d;
    const bf16* g = ok ? src + (r0 + r) * rs + c : src;
    bf16* p = dst + sm90::swz_off<T64>(r, c);
    if constexpr (W == 16)
      sm90::cp_async<16>(p, g, ok);
    else
      *p = ok ? *g : __float2bfloat16_rn(0.0f);
  }
}
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long rs, int r0, int nrows,
                                      int d, int cols, int w, int t = threadIdx.x, int nt = NT) {
  if (w == 16)
    stage_w<16>(dst, src, rs, r0, nrows, d, cols, t, nt);
  else
    stage_w<2>(dst, src, rs, r0, nrows, d, cols, t, nt);
}
// The weighted scores as the A operand of the Y product: register j is
// query row q0 + row + 8 ((j / 2) % 2), key k0 + 8 (j / 4) + col + j % 2;
// rq the two rows' seg times log2(e), sk the key tile's seg.  L = 2^(rq -
// sk log2(e)): one FFMA and one ex2 a score (kernels/tolerance.py charges
// the prescale and ex2's error).  MASK (the diagonal tile, a ragged last
// query tile) puts the mask inside the exponent: 2^(-1e30) = 0, so a
// masked entry never takes the exponential of a positive difference.
template <bool MASK>
__device__ __forceinline__ void weigh(uint32_t (*pf)[4], const float* s, const float* rq,
                                      const float* sk, int q0, int k0, int Q, int row, int col) {
#pragma unroll
  for (int kk = 0; kk < T64 / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float2 sc = *reinterpret_cast<const float2*>(sk + 8 * (2 * kk + (jj >> 1)) + col);
      const int hh = jj & 1, qi = q0 + row + 8 * hh;
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (2 * kk + (jj >> 1)) + col + e;
        float d = fmaf(e ? sc.y : sc.x, -LOG2E, rq[hh]);
        // k0 + c < Q follows from k0 + c <= qi < Q
        if (MASK && !(k0 + c <= qi && qi < Q)) d = NEG_INF;
        w[e] = s[8 * kk + 2 * jj + e] * exp2f(d);
      }
      pf[kk][jj] = sm90::pack_bf16(w[0], w[1]);
    }
}

// d (+)= A . B, PP wide, both operands MN-major in shared memory: one
// m64n64 piece per 64-column atom (B's descriptor advances one atom).
template <int PP> struct WgmmaSS {
  static constexpr int W = PP >= 64 ? 64 : PP;
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    sm90::Wgmma<W, 1, 1>::ss(d, da, db, acc);
    if constexpr (PP > W) WgmmaSS<PP - W>::ss(d + W / 2, da, db + (T64 * 128 >> 4), acc);
  }
};

// 1-D grid of (nnt + nqt) x nc x l0 l1 x nslab blocks of two warpgroups.
// Unit u < nnt: S rows [S_ROWS u, S_ROWS (u + 1)) of a slab of heads (64 a
// warpgroup); then query tile nqt - 1 - (u - nnt) (the heaviest first).
// SHARED: B and C stride 0 over the heads, C B^T once a block, the
// warpgroups take the slab's heads in turn; else each warpgroup its own
// head and scores.
template <int PP, bool SHARED>
__global__ void __launch_bounds__(NT, SHARED && PP <= 64 ? 2 : 1) ssd_chunk_sm90(const SsdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = sm90::align1024(smem);
  const Strides& sd = a.sd;
  const int per = a.nc * a.l01 * a.nslab;
  const int unit = blockIdx.x / per, slab = blockIdx.x % per % a.nslab;
  const int rest = blockIdx.x % per / a.nslab;
  const int chunk = rest % a.nc, li = rest / a.nc, i0 = li / a.l1, i1 = li % a.l1;
  const int h0 = slab * a.heads, nh = min(a.heads, a.l2 - h0);
  auto at = [&](const long long* s5, int h) {
    return i0 * s5[0] + i1 * s5[1] + h * s5[2] + chunk * s5[3];
  };
  const int Q = a.Q, P = a.P, N = a.N, np = round16(N);
  const long long ss = sd.seg[4];
  const int tc = tile_bytes(np);
  constexpr int tx = tile_bytes(PP), tb = tile_bytes(S_ROWS);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row = 16 * (tid / 32) + tid % 32 / 4, col = 2 * (tid % 4);  // rows row, row + 8

  if (unit < a.nnt) {
    // ---- S rows [n0, n0 + S_ROWS) of each head: every key tile of the
    // chunk; each warpgroup on its own ring takes heads wg, wg + WG, ... and
    // all S_ROWS rows (two 64-row accumulators) ----
    const int n0 = unit * S_ROWS, nkt = a.nqt;
    float sacc[S_ROWS / T64][PP / 2];
    // B's columns [n0, n0 + S_ROWS): SHARED, every key tile of the chunk,
    // staged once; else a ring of them a warpgroup.  Then the rings of X
    // and seg.
    const int x0 = (SHARED ? nkt : STAGES * WG) * tb, seg0 = x0 + STAGES * WG * tx;
    auto Bs = [&](int st, int kt) {
      return reinterpret_cast<bf16*>(base + (SHARED ? kt : st * WG + wg) * tb);
    };
    auto Xs = [&](int st) { return reinterpret_cast<bf16*>(base + x0 + (st * WG + wg) * tx); };
    auto Sg = [&](int st) {
      return reinterpret_cast<float*>(base + seg0) + (st * WG + wg) * T64;
    };
    if constexpr (SHARED) {
      for (int kt = 0; kt < nkt; ++kt)
        stage(Bs(0, kt), a.b + at(sd.b, h0) + n0, sd.b[4], kt * T64, Q, N - n0, S_ROWS, a.wb);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      sm90::fence_async_smem();
      __syncthreads();  // every warpgroup's ring reads all of B
    }
    float last = 0.0f;
    ring<true>(
        (nh - wg + WG - 1) / WG * nkt,
        [&](int i, int st) {
          const int h = h0 + i / nkt * WG + wg, k0 = (i % nkt) * T64;
          if constexpr (!SHARED)
            stage(Bs(st, 0), a.b + at(sd.b, h) + n0, sd.b[4], k0, Q, N - n0, S_ROWS, a.wb, tid,
                  128);
          stage(Xs(st), a.x + at(sd.x, h), sd.x[4], k0, Q, P, PP, a.wx, tid, 128);
          stage_seg(Sg(st), a.seg + at(sd.seg, h), ss, k0, Q, 128 * wg);
        },
        [&](int i, int st) {
          const int h = h0 + i / nkt * WG + wg, kt = i % nkt;
          if (kt == 0) last = a.seg[at(sd.seg, h) + (Q - 1) * ss];
          // decay o X, rounded to bf16 in place: a 16-byte chunk lies in one row
          bf16* xs = Xs(st);
          const float* sg = Sg(st);
          for (int o = tid * 8; o < tx / 2; o += 128 * 8) {
            const float d = expf(last - sg[(o / 64) % T64]);
            uint4 v = *reinterpret_cast<uint4*>(xs + o);
            __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(p2[e]);
              p2[e] = __floats2bfloat162_rn(f.x * d, f.y * d);
            }
            *reinterpret_cast<uint4*>(xs + o) = v;
          }
          sm90::fence_async_smem();
          wg_sync();
          const bf16* bs = Bs(st, kt);
          sm90::wgmma_fence();
#pragma unroll
          for (int m = 0; m < S_ROWS / T64; ++m)
#pragma unroll
            for (int kk = 0; kk < T64 / 16; ++kk)
              WgmmaSS<PP>::ss(sacc[m], sm90::desc_mn<T64>(bs, kk, T64 * m),
                              sm90::desc_mn<T64>(xs, kk, 0), kt > 0 || kk > 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
#pragma unroll
          for (int m = 0; m < S_ROWS / T64; ++m) sm90::fence_regs<PP / 2>(sacc[m]);
          if (kt == nkt - 1)
#pragma unroll
            for (int m = 0; m < S_ROWS / T64; ++m)
              store_tile<PP>(a.s + at(sd.s, h) + (n0 + T64 * m) * sd.s[4], sd.s[4], sacc[m], 0,
                             N - n0 - T64 * m, P, row, col);
        });
    return;
  }

  // ---- Y rows [q0, q0 + 64): key tiles qt .. 0, the diagonal first ----
  const int qt = a.nqt - 1 - (unit - a.nnt), q0 = qt * T64, nk = qt + 1;
  float acc[PP / 2], s[T64 / 2];
  uint32_t pf[T64 / 16][4];
  float rq[2] = {0.0f, 0.0f};
  // one key step of head h: weigh the scores s, Y (+)= (C B^T o L) X_k; the
  // diagonal (the first step) brings the query rows' seg
  auto y_step = [&](int j, int h, const bf16* xs, const float* sk) {
    if (j == 0) {
      rq[0] = sk[row] * LOG2E;
      rq[1] = sk[row + 8] * LOG2E;
      weigh<true>(pf, s, rq, sk, q0, q0, Q, row, col);
    } else if (q0 + T64 > Q) {
      weigh<true>(pf, s, rq, sk, q0, (qt - j) * T64, Q, row, col);
    } else {
      weigh<false>(pf, s, rq, sk, q0, (qt - j) * T64, Q, row, col);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T64 / 16; ++kk)
      sm90::WgmmaN<PP>::rs(acc, pf[kk], sm90::desc_mn<T64>(xs, kk, 0), T64 * 128,
                           j > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<PP / 2>(acc);
    sm90::fence_regs<T64 / 4>(&pf[0][0]);
    if (j == nk - 1) store_tile<PP>(a.y + at(sd.y, h), sd.y[4], acc, q0, Q, P, row, col);
  };

  if constexpr (SHARED) {
    // the slab's score tiles, once, into shared memory, two at a time (one
    // a warpgroup); each thread keeps its accumulator elements where it
    // reads them back
    float4* scores = reinterpret_cast<float4*>(base);
    unsigned char* work = base + a.nqt * SCORE_BYTES;
    bf16* Cs = reinterpret_cast<bf16*>(work);
    auto Bs = [&](int w) { return reinterpret_cast<bf16*>(work + (1 + w) * tc); };
    stage(Cs, a.c + at(sd.c, h0), sd.c[4], q0, Q, N, np, a.wc);
    for (int k0 = 0; k0 < nk; k0 += WG) {
      for (int w = 0; w < WG && k0 + w < nk; ++w)
        stage(Bs(w), a.b + at(sd.b, h0), sd.b[4], (k0 + w) * T64, Q, N, np, a.wb);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      sm90::fence_async_smem();
      __syncthreads();
      const int k = k0 + wg;
      if (k < nk) {
        score(s, Cs, Bs(wg), np);
#pragma unroll
        for (int i = 0; i < T64 / 8; ++i)
          scores[(k * (T64 / 8) + i) * 128 + tid] =
              make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      }
      __syncthreads();  // B read (and, the last time, C: their space takes the ring)
    }

    // the warpgroups take the slab's heads in turn over the scores
    auto Xs = [&](int st, int w) { return reinterpret_cast<bf16*>(work + (st * WG + w) * tx); };
    auto Sg = [&](int st, int w) {
      return reinterpret_cast<float*>(work + STAGES * WG * tx) + (st * WG + w) * T64;
    };
    // each warpgroup on its own ring: heads wg, wg + WG, ... of the slab
    ring<true>(
        (nh - wg + WG - 1) / WG * nk,
        [&](int i, int st) {
          const int h = h0 + i / nk * WG + wg, k0 = (qt - i % nk) * T64;
          stage(Xs(st, wg), a.x + at(sd.x, h), sd.x[4], k0, Q, P, PP, a.wx, tid, 128);
          stage_seg(Sg(st, wg), a.seg + at(sd.seg, h), ss, k0, Q, 128 * wg);
        },
        [&](int i, int st) {
          const int j = i % nk, hh = i / nk * WG + wg;
#pragma unroll
          for (int q = 0; q < T64 / 8; ++q) {
            const float4 v = scores[((qt - j) * (T64 / 8) + q) * 128 + tid];
            s[4 * q] = v.x;
            s[4 * q + 1] = v.y;
            s[4 * q + 2] = v.z;
            s[4 * q + 3] = v.w;
          }
          y_step(j, h0 + hh, Xs(st, wg), Sg(st, wg));
        });
    return;
  }

  // per head: warpgroup w takes head h0 + w, its score tile never leaving
  // registers.  Warpgroup w's C, B ring and X ring, then the seg rings.
  const int region = tc + STAGES * (tc + tx);
  auto Cs = [&](int w) { return reinterpret_cast<bf16*>(base + w * region); };
  auto Bs = [&](int st, int w) {
    return reinterpret_cast<bf16*>(base + w * region + (1 + st) * tc);
  };
  auto Xs = [&](int st, int w) {
    return reinterpret_cast<bf16*>(base + w * region + (1 + STAGES) * tc + st * tx);
  };
  auto Sg = [&](int st, int w) {
    return reinterpret_cast<float*>(base + a.heads * region) + (w * STAGES + st) * T64;
  };
  for (int w = 0; w < nh; ++w) stage(Cs(w), a.c + at(sd.c, h0 + w), sd.c[4], q0, Q, N, np, a.wc);
  ring(
      nk,
      [&](int j, int st) {
        const int k0 = (qt - j) * T64;
        for (int w = 0; w < nh; ++w) {
          stage(Bs(st, w), a.b + at(sd.b, h0 + w), sd.b[4], k0, Q, N, np, a.wb);
          stage(Xs(st, w), a.x + at(sd.x, h0 + w), sd.x[4], k0, Q, P, PP, a.wx);
          stage_seg(Sg(st, w), a.seg + at(sd.seg, h0 + w), ss, k0, Q, T64 * w);
        }
      },
      [&](int j, int st) {
        if (wg >= nh) return;
        score(s, Cs(wg), Bs(st, wg), np);
        y_step(j, h0 + wg, Xs(st, wg), Sg(st, wg));
      });
}

template <int PP, bool SHARED>
cudaError_t launch_sm90(const SsdArgs& g, size_t smem, cudaStream_t st) {
  auto* k = ssd_chunk_sm90<PP, SHARED>;
  cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)(g.nnt + g.nqt) * g.nc * g.l01 * g.nslab;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  k<<<(unsigned)blocks, NT, smem, st>>>(g);
  return cudaGetLastError();
}

template <int PP>
cudaError_t launch_sm90(const SsdArgs& g, bool shared, size_t smem, cudaStream_t st) {
  return shared ? launch_sm90<PP, true>(g, smem, st) : launch_sm90<PP, false>(g, smem, st);
}

// ---- f32: ssd_chunk_f32 --------------------------------------------------------------------

// Shared-memory geometry for N state columns and P head columns: the C and
// B tiles (64 rows, at least 64 columns so a state block can stage 64 of
// B's), the X tile, the f32 score tile, the f32 accumulator and two
// 64-entry f32 row vectors.
struct Layout {
  int ldn, ldx, lds, lda;
  size_t c, b, x, s, acc, rows, bytes;
  __host__ __device__ Layout(int N, int P) {
    const int np = round16(N) > T64 ? round16(N) : T64;
    const int pp = round16(P);
    ldn = np + Pad<float>::v;
    ldx = pp + Pad<float>::v;
    lds = T64 + 4;
    lda = pp + 4;
    size_t o = 0;
    c = o;
    o += al128(sizeof(float) * T64 * ldn);
    b = o;
    o += al128(sizeof(float) * T64 * ldn);
    x = o;
    o += al128(sizeof(float) * T64 * ldx);
    s = o;
    o += al128(sizeof(float) * T64 * lds);
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
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* __restrict__ src,
                                          long long rs, int r0, int nrows, int ncols, int cols,
                                          bool vec) {
  constexpr int CH = 4;
  const int cpr = cols / CH;
  for (int idx = threadIdx.x; idx < T64 * cpr; idx += NTHREADS) {
    const int r = idx / cpr, c = (idx % cpr) * CH, gr = r0 + r;
    float* d = dst + r * ld + c;
    if (gr < nrows && vec && c + CH <= ncols) {
      *reinterpret_cast<uint4*>(d) = __ldg(reinterpret_cast<const uint4*>(src + gr * rs + c));
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        d[e] = (gr < nrows && c + e < ncols) ? src[gr * rs + c + e] : 0.0f;
    }
  }
}

// C (64 x ncols, ldc) [+]= A (64 x K) . B (K x ncols), all in shared
// memory, full-f32 FMA.  A(i, k) at A[i * lda + k] (A_COL: A[k * lda + i]);
// B(k, j) at B[k * ldb + j] (B_COL: B[j * ldb + k]); ncols a multiple of
// 16.  Thread t owns rows (t / 16) * 8 + i and columns t % 16 + 16 * j of
// each 64-column stripe.
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
__global__ void __launch_bounds__(NTHREADS)
ssd_chunk_f32(const float* __restrict__ x, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ seg, float* __restrict__ y,
              float* __restrict__ st, Strides sd, int l1, int l2, int Q, int P, int N, int nqt,
              int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout g(N, P);
  float* Cs = reinterpret_cast<float*>(smem + g.c);
  float* Bs = reinterpret_cast<float*>(smem + g.b);
  float* Xs = reinterpret_cast<float*>(smem + g.x);
  float* Ss = reinterpret_cast<float*>(smem + g.s);
  float* Acc = reinterpret_cast<float*>(smem + g.acc);
  float* rq = reinterpret_cast<float*>(smem + g.rows);
  float* rk = rq + T64;

  const int li = blockIdx.z, chunk = blockIdx.y;
  const long long i0 = li / (l1 * l2), i1 = (li / l2) % l1, i2 = li % l2;
  auto at = [&](const long long* s5) {
    return i0 * s5[0] + i1 * s5[1] + i2 * s5[2] + (long long)chunk * s5[3];
  };
  const float* xb = x + at(sd.x);
  const float* bb = bm + at(sd.b);
  const float* cb = cm + at(sd.c);
  const float* sg = seg + at(sd.seg);
  const long long ss = sd.seg[4];
  const int pp = round16(P), np = round16(N);
  const bool v = vec != 0;

  if ((int)blockIdx.x < nqt) {
    // ---- Y rows [q0, q0 + 64): key tiles up to the diagonal ----
    const int q0 = blockIdx.x * T64;
    stage_f32(Cs, g.ldn, cb, sd.c[4], q0, Q, N, np, v);
    for (int r = threadIdx.x; r < T64; r += NTHREADS) rq[r] = q0 + r < Q ? sg[(q0 + r) * ss] : 0.0f;
    const int kend = min(q0 + T64, Q);
    for (int k0 = 0; k0 < kend; k0 += T64) {
      __syncthreads();
      stage_f32(Bs, g.ldn, bb, sd.b[4], k0, Q, N, np, v);
      stage_f32(Xs, g.ldx, xb, sd.x[4], k0, Q, P, pp, v);
      for (int r = threadIdx.x; r < T64; r += NTHREADS)
        rk[r] = k0 + r < Q ? sg[(k0 + r) * ss] : 0.0f;
      __syncthreads();
      tile_mma<false, true>(Ss, g.lds, Cs, g.ldn, Bs, g.ldn, T64, np, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < T64 * T64; idx += NTHREADS) {
        const int r = idx / T64, j = idx % T64, qi = q0 + r, kj = k0 + j;
        // the mask inside the exponent; kj < Q follows from kj <= qi < Q
        const bool live = kj <= qi && qi < Q;
        Ss[r * g.lds + j] = Ss[r * g.lds + j] * expf(live ? rq[r] - rk[j] : NEG_INF);
      }
      __syncthreads();
      tile_mma<false, false>(Acc, g.lda, Ss, g.lds, Xs, g.ldx, pp, T64, k0 > 0);
    }
    __syncthreads();
    float* yb = y + at(sd.y);
    for (int idx = threadIdx.x; idx < T64 * P; idx += NTHREADS) {
      const int r = idx / P, c = idx % P;
      if (q0 + r < Q) yb[(q0 + r) * sd.y[4] + c] = Acc[r * g.lda + c];
    }
  } else {
    // ---- S rows [n0, n0 + 64): every key tile of the chunk ----
    const int n0 = (blockIdx.x - nqt) * T64;
    const float last = sg[(Q - 1) * ss];
    for (int k0 = 0; k0 < Q; k0 += T64) {
      __syncthreads();
      stage_f32(Bs, g.ldn, bb + n0, sd.b[4], k0, Q, N - n0, T64, v);
      stage_f32(Xs, g.ldx, xb, sd.x[4], k0, Q, P, pp, v);
      for (int r = threadIdx.x; r < T64; r += NTHREADS)
        rq[r] = k0 + r < Q ? expf(last - sg[(k0 + r) * ss]) : 0.0f;
      __syncthreads();
      for (int idx = threadIdx.x; idx < T64 * pp; idx += NTHREADS) {
        const int r = idx / pp, c = idx % pp;
        Xs[r * g.ldx + c] = Xs[r * g.ldx + c] * rq[r];
      }
      __syncthreads();
      tile_mma<true, false>(Acc, g.lda, Bs, g.ldn, Xs, g.ldx, pp, T64, k0 > 0);
    }
    __syncthreads();
    float* sb = st + at(sd.s);
    for (int idx = threadIdx.x; idx < T64 * P; idx += NTHREADS) {
      const int r = idx / P, c = idx % P;
      if (n0 + r < N) sb[(n0 + r) * sd.s[4] + c] = Acc[r * g.lda + c];
    }
  }
}

cudaError_t launch_f32(const void* x, const void* b, const void* c, const void* seg, void* y,
                       void* st, const Strides& sd, int l0, int l1, int l2, int nc, int Q, int P,
                       int N, int vec, cudaStream_t s) {
  if (nc > 65535 || (long long)l0 * l1 * l2 > 65535) return cudaErrorInvalidValue;
  const Layout g(N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)g.bytes);
  if (err != cudaSuccess) return err;
  const int nqt = (Q + T64 - 1) / T64, nnt = (N + T64 - 1) / T64;
  dim3 grid(nqt + nnt, nc, l0 * l1 * l2);
  ssd_chunk_f32<<<grid, NTHREADS, g.bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(seg), static_cast<float*>(y), static_cast<float*>(st), sd, l1, l2,
      Q, P, N, nqt, vec);
  return cudaGetLastError();
}

}  // namespace

// x (l0, l1, l2, nc, Q, P), B / C (l0, l1, l2, nc, Q, N) bf16 or f32 with
// the element strides of `strides` (30: x, B, C, seg, Y, S; each three
// leading dims, the chunk and the row); seg (l0, l1, l2, nc, Q) f32; Y like
// x; S (l0, l1, l2, nc, N, P).  N <= 256, P <= 128.
// f32: `vec` allows 16-byte loads; nc and l0 l1 l2 <= 65535.
// bf16: `heads` heads per block (a slab), `shared` computes C B^T once per
// slab (B and C stride 0 over l2, Q <= 256), `widths` the copy widths in
// bytes of x, B and C (x | B << 8 | C << 16), `smem` the dynamic shared
// memory, as kernels/ssd/ops.py `launch_shape` decides them.
extern "C" int repro_ssd_chunk(const void* x, const void* b, const void* c, const void* seg,
                               void* y, void* st, const long long* strides, int l0, int l1,
                               int l2, int nc, int Q, int P, int N, int dtype, int vec, int heads,
                               int shared, int widths, long long smem, void* stream) {
  if (l0 <= 0 || l1 <= 0 || l2 <= 0 || nc <= 0 || Q <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      P > MAX_P)
    return (int)cudaErrorInvalidValue;
  Strides sd;
  std::memcpy(&sd, strides, sizeof(sd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return (int)launch_f32(x, b, c, seg, y, st, sd, l0, l1, l2, nc, Q, P, N, vec, s);
  if (dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  const int PP = P <= 16 ? 16 : P <= 32 ? 32 : P <= 64 ? 64 : 128;
  const int nqt = (Q + T64 - 1) / T64;
  if (heads <= 0 || (shared && nqt > MAX_SHARED_TILES) || (!shared && heads > WG) ||
      (size_t)smem != ssd_smem(N, PP, nqt, shared != 0, heads))
    return (int)cudaErrorInvalidValue;
  SsdArgs g{static_cast<const bf16*>(x), static_cast<const bf16*>(b), static_cast<const bf16*>(c),
            static_cast<const float*>(seg), static_cast<bf16*>(y), static_cast<bf16*>(st), sd,
            l1, l2, l0 * l1, nc, Q, P, N, heads, (l2 + heads - 1) / heads, nqt,
            (N + S_ROWS - 1) / S_ROWS, widths & 0xff, (widths >> 8) & 0xff, (widths >> 16) & 0xff};
  switch (PP) {
    case 16: return (int)launch_sm90<16>(g, shared != 0, (size_t)smem, s);
    case 32: return (int)launch_sm90<32>(g, shared != 0, (size_t)smem, s);
    case 64: return (int)launch_sm90<64>(g, shared != 0, (size_t)smem, s);
    default: return (int)launch_sm90<128>(g, shared != 0, (size_t)smem, s);
  }
}
