// The int8 GEMM mainloop for Hopper (sm_90a), behind the int8 GEMM
// (int8_matmul.cu) and the int8 fused MLP (int8_fused_mlp.cu): int8
// operands, exact int32 sums, an f32 de-scale in the epilogue.
//
// The shape of gemm_sm90.cuh's bf16 mainloop, with the byte geometry
// unchanged: a k step is I8_BK = 128 int8 columns, one 128-byte swizzle atom
// (sm90.cuh), which `wgmma.mma_async ... m64nNk32.s32.s8.s8` consumes in
// four products of 32 bytes (desc_k's 32-byte advance inside the atom, as
// one k16 bf16 product).  Each step's A tile and B tile(s) are copied with
// cp.async (16-byte chunks, zero fill past the ragged edge; plain byte
// stores where a row is not whole 16-byte chunks) into gemm_sm90.cuh's
// ring (ring_mainloop: four slots, two steps ahead of the step being
// multiplied, one barrier per step).  Deeper rings (six or eight slots, or
// four steps ahead at two blocks an SM) and 256-column steps ran no faster
// on the card.
//
// Layout: PTX allows an MN-major (transposed) `wgmma` operand only for
// f16 / bf16, so for s8 both operands are K-major.  A (m, k) row-major is;
// the weights are held transposed, Bt (n, k) row-major (quant.k_major: the
// `.mT` view of a contiguous (n, k) tensor, made once at load).  Each tile
// is R rows of one 128-byte atom.
//
// Tiles: TM x TN outputs a block, TM = 64 (one warpgroup: decode and
// prefill rows of at most 64, every weight byte read once) or 128 (two
// warpgroups); TN = 128 (64 rows) or 256 (128 rows) for the GEMM, 32 with
// NB = 2 accumulator sets for the gated MLP (x staged once for gate and
// up).
//
// Arithmetic, exact: |sum| <= k 127^2 < 2^31 for k < 133,000, so the int32
// products need no .satfinite.  The epilogue reads the accumulators from
// registers (layout at the head of sm90.cuh): the de-scale (f32(acc) *
// a_scale[row]) * b_scale[col] — i32 -> f32 rounded to nearest, then two
// f32 products in the JAX kernel's order — and the activation (silu(g) u,
// gelu_tanh, relu2) in f32, rounded once to T.  A split of k runs its
// blocks as one thread-block cluster, which sums the int32 partials exactly
// in distributed shared memory before that de-scale (i8_cluster_reduce).
#pragma once

#include <cooperative_groups.h>

#include "gemm_sm90.cuh"

namespace sm90 {

template <int N> __device__ __forceinline__ void fence_regs(int* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// m64nNk32, s8 x s8 -> s32: d (N / 2 registers) (+)= A . B, A and B K-major
// in shared memory (descriptors).
template <int N> struct WgmmaS8;

template <> struct WgmmaS8<32> {
  static __device__ __forceinline__ void ss(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <> struct WgmmaS8<128> {
  static __device__ __forceinline__ void ss(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <> struct WgmmaS8<256> {
  static __device__ __forceinline__ void ss(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(acc));
  }
};

}  // namespace sm90

namespace repro {

constexpr int I8_BK = 128;  // k per step: one 128-byte swizzle atom

// One launch's operands.  Every matrix is row-major with its row length as
// its leading dimension.
struct I8Args {
  const signed char* a;   // A (m, k)
  const signed char* b0;  // Bt (n, k): the weight, K-major; the gate when NB = 2
  const signed char* b1;  // the up weight (NB = 2)
  const float* a_scale;   // (m)
  const float* b0_scale;  // (n)
  const float* b1_scale;  // (n), NB = 2
  void* c;                // C (m, n), T
  int m, n, k, k_split;
  int vec;  // both bases 16-byte aligned, k a multiple of 16
  // an expert-batched launch (BATCH): expert z's A, Bt and C start z * sa,
  // z * sb and z * sc elements after the bases, its activation scales z * m
  // and its weight scales z * n
  long long sa, sb, sc;
};

// The operands of expert z of a batched launch (NB = 1), C in T.
template <typename T> __device__ __forceinline__ I8Args i8_expert(I8Args g, int z) {
  const long long e = z;
  g.a += e * g.sa;
  g.b0 += e * g.sb;
  g.a_scale += e * g.m;
  g.b0_scale += e * g.n;
  g.c = static_cast<T*>(g.c) + e * g.sc;
  return g;
}

template <int TM, int TN, int NB> struct I8Smem {
  static constexpr int A_BYTES = TM * I8_BK;
  static constexpr int B_BYTES = TN * I8_BK;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  // the ring, and room to align it to 1024 bytes (the swizzle's period)
  static constexpr int BYTES = GEMM_STAGES * STAGE_BYTES + 1024;
};

// Stage rows [r0, r0 + R) x columns [c0, c0 + 128) of an int8 row-major
// matrix (row length `stride`, valid extent nrows x ncols) into a swizzled
// tile of R rows of 128 bytes: chunk j of row r at chunk j ^ (r % 8)
// (sm90::swz_off in bytes).  Out of range reads as zero.  Eight
// consecutive threads copy one row's 128 contiguous bytes.
template <int R, int NT>
__device__ __forceinline__ void i8_stage(signed char* dst, const signed char* src, int stride,
                                         int r0, int nrows, int c0, int ncols, int vec) {
  if (vec) {
    for (int i = threadIdx.x; i < R * 8; i += NT) {
      const int r = i / 8, j = i % 8, c = c0 + 16 * j;
      const bool ok = r0 + r < nrows && c < ncols;
      sm90::cp_async<16>(dst + r * 128 + ((j ^ (r & 7)) << 4),
                         ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
    }
  } else {  // rows not whole 16-byte chunks
    for (int i = threadIdx.x; i < R * 128; i += NT) {
      const int r = i / 128, b = i % 128;
      const bool ok = r0 + r < nrows && c0 + b < ncols;
      dst[r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))] =
          ok ? src[(size_t)(r0 + r) * stride + c0 + b] : (signed char)0;
    }
  }
}

__device__ __forceinline__ const sm90::bf16* as_desc_tile(const signed char* p) {
  return reinterpret_cast<const sm90::bf16*>(p);
}

template <int TM, int TN, int NB> struct I8Mainloop {
  static constexpr int NT = TM / 64 * 128;
  using S = I8Smem<TM, TN, NB>;

  // Copy step t (k columns from k0 + t * 128) into a slot.
  static __device__ __forceinline__ void load(signed char* slot, const I8Args& g, int t, int k0,
                                              int k1, int row0, int col0) {
    const int kt = k0 + t * I8_BK;
    i8_stage<TM, NT>(slot, g.a, g.k, row0, g.m, kt, k1, g.vec);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      i8_stage<TN, NT>(slot + S::A_BYTES + nb * S::B_BYTES, nb ? g.b1 : g.b0, g.k, col0, g.n, kt,
                       k1, g.vec);
  }

  // acc[nb] += (this warpgroup's 64 rows of A) . Bt[nb]^T over one slot's 128 k.
  static __device__ __forceinline__ void mma(int (&acc)[NB][TN / 2], const signed char* slot,
                                             int wg) {
#pragma unroll
    for (int kk = 0; kk < I8_BK / 32; ++kk) {
      const uint64_t da = sm90::desc_k<64>(as_desc_tile(slot + wg * 64 * I8_BK), kk);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint64_t db = sm90::desc_k<TN>(as_desc_tile(slot + S::A_BYTES + nb * S::B_BYTES), kk);
        sm90::WgmmaS8<TN>::ss(acc[nb], da, db, 1);
      }
    }
  }

  // acc[nb] += A . Bt[nb]^T over k in [k0, k1) for the tile at (row0, col0).
  static __device__ __forceinline__ void run(int (&acc)[NB][TN / 2], signed char* ring,
                                             const I8Args& g, int k0, int k1, int row0,
                                             int col0) {
    const int wg = threadIdx.x / 128;
    ring_mainloop(
        (k1 - k0 + I8_BK - 1) / I8_BK,
        [&](int slot, int t) { load(ring + slot * S::STAGE_BYTES, g, t, k0, k1, row0, col0); },
        [&](int slot) { mma(acc, ring + slot * S::STAGE_BYTES, wg); });
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) sm90::fence_regs<TN / 2>(acc[nb]);
  }
};

// The de-scale of one exact int32 sum, as the JAX kernel's epilogue.
__device__ __forceinline__ float i8_descale(int acc, float a_scale, float b_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), a_scale), b_scale);
}

// Two adjacent outputs at p[o], p[o + 1] (the second only if `two`).
__device__ __forceinline__ void i8_put2(__nv_bfloat16* p, size_t o, float v0, float v1, bool two,
                                        bool even) {
  gemm_put2(p, o, v0, v1, two, even);
}
__device__ __forceinline__ void i8_put2(float* p, size_t o, float v0, float v1, bool two,
                                        bool even) {
  if (two && even) {
    *reinterpret_cast<float2*>(p + o) = make_float2(v0, v1);
  } else {
    p[o] = v0;
    if (two) p[o + 1] = v1;
  }
}

// The sum of a tile's split-k partials across its cluster (the gridDim.z
// blocks of one output tile): each block parks its int32 partial in its own
// shared memory, then block z sums rows z, z + splits, ... of the tile over
// every block's partial (distributed shared memory), exactly, de-scales
// them and writes them.  The second cluster barrier keeps every block's
// shared memory alive until the others have read it.
template <int TM, int TN, typename T>
__device__ __forceinline__ void i8_cluster_reduce(const int (&acc)[TN / 2], unsigned char* smem,
                                                  const I8Args& g, int row0, int col0) {
  constexpr int NT = TM / 64 * 128, LD = TN + 8;  // padded rows: no bank conflict parking them
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  int* part = reinterpret_cast<int*>(smem);
  __syncthreads();  // every warpgroup's products have read the ring
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int rl = 64 * wg + 16 * (t / 32) + (t % 32) / 4, cl = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(part + (rl + 8 * h) * LD + cl + 8 * j) =
          make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  cluster.sync();
  const int splits = gridDim.z, z = blockIdx.z;
  const bool even = (g.n & 1) == 0;
  for (int i = threadIdx.x;; i += NT) {
    const int r = z + (i / (TN / 2)) * splits, c = 2 * (i % (TN / 2));
    if (r >= TM) break;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= g.m || gc >= g.n) continue;
    int s0 = 0, s1 = 0;
    for (int q = 0; q < splits; ++q) {
      const int2 v = *reinterpret_cast<const int2*>(cluster.map_shared_rank(part, q) + r * LD + c);
      s0 += v.x;
      s1 += v.y;
    }
    const bool two = gc + 1 < g.n;
    const float xs = g.a_scale[gr];
    i8_put2(static_cast<T*>(g.c), (size_t)gr * g.n + gc, i8_descale(s0, xs, g.b0_scale[gc]),
            two ? i8_descale(s1, xs, g.b0_scale[gc + 1]) : 0.0f, two, even);
  }
  cluster.sync();
}

// C = epilogue(A . B0 [, A . B1]) with int8 operands, C in T.  NB = 2 only
// for ACT_SWIGLU (B0 the gate, B1 the up weight).  grid (ceil(m / TM),
// ceil(n / TN), splits): the row tile varies fastest, so the blocks in
// flight share B's column tiles and A stays in L2.  With splits > 1
// (ACT_NONE; launched as clusters of (1, 1, splits)) block z covers k in
// [z k_split, min(k, (z + 1) k_split)) and the cluster sums the partials.
// BATCH (ACT_NONE): grid (ceil(m / TM), ceil(n / TN), experts), no cluster
// and no split; block z runs expert z's product (`i8_expert`), the whole k
// range.
template <int TM, int TN, int ACT, typename T, bool BATCH = false>
__global__ void __launch_bounds__(TM / 64 * 128, 1) int8_sm90_kernel(const I8Args ga) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  static_assert(!BATCH || ACT == ACT_NONE, "a batched launch is the plain GEMM");
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* ring = reinterpret_cast<signed char*>(sm90::align1024(smem));

  const I8Args g = BATCH ? i8_expert<T>(ga, blockIdx.z) : ga;
  const int row0 = blockIdx.x * TM, col0 = blockIdx.y * TN;
  const int k0 = BATCH ? 0 : blockIdx.z * g.k_split;
  const int k1 = BATCH ? g.k : min(g.k, k0 + g.k_split);

  int acc[NB][TN / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[nb][i] = 0;
  I8Mainloop<TM, TN, NB>::run(acc, ring, g, k0, k1, row0, col0);
  if constexpr (ACT == ACT_NONE && !BATCH) {
    if (gridDim.z > 1) {
      i8_cluster_reduce<TM, TN, T>(acc[0], reinterpret_cast<unsigned char*>(ring), g, row0, col0);
      return;
    }
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int rb = row0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int cb = col0 + 2 * (t % 4);
  const bool even = (g.n & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = rb + 8 * h;
    if (gr >= g.m) continue;
    const float xs = g.a_scale[gr];
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int gc = cb + 8 * j;
      if (gc >= g.n) continue;
      const bool two = gc + 1 < g.n;
      const int i = 4 * j + 2 * h;  // registers i, i + 1: columns gc, gc + 1
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = two ? gc + e : gc;  // a lone last column reads its own scale twice
        v[e] = i8_descale(acc[0][i + e], xs, g.b0_scale[c]);
        if (ACT == ACT_SWIGLU) v[e] = silu(v[e]) * i8_descale(acc[NB - 1][i + e], xs, g.b1_scale[c]);
        if (ACT == ACT_GELU) v[e] = gelu_tanh(v[e]);
        if (ACT == ACT_RELU2) v[e] = relu2(v[e]);
      }
      i8_put2(static_cast<T*>(g.c), (size_t)gr * g.n + gc, v[0], v[1], two, even);
    }
  }
}

// Launch one instantiation: its dynamic shared memory, then the grid, with
// the blocks of each tile's k splits in one cluster (at most 8).  BATCH:
// `splits` is the number of experts, each block alone (no cluster).
template <int TM, int TN, int ACT, typename T, bool BATCH = false>
cudaError_t int8_sm90_launch(const I8Args& g, int splits, cudaStream_t s) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  constexpr int SMEM = I8Smem<TM, TN, NB>::BYTES;
  static_assert(TM * (TN + 8) * 4 <= SMEM - 1024, "the parked partial must fit the ring");
  const long long ny = (g.n + TN - 1) / TN;
  if (ny > 65535 || splits < 1 || splits > (BATCH ? 65535 : 8) ||
      (ACT != ACT_NONE && splits > 1))
    return cudaErrorInvalidValue;
  auto* kern = int8_sm90_kernel<TM, TN, ACT, T, BATCH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.m + TM - 1) / TM, (unsigned)ny, splits);
  if (BATCH || splits == 1) {
    kern<<<grid, TM / 64 * 128, SMEM, s>>>(g);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(TM / 64 * 128);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, g);
}

}  // namespace repro
