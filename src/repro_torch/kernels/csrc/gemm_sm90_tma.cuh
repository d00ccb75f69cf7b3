// The expert-batched bf16 GEMM for Hopper (sm_90a): a TMA producer warp,
// consumer warpgroups on `wgmma`, a persistent walk over every expert's
// output tiles and stores staged through shared memory.  It runs the MoE
// layer's batched products (matmul_expert.cu: the nn forward, the nt dgrad
// and its two-pair form, the tn wgrad) and the fused-MLP backward's
// batched recompute (fused_mlp_bwd_expert.cu).  Stacks the TMA cannot
// describe (a base or a row not whole 16 bytes) keep gemm_sm90.cuh's
// BATCH instantiation, chosen by the wrapper.
//
// Roles.  A block has TM / 64 consumer warpgroups (each owns 64 rows of
// the tile) and one producer warpgroup, of which one thread issues every
// load.  With two consumer warpgroups `setmaxnreg` moves registers from the
// producer (40 a thread) to the consumers (232), whose two accumulator
// sets of the gated recompute take 128; with one the launch's 255 (128 at
// two blocks an SM) are enough and nothing moves.  A block's tile is TM
// rows by NP of the 2-D kernel's TN-column tiles, each with its own
// accumulators (TmaGeom: NP = 2 for the recompute's 64 x 64 decode tiles),
// and the 64 x 128 decode tiles run two blocks an SM: at decode the weights
// stream, and wider rows and more blocks in flight read them faster.
//
// Loads.  Each operand has a 3-D tensor map over its stored layout
// (row length, rows, experts), encoded on the host from the wrapper's
// description (kernels/matmul/ops.py `tma_operand`): a `.mT` view is its
// storage read the other way.  A box is 64 elements of the stored row (one
// 128-byte swizzle atom, the tile layout of sm90.cuh) by its rows: a
// K-major tile (the stored row is the contraction axis) is one box of TM or
// TN rows, an MN-major tile TM / 64 or TN / 64 boxes of 64 k-rows.  The
// 128-byte swizzle of the maps puts every box where sm90.cuh's
// descriptors read it, so the products are gemm_sm90.cuh's own
// (`GemmMainloop::mma_ab`).  The map's bounds zero-fill past each expert's
// rows and k, so no ragged copy and no padding: k = 8 or capacities off
// the tile cost one box each.  A K-major A box of an expert with fewer rows
// than the tile spans only those, rounded up to 8 (`tma_a_rows`): rows past
// them are never loaded, and the products they feed are rows the stores
// clip.  A ring of STAGES slots (as many as shared memory holds beside the
// epilogue's buffers, at most 8) has a full and an empty mbarrier a slot:
// the producer waits for a slot's empty phase, arms its full barrier with
// the step's bytes and issues its boxes; a consumer waits for the full
// phase, issues the step's products, and once `wgmma_wait<1>` shows the
// previous step's products done, each of its warps releases that step's
// slot.  The producer runs ahead through tile boundaries, so the next
// tile's first steps land while the consumers store the last one.
//
// Walk.  min(CTAS x SMs, tiles) blocks walk the (expert, n tile, m tile)
// order, m fastest, in one of two ways (expert_gemm_tma_launch).  Where an
// expert has several m tiles and several k steps, block b takes tiles b,
// b + gridDim.x, ...: the m tiles of one weight column tile start together
// and their k loops run side by side, so each weight box comes from device
// memory once.  Otherwise (decode, or k <= 64) the producer takes each next
// tile from a counter in device memory (one atomic a tile, zeroed by the
// launch) and hands it to its consumers through a queue in shared memory:
// the tiles in flight stay neighbours, where a fixed stride lets a slow
// block drift behind and scatter the weight rows' reads.
//
// Epilogue.  Each consumer warpgroup writes its 64 rows of the output in
// bf16 into a swizzled buffer (64-row atoms, conflict-free 4-byte writes),
// fences them into the async proxy, meets its other warps at a named
// barrier, and one thread stores the 64 x 64 boxes by TMA, clipped at the
// expert's edges.  C has two buffers: a tile's store drains while the next
// is written.  The backward epilogue's dh tile is one more TMA load (TM
// rows, issued once the tile's first ring steps are in: by then the last
// epilogue has freed it); dg is written over dh in place and du beside it
// (gated), du over dh otherwise, both leave by TMA, and the buffer is
// released when the stores have read it.
//
// Bits.  Tiles (64 x 128, 128 x 128; the recompute's 64 x 64, 128 x 128),
// 64-column k steps in ascending order, the same `wgmma` shapes issued in
// the same order into the same accumulators, and the same epilogue
// arithmetic (gemm_bwd_elem, round to nearest): every expert is
// bit-identical to the 2-D kernel at the same tile, unsplit.
#pragma once

#include <cuda.h>

#include <initializer_list>

#include "gemm_sm90.cuh"

namespace repro {

// Fields of one operand's description (kernels/matmul/ops.py
// `tma_operand`): dims innermost first, byte strides of dims 1 and 2, the
// box (elements of the stored row, rows), whether the stored row is the
// contraction axis (1: K-major) or not (0).
enum TmaField { TD_DIM0, TD_DIM1, TD_DIM2, TD_STRIDE1, TD_STRIDE2, TD_BOX0, TD_BOX1, TD_KMAJOR,
                TD_FIELDS };
// Operand slots of a description array and of TmaArgs.
enum TmaSlot { TS_A, TS_A1, TS_B0, TS_B1, TS_C, TS_DH, TS_DG, TS_DU, TS_SLOTS };

struct TmaArgs {
  CUtensorMap map[TS_SLOTS];  // unused slots stay zero
  int m, n, k, experts;
  int dynamic;   // 1: blocks take tiles from `counter` as they free up; 0: a fixed stride
  int* counter;  // the tiles handed out past the first wave (zeroed per launch)
  int stage_tx;  // bytes a ring step's boxes bring (the A box may have fewer than TM rows)
};

constexpr int TMA_TQ = 8;  // tile indices the producer may publish ahead

// A block's tile is TM rows by NP adjacent output tiles of TN columns,
// each of them the 2-D kernel's tile with its own accumulators: NP = 2 for
// the recompute's 64 x 64 decode tiles, so a block reads each weight row
// 256 bytes wide.  The 64 x 128 tiles run two blocks an SM (CTAS).
template <int TM, int TN, int NB, bool BWD> struct TmaGeom {
  static constexpr int CWG = TM / 64;              // consumer warpgroups
  static constexpr int THREADS = (CWG + 1) * 128;  // + the producer warpgroup
  static constexpr int NP = TM == 64 && TN == 64 ? 2 : 1;
  static constexpr int CTAS = TM == 64 && NP == 1 ? 2 : 1;  // blocks an SM
  static constexpr int W = NP * TN;                // a block tile's columns
  static constexpr int A_BYTES = TM * GEMM_BK * 2;
  static constexpr int B_BYTES = GEMM_BK * TN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NP * NB * B_BYTES;
  static constexpr int TILE_BYTES = TM * W * 2;
  // the epilogue's buffers: dh (dg over it) and du (gated), or C twice
  static constexpr int OUT_BYTES = BWD ? NB * TILE_BYTES : 2 * TILE_BYTES;
  static constexpr int BAR_BYTES = 512;  // the mbarriers and the tile queue
  // shared memory a block may take: 227 KB, or its share of the SM's 228 KB
  // less the 1 KB the hardware keeps a block
  static constexpr int LIMIT = CTAS == 1 ? 232448 : 233472 / CTAS - 1024;
  static constexpr int FIT = (LIMIT - 1024 - BAR_BYTES - OUT_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static_assert(STAGES >= 2, "the ring needs two slots");
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + BAR_BYTES;
};

// Expert z, block tile (m tile mt, n tile nt) of tile index `tile`, m fastest.
struct TmaTile {
  int z, row0, col0;
};
template <int TM, int W>
__device__ __forceinline__ TmaTile tma_tile(int tile, int tiles_m, int tiles_n) {
  const int mt = tile % tiles_m, rest = tile / tiles_m;
  return {rest / tiles_n, mt * TM, (rest % tiles_n) * W};
}

// The producer: step t of block tile `tt` (pair t / nkp, k from (t % nkp) *
// 64) into ring slot `st`, completing on `bar`: the A tile, then for each
// of the NP output tiles its NB B tiles.
template <int TM, int TN, int NB, int NP, bool TA, bool TB, int PAIRS>
__device__ __forceinline__ void tma_load_step(unsigned char* st, uint64_t* bar, const TmaArgs& p,
                                              const TmaTile& tt, int t, int nkp) {
  const int pr = PAIRS == 2 && t >= nkp;
  const int kt = (t - pr * nkp) * GEMM_BK;
  const CUtensorMap* A = &p.map[pr ? TS_A1 : TS_A];
  if (TA) {  // MN-major: TM / 64 boxes of 64 k-rows x 64 rows of the output
#pragma unroll
    for (int a = 0; a < TM / 64; ++a)
      sm90::tma_load_3d(st + a * 64 * 128, A, bar, tt.row0 + 64 * a, kt, tt.z);
  } else {   // K-major: one box of 64 k x TM rows
    sm90::tma_load_3d(st, A, bar, kt, tt.row0, tt.z);
  }
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const CUtensorMap* B = &p.map[(nb + pr) ? TS_B1 : TS_B0];
      unsigned char* bs = st + TM * GEMM_BK * 2 + (j * NB + nb) * GEMM_BK * TN * 2;
      const int c = tt.col0 + j * TN;
      if (TB) {
        sm90::tma_load_3d(bs, B, bar, kt, c, tt.z);
      } else {
#pragma unroll
        for (int a = 0; a < TN / 64; ++a)
          sm90::tma_load_3d(bs + a * 64 * 128, B, bar, c + 64 * a, kt, tt.z);
      }
    }
}

// C = A . B0 (+ A1 . B1), or the backward epilogue on A . B0 [, A . B1]
// (BWD: dh in, dg and du out), for every expert, persistent (head of file).
template <int TM, int TN, bool TA, bool TB, int PAIRS, int ACT, bool BWD>
__global__ void __launch_bounds__(TmaGeom<TM, TN, (ACT == ACT_SWIGLU ? 2 : 1), BWD>::THREADS,
                                  TmaGeom<TM, TN, (ACT == ACT_SWIGLU ? 2 : 1), BWD>::CTAS)
    expert_gemm_tma(const __grid_constant__ TmaArgs p) {
  constexpr int NB = ACT == ACT_SWIGLU ? 2 : 1;
  using G = TmaGeom<TM, TN, NB, BWD>;
  constexpr int STAGES = G::STAGES, CWG = G::CWG, NP = G::NP, W = G::W;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = sm90::align1024(smem_raw);
  unsigned char* out = ring + STAGES * G::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + G::OUT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* dh_full = empty + STAGES;
  uint64_t* dh_empty = dh_full + 1;
  uint64_t* tq_full = dh_empty + 1;  // the tile queue: tile tc at tc % TMA_TQ
  uint64_t* tq_empty = tq_full + TMA_TQ;
  int* tile_q = reinterpret_cast<int*>(tq_empty + TMA_TQ);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CWG * 4);  // each consumer warp
    }
    sm90::mbar_init(dh_full, 1);
    sm90::mbar_init(dh_empty, CWG);
    for (int q = 0; q < TMA_TQ; ++q) {
      sm90::mbar_init(&tq_full[q], 1);
      sm90::mbar_init(&tq_empty[q], CWG * 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int tiles_m = (p.m + TM - 1) / TM, tiles_n = (p.n + W - 1) / W;
  const int tiles = tiles_m * tiles_n * p.experts;
  const int nkp = (p.k + GEMM_BK - 1) / GEMM_BK, steps = PAIRS * nkp;

  if (wg == CWG) {
    // the producer warpgroup: one thread issues every load
    if (CWG == 2) sm90::setmaxnreg_dec<40>();
    if (tid != 0) return;
    sm90::prefetch_tmap(&p.map[TS_A]);
    sm90::prefetch_tmap(&p.map[TS_B0]);
    int it = 0;
    for (int tile = blockIdx.x, tc = 0;; ++tc) {
      int next = tile + gridDim.x;
      if (p.dynamic) {
        // publish this tile (or the end) to the consumers, then ask for the next
        const int q = tc % TMA_TQ;
        sm90::mbar_wait(&tq_empty[q], ((tc / TMA_TQ) & 1) ^ 1);
        tile_q[q] = tile;
        sm90::mbar_arrive(&tq_full[q]);
        if (tile < tiles) next = gridDim.x + atomicAdd(p.counter, 1);
      }
      if (tile >= tiles) break;
      const TmaTile tt = tma_tile<TM, W>(tile, tiles_m, tiles_n);
      // BWD: dh after the step whose slot the tile's first step freed (the
      // last epilogue is then done with the buffer), or after the last
      const int dh_after = steps - 1 < STAGES ? steps - 1 : STAGES;
      for (int t = 0; t < steps; ++t, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], p.stage_tx);
        tma_load_step<TM, TN, NB, NP, TA, TB, PAIRS>(ring + s * G::STAGE_BYTES, &full[s], p, tt,
                                                     t, nkp);
        if constexpr (BWD) {
          if (t != dh_after) continue;
          sm90::mbar_wait(dh_empty, (tc & 1) ^ 1);
          sm90::mbar_expect_tx(dh_full, G::TILE_BYTES);
#pragma unroll
          for (int a = 0; a < W / 64; ++a)
            sm90::tma_load_3d(out + a * TM * 128, &p.map[TS_DH], dh_full, tt.col0 + 64 * a,
                              tt.row0, tt.z);
        }
      }
      tile = next;
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of each tile
  if (CWG == 2) sm90::setmaxnreg_inc<232>();
  using Mainloop = GemmMainloop<TM, TN, NB, TA, TB, PAIRS>;
  const int lane = threadIdx.x % 32;
  // this thread's accumulator rows (and + 8) and first column in an output tile
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4, c0 = 2 * (tid % 4);
  float acc[NP][NB][TN / 2];
  int it = 0;
  for (int tc = 0;; ++tc) {
    int tile = blockIdx.x + tc * gridDim.x;
    if (p.dynamic) {
      const int q = tc % TMA_TQ;
      sm90::mbar_wait(&tq_full[q], (tc / TMA_TQ) & 1);
      tile = tile_q[q];
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&tq_empty[q]);
    }
    if (tile >= tiles) break;
    const TmaTile tt = tma_tile<TM, W>(tile, tiles_m, tiles_n);
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) acc[j][nb][i] = 0.0f;
    for (int t = 0; t < steps; ++t, ++it) {
      const int s = it % STAGES;
      const auto* st = reinterpret_cast<const __nv_bfloat16*>(ring + s * G::STAGE_BYTES);
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < NP; ++j)
        Mainloop::mma_ab(acc[j], st, st + TM * GEMM_BK + j * NB * GEMM_BK * TN, wg);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (t > 0 && lane == 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    if (lane == 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) sm90::fence_regs<TN / 2>(acc[j][nb]);

    const bool rows = tt.row0 + 64 * wg < p.m;  // this warpgroup's rows hold any output

    if constexpr (BWD) {
      // dh: W / 64 atoms of TM rows; dg over it, du (gated) in the next buffer
      unsigned char* dhb = out;
      unsigned char* dub = out + (NB - 1) * G::TILE_BYTES;
      sm90::mbar_wait(dh_full, tc & 1);
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int jj = 0; jj < TN / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h;
            const int off = 2 * sm90::swz_off<TM>(64 * wg + r0 + 8 * h, j * TN + 8 * jj + c0);
            const __nv_bfloat162 dh2 = *reinterpret_cast<const __nv_bfloat162*>(dhb + off);
            const float dh[2] = {__low2float(dh2), __high2float(dh2)};
            float dg[2], du[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              gemm_bwd_elem<ACT>(dh[e], acc[j][0][i + e], acc[j][NB - 1][i + e], dg[e], du[e]);
            if constexpr (NB == 2)
              *reinterpret_cast<uint32_t*>(dhb + off) = sm90::pack_bf16(dg[0], dg[1]);
            *reinterpret_cast<uint32_t*>(dub + off) = sm90::pack_bf16(du[0], du[1]);
          }
      sm90::fence_async_smem();
      sm90::named_sync(1 + wg, 128);
      if (tid == 0) {
        if (rows)
#pragma unroll
          for (int a = 0; a < W / 64; ++a) {
            if (tt.col0 + 64 * a >= p.n) break;
            const int o = a * TM * 128 + wg * 64 * 128;
            if constexpr (NB == 2)
              sm90::tma_store_3d(&p.map[TS_DG], dhb + o, tt.col0 + 64 * a, tt.row0 + 64 * wg,
                                 tt.z);
            sm90::tma_store_3d(&p.map[TS_DU], dub + o, tt.col0 + 64 * a, tt.row0 + 64 * wg, tt.z);
          }
        sm90::bulk_commit();
        sm90::bulk_wait_read<0>();
        sm90::mbar_arrive(dh_empty);
      }
    } else {
      // C: this warpgroup's 64 rows, W / 64 atoms of 64 rows, in buffer tc % 2
      unsigned char* cb = out + (tc & 1) * G::TILE_BYTES + wg * 64 * W * 2;
      if (tid == 0) sm90::bulk_wait_read<1>();  // the store two tiles back has read it
      sm90::named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int jj = 0; jj < TN / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * jj + 2 * h;
            *reinterpret_cast<uint32_t*>(
                cb + 2 * sm90::swz_off<64>(r0 + 8 * h, j * TN + 8 * jj + c0)) =
                sm90::pack_bf16(acc[j][0][i], acc[j][0][i + 1]);
          }
      sm90::fence_async_smem();
      sm90::named_sync(1 + wg, 128);
      if (tid == 0) {
        if (rows)
#pragma unroll
          for (int a = 0; a < W / 64; ++a) {
            if (tt.col0 + 64 * a >= p.n) break;
            sm90::tma_store_3d(&p.map[TS_C], cb + a * 64 * 128, tt.col0 + 64 * a,
                               tt.row0 + 64 * wg, tt.z);
          }
        sm90::bulk_commit();
      }
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();
}

// --- the host side: tensor maps and the launch ---------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, looked up once (no link to libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
        cudaSuccess)
      f = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// Encode one operand's bf16 map from its description (TD_FIELDS int64s),
// 128-byte swizzle, out-of-bounds elements zero; checks the box against the
// kernel's (box_rows rows, K-major or not).
inline cudaError_t tma_encode(CUtensorMap* map, const void* ptr, const long long* d,
                              int box_rows, int k_major) {
  if (ptr == nullptr || d[TD_BOX0] != GEMM_BK || d[TD_BOX1] != box_rows ||
      d[TD_KMAJOR] != k_major)
    return cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d[TD_DIM0], (cuuint64_t)d[TD_DIM1],
                              (cuuint64_t)d[TD_DIM2]};
  const cuuint64_t strides[2] = {(cuuint64_t)d[TD_STRIDE1], (cuuint64_t)d[TD_STRIDE2]};
  const cuuint32_t box[3] = {(cuuint32_t)d[TD_BOX0], (cuuint32_t)d[TD_BOX1], 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The rows of a K-major A box: the tile's TM, or, where an expert has
// fewer rows (decode), those rounded up to 8: the rows past them are never
// loaded, and the products they feed are rows the stores clip.
inline int tma_a_rows(int m, int tm) { return m < tm ? (m + 7) / 8 * 8 : tm; }

// Launch one instantiation over `sms` SMs, CTAS blocks an SM (at most one
// block a tile), in the walk the head of the file sets out: a fixed stride
// where an expert has several m tiles and several k steps, else the
// counter's.
template <int TM, int TN, bool TA, bool TB, int PAIRS, int ACT, bool BWD>
cudaError_t expert_gemm_tma_launch(TmaArgs& p, int sms, cudaStream_t s) {
  using G = TmaGeom<TM, TN, (ACT == ACT_SWIGLU ? 2 : 1), BWD>;
  const long long tiles_m = (p.m + TM - 1) / TM;
  const long long tiles = tiles_m * ((p.n + G::W - 1) / G::W) * p.experts;
  if (tiles <= 0 || tiles > 0x7fffffffLL || sms <= 0) return cudaErrorInvalidValue;
  p.dynamic = tiles_m == 1 || p.k <= GEMM_BK;
  p.stage_tx = G::STAGE_BYTES - (TA ? 0 : (TM - tma_a_rows(p.m, TM)) * GEMM_BK * 2);
  auto* kern = expert_gemm_tma<TM, TN, TA, TB, PAIRS, ACT, BWD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return err;
  const int grid = tiles < G::CTAS * sms ? (int)tiles : G::CTAS * sms;
  err = cudaMemsetAsync(p.counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kern<<<grid, G::THREADS, G::BYTES, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro
