// Hopper (sm_90a) building blocks of the flash-attention kernels and of
// the bf16 GEMM mainloop (gemm_sm90.cuh): cp.async copies with zero fill,
// the async-proxy fence, shared-memory matrix descriptors, and the
// warpgroup matrix product `wgmma` (bf16 in, f32 accumulators in
// registers), as PTX; and for the warp-specialized expert GEMM
// (gemm_sm90_tma.cuh) TMA loads and stores of 3-D tensor maps, mbarriers,
// bulk groups, named barriers and `setmaxnreg`.
//
// Shared-memory tiles use the 128-byte swizzle of the descriptors (and of
// TMA): a tile of R rows is cut into atoms 64 columns (128 bytes) wide,
// each atom R rows of 128 bytes, and within each 8-row group the 16-byte
// chunk j of row r sits at chunk j ^ (r % 8) (`swz_off`).  So the 8 chunks
// of a row's atom fill one 128-byte shared row (no bank conflict), and the
// 8 threads that copy them read 128 contiguous bytes of device memory.
// (The no-swizzle core-matrix layout makes a warp's 16-byte copies either
// touch 16 device lines or conflict 16 ways in shared memory, and the
// copies then bound the kernels.)  The same tile is a
// K-major operand when its columns are the contraction axis (`desc_k`) and
// an MN-major (transposed) one when its rows are (`desc_mn`).  Tiles start
// 1024-byte aligned (the swizzle repeats every 8 rows of 128 bytes).  Rows
// of d not a multiple of 8 stage with 8-, 4- or 2-byte copies into the
// same places.
//
// Accumulator layout of m64nNk16 (PTX ISA, wgmma register fragments):
// thread t of the warpgroup (warp w = t / 32, lane l) holds rows
// 16 w + l / 4 and that + 8, and in each 8-column block J the columns
// 8 J + 2 (l % 4) + {0, 1}: register 4 J + e is (row + 8 (e / 2), column
// + e % 2).  A row's elements sit in one quad of lanes.  The A operand from
// registers (k16: four bf16x2 per thread) has the same layout as two
// adjacent 8-column accumulator blocks, so a score tile's accumulators
// become the next product's A operand without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Columns of a tile for padded head dim DP: whole 64-column atoms.
__host__ __device__ constexpr int tile_width(int DP) { return (DP + 63) / 64 * 64; }

// Element offset of (r, c) in a swizzled tile of R rows.
template <int R> __device__ __forceinline__ int swz_off(int r, int c) {
  return (c >> 6) * (R * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// The first 1024-byte aligned address at or after p.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// An asynchronous copy of B bytes (16, 8 or 4); ok == false fills zeros
// and reads nothing.
template <int B> __device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(B), "r"(ok ? B : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread (st.shared, cp.async) made visible to
// the async proxy that wgmma reads operands through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows [r0, r0 + R) of a row-strided matrix (row i at src + i *
// stride, d elements) into the first DP columns of a swizzled tile: columns
// in [d, DP) and rows >= nrows are zero.  All NT threads of the block take
// part, consecutive threads along a row's atom; the copies are
// asynchronous (commit and wait with cp_async_*) unless d is odd.
template <int R, int DP, int B, int NT>
__device__ __forceinline__ void stage_chunks(bf16* dst, const bf16* src, size_t stride, int r0,
                                             int nrows, int d) {
  constexpr int E = B / 2, CPA = 64 / E;  // elements per chunk, chunks per atom row
  constexpr int ATOMS = tile_width(DP) / 64;
  for (int i = threadIdx.x % NT; i < ATOMS * R * CPA; i += NT) {
    const int r = (i / CPA) % R, c = (i / (R * CPA)) * 64 + (i % CPA) * E;
    if (c >= DP) continue;
    const bool ok = r0 + r < nrows && c < d;
    cp_async<B>(dst + swz_off<R>(r, c), ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
  }
}
template <int R, int DP, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t stride, int r0,
                                           int nrows, int d) {
  if ((d & 7) == 0) {
    stage_chunks<R, DP, 16, NT>(dst, src, stride, r0, nrows, d);
  } else if ((d & 3) == 0) {
    stage_chunks<R, DP, 8, NT>(dst, src, stride, r0, nrows, d);
  } else if ((d & 1) == 0) {
    stage_chunks<R, DP, 4, NT>(dst, src, stride, r0, nrows, d);
  } else {  // 2-byte rows: no cp.async that narrow
    for (int i = threadIdx.x % NT; i < R * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      dst[swz_off<R>(r, c)] =
          r0 + r < nrows && c < d ? src[(size_t)(r0 + r) * stride + c] : __float2bfloat16_rn(0.0f);
    }
  }
}

// Matrix descriptor, 128-byte swizzle: start address, LBO and SBO in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// A swizzled tile of R rows as a K-major operand (contraction along its
// columns) at k step kk (columns 16 kk ..): the step's 32 bytes inside its
// atom's 128-byte rows; 8-row groups 1024 bytes apart (LBO unused).
template <int R> __device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return desc(tile + (kk >> 2) * (R * 64) + (kk & 3) * 16, 16, 1024);
}
// ... as an MN-major operand (contraction along its rows) at k step kk
// (rows 16 kk ..), from column c0 (a multiple of 64): 8-row groups 1024
// bytes apart along K, atoms R * 128 bytes apart along M or N.
template <int R> __device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk, int c0) {
  return desc(tile + (c0 >> 6) * (R * 64) + kk * 16 * 64, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin accumulator registers in program order around asynchronous products
// (the compiler sees the product's registers written at issue).
template <int N> __device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two f32 -> one bf16x2 (x0 in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16, bf16 x bf16 -> f32: d (N / 2 registers) = A . B (+ d when acc
// != 0).  TA, TB: 0 = K-major operand, 1 = MN-major (transposed).
template <int N, int TA, int TB> struct Wgmma;

template <int TA, int TB> struct Wgmma<16, TA, TB> {
  // d (+)= A . B, A and B in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (+)= A . B, A in registers (four bf16x2 per thread), B in shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<32, TA, TB> {
  // d (+)= A . B, A and B in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (+)= A . B, A in registers (four bf16x2 per thread), B in shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<48, TA, TB> {
  // d (+)= A . B, A and B in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (+)= A . B, A in registers (four bf16x2 per thread), B in shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<64, TA, TB> {
  // d (+)= A . B, A and B in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (+)= A . B, A in registers (four bf16x2 per thread), B in shared memory
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
};

// The GEMM's 128-column tiles (gemm_sm90.cuh): one instruction spans the
// tile's width, so A is read from shared memory once per k16 step.
template <int TA, int TB> struct Wgmma<128, TA, TB> {
  // d (+)= A . B, A and B in shared memory (descriptors)
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

// --- TMA, mbarriers and warp specialization (gemm_sm90_tma.cuh) -----------------------

// A shared-memory barrier expecting `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// The barriers' initialization made visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts ~2^26 polls (seconds) traps: a barrier nobody will complete is
// a fault, reported as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void prefetch_tmap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bytes` of transactions on `bar` (out-of-bounds elements
// arrive as zeros).
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// ... and back: the box at (c0, c1, c2) from shared memory (out-of-bounds
// elements are not written), in this thread's current bulk group.
__device__ __forceinline__ void tma_store_3d(const void* map, const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most N of this thread's bulk groups still reading shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ... or still writing device memory.
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Registers a thread of this warpgroup may hold, lowered or raised (all 128
// threads execute it; raised registers come from those a lowering freed).
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// A barrier among `threads` threads of the block (id 1-15; 0 is
// __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Any N that is a multiple of 16 (up to 256), A from registers, B MN-major:
// one m64n64 piece per 64-column atom, then one narrower; B's descriptor
// advances `atom` bytes per atom.
template <int N> struct WgmmaN {
  static constexpr int W = N >= 64 ? 64 : N;
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db,
                                            uint32_t atom, int acc) {
    Wgmma<W, 0, 1>::rs(d, a, db, acc);
    if constexpr (N > W) WgmmaN<N - W>::rs(d + W / 2, a, db + (atom >> 4), atom, acc);
  }
};

}  // namespace sm90
