// Candidate tiles of the int8 kernels (kernels/csrc/gemm_sm90_s8.cuh) for
// the sweep in int8_tiles.py: the library's own tiles and the others the
// mainloop can run, each with any split of k.  Not part of the kernel
// library; the sweep builds it on its own.
#include "gemm_sm90_s8.cuh"

// m64n64k32 for the 64-column fused candidates (the library has n 32, 128
// and 256 only).
namespace sm90 {
template <> struct WgmmaS8<64> {
  static __device__ __forceinline__ void ss(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};
}  // namespace sm90

using namespace repro;

#define REPRO_INT8_TILE(TM, TN, ACT)                                            \
  if (tm == TM && tn == TN && act == ACT)                                       \
    return (int)int8_sm90_launch<TM, TN, ACT, __nv_bfloat16>(g, splits, s);

// The arguments of repro_int8_matmul / repro_int8_fused_mlp (bf16 out),
// with the tile (tm, tn) and the split of k forced; act ACT_NONE (the GEMM)
// or ACT_SWIGLU (the fused MLP: b0 the gate, b1 up).
extern "C" int repro_int8_tile(const void* a, const void* b0, const void* b1, const void* as,
                               const void* s0, const void* s1, void* c, int m, int n, int k,
                               int k_split, int act, int vec, int tm, int tn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || k_split <= 0 || k_split % I8_BK)
    return (int)cudaErrorInvalidValue;
  const int splits = (k + k_split - 1) / k_split;
  const I8Args g{static_cast<const signed char*>(a), static_cast<const signed char*>(b0),
                 static_cast<const signed char*>(b1), static_cast<const float*>(as),
                 static_cast<const float*>(s0), static_cast<const float*>(s1),
                 c, m, n, k, k_split, vec};
  REPRO_INT8_TILE(64, 128, ACT_NONE)
  REPRO_INT8_TILE(64, 256, ACT_NONE)
  REPRO_INT8_TILE(128, 128, ACT_NONE)
  REPRO_INT8_TILE(128, 256, ACT_NONE)
  REPRO_INT8_TILE(64, 32, ACT_SWIGLU)
  REPRO_INT8_TILE(64, 64, ACT_SWIGLU)
  REPRO_INT8_TILE(128, 32, ACT_SWIGLU)
  REPRO_INT8_TILE(128, 64, ACT_SWIGLU)
  return (int)cudaErrorInvalidValue;
}
