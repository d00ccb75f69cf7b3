// paged_decode: one-query GQA decode attention over a KV slot pool.
//
// Replaces: src/repro/kernels/flash_attention/paged.py `paged_decode_pallas`
// (`_paged_kernel`), float pool: decode attention of every layer under
// Engine(use_paged_kernel=True).
//
// What bounds it on the H100: bytes.  Per row it reads the live prefix of
// one pool slot, lengths[b] * nkv * d * 2 elements of K and V, and does 4
// FLOPs per element read (a score and a weighted sum per query head of the
// group, g = 2 here): ~2 FLOP/byte, far under any compute line.
//
// What the design does about it: one block per (row b, kv head h) serves
// the g query heads that share the kv head (head i -> kv head i // g, as
// paged.py:121), so each K/V element is read from device memory once for
// all g heads.  The block loads slot_idx[b] and lengths[b] itself and walks
// kv tiles only up to lengths[b] (a dead slot reads nothing and writes
// zeros), staging each tile in shared memory with 16-byte loads and running
// the online softmax in f32 (paged.py:76-88).  The tail tile is masked, so
// any pool depth works (no gcd clamp or pad of the pool, ops.py:208-225).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;       // query heads per kv head
constexpr int MAX_D = 256;     // head dim
constexpr int DPT = MAX_D / THREADS;  // output columns per thread (<= 2)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q (b, a, d); pools (slots, s_max, nkv, d); out (b, a, d).  grid (b, nkv).
// Dynamic shared memory: K and V tiles (bkv x d of T each), q (g x d f32),
// scores (g x bkv f32), and the per-head running max / sum / rescale.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ slot_idx,
                    const int* __restrict__ lengths, T* __restrict__ out, int a, int nkv, int d,
                    int s_max, int bkv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = a / nkv;
  const int row = blockIdx.x, h = blockIdx.y;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + bkv * d;
  float* qs = reinterpret_cast<float*>(Vs + bkv * d);
  float* ss = qs + g * d;
  float* m_s = ss + g * bkv;
  float* l_s = m_s + MAX_G;
  float* alpha_s = l_s + MAX_G;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qrow = q + ((size_t)row * a + (size_t)h * g) * d;
  T* orow = out + ((size_t)row * a + (size_t)h * g) * d;
  const int len = min(lengths[row], s_max);

  float acc[MAX_G][DPT];
#pragma unroll
  for (int gi = 0; gi < MAX_G; ++gi)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[gi][c] = 0.0f;

  if (len <= 0) {  // dead slot: zeros (paged.py:92-94)
    for (int i = tid; i < g * d; i += THREADS) orow[i] = from_f<T>(0.0f);
    return;
  }
  const int slot = slot_idx[row];
  for (int i = tid; i < g * d; i += THREADS) qs[i] = to_f(qrow[i]);
  if (tid < g) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }

  constexpr int CH = 16 / sizeof(T);
  const int cpr = d / CH;  // 16-byte chunks per token row
  const size_t tok_stride = (size_t)nkv * d;
  const T* kbase = k_pool + ((size_t)slot * s_max * nkv + h) * d;
  const T* vbase = v_pool + ((size_t)slot * s_max * nkv + h) * d;

  for (int t0 = 0; t0 < len; t0 += bkv) {
    const int nt = min(bkv, len - t0);
    __syncthreads();  // previous tile fully consumed (and q / m / l staged)
    for (int idx = tid; idx < nt * cpr; idx += THREADS) {
      const int j = idx / cpr, c = (idx % cpr) * CH;
      const size_t off = (size_t)(t0 + j) * tok_stride + c;
      *reinterpret_cast<uint4*>(Ks + j * d + c) = __ldg(reinterpret_cast<const uint4*>(kbase + off));
      *reinterpret_cast<uint4*>(Vs + j * d + c) = __ldg(reinterpret_cast<const uint4*>(vbase + off));
    }
    __syncthreads();

    // scores: warp w takes tokens w, w + WARPS, ...; lanes split the dot
    for (int j = warp; j < nt; j += WARPS) {
      float part[MAX_G];
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) part[gi] = 0.0f;
      for (int e = lane; e < d; e += 32) {
        const float kv = to_f(Ks[j * d + e]);
#pragma unroll
        for (int gi = 0; gi < MAX_G; ++gi)
          if (gi < g) part[gi] = fmaf(qs[gi * d + e], kv, part[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) {
        if (gi < g) {
          const float s = warp_sum(part[gi]);
          if (lane == 0) ss[gi * bkv + j] = s * scale;
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int gi = warp; gi < g; gi += WARPS) {
      float mx = NEG_INF;
      for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, ss[gi * bkv + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < nt; j += 32) {
        const float p = expf(ss[gi * bkv + j] - m_new);
        ss[gi * bkv + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[gi] = alpha;
        l_s[gi] = alpha * l_s[gi] + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V; thread owns columns tid, tid + THREADS
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int e = tid + c * THREADS;
      if (e >= d) break;
      float pv[MAX_G];
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi) pv[gi] = 0.0f;
      for (int j = 0; j < nt; ++j) {
        const float vv = to_f(Vs[j * d + e]);
#pragma unroll
        for (int gi = 0; gi < MAX_G; ++gi)
          if (gi < g) pv[gi] = fmaf(ss[gi * bkv + j], vv, pv[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < MAX_G; ++gi)
        if (gi < g) acc[gi][c] = acc[gi][c] * alpha_s[gi] + pv[gi];
    }
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int e = tid + c * THREADS;
    if (e >= d) break;
#pragma unroll
    for (int gi = 0; gi < MAX_G; ++gi) {
      if (gi < g) {
        float l = l_s[gi];
        l = l == 0.0f ? 1.0f : l;
        orow[gi * d + e] = from_f<T>(acc[gi][c] / l);
      }
    }
  }
}

}  // namespace

// Shared memory for a tile of bkv tokens (the wrapper sizes bkv).
extern "C" size_t repro_paged_decode_smem(int g, int d, int bkv, int dtype) {
  const size_t el = dtype == 1 ? 2 : 4;
  return 2 * (size_t)bkv * d * el + (size_t)g * d * 4 + (size_t)g * bkv * 4 + 3 * MAX_G * 4;
}

// q (b, a, d); k_pool, v_pool (slots, s_max, nkv, d); slot_idx, lengths (b,)
// int32; out (b, a, d).  All contiguous.  dtype: 0 = f32, 1 = bf16.
extern "C" int repro_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                  const void* slot_idx, const void* lengths, void* out, int b,
                                  int a, int nkv, int d, int s_max, int bkv, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || nkv <= 0 || a % nkv || a / nkv > MAX_G || d > MAX_D || bkv <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = repro_paged_decode_smem(a / nkv, d, bkv, dtype);
  dim3 grid(b, nkv);
  const int* si = static_cast<const int*>(slot_idx);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == 1) {
    if (d % 8) return (int)cudaErrorInvalidValue;
    auto* kern = paged_decode_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), si, ln, static_cast<__nv_bfloat16*>(out), a,
        nkv, d, s_max, bkv, scale);
  } else if (dtype == 0) {
    if (d % 4) return (int)cudaErrorInvalidValue;
    auto* kern = paged_decode_kernel<float>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, THREADS, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k_pool),
                                     static_cast<const float*>(v_pool), si, ln,
                                     static_cast<float*>(out), a, nkv, d, s_max, bkv, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
