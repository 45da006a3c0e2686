// Paged decode attention for NVIDIA Hopper (sm_90a), with a plain C entry
// point for ctypes (built by deepspeed_tpu_torch/ops/op_builder.py).
//
// Replaces the TPU kernels in deepspeed_tpu/ops/transformer/paged_attention.py:
// `_decode_kernel_stream` (:76, the default `stream=True` path) and
// `_decode_kernel` (:38, `stream=False`). Both compute the same function;
// `stream` only chose a TPU memory layout, so this one kernel serves both.
//
// What it computes. One query token per row against a blocked KV pool:
//   q (B, nh, hd), k_pool / v_pool (kvh, NB, BS, hd) kv-head-major,
//   tables (B, MAXB) int32 pool block ids, lens (B,) int32 = position + 1.
// Query heads [h*g, h*g + g) share KV head h (g = nh / kvh). An fp32 online
// softmax runs over the keys at positions < lens[b], which lie in the first
// ceil(lens[b] / BS) table blocks. The output (B, nh, hd) is in q's dtype; a
// row with lens == 0 gives zeros (the TPU kernel's `l_safe`, :156).
//
// What bounds it on this card: bytes. Each (row, kv head) reads K and V of
// its active keys once, 2 * len * hd elements, and does 4 * g * hd flops per
// key: g flops per byte in bf16, below the ~20 flops per byte at which the
// H100's fp32 units, and not its 3.35 TB/s memory, would be the limit.
//
// What the design does about it. A CTA of four warps takes one
// (row, kv head, chunk of up to GMAX query heads) and walks that row's block
// table itself (the TPU prefetched it as scalars). The warps split the keys
// of each block; a warp holds one key across its 32 lanes, hd / 32 contiguous
// elements a lane, read with loads of up to 16 bytes, so each K and V row
// is read once, coalesced, and never staged. q, the running max m, the sum l
// and the fp32 accumulator of every query head stay in registers; the four
// warps' partial states merge once, through shared memory, at the end. The
// TPU kernel's packed hd=64 view and its DMA double buffer answered Mosaic's
// 128-lane DMA rule, which Hopper does not have, and are not carried over.
//
// Left for later: splitting long contexts over several CTAs (flash-decoding),
// so a decode step with few rows fills all 132 SMs; cp.async or TMA
// pipelining of the blocks; packing a GQA group into tensor-core tiles.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Finite, as the TPU kernel's NEG_INF: a row that sees no key ends with
// l == 0 and writes zeros instead of NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// VEC contiguous elements at p, in loads of at most 16 bytes, widened to fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  constexpr int kPer16 = int(16 / sizeof(T));
  constexpr int kChunk = kPer16 < VEC ? kPer16 : VEC;
#pragma unroll
  for (int c = 0; c < VEC; c += kChunk) {
    const Vec<T, kChunk> x = *reinterpret_cast<const Vec<T, kChunk>*>(p + c);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) out[c + e] = to_float(x.v[e]);
  }
}

// Butterfly sum: every lane ends with the same, bitwise identical, total.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, T* __restrict__ out, int nh, int g,
                    int num_blocks, int block_size, int max_blocks, float scale) {
  constexpr int VEC = HD / 32;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * GMAX;  // first query head of this CTA's chunk
  const int ng = min(GMAX, g - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lens[b];
  const int nblk = min((len + block_size - 1) / block_size, max_blocks);

  // this CTA's query rows, pre-scaled; lane holds dims [lane*VEC, lane*VEC + VEC)
  const size_t q_row = (size_t)b * nh + (size_t)h * g + g0;
  float qr[GMAX][VEC];
  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    if (i < ng) {
      load_vec<T, VEC>(q + (q_row + i) * HD + lane * VEC, qr[i]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[i][e] = i < ng ? qr[i][e] * scale : 0.f;
      acc[i][e] = 0.f;
    }
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const size_t head_off = (size_t)h * num_blocks * block_size * HD;
  const T* kh = k_pool + head_off;
  const T* vh = v_pool + head_off;
  const int32_t* table = tables + (size_t)b * max_blocks;
  for (int j = 0; j < nblk; ++j) {
    const size_t blk_off = (size_t)table[j] * block_size * HD;
    const int valid = min(block_size, len - j * block_size);  // keys < lens in this block
    for (int t = warp; t < valid; t += kWarps) {
      float kf[VEC], vf[VEC];
      const size_t off = blk_off + (size_t)t * HD + lane * VEC;
      load_vec<T, VEC>(kh + off, kf);
      load_vec<T, VEC>(vh + off, vf);
#pragma unroll
      for (int i = 0; i < GMAX; ++i) {
        if (i < ng) {  // uniform across the CTA: no divergence around the shuffles
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s += qr[i][e] * kf[e];
          s = warp_sum(s);
          const float m_new = fmaxf(m[i], s);
          const float alpha = expf(m[i] - m_new);
          const float p = expf(s - m_new);
          l[i] = l[i] * alpha + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = acc[i][e] * alpha + p * vf[e];
          m[i] = m_new;
        }
      }
    }
  }

  // merge the four warps' online-softmax states (associative over any split
  // of the keys): rescale each to the common max, sum, divide once
  __shared__ float s_acc[kWarps * GMAX * HD];
  __shared__ float s_m[kWarps * GMAX];
  __shared__ float s_l[kWarps * GMAX];
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    if (i < ng) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_acc[(warp * GMAX + i) * HD + lane * VEC + e] = acc[i][e];
      if (lane == 0) {
        s_m[warp * GMAX + i] = m[i];
        s_l[warp * GMAX + i] = l[i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * HD; idx += kThreads) {
    const int i = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * GMAX + i]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w * GMAX + i] - mx);
      lsum += c * s_l[w * GMAX + i];
      a += c * s_acc[(w * GMAX + i) * HD + d];
    }
    out[(q_row + i) * HD + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* tables;
  const void* lens;
  void* out;
  int batch, num_heads, kv_heads, group, num_blocks, block_size, max_blocks;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int GMAX>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.batch, a.kv_heads, (a.group + GMAX - 1) / GMAX);
  paged_decode_kernel<T, HD, GMAX><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.lens), static_cast<T*>(a.out), a.num_heads, a.group,
      a.num_blocks, a.block_size, a.max_blocks, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(const Args& a) {
  if (a.group >= 8) return launch<T, HD, 8>(a);
  if (a.group >= 4) return launch<T, HD, 4>(a);
  if (a.group >= 2) return launch<T, HD, 2>(a);
  return launch<T, HD, 1>(a);
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 64: return dispatch_group<T, 64>(a);
    case 128: return dispatch_group<T, 128>(a);
    case 256: return dispatch_group<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a shape the kernel
// does not take. Launches on `stream`; does not synchronise.
extern "C" int dstt_paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                                           const void* tables, const void* lens, void* out,
                                           int dtype, int batch, int num_heads, int kv_heads,
                                           int head_dim, int num_blocks, int block_size,
                                           int max_blocks, float scale, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || kv_heads > 65535 || num_heads % kv_heads != 0 ||
      block_size <= 0 || max_blocks <= 0 || num_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q,         k_pool,    v_pool,
               tables,    lens,      out,
               batch,     num_heads, kv_heads,
               num_heads / kv_heads,  num_blocks, block_size,
               max_blocks, scale,    static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dispatch_head_dim<float>(head_dim, a);
    case 1: return (int)dispatch_head_dim<__nv_bfloat16>(head_dim, a);
    case 2: return (int)dispatch_head_dim<__half>(head_dim, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dstt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
