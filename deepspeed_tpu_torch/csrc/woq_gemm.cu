// Weight-only-quantized matmul for NVIDIA Hopper (sm_90a), with a plain C
// entry point for ctypes (built by deepspeed_tpu_torch/ops/op_builder.py).
//
// Replaces the TPU kernel `_kernel` in deepspeed_tpu/ops/quantizer/woq_gemm.py
// (:39, launched by `woq_matmul` :84).
//
// What it computes. out (B, Out) fp32 = x (B, In) @ w, where w is the
// dequantized weight: w[k, o] = code[k, o] * scale[k / group, o], formed in
// fp32 as `_dequant_leaf` forms it, then rounded to x's dtype (identity for
// fp32 x), with every product accumulated in fp32. codes are int8
// (ng, packed, Out) with Out contiguous; scale is fp32 (ng, 1, Out).
//   int8: one code a byte, K row k in byte row k.
//   int4: two codes a byte along K: byte row k / 2, the low nibble is the
//         even row and the high nibble the odd one, sign-extended with
//         arithmetic shifts (woq.py:60-63, 89-92).
//   int6: four codes in three bytes along K: byte rows (k / 4) * 3 + {0,1,2},
//         read as 0..255 and unpacked as `unpack6` does, then (c ^ 32) - 32.
// Because a group is a multiple of the packing unit, a code's byte row
// depends on k alone; only the scale depends on the group, so any group the
// quantizer makes (power of two or not) runs the same code.
//
// What bounds it on this card. Decode (B <= 8 rows): bytes. The codes and
// scales stream once, ~1 byte a weight for int8, and each byte feeds at
// most 2 * B flops, far below the ~295 flops a byte at which the tensor
// cores would be the limit. Prefill (B = 256): operations, 2 * B flops a
// weight, above that line for 16-bit x.
//
// What the design does about it. The TPU kernel walks the K groups as a
// sequential grid axis with an accumulator carried in VMEM from one grid
// step to the next; CUDA blocks run in no order, so a loop inside the block
// takes that axis' place, and a split of K across blocks writes partial sums
// that a second pass adds in a fixed order (no atomics: repeated serving
// steps are bitwise equal).
// - Few rows (`woq_gemv_kernel`): a CTA of four warps covers 256 columns,
//   eight contiguous columns a lane, so a warp reads 256 contiguous code
//   bytes of a row in 8-byte loads and unpacks them in registers. The four
//   warps take interleaved packing units of each group of the CTA's K run;
//   B x 8 fp32 accumulators stay in registers and the warps' sums meet once
//   in shared memory. K is split over CTAs in whole groups so that a
//   4096-column projection still fills the 132 SMs.
// - Many rows (`woq_tiled_kernel`): a CTA computes a 64 x 64 tile of out,
//   stepping K by 32: it stages the x tile and the dequantized (32 x 64)
//   weight slab in shared memory in x's dtype, then runs the tile product
//   on the tensor cores (WMMA 16x16x16, bf16/fp16 in, fp32 accumulators in
//   registers) or, for fp32 x, with FMAs from an 8 x 4 register tile a
//   thread; the next K step's x and raw codes are fetched into registers
//   while the current product runs. K is split over CTAs only when the
//   tiles alone do not fill the card.
//
// Left for later: a decode GEMV tuned to the byte bound (wider loads,
// cp.async prefetch of the next group, several row tiles in flight), and
// wgmma with TMA-fed rings of code slabs for prefill.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGemvCols = kThreads / kWarps * 8;  // 256 columns a few-rows CTA covers
constexpr int kGemvMaxRows = 8;                   // ops/quantizer/woq_gemm.py GEMV_MAX_ROWS
constexpr int kTileM = 64, kTileN = 64, kTileK = 32;

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

// The weight as the operand rule forms it: fp32 product, rounded to T.
template <typename T>
__device__ __forceinline__ float weight(float code, float scale) {
  return to_float(from_float<T>(code * scale));
}

// Codes a packing unit spans along K (rows), and byte rows it takes.
template <int BITS>
struct Unit {
  static constexpr int K = BITS == 8 ? 1 : (BITS == 4 ? 2 : 4);
  static constexpr int ROWS = BITS == 6 ? 3 : 1;
};

// The raw bytes of one packing unit for 8 columns: Unit::ROWS byte rows.
template <int BITS>
struct Raw {
  uint2 row[Unit<BITS>::ROWS];
};

// Fetch the unit that starts at K row k (a multiple of Unit::K), columns
// [col, col + 8): 8-byte loads, one per byte row.
template <int BITS>
__device__ __forceinline__ void fetch_unit(const int8_t* __restrict__ codes, int k, int col,
                                           int out_dim, Raw<BITS>& raw) {
  const int row0 = BITS == 8 ? k : (BITS == 4 ? k / 2 : (k / 4) * 3);
#pragma unroll
  for (int i = 0; i < Unit<BITS>::ROWS; ++i) {
    raw.row[i] = __ldg(
        reinterpret_cast<const uint2*>(codes + (size_t)(row0 + i) * out_dim + col));
  }
}

__device__ __forceinline__ uint8_t byte_of(const uint2& v, int c) {
  return uint8_t((c < 4 ? v.x : v.y) >> (8 * (c % 4)));
}

// The signed codes of a fetched unit: q[j][c] is the code of K row k + j.
template <int BITS>
__device__ __forceinline__ void unpack_unit(const Raw<BITS>& raw,
                                            float (&q)[Unit<BITS>::K][8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if constexpr (BITS == 8) {
      q[0][c] = float(int8_t(byte_of(raw.row[0], c)));
    } else if constexpr (BITS == 4) {
      const uint8_t b = byte_of(raw.row[0], c);
      // (int8)(b << 4) >> 4 and (int8)b >> 4, as woq.py:89-91 in int8
      q[0][c] = float(int(int8_t(uint8_t(b << 4))) >> 4);  // low nibble
      q[1][c] = float(int(int8_t(b)) >> 4);                // high nibble
    } else {
      // the bytes as 0..255, as `& 0xFF` (woq_gemm.py:48), then unpack6
      const int u0 = byte_of(raw.row[0], c), u1 = byte_of(raw.row[1], c),
                u2 = byte_of(raw.row[2], c);
      const int c0 = u0 & 0x3F;
      const int c1 = ((u0 >> 6) & 0x03) | ((u1 & 0x0F) << 2);
      const int c2 = ((u1 >> 4) & 0x0F) | ((u2 & 0x03) << 4);
      const int c3 = (u2 >> 2) & 0x3F;
      q[0][c] = float((c0 ^ 32) - 32);
      q[1][c] = float((c1 ^ 32) - 32);
      q[2][c] = float((c2 ^ 32) - 32);
      q[3][c] = float((c3 ^ 32) - 32);
    }
  }
}

__device__ __forceinline__ void load_scale8(const float* __restrict__ p, float (&s)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
  s[4] = b.x, s[5] = b.y, s[6] = b.z, s[7] = b.w;
}

// Few rows. Grid (ceil(Out / 256), splits); split z takes groups
// [z * gps, min(ng, z * gps + gps)) and writes dst + z * rows * Out.
template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
woq_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                const float* __restrict__ scale, float* __restrict__ dst, int rows, int in_dim,
                int out_dim, int group, int gps) {
  using U = Unit<BITS>;
  constexpr int RB = kGemvMaxRows;  // rows >= `rows` are skipped
  constexpr int UNR = U::ROWS == 3 ? 4 : 8;  // units a warp fetches before using any
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kGemvCols;
  const int col = col0 + lane * 8;
  const int ng = in_dim / group;
  const int g_begin = blockIdx.y * gps;
  const int g_end = min(ng, g_begin + gps);
  const int units = group / U::K;

  float acc[RB][8];
#pragma unroll
  for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[b][c] = 0.f;

  if (col < out_dim) {  // Out % 8 == 0: a lane's 8 columns are all in or all out
    for (int g = g_begin; g < g_end; ++g) {
      float s[8];
      load_scale8(scale + (size_t)g * out_dim + col, s);
      for (int u0 = warp; u0 < units; u0 += kWarps * UNR) {
        // UNR units' loads in flight at once: the stream is latency-bound
        // with one 8-byte load a lane outstanding
        Raw<BITS> raw[UNR];
#pragma unroll
        for (int r = 0; r < UNR; ++r) {
          const int u = u0 + r * kWarps;
          if (u < units) fetch_unit<BITS>(codes, g * group + u * U::K, col, out_dim, raw[r]);
        }
#pragma unroll
        for (int r = 0; r < UNR; ++r) {
          const int u = u0 + r * kWarps;
          if (u >= units) break;
          const int k = g * group + u * U::K;
          float q[U::K][8];
          unpack_unit<BITS>(raw[r], q);
#pragma unroll
          for (int j = 0; j < U::K; ++j) {
            float w[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) w[c] = weight<T>(q[j][c], s[c]);
#pragma unroll
            for (int b = 0; b < RB; ++b) {
              if (b < rows) {
                const float xv = to_float(x[(size_t)b * in_dim + k + j]);
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[b][c] = fmaf(xv, w[c], acc[b][c]);
              }
            }
          }
        }
      }
    }
  }

  // the four warps' partial sums, added in a fixed order
  __shared__ float red[kWarps][RB][kGemvCols];
#pragma unroll
  for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c) red[warp][b][lane * 8 + c] = acc[b][c];
  __syncthreads();
  dst += (size_t)blockIdx.y * rows * out_dim;
  for (int idx = threadIdx.x; idx < RB * kGemvCols; idx += kThreads) {
    const int b = idx / kGemvCols;
    const int cc = idx % kGemvCols;
    if (b < rows && col0 + cc < out_dim) {
      dst[(size_t)b * out_dim + col0 + cc] =
          ((red[0][b][cc] + red[1][b][cc]) + red[2][b][cc]) + red[3][b][cc];
    }
  }
}

// Many rows. Grid (ceil(Out / 64), ceil(B / 64), splits); split z takes K
// rows [z * split_len, min(In, z * split_len + split_len)) and writes
// dst + z * rows * Out.
template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
woq_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                 const float* __restrict__ scale, float* __restrict__ dst, int rows,
                 int in_dim, int out_dim, int group, int split_len) {
  using U = Unit<BITS>;
  constexpr bool kTensorCores = sizeof(T) == 2;
  constexpr int PAD = int(16 / sizeof(T));  // 16 bytes a row against bank conflicts
  constexpr int LDA = kTileK + PAD;         // x tile (64, 32)
  constexpr int LDB = kTileN + PAD;         // weight slab (32, 64)
  constexpr int LDC = kTileN + 4;           // fp32 result tile (64, 64)
  __shared__ __align__(128) T sA[kTileM * LDA];
  __shared__ __align__(128) T sB[kTileK * LDB];
  __shared__ __align__(128) float sC[kTensorCores ? kTileM * LDC : 1];

  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;
  const int k_begin = blockIdx.z * split_len;
  const int k_end = min(in_dim, k_begin + split_len);
  const int warp = threadIdx.x / 32;
  const int tid = threadIdx.x;
  dst += (size_t)blockIdx.z * rows * out_dim;

  // tensor cores: warp (wm, wn) owns a 32 x 32 quarter as 2 x 2 fragments;
  // FMAs: thread owns rows tr*8 .. tr*8+7, columns tc*4 .. tc*4+3
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag[2][2];
  float acc[8][4];
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int tr = tid / 16, tc = tid % 16;
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(frag[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  // the next K step's x values and raw codes wait in registers while the
  // current step's product runs (a register double buffer)
  constexpr int A_PER = kTileM * kTileK / kThreads;
  constexpr int B_UNITS = (kTileK / U::K) * (kTileN / 8);
  constexpr int B_PER = (B_UNITS + kThreads - 1) / kThreads;
  T a_reg[A_PER];
  Raw<BITS> b_raw[B_PER];
  float b_s[B_PER][8];
  bool b_in[B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * kThreads;
      const int m = m0 + idx / kTileK, k = k0 + idx % kTileK;
      a_reg[i] = (m < rows && k < k_end) ? x[(size_t)m * in_dim + k] : from_float<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * kThreads;
      const int k = k0 + (idx / (kTileN / 8)) * U::K;
      const int col = n0 + (idx % (kTileN / 8)) * 8;
      // a unit never straddles k_end or a group
      b_in[i] = idx < B_UNITS && k < k_end && col < out_dim;
      if (b_in[i]) {
        fetch_unit<BITS>(codes, k, col, out_dim, b_raw[i]);
        load_scale8(scale + (size_t)(k / group) * out_dim + col, b_s[i]);
      }
    }
  };
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous step's products are done with sA, sB
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * kThreads;
      sA[(idx / kTileK) * LDA + idx % kTileK] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < B_UNITS) {
        const int ur = idx / (kTileN / 8), cv = idx % (kTileN / 8);
        float q[U::K][8];
        if (b_in[i]) unpack_unit<BITS>(b_raw[i], q);
#pragma unroll
        for (int j = 0; j < U::K; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            sB[(ur * U::K + j) * LDB + cv * 8 + c] =
                from_float<T>(b_in[i] ? q[j][c] * b_s[i][c] : 0.f);
      }
    }
    __syncthreads();
    if (k0 + kTileK < k_end) fetch(k0 + kTileK);
    if constexpr (kTensorCores) {
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], sA + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], sB + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(frag[i][j], a[i], b[j], frag[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < kTileK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_float(sA[(tr * 8 + i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = to_float(sB[kk * LDB + tc * 4 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sC + (wm + 16 * i) * LDC + wn + 16 * j, frag[i][j], LDC,
                                wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < kTileM * kTileN; idx += kThreads) {
      const int r = idx / kTileN, c = idx % kTileN;
      if (m0 + r < rows && n0 + c < out_dim) {
        dst[(size_t)(m0 + r) * out_dim + n0 + c] = sC[r * LDC + c];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + tr * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tc * 4 + j;
        if (m < rows && n < out_dim) dst[(size_t)m * out_dim + n] = acc[i][j];
      }
    }
  }
}

// out[i] = sum over splits z, in order, of work[z * n + i].
__global__ void __launch_bounds__(256)
woq_splitk_reduce_kernel(const float* __restrict__ work, float* __restrict__ out, int splits,
                         size_t n) {
  for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < n; i += size_t(gridDim.x) * 256) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[z * n + i];
    out[i] = s;
  }
}

struct Args {
  const void* x;
  const int8_t* codes;
  const float* scale;
  float* out;
  float* work;
  int rows, in_dim, out_dim, group, tiled, splits, split_len;
  cudaStream_t stream;
};

template <typename T, int BITS>
cudaError_t launch(const Args& a) {
  float* dst = a.splits > 1 ? a.work : a.out;
  const T* x = static_cast<const T*>(a.x);
  if (a.tiled) {
    const dim3 grid((a.out_dim + kTileN - 1) / kTileN, (a.rows + kTileM - 1) / kTileM, a.splits);
    woq_tiled_kernel<T, BITS><<<grid, kThreads, 0, a.stream>>>(
        x, a.codes, a.scale, dst, a.rows, a.in_dim, a.out_dim, a.group, a.split_len);
  } else {
    const dim3 grid((a.out_dim + kGemvCols - 1) / kGemvCols, a.splits);
    woq_gemv_kernel<T, BITS><<<grid, kThreads, 0, a.stream>>>(
        x, a.codes, a.scale, dst, a.rows, a.in_dim, a.out_dim, a.group, a.split_len);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t n = size_t(a.rows) * a.out_dim;
  const int blocks = int(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  woq_splitk_reduce_kernel<<<blocks, 256, 0, a.stream>>>(a.work, a.out, a.splits, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bits(int bits, const Args& a) {
  switch (bits) {
    case 8: return launch<T, 8>(a);
    case 6: return launch<T, 6>(a);
    case 4: return launch<T, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x): 0 float32, 1 bfloat16, 2 float16. bits: 8, 6 or 4. tiled: 0
// runs the few-rows kernel (rows <= 8; split_len = groups a split takes), 1
// the tiled kernel (split_len = K rows a split takes, a multiple of 32).
// work: (splits, rows, out_dim) fp32 when splits > 1, else unused. Returns
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for arguments the kernels do not take. Launches on
// `stream`; does not synchronise.
extern "C" int dstt_woq_matmul(const void* x, const void* codes, const void* scale, void* out,
                               void* work, int dtype, int bits, int rows, int in_dim,
                               int out_dim, int group, int tiled, int splits, int split_len,
                               void* stream) {
  const int unit = bits == 8 ? 1 : (bits == 4 ? 2 : 4);
  if (rows <= 0 || in_dim <= 0 || out_dim <= 0 || out_dim % 8 != 0 || group <= 0 ||
      group % unit != 0 || in_dim % group != 0 || splits <= 0 || split_len <= 0 ||
      splits > 65535 || (splits > 1 && work == nullptr) ||
      (!tiled && (rows > kGemvMaxRows || (long long)(splits - 1) * split_len >= in_dim / group)) ||
      (tiled && (split_len % kTileK != 0 || (long long)(splits - 1) * split_len >= in_dim ||
                 (rows + kTileM - 1) / kTileM > 65535))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x,     static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
               static_cast<float*>(out), static_cast<float*>(work), rows, in_dim, out_dim,
               group, tiled, splits, split_len, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dispatch_bits<float>(bits, a);
    case 1: return (int)dispatch_bits<__nv_bfloat16>(bits, a);
    case 2: return (int)dispatch_bits<__half>(bits, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dstt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
