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
// depends on k alone (byte row k * bits / 8 for k a multiple of 4); only the
// scale depends on the group, so any group the quantizer makes (power of two
// or not) runs the same code.
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
// - Many rows, 16-bit x (`woq_mma_kernel`, the prefill path): a CTA of 16
//   warps computes a BM x 128 tile of out (BM = 64 up to 64 rows, else
//   256), stepping K by 64.
//   * A 4-stage ring in dynamic shared memory. A stage holds the x tile
//     (BM x 64; 16-byte cp.async copies, one TMA at 256 rows), the raw code
//     slab of the same 64 K rows (64 / 48 / 32 x 128 bytes for int8 / int6 /
//     int4, 8-byte cp.async copies: Out is only sure to be a multiple of 8)
//     and 3 scale rows (the groups 64 K rows touch when the group is >= 32;
//     a smaller group reads its scales from L1, a second instantiation).
//     Rows of x past B, K past the split's end and columns past Out are
//     zero-filled, so their products add exact zeros. x is copied in
//     16-byte pieces only: the wrapper pads a misaligned x, or an In not a
//     multiple of 8, into a fresh buffer first.
//   * Each weight is dequantized once a CTA, so once in the grid at 256
//     rows: the CTA's 512 threads turn the landed code slab of step i + 1
//     into a 64 x 128 16-bit B tile, 4 rows x 4 columns a thread, while the
//     tensor cores run step i on the other B buffer; one barrier a step. No
//     conversion instruction turns a code into a float: u = code + bias in
//     a byte lane (c ^ 0x80 for int8, ^ 8 a nibble for int4, ^ 32 for int6,
//     on whole 32-bit words), PRMT into 0x4B0000uu, and an FADD of -(2^23 +
//     bias) is exact for every code; one FMUL by the fp32 scale (the operand
//     rule's product), and cvt.rn.bf16x2.f32 / .f16x2 (round to nearest
//     even, as __float2bfloat16) packs two weights. A weight costs 1 PRMT,
//     1 FADD, 1 FMUL, 1/2 F2FP and 1/4 LOP3; the SASS has no I2F per weight
//     (its few I2F / F2I pairs are the integer divisions by the group, once
//     a step).
//   * 256-row tiles (every prefill step of the serving path): TMA and
//     wgmma. Thread 0 copies each x tile with one TMA (a tensor map of x
//     made on the host with cuTensorMapEncodeTiled, no libcuda link; the copy
//     does the 128-byte swizzle and zero-fills rows past B and K past In)
//     that completes on the stage's mbarrier. Each warpgroup waits for it,
//     starts 4 asynchronous wgmma.m64n128k16 for its 64 rows, A (x,
//     K-major) and B (the dequantized tile, MN-major, the transpose bit set)
//     read straight from shared memory in the 128-byte swizzled layouts
//     (MmaSmem), then starts the next copies and the next dequantization
//     while they run, and waits for them before the step's barrier.
//     fence.proxy.async before each barrier hands the st.shared writes of
//     the B tile to wgmma's proxy. The fp32 accumulators (64 a thread) stay
//     in registers in mma.sync's C-fragment layout.
//   * 64-row tiles (9-64 rows): mma.sync.m16n8k16 fed by ldmatrix; the
//     warps tile the CTA 4 x 4, accumulators in registers; each 16-deep
//     slice of the product is interleaved, with no branch between them,
//     with a quarter of the copies of step i + 3 (and the first with the
//     dequantization of step i + 1). There a 256-row tile would multiply
//     four times the rows for the same copies and dequant; above 64 rows
//     the 256-row tile takes over.
//   * The epilogue stores the accumulators from registers as 8-byte
//     float2s. Grid (ceil(Out / 128), ceil(B / BM), splits). The wrapper's
//     `plan` takes the resident CTAs an SM from `dstt_woq_mma_ctas_per_sm`
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor: 1 for every tile
//     here) and splits K over CTAs only where that shortens the waves by a
//     tenth; an ordered second pass adds the splits
//     (`woq_splitk_reduce_kernel`). At 256 rows on 132 SMs:
//       (In, Out)        tiles  K steps  splits  CTAs  waves x steps (ideal)
//       (4096, 4096)      32      64       4     128   1 x 16  (15.5)
//       (4096, 11008)     86      64       3     258   2 x 22  (41.7)
//       (11008, 4096)     32     172       4     128   1 x 43  (41.7)
//     BM 256 dequantizes each weight once in the grid; 128 columns halve
//     the x tiles a weight's product reads against 64 (x re-read from L2
//     once a column tile is the largest traffic: 172 MB at (4096, 11008)).
//   * ptxas (CUDA 12.9, sm_90a), bf16 and fp16 alike: registers (group
//     >= 32 / < 32) / spilled bytes / dynamic shared memory by (BM, bits):
//       BM    int8                   int6                   int4
//       256   119 / 113, 0, 205,856  123 / 116, 0, 197,664  120 / 110, 0, 189,472
//       64    86 / 74, 0, 111,648    89 / 78, 0, 103,456    86 / 72, 0, 95,264
//     (the 256-row kernels keep a 32-byte stack frame, no spill); 1 CTA an
//     SM for each (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
//   * What bounds it (PERF.md section 6): the copies and the dequant of a
//     step, which the barrier serialises with the product, and the split-K
//     partial sums (written, then read by the second pass).
// - Many rows, fp32 x (`woq_tiled_fma_kernel`, the tests' and the small card
//   engines' dtype): a CTA computes a 64 x 64 tile, stepping K by 32, from
//   the x tile and the dequantized (32 x 64) slab staged in shared memory,
//   an 8 x 4 register tile a thread on FMAs; the next step's x values and
//   raw codes wait in registers while the current product runs.
//
// Left for later (ROADMAP R2b): a producer warpgroup that copies and
// dequantizes so that no barrier a step holds the product, a cheaper
// dequant for groups that are multiples of 64, an in-cluster split-K sum in
// place of the second pass; and a decode GEMV tuned to the byte bound (R6).

#include <cuda.h>  // CUtensorMap (the encoder is looked up at run time: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_ptx.cuh"
#include "hopper_ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGemvCols = kThreads / kWarps * 8;  // 256 columns a few-rows CTA covers
constexpr int kGemvMaxRows = 8;                   // ops/quantizer/woq_gemm.py GEMV_MAX_ROWS
constexpr int kTileM = 64, kTileN = 64, kTileK = 32;  // the fp32 FMA tile

// the 16-bit tensor-core kernel: ops/quantizer/woq_gemm.py MMA_TILE_K
constexpr int kMmaWarps = 16, kMmaThreads = kMmaWarps * 32;
constexpr int kMmaN = 128, kMmaK = 64, kStages = 4;
constexpr int kScaleRows = 3;  // scale rows a stage holds: the groups 64 K rows touch, group >= 32
constexpr int kMinStagedGroup = 32;

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

// Many rows, fp32 x. Grid (ceil(Out / 64), ceil(B / 64), splits); split z
// takes K rows [z * split_len, min(In, z * split_len + split_len)) and
// writes dst + z * rows * Out.
template <int BITS>
__global__ void __launch_bounds__(kThreads)
woq_tiled_fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                     const float* __restrict__ scale, float* __restrict__ dst, int rows,
                     int in_dim, int out_dim, int group, int split_len) {
  using T = float;
  using U = Unit<BITS>;
  constexpr int PAD = int(16 / sizeof(T));  // 16 bytes a row against bank conflicts
  constexpr int LDA = kTileK + PAD;         // x tile (64, 32)
  constexpr int LDB = kTileN + PAD;         // weight slab (32, 64)
  __shared__ __align__(128) T sA[kTileM * LDA];
  __shared__ __align__(128) T sB[kTileK * LDB];

  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;
  const int k_begin = blockIdx.z * split_len;
  const int k_end = min(in_dim, k_begin + split_len);
  const int tid = threadIdx.x;
  dst += (size_t)blockIdx.z * rows * out_dim;

  // thread owns rows tr*8 .. tr*8+7, columns tc*4 .. tc*4+3
  float acc[8][4];
  const int tr = tid / 16, tc = tid % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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

// ---------------------------------------------------------------------------
// Many rows, 16-bit x: the tensor-core kernel
// ---------------------------------------------------------------------------

// The wgmma, mbarrier and TMA helpers and the tensor-map encoder lookup
// are in hopper_ptx.cuh, shared with the fused cross-entropy kernels.

// Dynamic shared memory of woq_mma_kernel<T, BITS, MT, ...>, in bytes:
// kStages stages of {x tile, code slab, scale rows}, then two dequantized
// B tiles, from a 1024-byte aligned base. 64-row tiles (the mma.sync
// path) pad the rows of the x and B tiles by 16 bytes, which keeps
// every ldmatrix free of bank conflicts. 256-row tiles (the wgmma path) keep
// both in the layouts wgmma reads with the 128-byte swizzle: x K-major
// (row r of 64 elements at r * 128 bytes, its 16-byte chunk c at position
// c ^ (r % 8)), the B tile MN-major in atoms of 8 K rows x 64 columns
// (1024 bytes, row k % 8 at (k % 8) * 128, chunk (n % 64) / 8 at position
// ((n % 64) / 8) ^ (k % 8)), K atoms 1024 bytes apart, column atoms 8192.
template <typename T, int BITS, int MT>
struct MmaSmem {
  static constexpr bool WG = MT == 4;  // the wgmma path
  static constexpr int BM = 64 * MT, BN = kMmaN;
  static constexpr int LDA = WG ? kMmaK : kMmaK + 8;
  static constexpr int LDB = BN + 8;  // the mma.sync path's B pitch
  static constexpr int CODE_ROWS = kMmaK * BITS / 8;  // byte rows of a 64-row slab
  static constexpr int A = BM * LDA * int(sizeof(T));
  static constexpr int C = CODE_ROWS * BN;
  static constexpr int S = kScaleRows * BN * int(sizeof(float));
  static constexpr int STAGE = WG ? (A + C + S + 1023) / 1024 * 1024 : A + C + S;
  static constexpr int B = WG ? kMmaK * BN * int(sizeof(T)) : kMmaK * LDB * int(sizeof(T));
  static constexpr int BARS = kStages * 8;  // the x tiles' mbarriers (wgmma path)
  static constexpr int BYTES = kStages * STAGE + 2 * B + BARS + 1024;  // + the base's alignment
  static_assert(A % 16 == 0 && C % 16 == 0 && S % 16 == 0 && B % 16 == 0, "16-byte alignment");
};

// Byte offset of element (k, n) in a wgmma-path B tile (see MmaSmem).
__device__ __forceinline__ int b_swz(int k, int n) {
  return (n >> 6) * 8192 + (k >> 3) * 1024 + (k & 7) * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4) +
         (n & 7) * 2;
}

// Part `part` (of 4) of this thread's 16-byte copies of x rows [m0, m0 +
// BM), K [k0, k0 + 64) into sA (x's rows x_ld elements apart, a multiple
// of 8; zeros past In). Rows past `rows` and K past k_end are zero-filled.
template <int BM, int LDA, typename T>
__device__ __forceinline__ void load_x_part(T* sA, const T* __restrict__ x, int part, int m0,
                                            int rows, int x_ld, int k0, int k_end) {
  constexpr int PER_ROW = kMmaK / 8;
  constexpr int Q = BM * PER_ROW / kMmaThreads;  // copies a thread: 1, 2 or 4
  constexpr int QP = (Q + 3) / 4;
#pragma unroll
  for (int q = part * QP; q < part * QP + QP && q < Q; ++q) {
    const int i = threadIdx.x + q * kMmaThreads;
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool ok = m0 + r < rows && k0 + c < k_end;  // k_end is In or a multiple of 64
    cp_async16(sA + r * LDA + c, ok ? x + (size_t)(m0 + r) * x_ld + k0 + c : x, ok);
  }
}

// Part `part` (of 4) of this thread's 8-byte copies of the raw codes of K
// rows [k0, k0 + 64), columns [n0, n0 + 128), into sC (CODE_ROWS x 128
// bytes; 8 bytes, since Out is only sure to be a multiple of 8).
template <int BITS>
__device__ __forceinline__ void load_code_part(int8_t* sC, const int8_t* __restrict__ codes,
                                               int part, int out_dim, int n0, int k0,
                                               int k_end) {
  constexpr int CODE_ROWS = kMmaK * BITS / 8;
  constexpr int PER_ROW = kMmaN / 8;
  constexpr int TOTAL = CODE_ROWS * PER_ROW;
  constexpr int Q = (TOTAL + kMmaThreads - 1) / kMmaThreads;  // copies a thread: 1 or 2
  constexpr int QP = (Q + 3) / 4;
  const size_t row0 = (size_t)k0 * BITS / 8;  // k0 is a multiple of 64
#pragma unroll
  for (int q = part * QP; q < part * QP + QP && q < Q; ++q) {
    const int i = threadIdx.x + q * kMmaThreads;
    if (TOTAL % kMmaThreads != 0 && i >= TOTAL) break;
    const int br = i / PER_ROW, c = (i % PER_ROW) * 8;
    // the first K row of this byte row's packing unit
    const int k = k0 + (BITS == 8 ? br : (BITS == 4 ? 2 * br : (br / 3) * 4));
    const bool ok = k < k_end && n0 + c < out_dim;  // Out % 8 == 0
    cp_async8(sC + br * kMmaN + c, ok ? codes + (row0 + br) * out_dim + n0 + c : codes, ok);
  }
}

// float(code) for a biased code u = code + BIAS in the low byte of `bits`
// (0x4B0000uu, 2^23 + u as a float): exact, with no conversion instruction.
template <int BIAS>
__device__ __forceinline__ float biased_to_float(uint32_t bits) {
  return __int_as_float(int(bits)) - float(8388608 + BIAS);
}

// Byte j (0..3) of w in the low byte of 0x4B000000 (2^23 as a float).
__device__ __forceinline__ uint32_t byte_into_f32(uint32_t w, int j) {
  return __byte_perm(w, 0x4B000000u, 0x7540u | unsigned(j));
}

// Four weights of one K row (biased codes in the byte lanes of `q`, bias
// BIAS), times their scales, rounded to T, into 8 bytes of the B tile.
template <typename T, int BIAS>
__device__ __forceinline__ void store_row4(void* dst, uint32_t q, const float4& s) {
  const uint32_t lo = pack2<T>(biased_to_float<BIAS>(byte_into_f32(q, 0)) * s.x,
                               biased_to_float<BIAS>(byte_into_f32(q, 1)) * s.y);
  const uint32_t hi = pack2<T>(biased_to_float<BIAS>(byte_into_f32(q, 2)) * s.z,
                               biased_to_float<BIAS>(byte_into_f32(q, 3)) * s.w);
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

// Where B tile element (k, n) lies (n a multiple of 4: 8 bytes there).
template <bool SWZ, int LDB, typename T>
__device__ __forceinline__ void* b_at(T* sB, int k, int n) {
  return SWZ ? static_cast<void*>(reinterpret_cast<unsigned char*>(sB) + b_swz(k, n))
             : static_cast<void*>(sB + k * LDB + n);
}

// The thread's share of dequantizing a K step: K rows kr .. kr + 3 of the
// step (a whole packing unit for every width), columns c0 .. c0 + 3, from
// the landed code slab sC into the B tile sB ([k][n], pitch LDB), each
// weight code * scale in fp32 rounded to T. Scales: with a group >= 32 from
// the stage's scale rows, row 0 for the step's rows below b1 (those in the
// step's first group), row 1 below b1 + group, else row 2 (the block's
// rows touch at most two of them; a row past k_end reads a zero or a real
// row, times a zero code); with a smaller group (SMALL) from L1, zeros past
// k_end or Out.
template <typename T, int BITS, int LDB, bool SMALL, bool SWZ>
__device__ __forceinline__ void dequant_block(T* sB, const int8_t* sC, const float* sS,
                                              const float* __restrict__ scale, int kr, int c0,
                                              int k0, int b1, int k_end, int group, int n0,
                                              int out_dim) {
  // the biased codes of rows kr .. kr + 3, four columns a word (byte lanes)
  uint32_t q[4];
  if constexpr (BITS == 8) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = *reinterpret_cast<const uint32_t*>(sC + (kr + j) * kMmaN + c0) ^ 0x80808080u;
  } else if constexpr (BITS == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // byte row kr / 2 + j: rows kr + 2j (low nibbles), + 1 (high)
      const uint32_t b =
          *reinterpret_cast<const uint32_t*>(sC + (kr / 2 + j) * kMmaN + c0) ^ 0x88888888u;
      q[2 * j] = b & 0x0F0F0F0Fu;
      q[2 * j + 1] = (b >> 4) & 0x0F0F0F0Fu;
    }
  } else {
    // unpack6 on four columns at once, a byte lane each, then the bias ^ 32
    const int8_t* u = sC + (kr / 4 * 3) * kMmaN + c0;
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(u);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(u + kMmaN);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(u + 2 * kMmaN);
    q[0] = (r0 & 0x3F3F3F3Fu) ^ 0x20202020u;
    q[1] = (((r0 >> 6) & 0x03030303u) | ((r1 << 2) & 0x3C3C3C3Cu)) ^ 0x20202020u;
    q[2] = (((r1 >> 4) & 0x0F0F0F0Fu) | ((r2 << 4) & 0x30303030u)) ^ 0x20202020u;
    q[3] = ((r2 >> 2) & 0x3F3F3F3Fu) ^ 0x20202020u;
  }
  constexpr int BIAS = BITS == 8 ? 128 : (BITS == 4 ? 8 : 32);
  if constexpr (!SMALL) {
    const int j = (kr >= b1) + (kr >= b1 + group);  // the first row's scale row
    const int split = b1 + j * group - kr;           // rows of the block in it
    const float4 s0 = *reinterpret_cast<const float4*>(sS + j * kMmaN + c0);
    const float4 s1 =
        *reinterpret_cast<const float4*>(sS + min(j + 1, kScaleRows - 1) * kMmaN + c0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      store_row4<T, BIAS>(b_at<SWZ, LDB>(sB, kr + r, c0), q[r], r < split ? s0 : s1);
  } else {
    const int k = k0 + kr;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k + r < k_end && n0 + c0 < out_dim)
        s = __ldg(reinterpret_cast<const float4*>(scale + (size_t)((k + r) / group) * out_dim +
                                                  n0 + c0));
      store_row4<T, BIAS>(b_at<SWZ, LDB>(sB, kr + r, c0), q[r], s);
    }
  }
}

// Many rows, 16-bit x. Grid (ceil(Out / 128), ceil(B / BM), splits), 512
// threads, MmaSmem::BYTES of dynamic shared memory; split z takes K rows
// [z * split_len, min(In, z * split_len + split_len)) (split_len a multiple
// of 64) and writes dst + z * rows * Out. x: 16-byte aligned, rows x_ld
// elements apart (a multiple of 8, zeros past In). SMALL: group < 32.
template <typename T, int BITS, int MT, bool SMALL>
__global__ void __launch_bounds__(kMmaThreads, 1)
woq_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
               const float* __restrict__ scale, float* __restrict__ dst, int rows, int in_dim,
               int out_dim, int group, int split_len, int x_ld,
               const __grid_constant__ CUtensorMap x_map) {
  using L = MmaSmem<T, BITS, MT>;
  constexpr bool WG = L::WG;
  constexpr int BM = L::BM, BN = L::BN, LDA = L::LDA, LDB = L::LDB;
  // the warps' grid over the tile: mma.sync 4 x 4 at 64 rows; wgmma:
  // warpgroup g owns rows 64g .. 64g + 63, its warp w rows 16w .. 16w + 15
  // of them, in the same C-fragment layout
  static_assert(MT == 1 || MT == 4, "64- and 256-row tiles");
  constexpr int WGM = WG ? 16 : 4, WGN = kMmaWarps / WGM;
  constexpr int WTM = BM / WGM, WTN = BN / WGN;  // a warp's rows and columns
  constexpr int MTW = WTM / 16, N8 = WTN / 8;     // its 16-row and 8-column mma tiles
  extern __shared__ __align__(1024) unsigned char woq_smem_raw[];
  unsigned char* const woq_smem = woq_smem_raw + ((1024 - (smem_u32(woq_smem_raw) & 1023)) & 1023);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * split_len;
  const int k_end = min(in_dim, k_begin + split_len);
  const int steps = (k_end - k_begin + kMmaK - 1) / kMmaK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / WGN) * WTM, wn = (warp % WGN) * WTN;
  // dequant: warp w makes K rows 4w .. 4w + 3, lane l columns 4l .. 4l + 3
  const int dq_kr = warp * 4, dq_c0 = lane * 4;
  auto b_buf = [&](int j) { return reinterpret_cast<T*>(woq_smem + kStages * L::STAGE + j * L::B); };
  uint64_t* const x_bar = reinterpret_cast<uint64_t*>(woq_smem + kStages * L::STAGE + 2 * L::B);

  auto stage_a = [&](int st) { return reinterpret_cast<T*>(woq_smem + st * L::STAGE); };
  auto stage_c = [&](int st) { return reinterpret_cast<int8_t*>(woq_smem + st * L::STAGE + L::A); };
  auto stage_s = [&](int st) {
    return reinterpret_cast<float*>(woq_smem + st * L::STAGE + L::A + L::C);
  };
  // part `part` of 4 of step s's copies into stage st: x and codes in every
  // part, the scale rows (of the groups K rows [k0, min(k_end, k0 + 64))
  // touch) in part 3. A step past the last only zero-fills (k0 >= k_end),
  // into a stage no product reads again.
  auto load = [&](int s, int st, int part) {
    const int k0 = k_begin + s * kMmaK;
    if constexpr (WG) {
      // x by TMA: thread 0 arms the stage's mbarrier with the box's bytes
      // (always the whole box) and starts the copy; steps past the last
      // load nothing, so every copy started is waited for
      if (part == 0 && threadIdx.x == 0 && s < steps) {
        mbar_arrive_expect_tx(&x_bar[st], BM * kMmaK * int(sizeof(T)));
        tma_load_2d(stage_a(st), &x_map, k0, m0, &x_bar[st]);
      }
    } else {
      load_x_part<BM, LDA>(stage_a(st), x, part, m0, rows, x_ld, k0, k_end);
    }
    load_code_part<BITS>(stage_c(st), codes, part, out_dim, n0, k0, k_end);
    if (part == 3 && !SMALL && threadIdx.x < kScaleRows * (BN / 4)) {
      const int g0 = k0 / group, g1 = (min(k_end, k0 + kMmaK) - 1) / group;
      const int j = threadIdx.x / (BN / 4), c = (threadIdx.x % (BN / 4)) * 4;
      const bool ok = g0 + j <= g1 && n0 + c < out_dim;
      cp_async16(stage_s(st) + j * BN + c,
                 ok ? scale + (size_t)(g0 + j) * out_dim + n0 + c : scale, ok);
    }
  };
  // the thread's dequant share of step s (stage st) into sB; a step past
  // the last writes a B buffer no product reads
  auto dequant = [&](int s, int st, T* sB) {
    const int k0 = k_begin + s * kMmaK;
    const int b1 = SMALL ? 0 : (k0 / group + 1) * group - k0;  // rows in the step's first group
    dequant_block<T, BITS, LDB, SMALL, WG>(sB, stage_c(st), stage_s(st), scale, dq_kr, dq_c0,
                                           k0, b1, k_end, group, n0, out_dim);
  };

  float acc[MTW][N8][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  if constexpr (WG) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(&x_bar[st], 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
  // prologue: steps 0 .. kStages - 2 in flight, step 0 dequantized
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
#pragma unroll
    for (int part = 0; part < 4; ++part) load(s, s, part);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  dequant(0, 0, b_buf(0));

  for (int i = 0; i < steps; ++i) {
    // step i + 1 has landed (this thread's copies); after the barrier every
    // thread's copies are visible, B tile i is complete, and iteration i - 1
    // is done with x stage (i - 1) % kStages and B buffer (i + 1) % 2
    cp_async_wait<kStages - 3>();
    if constexpr (WG) fence_proxy_async();  // copies and B-tile stores, to wgmma's proxy
    __syncthreads();
    const T* sA = stage_a(i % kStages);
    const T* sB = b_buf(i & 1);
    T* sB_next = b_buf((i + 1) & 1);
    if constexpr (WG) {
      // the warpgroup's 64 rows of step i on the tensor cores, asynchronously,
      // while its threads start the copies of step i + 3 and dequantize step
      // i + 1; both wgmma operands come from shared memory
      const unsigned char* a_wg = reinterpret_cast<const unsigned char*>(sA) + (warp / 4) * 64 * 128;
      const unsigned char* b_st = reinterpret_cast<const unsigned char*>(sB);
      float (&d)[64] = reinterpret_cast<float (&)[64]>(acc);
      mbar_wait(&x_bar[i % kStages], (i / kStages) & 1);  // x of step i has landed
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMmaK / 16; ++kk)
        wgmma_m64n128k16<T>(d, wgmma_desc(a_wg + kk * 32, 16, 1024),
                            wgmma_desc(b_st + kk * 2048, 8192, 1024));
      wgmma_commit();
#pragma unroll
      for (int part = 0; part < 4; ++part) load(i + kStages - 1, (i + kStages - 1) % kStages, part);
      dequant(i + 1, (i + 1) % kStages, sB_next);
      wgmma_wait<0>();
    } else {
      // each 16-deep slice of the product is interleaved with a quarter of
      // the copies of step i + 3 (and the first with the dequantization of
      // step i + 1), with no branch between them, so that copies, ALUs and
      // tensor cores overlap within every warp; rows past B multiply zeros
#pragma unroll
      for (int kk = 0; kk < kMmaK / 16; ++kk) {
        load(i + kStages - 1, (i + kStages - 1) % kStages, kk);
        if (kk == 0) dequant(i + 1, (i + 1) % kStages, sB_next);
        uint32_t a[MTW][4];
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) ldsm_x4(a[mt], a_at<LDA>(sA, wm + 16 * mt, kk * 16, lane));
#pragma unroll
        for (int n2 = 0; n2 < N8 / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4_t(b, bk_at<LDB>(sB, kk * 16, wn + 16 * n2, lane));
#pragma unroll
          for (int mt = 0; mt < MTW; ++mt) {
            mma16816<T>(acc[mt][2 * n2], a[mt], b[0], b[1]);
            mma16816<T>(acc[mt][2 * n2 + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    cp_async_commit();  // one group a step
  }
  cp_async_wait<0>();

  // C fragments straight from registers: lane holds rows lane / 4 and + 8,
  // columns 2 (lane % 4) and + 1 of each 16 x 8 tile
  dst += (size_t)blockIdx.z * rows * out_dim;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int r = m0 + wm + 16 * mt + lane / 4;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int c = n0 + wn + 8 * n + 2 * (lane % 4);
      if (c < out_dim) {  // Out % 8 == 0: an 8-column tile is all in or all out
        if (r < rows)
          *reinterpret_cast<float2*>(dst + (size_t)r * out_dim + c) =
              make_float2(acc[mt][n][0], acc[mt][n][1]);
        if (r + 8 < rows)
          *reinterpret_cast<float2*>(dst + (size_t)(r + 8) * out_dim + c) =
              make_float2(acc[mt][n][2], acc[mt][n][3]);
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

enum Kind { kGemv = 0, kTiledFma = 1, kMma = 2 };

struct Args {
  const void* x;
  const int8_t* codes;
  const float* scale;
  float* out;
  float* work;
  int rows, in_dim, out_dim, group, kind, tile_m, splits, split_len, x_ld;
  cudaStream_t stream;
};

// Allow woq_mma_kernel<T, BITS, MT, SMALL> its dynamic shared memory (above
// the 48 KB default) on the current device.
template <typename T, int BITS, int MT, bool SMALL>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(woq_mma_kernel<T, BITS, MT, SMALL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              MmaSmem<T, BITS, MT>::BYTES);
}

// The tensor map of x (rows x in_dim, rows x_ld elements apart) in boxes of
// BM rows x 64 columns with the 128-byte swizzle, for the wgmma path.
template <typename T, int BM>
cudaError_t x_tensor_map(const Args& a, CUtensorMap* map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(a.in_dim), cuuint64_t(a.rows)};
  const cuuint64_t strides[1] = {cuuint64_t(a.x_ld) * sizeof(T)};
  const cuuint32_t box[2] = {kMmaK, BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 && std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(a.x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int BITS, int MT, bool SMALL>
cudaError_t launch_mma(const Args& a, float* dst) {
  cudaError_t err = allow_smem<T, BITS, MT, SMALL>();
  if (err != cudaSuccess) return err;
  CUtensorMap x_map = {};
  if constexpr (MmaSmem<T, BITS, MT>::WG) {
    err = x_tensor_map<T, 64 * MT>(a, &x_map);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.out_dim + kMmaN - 1) / kMmaN, (a.rows + 64 * MT - 1) / (64 * MT), a.splits);
  woq_mma_kernel<T, BITS, MT, SMALL><<<grid, kMmaThreads, MmaSmem<T, BITS, MT>::BYTES, a.stream>>>(
      static_cast<const T*>(a.x), a.codes, a.scale, dst, a.rows, a.in_dim, a.out_dim, a.group,
      a.split_len, a.x_ld, x_map);
  return cudaGetLastError();
}

template <typename T, int BITS, int MT>
cudaError_t launch_mma_group(const Args& a, float* dst) {
  return a.group >= kMinStagedGroup ? launch_mma<T, BITS, MT, false>(a, dst)
                                    : launch_mma<T, BITS, MT, true>(a, dst);
}

template <typename T, int BITS>
cudaError_t launch(const Args& a) {
  float* dst = a.splits > 1 ? a.work : a.out;
  cudaError_t err = cudaErrorInvalidValue;
  if (a.kind == kMma) {
    if constexpr (sizeof(T) == 2) {
      switch (a.tile_m) {
        case 64: err = launch_mma_group<T, BITS, 1>(a, dst); break;
        case 256: err = launch_mma_group<T, BITS, 4>(a, dst); break;
        default: break;
      }
    }
  } else if (a.kind == kTiledFma) {
    if constexpr (sizeof(T) == 4) {
      const dim3 grid((a.out_dim + kTileN - 1) / kTileN, (a.rows + kTileM - 1) / kTileM,
                      a.splits);
      woq_tiled_fma_kernel<BITS><<<grid, kThreads, 0, a.stream>>>(
          static_cast<const float*>(a.x), a.codes, a.scale, dst, a.rows, a.in_dim, a.out_dim,
          a.group, a.split_len);
      err = cudaGetLastError();
    }
  } else {
    const dim3 grid((a.out_dim + kGemvCols - 1) / kGemvCols, a.splits);
    woq_gemv_kernel<T, BITS><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), a.codes, a.scale, dst, a.rows, a.in_dim, a.out_dim, a.group,
        a.split_len);
    err = cudaGetLastError();
  }
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

template <typename T, int BITS, int MT, bool SMALL>
int mma_ctas_per_sm() {
  int n = 0;
  cudaError_t err = allow_smem<T, BITS, MT, SMALL>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, woq_mma_kernel<T, BITS, MT, SMALL>, kMmaThreads, MmaSmem<T, BITS, MT>::BYTES);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int BITS, int MT>
int mma_ctas_per_sm_group(int group) {
  return group >= kMinStagedGroup ? mma_ctas_per_sm<T, BITS, MT, false>()
                                  : mma_ctas_per_sm<T, BITS, MT, true>();
}

template <typename T, int BITS>
int mma_ctas_per_sm_tile(int tile_m, int group) {
  switch (tile_m) {
    case 64: return mma_ctas_per_sm_group<T, BITS, 1>(group);
    case 256: return mma_ctas_per_sm_group<T, BITS, 4>(group);
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <typename T>
int mma_ctas_per_sm_bits(int bits, int tile_m, int group) {
  switch (bits) {
    case 8: return mma_ctas_per_sm_tile<T, 8>(tile_m, group);
    case 6: return mma_ctas_per_sm_tile<T, 6>(tile_m, group);
    case 4: return mma_ctas_per_sm_tile<T, 4>(tile_m, group);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x): 0 float32, 1 bfloat16, 2 float16. bits: 8, 6 or 4. kind:
// 0 runs the few-rows kernel (rows <= 8; split_len = groups a split takes),
// 1 the fp32 FMA tile kernel (float32 x; split_len = K rows a split takes,
// a multiple of 32), 2 the tensor-core kernel (16-bit x, 16-byte aligned,
// rows x_ld >= in_dim elements apart, x_ld a multiple of 8 and x zero in
// the columns past in_dim; tile_m = 64 or 256 rows of 128 columns a CTA;
// split_len a multiple of 64). For kinds 0 and 1, x_ld = in_dim.
// work: (splits, rows, out_dim) fp32 when splits > 1, else unused. Returns
// cudaGetLastError()
// after the launches (0 = launched), or cudaErrorInvalidValue for arguments
// the kernels do not take. Launches on `stream`; does not synchronise.
extern "C" int dstt_woq_matmul(const void* x, const void* codes, const void* scale, void* out,
                               void* work, int dtype, int bits, int rows, int in_dim,
                               int out_dim, int group, int kind, int tile_m, int splits,
                               int split_len, int x_ld, void* stream) {
  const int unit = bits == 8 ? 1 : (bits == 4 ? 2 : 4);
  const bool ok_common = rows > 0 && in_dim > 0 && out_dim > 0 && out_dim % 8 == 0 &&
                         group > 0 && group % unit == 0 && in_dim % group == 0 && splits > 0 &&
                         split_len > 0 && splits <= 65535 && (splits == 1 || work != nullptr);
  bool ok_kind = false;
  if (kind == kGemv) {
    ok_kind = rows <= kGemvMaxRows && x_ld == in_dim &&
              (long long)(splits - 1) * split_len < in_dim / group;
  } else if (kind == kTiledFma) {
    ok_kind = dtype == 0 && x_ld == in_dim && split_len % kTileK == 0 &&
              (long long)(splits - 1) * split_len < in_dim && (rows + kTileM - 1) / kTileM <= 65535;
  } else if (kind == kMma) {
    ok_kind = (dtype == 1 || dtype == 2) && (tile_m == 64 || tile_m == 256) &&
              x_ld >= in_dim && x_ld % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
              split_len % kMmaK == 0 && (long long)(splits - 1) * split_len < in_dim &&
              (rows + tile_m - 1) / tile_m <= 65535;
  }
  if (!ok_common || !ok_kind) return (int)cudaErrorInvalidValue;
  const Args a{x,     static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
               static_cast<float*>(out), static_cast<float*>(work), rows, in_dim, out_dim,
               group, kind, tile_m, splits, split_len, x_ld, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)dispatch_bits<float>(bits, a);
    case 1: return (int)dispatch_bits<__nv_bfloat16>(bits, a);
    case 2: return (int)dispatch_bits<__half>(bits, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Tensor-core CTAs (dtype 1 bfloat16 / 2 float16, bits, tile_m 64 or 256 rows, the
// group) resident on one SM at once on the current device (their registers
// and shared memory allow that many), or minus the CUDA error.
extern "C" int dstt_woq_mma_ctas_per_sm(int dtype, int bits, int tile_m, int group) {
  switch (dtype) {
    case 1: return mma_ctas_per_sm_bits<__nv_bfloat16>(bits, tile_m, group);
    case 2: return mma_ctas_per_sm_bits<__half>(bits, tile_m, group);
    default: return -(int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dstt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
