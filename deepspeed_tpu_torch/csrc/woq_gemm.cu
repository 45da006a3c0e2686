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
// takes that axis' place, and K split across blocks is summed in a fixed
// order (no atomics: repeated serving steps are bitwise equal).
// - Few rows (`woq_gemv_kernel`, decode): the weight bytes must be in
//   flight, ~20-30 KB an SM at 3.35 TB/s and ~1 us of latency, and each
//   weight must cost few instructions: 8 rows of fp32 FMAs a weight take
//   ~20 instructions a weight and lane, ~5x the bytes' time. A CTA of 8
//   warps takes 128 columns and one K split, stepping K by 64
//   rows through a cp.async ring (4 stages for 16-bit x, 3 for fp32); a
//   stage holds the step's code slab (byte rows padded by 16 or 32 bytes
//   against bank conflicts; 16- or 8-byte copies: Out is only sure to be a
//   multiple of 8), x of every row from the step's first K rounded down to
//   8 (16-byte copies; the wrapper pads an x whose rows are not 16-byte
//   multiples), and its 3 scale rows (a group below 32 reads its scales
//   from L1: a second instantiation). Dequant with no conversion
//   instruction (the prefill kernel's PRMT into 0x4B0000uu, FADD, FMUL by
//   the scale, then round to x's dtype: the operand rule's
//   to_float(from_float<T>(code * scale)), bit for bit). For 16-bit x the
//   products run on mma.sync.m16n8k16 as out^T = w^T x^T: a lane
//   dequantizes 4 K rows x 4 columns straight into the A fragments of two
//   products (no shared-memory round trip), x's 8 rows are the 8-column B
//   operand read as one 8-byte word a lane, and the fp32 C fragments stay
//   in registers: ~4 instructions a weight and lane. fp32 x keeps FMAs (8
//   rows x 8 columns of sums a thread). The K lanes' sums meet in shared
//   memory in lane order; the K splits of a column tile (at most 8,
//   `plan`) are one thread-block cluster, and each output is the sum of
//   the splits' sums in split order, read through distributed shared
//   memory: one launch a call, no workspace, no second pass. `plan` picks
//   the splits (a pure function of the shape: a row's sums do not
//   depend on how many rows there are) to fill the card in one wave. ptxas
//   (CUDA 12.9, sm_90a): 66-72 registers and no spill for 16-bit x at 128
//   columns (47,616 B of shared memory at int8, 3 CTAs an SM), 123-128 and
//   no spill for fp32 x.
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
// place of the prefill's second pass.

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
// the few-rows kernel (ops/quantizer/woq_gemm.py GEMV_MAX_ROWS)
constexpr int kGemvMaxRows = 8;
constexpr int kGemvThreads = 256;
constexpr int kGemvCols = 128;       // columns a CTA (ops/quantizer/woq_gemm.py GEMV_COLS)
constexpr int kGemvK = 64;           // K rows a step
constexpr int kGemvXW = kGemvK + 8;  // x elements a stage holds a row: from k0 rounded down to 8
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

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

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

// ---------------------------------------------------------------------------
// Few rows (decode): the GEMV
// ---------------------------------------------------------------------------

// Dynamic shared memory of woq_gemv_kernel: STAGES stages of {code slab
// (64 K rows in BITS / 8 * 64 byte rows of 128 bytes, PITCH apart), x
// slab (8 rows x kGemvXW elements), 3 scale rows of 128 floats}; the
// partial sums then reuse it. The pitch pads each byte row by 16 (int8)
// or 32 bytes so that the tensor-core path's four K rows a warp reads at
// once fall on different banks.
template <typename T, int BITS>
struct GemvSmem {
  static constexpr bool MMA = sizeof(T) == 2;  // 16-bit x: the products on mma.sync
  static constexpr int STAGES = MMA ? 4 : 3;
  // resident CTAs an SM the registers are held to (ops/quantizer/woq_gemm.py
  // gemv_ctas_per_sm): 3 for 16-bit x; the fp32 FMA path's registers allow 2
  static constexpr int CTAS_PER_SM = MMA ? 3 : 2;
  static constexpr int CODE_ROWS = kGemvK * BITS / 8;
  static constexpr int X = kGemvMaxRows * kGemvXW * int(sizeof(T));
  static constexpr int PITCH = kGemvCols + (BITS == 8 ? 16 : 32);
  static constexpr int CODE = CODE_ROWS * PITCH;
  static constexpr int STAGE = CODE + X + kScaleRows * kGemvCols * 4;
  // the partial sums: [K lanes][8 rows][128] floats (K lanes: 2 warps on
  // mma.sync; 16 threads on FMAs)
  static constexpr int RED =
      (MMA ? kGemvThreads / kGemvCols : kGemvThreads * 8 / kGemvCols) * kGemvMaxRows * kGemvCols * 4;
  static constexpr int BYTES = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static_assert(X % 16 == 0, "16-byte alignment");
};

// Two weights rounded to T and widened back (identity for fp32): the
// operand rule's to_float(from_float<T>(code * scale)), round to nearest
// even as __float2bfloat16 / __float2half.
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t p = pack2<T>(a, b);
    a = __uint_as_float(p << 16);
    b = __uint_as_float(p & 0xFFFF0000u);
  } else if constexpr (std::is_same<T, __half>::value) {
    const uint32_t p = pack2<T>(a, b);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&p));
    a = f.x;
    b = f.y;
  }
}

// Four x values of row b at slab offset o: one 8- or 16-byte load where o
// is a multiple of 4, else four.
template <typename T>
__device__ __forceinline__ void load_x4(const T* sx, int o, bool vec, float (&v)[4]) {
  if (vec) {
    const Vec<T, 4> x = *reinterpret_cast<const Vec<T, 4>*>(sx + o);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = to_float(x.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = to_float(sx[o + j]);
  }
}

// The biased codes of K rows kr .. kr + 3 (one packing unit for every
// width; kr a multiple of 4) at byte offset c of a code slab whose byte
// rows lie `pitch` apart: word r holds four columns' codes of row kr + r,
// a byte lane each (the prefill's dequant_block does the same from its
// slab).
template <int BITS>
__device__ __forceinline__ void quad_codes(const int8_t* sc, int pitch, int kr, int c,
                                           uint32_t (&q)[4]) {
  if constexpr (BITS == 8) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = *reinterpret_cast<const uint32_t*>(sc + (kr + j) * pitch + c) ^ 0x80808080u;
  } else if constexpr (BITS == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // byte row kr / 2 + j: rows kr + 2j (low nibbles), + 1 (high)
      const uint32_t b = *reinterpret_cast<const uint32_t*>(sc + (kr / 2 + j) * pitch + c) ^
                         0x88888888u;
      q[2 * j] = b & 0x0F0F0F0Fu;
      q[2 * j + 1] = (b >> 4) & 0x0F0F0F0Fu;
    }
  } else {
    // unpack6 on four columns at once, a byte lane each, then the bias ^ 32
    const int8_t* u = sc + (kr / 4 * 3) * pitch + c;
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(u);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(u + pitch);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(u + 2 * pitch);
    q[0] = (r0 & 0x3F3F3F3Fu) ^ 0x20202020u;
    q[1] = (((r0 >> 6) & 0x03030303u) | ((r1 << 2) & 0x3C3C3C3Cu)) ^ 0x20202020u;
    q[2] = (((r1 >> 4) & 0x0F0F0F0Fu) | ((r2 << 4) & 0x30303030u)) ^ 0x20202020u;
    q[3] = ((r2 >> 2) & 0x3F3F3F3Fu) ^ 0x20202020u;
  }
}

// Few rows (<= 8). Grid (splits, ceil(Out / 128)), clusters of `splits`
// CTAs along x: CTA z of column tile y takes groups [z * gps, min(ng, z *
// gps + gps)) of columns [y * ncol, y * ncol + ncol) (ncol = 128), in
// steps of 64 K rows. 256 threads.
// - 16-bit x (mma.sync.m16n8k16, out^T = w^T x^T): warp (cw, kw) takes
//   columns 32 cw .. 32 cw + 31 and the 16-row slices kw, kw + 2, ... of
//   each step; lane (g, t) dequantizes K rows 4t .. 4t + 3 of a
//   slice for columns 4g .. 4g + 3 straight into the A fragments of two
//   products (columns 4g + 2m and + 1 as A rows g and g + 8 of product m;
//   rows 4t + {0, 1, 2, 3} as its K slots 2t, 2t + 1, 2t + 8, 2t + 9), and
//   x row g's K values 4t .. 4t + 3 are its B fragment (the same K
//   permutation on both sides). Rows past `rows` read zeros.
// - fp32 x (FMAs): thread (ct = tid % (ncol / 8), kl = tid / (ncol / 8))
//   owns columns 8 ct .. 8 ct + 7 and the 4-row quads kl, kl + 256 /
//   (ncol / 8), ... of each step, 8 rows x 8 columns of sums in registers.
// x: rows x_ld elements apart, x_ld a multiple of 8, 16-byte aligned. wide:
// 16-byte code copies (Out % 16 == 0, codes 16-byte aligned), else 8-byte
// ones. SMALL: group < 32 (scales from L1).
template <typename T, int BITS, bool SMALL>
__global__ void __launch_bounds__(kGemvThreads, GemvSmem<T, BITS>::CTAS_PER_SM)
woq_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                const float* __restrict__ scale, float* __restrict__ out, int rows, int in_dim,
                int out_dim, int group, int gps, int x_ld, bool wide) {
  using L = GemvSmem<T, BITS>;
  constexpr int ncol = kGemvCols;
  constexpr int RB = kGemvMaxRows;
  constexpr int BIAS = BITS == 8 ? 128 : (BITS == 4 ? 8 : 32);
  constexpr int EPC = 16 / int(sizeof(T));  // x elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  const int splits = gridDim.x;
  const int z = blockIdx.x;  // the split, and the CTA's rank in its cluster
  const int n0 = blockIdx.y * ncol;
  const int k_begin = z * gps * group;
  const int k_end = min(in_dim, k_begin + gps * group);
  const int steps = (k_end - k_begin + kGemvK - 1) / kGemvK;
  constexpr int pitch = L::PITCH;
  auto stage_c = [&](int st) { return reinterpret_cast<int8_t*>(gemv_smem + st * L::STAGE); };
  auto stage_x = [&](int st) {
    return reinterpret_cast<T*>(gemv_smem + st * L::STAGE + L::CODE);
  };
  auto stage_s = [&](int st) {
    return reinterpret_cast<float*>(gemv_smem + st * L::STAGE + L::CODE + L::X);
  };

  // step s's copies into stage st: code byte rows whose unit starts below
  // k_end (zeros past it and past Out), x of rows < `rows` from k0 rounded
  // down to 8 (zeros past In), and the scale rows of the groups the step
  // touches (zeros past them: a row past k_end reads a zero or a real one,
  // times a zero code). A thread's pieces sit at the same place in every
  // stage and move by a fixed stride a step: their addresses are set once.
  const int cbytes = wide ? 16 : 8;
  const int per_row = ncol / cbytes;                // pieces a byte row (8 or 16)
  const int rstep = kGemvThreads / per_row;         // byte rows between a thread's pieces
  constexpr int NCP = (L::CODE_ROWS * (ncol / 8) + kGemvThreads - 1) / kGemvThreads;  // 8-byte
  const int br0 = threadIdx.x / per_row, c0 = (threadIdx.x % per_row) * cbytes;
  const bool c_in = n0 + c0 < out_dim;
  const int8_t* const csrc = codes + ((size_t)k_begin * BITS / 8 + br0) * out_dim + n0 + c0;
  const size_t crow = (size_t)rstep * out_dim;      // code bytes between a thread's pieces
  const size_t cstep = (size_t)kGemvK * BITS / 8 * out_dim;  // code bytes a step
  constexpr int XC = kGemvXW / EPC;                           // x copies a row
  const int xb_row = threadIdx.x / XC, xc = (threadIdx.x % XC) * EPC;
  const bool x_in = threadIdx.x < RB * XC && xb_row < rows;
  const T* const xsrc = x + (size_t)xb_row * x_ld + (k_begin & ~7) + xc;
  const int sj = threadIdx.x / (ncol / 4), scol = (threadIdx.x % (ncol / 4)) * 4;
  auto load = [&](int s, int st) {
    if (s >= steps) return;
    const int k0 = k_begin + s * kGemvK;
    int8_t* const sc = stage_c(st);
#pragma unroll
    for (int it = 0; it < NCP; ++it) {
      const int br = br0 + it * rstep;
      if (br >= L::CODE_ROWS || !c_in) continue;
      // the first K row of this byte row's packing unit
      const int k = k0 + (BITS == 8 ? br : (BITS == 4 ? 2 * br : (br / 3) * 4));
      const bool ok = k < k_end;
      const int8_t* src = ok ? csrc + s * cstep + it * crow : codes;
      if (wide) {
        cp_async16(sc + br * pitch + c0, src, ok);
      } else {
        cp_async8(sc + br * pitch + c0, src, ok);
      }
    }
    if (threadIdx.x < RB * XC) {
      const bool ok = x_in && (k0 & ~7) + xc < in_dim;
      cp_async16(stage_x(st) + xb_row * kGemvXW + xc, ok ? xsrc + s * kGemvK : x, ok);
    }
    if (!SMALL && threadIdx.x < kScaleRows * (ncol / 4)) {
      const int g0 = k0 / group, g1 = (min(k_end, k0 + kGemvK) - 1) / group;
      const bool ok = g0 + sj <= g1 && n0 + scol < out_dim;
      cp_async16(stage_s(st) + sj * ncol + scol,
                 ok ? scale + (size_t)(g0 + sj) * out_dim + n0 + scol : scale, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cth = ncol / 8;                                // FMA: column threads
  const int kls = L::MMA ? kGemvThreads / ncol : kGemvThreads / cth;  // K lanes
  const int kl = L::MMA ? warp / (ncol / 32) : threadIdx.x / cth;     // this thread's
  const int cw = warp % (ncol / 32), lg = lane / 4, lt = lane % 4;    // MMA: column warp, lane
  const int ct = threadIdx.x % cth;                                   // FMA: column thread
  const int col = L::MMA ? 32 * cw + 4 * lg : 8 * ct;  // the thread's first column in the tile
  float acc[RB][8];  // MMA: acc[m] is product m's C fragment; FMA: [row][column]
#pragma unroll
  for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[b][c] = 0.f;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    load(s, s);
    cp_async_commit();
  }
  const bool x_vec = ((k_begin - (k_begin & ~7)) & 3) == 0;  // the same for every step
  for (int s = 0; s < steps; ++s) {
    // step s has landed (this thread's copies; after the barrier every
    // thread's), and every thread is done with step s - 1's stage
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();
    load(s + L::STAGES - 1, (s + L::STAGES - 1) % L::STAGES);
    cp_async_commit();
    const int st = s % L::STAGES;
    const int k0 = k_begin + s * kGemvK;
    const int8_t* const sc = stage_c(st);
    const T* const sx = stage_x(st);
    const float* const ss = stage_s(st);
    const int xo = k0 - (k0 & ~7);
    // the step's rows below b1 are in its first group (scale row 0)
    const int b1 = SMALL ? 0 : (k0 / group + 1) * group - k0;
    if constexpr (L::MMA) {
      // the warp's 16-row slices of the step, all loads first (ILP)
      constexpr int KW = kGemvThreads / ncol, SPW = kGemvK / 16 / KW;
      uint32_t q[SPW][4];
      float4 s0[SPW], s1[SPW];
      int split[SPW];
      uint32_t xb[SPW][2];
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        const int kr = 16 * (kl + KW * i) + 4 * lt;  // this lane's 4 K rows in the step
        quad_codes<BITS>(sc, pitch, kr, col, q[i]);
        // the scales of the 4 rows' columns: rows below split[i] take s0[i]
        split[i] = 4;
        s0[i] = s1[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (!SMALL) {
          const int j = (kr >= b1) + (kr >= b1 + group);
          split[i] = b1 + j * group - kr;
          s0[i] = *reinterpret_cast<const float4*>(ss + j * ncol + col);
          if (split[i] < 4)  // a group boundary inside the 4 rows (group % 4 != 0)
            s1[i] = *reinterpret_cast<const float4*>(ss + min(j + 1, kScaleRows - 1) * ncol + col);
        }
        // x row lg, K rows kr .. kr + 3: the B fragment
        const T* xp = sx + lg * kGemvXW + xo + kr;
        if (x_vec) {
          const uint2 v = *reinterpret_cast<const uint2*>(xp);
          xb[i][0] = v.x;
          xb[i][1] = v.y;
        } else {
          const uint16_t* h = reinterpret_cast<const uint16_t*>(xp);
          xb[i][0] = uint32_t(h[0]) | (uint32_t(h[1]) << 16);
          xb[i][1] = uint32_t(h[2]) | (uint32_t(h[3]) << 16);
        }
      }
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        if (k0 + 16 * (kl + KW * i) >= k_end) break;  // the whole warp: past the split's end
        const int kr = 16 * (kl + KW * i) + 4 * lt;
        // dequantize (scale row of row r: srow(r)) and multiply; a select a
        // row only where a group boundary falls inside the 4 rows
        auto product = [&](auto srow) {
          float w[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 sv = srow(r);
            const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              w[r][c] = biased_to_float<BIAS>(byte_into_f32(q[i][r], c)) * s4[c];
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint32_t a[4] = {pack2<T>(w[0][2 * m], w[1][2 * m]),
                                   pack2<T>(w[0][2 * m + 1], w[1][2 * m + 1]),
                                   pack2<T>(w[2][2 * m], w[3][2 * m]),
                                   pack2<T>(w[2][2 * m + 1], w[3][2 * m + 1])};
            mma16816<T>(reinterpret_cast<float (&)[4]>(acc[0][4 * m]), a, xb[i][0], xb[i][1]);
          }
        };
        if constexpr (SMALL) {
          product([&](int r) {
            const int k = k0 + kr + r;
            return k < k_end && n0 + col < out_dim
                       ? __ldg(reinterpret_cast<const float4*>(scale + (size_t)(k / group) * out_dim +
                                                               n0 + col))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          });
        } else if (__all_sync(0xffffffffu, split[i] >= 4)) {  // mma.sync: the whole warp
          product([&](int) { return s0[i]; });
        } else {
          product([&](int r) { return r < split[i] ? s0[i] : s1[i]; });
        }
      }
    } else {
      if (n0 + col >= out_dim) continue;  // Out % 8 == 0: all 8 columns in or out
      for (int qd = kl; qd < kGemvK / 4; qd += kls) {
        const int r0 = 4 * qd, k = k0 + r0;
        if (k >= k_end) break;
        uint32_t qw[4][2];  // biased codes of rows r0 .. r0 + 3: columns 0-3, 4-7
        {
          uint32_t lo[4], hi[4];
          quad_codes<BITS>(sc, pitch, r0, col, lo);
          quad_codes<BITS>(sc, pitch, r0, col + 4, hi);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qw[j][0] = lo[j];
            qw[j][1] = hi[j];
          }
        }
        float w[4][8];
        int ga = 0, split = 4;  // rows j < split take scale row ga, the rest ga + 1
        if constexpr (!SMALL) {
          ga = (r0 >= b1) + (r0 >= b1 + group);
          split = b1 + ga * group - r0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sv[8];
          if constexpr (!SMALL) {
            const float* sp = ss + (j < split ? ga : min(ga + 1, kScaleRows - 1)) * ncol + col;
            const float4 a = *reinterpret_cast<const float4*>(sp);
            const float4 b = *reinterpret_cast<const float4*>(sp + 4);
            sv[0] = a.x, sv[1] = a.y, sv[2] = a.z, sv[3] = a.w;
            sv[4] = b.x, sv[5] = b.y, sv[6] = b.z, sv[7] = b.w;
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c) sv[c] = 0.f;
            if (k + j < k_end)
              load_scale8(scale + (size_t)((k + j) / group) * out_dim + n0 + col, sv);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c)
            w[j][c] = biased_to_float<BIAS>(byte_into_f32(qw[j][c / 4], c % 4)) * sv[c];
#pragma unroll
          for (int c = 0; c < 8; c += 2) round_pair<T>(w[j][c], w[j][c + 1]);
        }
        const int xk = xo + r0;
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          if (b < rows) {
            float xv[4];
            load_x4<T>(sx + b * kGemvXW, xk, x_vec, xv);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[b][c] = fmaf(xv[j], w[j][c], acc[b][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial sums go there

  // the K lanes' sums, added in lane order into lane 0's place: the CTA's
  // sums of its K run ([b][ncol] floats)
  float* const red = reinterpret_cast<float*>(gemv_smem);  // [kls][RB][ncol]
  if constexpr (L::MMA) {
    // product m's C fragment: rows lg (column col + 2m) and lg + 8 (+ 1),
    // columns 2 lt and + 1 (x rows)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 2 * lt + (e & 1), c = col + 2 * m + (e >> 1);
        if (b < rows) red[(kl * RB + b) * ncol + c] = acc[0][4 * m + e];
      }
  } else {
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      if (b < rows) {
        float4* dst = reinterpret_cast<float4*>(red + (kl * RB + b) * ncol + col);
        dst[0] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
        dst[1] = make_float4(acc[b][4], acc[b][5], acc[b][6], acc[b][7]);
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * ncol; idx += kGemvThreads) {
    const int b = idx / ncol, n = idx % ncol;
    float v = red[b * ncol + n];
    for (int j = 1; j < kls; ++j) v += red[(j * RB + b) * ncol + n];
    if (splits == 1) {
      if (n0 + n < out_dim) out[(size_t)b * out_dim + n0 + n] = v;
    } else {
      red[b * ncol + n] = v;
    }
  }
  if (splits == 1) return;

  // the splits' sums, added in split order, each output by one thread of
  // the cluster, read from the CTAs' shared memory; the second barrier
  // keeps every CTA's shared memory until all reads are done
  cluster_arrive();
  cluster_wait();
  for (int idx = z * kGemvThreads + threadIdx.x; idx < rows * ncol;
       idx += splits * kGemvThreads) {
    const int b = idx / ncol, n = idx % ncol;
    if (n0 + n < out_dim) {
      float v = 0.f;
      for (int r = 0; r < splits; ++r) v += ld_cluster(cluster_addr(red + b * ncol + n, r));
      out[(size_t)b * out_dim + n0 + n] = v;
    }
  }
  cluster_arrive();
  cluster_wait();
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

// woq_gemv_kernel<T, BITS, SMALL>: grid (splits, ceil(Out / 128)), the
// splits of a column tile one cluster. The dynamic shared memory opt-in is
// made once a device.
template <typename T, int BITS, bool SMALL>
cudaError_t launch_gemv(const Args& a) {
  using L = GemvSmem<T, BITS>;
  const auto kernel = woq_gemv_kernel<T, BITS, SMALL>;
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = true;
  }
  const bool wide = a.out_dim % 16 == 0 && reinterpret_cast<uintptr_t>(a.codes) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, (a.out_dim + kGemvCols - 1) / kGemvCols);
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.x), a.codes, a.scale, a.out,
                           a.rows, a.in_dim, a.out_dim, a.group, a.split_len, a.x_ld, wide);
  return err != cudaSuccess ? err : cudaGetLastError();
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
  } else {  // the GEMV sums its K splits inside its clusters: no second pass
    return a.group < kMinStagedGroup ? launch_gemv<T, BITS, true>(a) : launch_gemv<T, BITS, false>(a);
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
// 0 runs the few-rows kernel (rows <= 8, 128 columns a CTA; split_len =
// groups a split takes, splits <= 8, summed in a cluster), 1 the fp32 FMA
// tile kernel (float32 x, 64 x 64 tiles; split_len = K rows a split takes,
// a multiple of 32), 2 the tensor-core kernel (16-bit x, tile_m = 64 or 256
// rows of 128 columns a CTA; split_len a multiple of 64). tile_m is the
// tensor-core kernel's tile rows, and the other kinds ignore it. Kinds 0 and 2: x 16-byte aligned, rows x_ld >= in_dim elements
// apart, x_ld a multiple of 8 and x zero in the columns past in_dim; kind
// 1: x_ld = in_dim. work: (splits, rows, out_dim) fp32 when kinds 1 and 2
// split K, else unused. Returns
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
                         split_len > 0 && splits <= 65535 &&
                         (splits == 1 || kind == kGemv || work != nullptr);
  bool ok_kind = false;
  if (kind == kGemv) {
    ok_kind = rows <= kGemvMaxRows && splits <= 8 &&
              x_ld >= in_dim && x_ld % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
              (long long)(splits - 1) * split_len < in_dim / group &&
              (out_dim + kGemvCols - 1) / kGemvCols <= 65535;
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
