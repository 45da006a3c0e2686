// Fused linear cross-entropy for NVIDIA Hopper (sm_90a), with a plain C
// entry point for ctypes (built by deepspeed_tpu_torch/ops/op_builder.py).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/fused_ce.py:
// `_fwd_kernel` (:45, launched by `_ce_fwd_impl` :93) and `_bwd_kernel`
// (:114, launched by `_ce_bwd_impl` :150).
//
// What it computes. x (N, H), W (V, H) (the embedding-table layout),
// labels (N,) int32, g (N,) fp32 the upstream gradient of nll.
//   forward:  s = x @ W^T accumulated in fp32; lg = s rounded to x's dtype
//             (the backward's residual, written only when asked);
//             lse = logsumexp(s) and nll = lse - s[label], both fp32 (N,).
//             A label outside [0, V) hits no column: its nll is lse.
//   backward: dlg = ((exp(float(lg) - lse) - onehot) * g) rounded to x's
//             dtype (the softmax from the rounded residual, as the TPU
//             kernel takes it); dx = dlg @ W and dw = dlg^T @ x, each
//             accumulated in fp32 and rounded once to x's / W's dtype.
// The TPU backward writes dw as N / R partial sums in x's dtype that XLA
// adds in fp32 (`fused_ce.py:172-173`); here each dw element is one fp32 sum
// over all N rows in order, rounded once: for bf16 more exact than the TPU
// kernel by those partials' roundings.
//
// What bounds it on this card: operations. The forward does 2 N V H flops
// on N H + V H + N V elements (with the residual), the backward 4 N V H on
// about twice that; at llama-7b's head (N 4096, H 4096, V 32000, bf16) that
// is ~2,000 and ~2,500 flops a byte, far above the ~295 at which the
// tensor cores, not device memory, are the limit.
//
// What the design does about it. bf16 / fp16: the three products (forward
// s = x W^T, dX = dlg W, dW = dlg^T x) are one persistent, warp-specialised
// GEMM core on wgmma (`ce_gemm`), instantiated once a product; only the
// operands' majorness differs, set by the tensor maps and the descriptors'
// transpose bits:
//   forward  A = x (K-major),        B = W (K-major);
//   dX       A = dlg (K-major),      B = W (K = V rows, MN-major);
//   dW       A = dlg^T (MN-major),   B = x (K = N rows, MN-major).
// - A CTA of 3 warpgroups, about one an SM (the occupancy query decides),
//   computes 128 x 256 output tiles, K in steps of 64 (one 128-byte swizzle
//   atom of 16-bit values). Warpgroup 0 is the producer: after giving its
//   registers back (setmaxnreg 40) one thread walks the CTA's tiles and K
//   steps and fills a ring of 4 stages (48 KB each: the A tile and the B
//   tile) with TMA copies that complete on the stage's "full" mbarrier, as
//   soon as both consumers have released the stage on its "empty" one.
//   Warpgroups 1 and 2 (setmaxnreg 232) each own 64 rows of the tile: per
//   K step 4 asynchronous wgmma.m64n256k16 straight from the swizzled
//   stage, the fp32 accumulators (128 a thread) in registers for the whole
//   K loop, one step's products left in flight while the next is issued.
// - Persistent: each CTA walks work units u = blockIdx.x, + gridDim.x, ...
//   A unit is (row block m, chunk c), the vocab (or H) tiles [c per,
//   min(nt, c per + per)). The forward orders units row-block-fastest, so
//   the CTAs busy at once share a few W tiles (W read from device memory
//   about once, x's 33.5 MB at llama-7b's head kept in L2); dX too (a W
//   column slab shared by every row block); dW column-tile-fastest (an x
//   slab shared by every vocab block). The units and the chunk length come
//   from `plan` (ops/transformer/fused_ce.py), a pure function of the
//   shape and the card's residency.
// - The epilogue reads the accumulators in registers. Forward: each row's
//   tile max, sum of exp(s - m) and gold logit by quad shuffles, carried as
//   a running (m, l, gold) over the unit's tiles, one fp32 partial per
//   (row, chunk) at the unit's end; `ce_combine_kernel` merges the chunks
//   in chunk order. The residual lg and dx / dw are rounded to T, passed
//   between the 4 lanes of a quad so that each holds 8 consecutive columns,
//   and stored 16 bytes a lane. Meanwhile the producer already loads the
//   next tile's first stages.
// - Tails: N, V and H are multiples of 128, so only the last 256-column
//   tile of a row may be half; its second half is never copied (the stale
//   stage bytes only reach accumulator columns that are never read), the
//   forward keeps those columns out of max, sum and gold, and every store
//   is masked by column.
// - The one-hot terms of dX and dW are kept out of the tensor cores: the
//   dlogits pass writes dlg with each row's label entry 0 and that entry
//   (rounded as dlg rounds it) to dlab. dX's epilogue adds dlab[n] W[label
//   n] to row n in fp32 before rounding; dW's writes each row v that a label
//   names in fp32 to a scratch row, and `ce_dw_label_kernel` adds dlab[n]
//   x[n] over the rows labelled v (ascending n) and rounds it (the rows to
//   finish come from `ce_label_rows_kernel`). The
//   tensor cores' fp32 accumulation loses more than an FMA chain when small
//   products join a large sum: at gpt2-6.7b's head in fp16, dW elements
//   whose two label terms (~1) cancel came out several fp16 ulps from their
//   fp64 sums where cuBLAS's fp32 sums did not (the WMMA kernel this one
//   replaced gave the same bits); with the label terms apart the
//   accumulator holds only the small softmax terms.
// - Every output element is one fp32 sum in a fixed order (the products over
//   all of K inside one CTA, then the label terms), rounded once: no split-K,
//   no partial sums, no atomics, so the forward and backward repeat bitwise.
// fp32: FMA kernels (`ce_*_fma_kernel`): a CTA of 8 warps owns a
// 64 x 128 tile, an 8 x 4 register tile a thread, a 2-stage cp.async ring,
// no TF32; the forward grid is (64-row tiles, vocab chunks of 128-column
// tiles). `ce_dlogits_kernel` forms dlg for every dtype in one elementwise
// pass, 16-byte loads and stores, into a scratch buffer the size of the
// residual (16-bit: with the label entries apart).

#include <cuda.h>  // CUtensorMap (the encoder is looked up at run time: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_ptx.cuh"
#include "hopper_ptx.cuh"

namespace {

constexpr int kGridLimit = 65535;

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

// ---------------------------------------------------------------------------
// fp32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 64, kBN = 128;     // output tile of every fp32 GEMM
constexpr int kLDC = kBN + 4;          // fp32 tile in shared memory, row stride
constexpr int kStages = 2;

// Copy a ROWS x COLS fp32 tile (COLS contiguous in device memory, rows `ld`
// elements apart) into shared memory with rows COLS + 4 floats apart, 16
// bytes a thread.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile_async(float* __restrict__ smem,
                                                const float* __restrict__ gmem, size_t ld) {
  constexpr int PER_ROW = COLS / 4;
  constexpr int SLD = COLS + 4;
  for (int c = threadIdx.x; c < ROWS * PER_ROW; c += kThreads) {
    const int r = c / PER_ROW, v = (c % PER_ROW) * 4;
    cp_async16(smem + r * SLD + v, gmem + r * ld + v, true);
  }
}

// C (64 x 128, fp32) = A (64 x K) . B (K x 128), K a multiple of BK.
// A_KMAJOR: A's element (m, k) at a[m * lda + k], else at a[k * lda + m];
// B_KMAJOR: B's element (k, n) at b[n * ldb + k], else at b[k * ldb + n].
// `run` leaves C in shared memory as a [64][kLDC] fp32 tile (aliasing the
// operand stages) and returns after a barrier.
template <bool A_KMAJOR, bool B_KMAJOR>
struct FmaGemm {
  static constexpr int BK = 16;  // 64 bytes of K a row
  static constexpr int PAD = 4;
  static constexpr int A_LD = A_KMAJOR ? BK + PAD : kBM + PAD;
  static constexpr int B_LD = B_KMAJOR ? BK + PAD : kBN + PAD;
  static constexpr int A_ELEMS = A_KMAJOR ? kBM * A_LD : BK * A_LD;
  static constexpr int B_ELEMS = B_KMAJOR ? kBN * B_LD : BK * B_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int OPERAND_BYTES = kStages * STAGE_ELEMS * 4;
  static constexpr int C_BYTES = kBM * kLDC * 4;
  static constexpr int SMEM_BYTES = OPERAND_BYTES > C_BYTES ? OPERAND_BYTES : C_BYTES;
  static_assert((A_ELEMS * 4) % 128 == 0 && (STAGE_ELEMS * 4) % 128 == 0,
                "stages must keep 128-byte alignment");

  static __device__ __forceinline__ void load_stage(float* stage, const float* a, size_t lda,
                                                    const float* b, size_t ldb, int k0) {
    if constexpr (A_KMAJOR) {
      load_tile_async<kBM, BK>(stage, a + k0, lda);
    } else {
      load_tile_async<BK, kBM>(stage, a + (size_t)k0 * lda, lda);
    }
    if constexpr (B_KMAJOR) {
      load_tile_async<kBN, BK>(stage + A_ELEMS, b + k0, ldb);
    } else {
      load_tile_async<BK, kBN>(stage + A_ELEMS, b + (size_t)k0 * ldb, ldb);
    }
  }

  // shared-memory element (m, k) of A and (k, n) of B within a stage
  static __device__ __forceinline__ int a_at(int m, int k) {
    return A_KMAJOR ? m * A_LD + k : k * A_LD + m;
  }
  static __device__ __forceinline__ int b_at(int k, int n) {
    return A_ELEMS + (B_KMAJOR ? n * B_LD + k : k * B_LD + n);
  }

  static __device__ void run(unsigned char* smem_raw, const float* __restrict__ a, size_t lda,
                             const float* __restrict__ b, size_t ldb, int K) {
    float* smem = reinterpret_cast<float*>(smem_raw);
    // thread owns rows tr * 8 .. tr * 8 + 7, columns tc + 32 j
    const int tr = threadIdx.x / 32, tc = threadIdx.x % 32;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    const int steps = K / BK;
    load_stage(smem, a, lda, b, ldb, 0);
    cp_async_commit();
    for (int t = 0; t < steps; ++t) {
      if (t + 1 < steps) {
        load_stage(smem + ((t + 1) % kStages) * STAGE_ELEMS, a, lda, b, ldb, (t + 1) * BK);
      }
      cp_async_commit();  // an empty group on the last step keeps the count
      cp_async_wait<1>();  // every group but the newest: step t has landed
      __syncthreads();
      const float* st = smem + (t % kStages) * STAGE_ELEMS;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = st[a_at(tr * 8 + i, kk)];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = st[b_at(kk, tc + 32 * j)];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    cp_async_wait<0>();

    float* sC = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sC[(tr * 8 + i) * kLDC + tc + 32 * j] = acc[i][j];
    __syncthreads();
  }
};

// Write the fp32 tile in shared memory to dst (64 x 128, rows `ld` apart),
// 16 bytes a thread.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, size_t ld,
                                           const float* __restrict__ sC) {
  constexpr int PER_ROW = kBN / 4;
  for (int c = threadIdx.x; c < kBM * PER_ROW; c += kThreads) {
    const int r = c / PER_ROW, cc = (c % PER_ROW) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + cc) =
        *reinterpret_cast<const float4*>(sC + r * kLDC + cc);
  }
}

// Grid (N / 64, chunks). Chunk c takes vocab tiles [c * tpc, min(V / 128,
// c * tpc + tpc)). The row tiles vary fastest, so the CTAs resident at once
// work on a few vocab tiles, each read from device memory about once and by
// every row tile from L2. part is (3, chunks, N) fp32: m, l, gold of each
// row over the chunk.
__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ labels, float* __restrict__ lg,
                  float* __restrict__ part, int N, int V, int H, int tpc) {
  using G = FmaGemm<true, true>;
  __shared__ __align__(128) unsigned char smem[G::SMEM_BYTES];
  const float* sC = reinterpret_cast<const float*>(smem);
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const int m0 = blockIdx.x * kBM;
  const int t_begin = chunk * tpc;
  const int t_end = min(V / kBN, t_begin + tpc);
  // the epilogue's row statistics: 4 threads a row, columns q + 4 i
  const int row = threadIdx.x / 4, q = threadIdx.x % 4;
  const int lab = labels[m0 + row];
  float m = -INFINITY, l = 0.f, gold = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * kBN;
    G::run(smem, x + (size_t)m0 * H, H, w + (size_t)n0 * H, H, H);
    if (lg != nullptr) store_tile(lg + (size_t)m0 * V + n0, V, sC);
    const float* srow = sC + row * kLDC + q;
    float tmax = -INFINITY;
#pragma unroll 8
    for (int i = 0; i < kBN / 4; ++i) tmax = fmaxf(tmax, srow[4 * i]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const int col = lab - n0;
    float sum = 0.f, hit = 0.f;
#pragma unroll 8
    for (int i = 0; i < kBN / 4; ++i) {
      const float s = srow[4 * i];
      sum += expf(s - m_new);
      if (q + 4 * i == col) hit = s;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    hit += __shfl_xor_sync(0xffffffffu, hit, 1);
    hit += __shfl_xor_sync(0xffffffffu, hit, 2);
    l = l * expf(m - m_new) + sum;  // the first tile: m = -inf, l = 0
    m = m_new;
    gold += hit;
    __syncthreads();  // sC is read: the next tile's operands overwrite it
  }
  if (q == 0) {
    const size_t at = (size_t)chunk * N + m0 + row;
    const size_t plane = (size_t)chunks * N;
    part[at] = m;
    part[plane + at] = l;
    part[2 * plane + at] = gold;
  }
}

// Grid (H / 128, N / 64): dx = dlg (N, V) @ W (V, H), K = V in order.
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_dx_fma_kernel(const float* __restrict__ dlg, const float* __restrict__ w,
                     float* __restrict__ dx, int N, int V, int H) {
  using G = FmaGemm<true, false>;
  __shared__ __align__(128) unsigned char smem[G::SMEM_BYTES];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  G::run(smem, dlg + (size_t)m0 * V, V, w + n0, H, V);
  store_tile(dx + (size_t)m0 * H + n0, H, reinterpret_cast<const float*>(smem));
}

// Grid (H / 128, V / 64): dw = dlg^T (V, N) @ x (N, H), K = all N rows in order.
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_dw_fma_kernel(const float* __restrict__ dlg, const float* __restrict__ x,
                     float* __restrict__ dw, int N, int V, int H) {
  using G = FmaGemm<false, false>;
  __shared__ __align__(128) unsigned char smem[G::SMEM_BYTES];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  G::run(smem, dlg + m0, V, x + n0, H, N);
  store_tile(dw + (size_t)m0 * H + n0, H, reinterpret_cast<const float*>(smem));
}

// ---------------------------------------------------------------------------
// Every dtype: the chunk merge and dlogits
// ---------------------------------------------------------------------------

// One thread a row: the chunks' (m, l, gold) merged in chunk order.
__global__ void __launch_bounds__(256)
ce_combine_kernel(const float* __restrict__ part, float* __restrict__ lse,
                  float* __restrict__ nll, int N, int chunks) {
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= N) return;
  const size_t plane = (size_t)chunks * N;
  float m = part[r], l = part[plane + r], gold = part[2 * plane + r];
  for (int c = 1; c < chunks; ++c) {
    const size_t at = (size_t)c * N + r;
    const float mc = part[at];
    const float m_new = fmaxf(m, mc);
    l = l * expf(m - m_new) + part[plane + at] * expf(mc - m_new);
    m = m_new;
    gold += part[2 * plane + at];
  }
  const float s = m + logf(l);
  lse[r] = s;
  nll[r] = s - gold;
}

// dlg = ((exp(float(lg) - lse) - onehot) * g) in T, 16 bytes a thread-step.
// With dlab (the 16-bit path) the label's entry of each row goes there
// instead, and its place in dlg holds 0: the dX and dW kernels add those
// terms in fp32 after their products (see `LabelTerms`).
template <typename T>
__global__ void __launch_bounds__(256)
ce_dlogits_kernel(const T* __restrict__ lg, const float* __restrict__ lse,
                  const int* __restrict__ labels, const float* __restrict__ g,
                  T* __restrict__ dlg, T* __restrict__ dlab, int N, int V) {
  constexpr int VEC = 16 / int(sizeof(T));
  const size_t nvec = (size_t)N * V / VEC;
  for (size_t i = blockIdx.x * size_t(256) + threadIdx.x; i < nvec;
       i += size_t(gridDim.x) * 256) {
    const size_t e0 = i * VEC;
    const int r = int(e0 / V);
    const int c0 = int(e0 % V);
    const float s = lse[r], gr = g[r];
    const int lab = labels[r];
    alignas(16) T in[VEC];
    alignas(16) T out[VEC];
    *reinterpret_cast<uint4*>(in) = __ldg(reinterpret_cast<const uint4*>(lg + e0));
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float p = expf(to_float(in[e]) - s);
      const float onehot = c0 + e == lab ? 1.f : 0.f;
      out[e] = from_float<T>((p - onehot) * gr);
      if (dlab != nullptr && c0 + e == lab) {
        dlab[r] = out[e];
        out[e] = from_float<T>(0.f);
      }
    }
    *reinterpret_cast<uint4*>(dlg + e0) = *reinterpret_cast<const uint4*>(out);
  }
}

// The index of the label terms for the 16-bit backward, in one CTA of 1024
// threads (its plain version: `label_rows_plain`, ops/transformer/
// fused_ce.py): starts (V + 1,), where label v's rows begin in order; order
// (its first starts[V] entries), the rows with a label in [0, V) by label,
// ascending within one; slot (V,), each label that some row has numbered in
// label order, -1 for the others; vlist (min(N, V),), the label of each
// slot, -1 past the last. cursor (V,) and tmp (N,) are scratch. Counts by
// atomics, one scan over the labels in blocks of 4096, rows placed by
// atomics and then ranked within their label (so the order does not depend
// on the atomics').
__global__ void __launch_bounds__(1024)
ce_label_rows_kernel(const int* __restrict__ labels, int N, int V, int* __restrict__ order,
                     int* __restrict__ starts, int* __restrict__ slot, int* __restrict__ vlist,
                     int* __restrict__ cursor, int* __restrict__ tmp) {
  __shared__ int sums[2][32];
  __shared__ int carry[2];
  const int t = threadIdx.x, lane = t % 32, wid = t / 32;
  const int S = N < V ? N : V;
  for (int v = t; v < V; v += 1024) cursor[v] = 0;
  for (int i = t; i < S; i += 1024) vlist[i] = -1;
  if (t < 2) carry[t] = 0;
  __syncthreads();
  for (int n = t; n < N; n += 1024) {
    const int lab = labels[n];
    if (lab >= 0 && lab < V) atomicAdd(&cursor[lab], 1);
  }
  __syncthreads();
  for (int base = 0; base < V; base += 4096) {
    // exclusive scans of the counts and of "has a row", 4096 labels at a
    // time, 4 consecutive ones a thread
    int c[4], has[4], c4 = 0, h4 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = base + 4 * t + k;
      c[k] = v < V ? cursor[v] : 0;
      has[k] = c[k] > 0 ? 1 : 0;
      c4 += c[k];
      h4 += has[k];
    }
    int ic = c4, ih = h4;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, ic, o), b = __shfl_up_sync(0xffffffffu, ih, o);
      if (lane >= o) {
        ic += a;
        ih += b;
      }
    }
    if (lane == 31) {
      sums[0][wid] = ic;
      sums[1][wid] = ih;
    }
    __syncthreads();
    if (wid == 0) {
      int a = sums[0][lane], b = sums[1][lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, a, o), y = __shfl_up_sync(0xffffffffu, b, o);
        if (lane >= o) {
          a += x;
          b += y;
        }
      }
      sums[0][lane] = a;
      sums[1][lane] = b;
    }
    __syncthreads();
    int before = carry[0] + (wid ? sums[0][wid - 1] : 0) + ic - c4;
    int nth = carry[1] + (wid ? sums[1][wid - 1] : 0) + ih - h4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = base + 4 * t + k;
      if (v < V) {
        starts[v] = before;
        cursor[v] = before;  // where label v's next row goes
        slot[v] = has[k] ? nth : -1;
        if (has[k]) vlist[nth] = v;
      }
      before += c[k];
      nth += has[k];
    }
    __syncthreads();
    if (t < 2) carry[t] += sums[t][31];
    __syncthreads();
  }
  if (t == 0) starts[V] = carry[0];
  for (int n = t; n < N; n += 1024) {
    const int lab = labels[n];
    if (lab >= 0 && lab < V) tmp[atomicAdd(&cursor[lab], 1)] = n;
  }
  __syncthreads();
  for (int n = t; n < N; n += 1024) {
    const int lab = labels[n];
    if (lab >= 0 && lab < V) {
      const int b = starts[lab], e = starts[lab + 1];
      int rank = 0;
      for (int i = b; i < e; ++i) rank += tmp[i] < n;
      order[b + rank] = n;
    }
  }
}

// The rows of dW that a label names, finished: dw[v] = (the GEMM's fp32 row,
// from scratch row s) + the sum over the rows n labelled v, in ascending n,
// of dlab[n] x[n], rounded once. Grid (slots, ceil(H / 1024)), 4 columns a
// thread; vlist[s] is the row v of slot s, or -1 past the last.
template <typename T>
__global__ void __launch_bounds__(256)
ce_dw_label_kernel(const float* __restrict__ scratch, const int* __restrict__ vlist,
                   const int* __restrict__ order, const int* __restrict__ starts,
                   const T* __restrict__ dlab, const T* __restrict__ x, T* __restrict__ dw,
                   int H) {
  const int v = vlist[blockIdx.x];
  const int h = (blockIdx.y * 256 + threadIdx.x) * 4;
  if (v < 0 || h >= H) return;
  float4 a = *reinterpret_cast<const float4*>(scratch + (size_t)blockIdx.x * H + h);
  for (int i = starts[v]; i < starts[v + 1]; ++i) {
    const int n = order[i];
    const float d = to_float(dlab[n]);
    const uint2 four = *reinterpret_cast<const uint2*>(x + (size_t)n * H + h);
    const T* xs = reinterpret_cast<const T*>(&four);
    a.x = fmaf(d, to_float(xs[0]), a.x);
    a.y = fmaf(d, to_float(xs[1]), a.y);
    a.z = fmaf(d, to_float(xs[2]), a.z);
    a.w = fmaf(d, to_float(xs[3]), a.w);
  }
  *reinterpret_cast<uint2*>(dw + (size_t)v * H + h) = make_uint2(pack2<T>(a.x, a.y),
                                                                  pack2<T>(a.z, a.w));
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the persistent wgmma GEMM core
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;               // producer + 2 consumer warpgroups
constexpr int kTM = 128, kTN = 256, kTK = 64;  // output tile, K step (16-bit)
constexpr int kRing = 4;                      // stages in the TMA ring
constexpr int kBox = 64 * 64 * 2;             // a 64 x 64 box of 16-bit values: 8 KB
constexpr int kStageA = kTM * kTK * 2;        // 16 KB
constexpr int kStageB = kTN * kTK * 2;        // 32 KB
constexpr int kStage = kStageA + kStageB;
constexpr int kSmemBytes = kRing * kStage + 2 * kRing * 8 + 1024;  // + the base's alignment
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

enum Product { kFwd = 0, kDx = 1, kDw = 2 };

// The products' operands: A MN-major only for dW (dlg^T, V contiguous in
// dlg); B MN-major for dX (W, H contiguous, K = V) and dW (x, K = N).
template <int P>
struct Operands {
  static constexpr int A_MN = P == kDw ? 1 : 0;
  static constexpr int B_MN = P == kFwd ? 0 : 1;
};

// The CTA's work: units u of (row block m, chunk c); chunk c takes the
// column tiles [c per, min(nt, c per + per)). Row blocks vary fastest
// unless n_fastest. ops/transformer/fused_ce.py `cta_tiles` walks the same
// schedule.
struct Sched {
  int mt, nt, per, chunks, n_fastest;
};

__device__ __forceinline__ void unit_of(const Sched& s, int u, int& m, int& c) {
  if (s.n_fastest) {
    m = u / s.chunks;
    c = u % s.chunks;
  } else {
    m = u % s.mt;
    c = u / s.mt;
  }
}

// The i-th of four 32-bit values, i known only at run time, with no local
// memory.
__device__ __forceinline__ uint32_t pick4(const uint32_t (&p)[4], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// Store rows r0 and r0 + 8 of this warp's 16 x 256 accumulator slab
// (columns n0 + [0, 8 jv): the valid 8-column groups) rounded to T, row r0
// + 8 h only where keep[h]. The 4 lanes of a quad pass their packed pairs
// around so that lane q holds the 8 columns of group 4a + q, then store 16
// bytes each.
template <typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[128], T* __restrict__ dst,
                                          size_t ld, int r0, int n0, int jv, int q,
                                          const bool (&keep)[2] = {true, true}) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    T* row = dst + (size_t)(r0 + 8 * h) * ld + n0;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      uint32_t p[4], o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        p[t] = pack2<T>(acc[4 * (4 * a + t) + 2 * h], acc[4 * (4 * a + t) + 2 * h + 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // lane q sends its pair of group 4a + (q ^ i) to lane q ^ i and
        // receives that lane's pair of group 4a + q: columns 2 (q ^ i), + 1
        const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(p, q ^ i), i);
#pragma unroll
        for (int s = 0; s < 4; ++s) o[s] = s == (q ^ i) ? got : o[s];
      }
      if (4 * a < jv && keep[h])
        *reinterpret_cast<uint4*>(row + 8 * (4 * a + q)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// What the epilogues read besides the accumulators. Forward: labels, out
// = lg (or null), part (3, chunks, N). dX / dW: out = dx / dw; dlab the
// label entries of dlg (N,) that the dlogits pass kept apart; src the
// other operand's rows (W for dX); dX takes row n's label from labels; dW
// writes each row v that a label names (slot[v] >= 0) to scratch row
// slot[v] in fp32, unrounded, for `ce_dw_label_kernel` to finish.
template <typename T>
struct Epi {
  const int* labels;
  const T* dlab;
  const T* src;
  const int* slot;
  float* scratch;
  T* out;
  float* part;
  int N, V;
};

// The label terms, kept out of the tensor cores' accumulator (the one-hot
// terms, the largest and the ones that cancel; the GEMM sums only the
// softmax terms), for a dX or dW tile's rows r0 (h 0) and r0 + 8 (h 1).
// dX: row n gains dlab[n] W[label n] in fp32 before it is rounded (`add`).
// dW: a row v that a label names goes out in fp32, unrounded, to its
// scratch row (`store_scratch`), and `ce_dw_label_kernel` adds its label
// terms and rounds it; the others are stored as they are. What a row
// needs is loaded at K step 0 and first used after the K loop (dX's W
// rows prefetched into L1 at step ksteps / 2), so that no load stalls the
// products; the dW epilogue reads nothing from memory.
template <typename T, int P>
struct LabelTerms {
  int idx[2];  // dX: the row's label, -1 if outside [0, V); dW: its slot
  float d[2];  // dX: dlab of the row

  __device__ __forceinline__ void at_step(const Epi<T>& e, int ks, int ksteps, int r0, int n0,
                                          int ncols, int q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (ks == 0) {
        if constexpr (P == kDx) {
          const int lab = e.labels[r];
          idx[h] = lab >= 0 && lab < e.V ? lab : -1;
          d[h] = to_float(e.dlab[r]);
        } else {
          idx[h] = e.slot[r];
        }
      } else if (P == kDx && ks == ksteps / 2 && idx[h] >= 0 && 64 * q < ncols - n0) {
        // lane q of the quad: line q of the W row's 512-byte slice
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(e.src + (size_t)idx[h] * ncols + n0 +
                                                          64 * q));
      }
    }
  }

  // dX: acc (columns n0 + [0, 8 jv) of the tile) += the rows' label terms
  __device__ __forceinline__ void add(float (&acc)[128], const Epi<T>& e, int n0, int ncols,
                                      int jv, int q) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (idx[h] < 0) continue;
      const T* src = e.src + (size_t)idx[h] * ncols + n0 + 2 * q;
      // 8 loads in flight, then their products: the accumulators leave few
      // registers, and one load at a time would wait 32 times a row
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += 8) {
        if (j0 < jv) {
          uint32_t two[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            two[j] = __ldg(reinterpret_cast<const unsigned int*>(src + 8 * (j0 + j)));
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const T* pair = reinterpret_cast<const T*>(&two[j]);
            acc[4 * (j0 + j) + 2 * h] = fmaf(d[h], to_float(pair[0]), acc[4 * (j0 + j) + 2 * h]);
            acc[4 * (j0 + j) + 2 * h + 1] =
                fmaf(d[h], to_float(pair[1]), acc[4 * (j0 + j) + 2 * h + 1]);
          }
        }
      }
    }
  }

  // dW: the rows a label names, in fp32 to their scratch rows
  __device__ __forceinline__ void store_scratch(const float (&acc)[128], const Epi<T>& e,
                                                int n0, int ncols, int jv, int q) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (idx[h] < 0) continue;
      float* row = e.scratch + (size_t)idx[h] * ncols + n0 + 2 * q;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j < jv)
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
};

// The forward's epilogue of one tile for rows r0 (h 0) and r0 + 8 (h 1):
// the running (m, l, gold) of each row updated with the tile's valid
// columns (8 jv of them from n0); lab_rel: each row's label minus n0.
__device__ __forceinline__ void fwd_tile_stats(const float (&acc)[128], int jv, int q,
                                               const int (&lab_rel)[2], float (&mx)[2],
                                               float (&l)[2], float (&gold)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j < jv) tmax = fmaxf(tmax, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(mx[h], tmax);
    // the label's column, if this lane holds it: group jl, element el
    const int col = lab_rel[h] - 2 * q;
    const int jl = col >= 0 && (col & 7) < 2 ? col >> 3 : -1;
    const int el = col & 1;
    float sum = 0.f, hit = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < jv) {
        const float s0 = acc[4 * j + 2 * h], s1 = acc[4 * j + 2 * h + 1];
        sum += expf(s0 - m_new) + expf(s1 - m_new);
        if (j == jl) hit = el ? s1 : s0;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    hit += __shfl_xor_sync(0xffffffffu, hit, 1);
    hit += __shfl_xor_sync(0xffffffffu, hit, 2);
    l[h] = l[h] * expf(mx[h] - m_new) + sum;  // the first tile: m = -inf, l = 0
    mx[h] = m_new;
    gold[h] += hit;
  }
}

// C = A (M x K) . B (K x ncols) over the CTA's units, 384 threads,
// kSmemBytes of dynamic shared memory; the outputs' rows are ncols apart.
template <typename T, int P>
__device__ __forceinline__ void ce_gemm(const CUtensorMap& a_map, const CUtensorMap& b_map,
                                        int K, int ncols, const Sched& s, const Epi<T>& e) {
  using Op = Operands<P>;
  extern __shared__ __align__(1024) unsigned char ce_smem_raw[];
  unsigned char* const smem =
      ce_smem_raw + ((1024 - (smem_u32(ce_smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kRing * kStage);
  uint64_t* const empty = full + kRing;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrive; the copies' bytes
      mbar_init(&empty[i], 2);  // one arrive from each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int ksteps = K / kTK;
  const int units = s.mt * s.chunks;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // the producer: one thread keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;  // K steps issued, over all of the CTA's tiles
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m, c;
        unit_of(s, u, m, c);
        const int t_end = min(s.nt, c * s.per + s.per);
        for (int t = c * s.per; t < t_end; ++t) {
          const int m0 = m * kTM, n0 = t * kTN;
          // 64-column B boxes (MN-major) or 128-row B boxes (K-major) that
          // lie inside the product: the half tile's others are not copied
          const int b_boxes = Op::B_MN ? min(4, (ncols - n0) / 64) : min(2, (ncols - n0) / 128);
          const int bytes = kStageA + b_boxes * (Op::B_MN ? kBox : 2 * kBox);
          for (int ks = 0; ks < ksteps; ++ks, ++it) {
            const int st = it % kRing;
            mbar_wait_or_trap(&empty[st], ((it / kRing) & 1) ^ 1);
            unsigned char* const sa = smem + st * kStage;
            unsigned char* const sb = sa + kStageA;
            const int k0 = ks * kTK;
            mbar_arrive_expect_tx(&full[st], bytes);
            if constexpr (Op::A_MN) {  // dlg (N, V): boxes of 64 v x 64 n
              tma_load_2d(sa, &a_map, m0, k0, &full[st]);
              tma_load_2d(sa + kBox, &a_map, m0 + 64, k0, &full[st]);
            } else {  // 128 rows x 64 k
              tma_load_2d(sa, &a_map, k0, m0, &full[st]);
            }
            for (int j = 0; j < b_boxes; ++j) {
              if constexpr (Op::B_MN) {  // 64 columns x 64 k rows
                tma_load_2d(sb + j * kBox, &b_map, n0 + 64 * j, k0, &full[st]);
              } else {  // 128 rows x 64 k
                tma_load_2d(sb + j * 2 * kBox, &b_map, k0, n0 + 128 * j, &full[st]);
              }
            }
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup g owns rows 64 g .. 64 g + 63 of each tile
    setmaxnreg_inc<kConsumerRegs>();
    const int g = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, q = lane % 4;
    const int row_in_tile = 64 * g + 16 * warp + lane / 4;  // and + 8
    float acc[128];
    int it = 0;  // K steps consumed
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int m, c;
      unit_of(s, u, m, c);
      const int r0 = m * kTM + row_in_tile;
      float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
      int lab[2] = {0, 0};
      if constexpr (P == kFwd) {
        lab[0] = e.labels[r0];
        lab[1] = e.labels[r0 + 8];
      }
      LabelTerms<T, P> terms;
      const int t_end = min(s.nt, c * s.per + s.per);
      for (int t = c * s.per; t < t_end; ++t) {
        const int n0 = t * kTN;
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int st = it % kRing;
          mbar_wait_or_trap(&full[st], (it / kRing) & 1);
          const unsigned char* const sa = smem + st * kStage + g * kBox;
          const unsigned char* const sb = smem + st * kStage + kStageA;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTK / 16; ++kk) {
            const uint64_t da = Op::A_MN ? wgmma_desc(sa + kk * 2048, 8192, 1024)
                                         : wgmma_desc(sa + kk * 32, 16, 1024);
            const uint64_t db = Op::B_MN ? wgmma_desc(sb + kk * 2048, 8192, 1024)
                                         : wgmma_desc(sb + kk * 32, 16, 1024);
            wgmma_m64n256k16<T, Op::A_MN, Op::B_MN>(acc, da, db);
          }
          wgmma_commit();
          fence_regs(acc);
          if constexpr (P != kFwd) {
            if (ks == 0 || ks == ksteps / 2) terms.at_step(e, ks, ksteps, r0, n0, ncols, q);
          }
          if (ks > 0) {
            // the previous step's products are done: release its stage
            wgmma_wait<1>();
            fence_regs(acc);
            if (tid == 0) mbar_arrive(&empty[(it - 1) % kRing]);
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (tid == 0) mbar_arrive(&empty[(it - 1) % kRing]);

        const int jv = min(kTN, ncols - n0) / 8;  // valid 8-column groups: 16 or 32
        if constexpr (P == kFwd) {
          const int lab_rel[2] = {lab[0] - n0, lab[1] - n0};
          fwd_tile_stats(acc, jv, q, lab_rel, mx, l, gold);
          if (e.out != nullptr) store_acc<T>(acc, e.out, (size_t)ncols, r0, n0, jv, q);
        } else {
          if constexpr (P == kDx) {
            terms.add(acc, e, n0, ncols, jv, q);
            store_acc<T>(acc, e.out, (size_t)ncols, r0, n0, jv, q);
          } else {
            const bool keep[2] = {terms.idx[0] < 0, terms.idx[1] < 0};
            store_acc<T>(acc, e.out, (size_t)ncols, r0, n0, jv, q, keep);
            terms.store_scratch(acc, e, n0, ncols, jv, q);
          }
        }
      }
      if constexpr (P == kFwd) {
        if (q == 0) {
          const size_t plane = (size_t)s.chunks * e.N;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t at = (size_t)c * e.N + r0 + 8 * h;
            e.part[at] = mx[h];
            e.part[plane + at] = l[h];
            e.part[2 * plane + at] = gold[h];
          }
        }
      }
    }
  }
}

// One kernel a product, so that each keeps its own name in a trace.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, int K, int ncols, Sched s,
                    Epi<T> e) {
  ce_gemm<T, kFwd>(a_map, b_map, K, ncols, s, e);
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
ce_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap b_map, int K, int ncols, Sched s,
                       Epi<T> e) {
  ce_gemm<T, kDx>(a_map, b_map, K, ncols, s, e);
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
ce_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap b_map, int K, int ncols, Sched s,
                       Epi<T> e) {
  ce_gemm<T, kDw>(a_map, b_map, K, ncols, s, e);
}

template <typename T, int P>
constexpr auto wgmma_kernel() {
  if constexpr (P == kFwd) {
    return ce_fwd_wgmma_kernel<T>;
  } else if constexpr (P == kDx) {
    return ce_bwd_dx_wgmma_kernel<T>;
  } else {
    return ce_bwd_dw_wgmma_kernel<T>;
  }
}

// The tensor map of a (rows, cols) 16-bit matrix, cols contiguous, in boxes
// of box_rows x 64 columns with the 128-byte swizzle.
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * sizeof(T)};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int P>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(wgmma_kernel<T, P>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

bool shape_ok(int N, int V, int H) {
  return N > 0 && V > 0 && H > 0 && N % 128 == 0 && V % 128 == 0 && H % 128 == 0 &&
         N / kBM <= kGridLimit && V / kBM <= kGridLimit;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

cudaError_t launch_fwd_fma(const float* x, const float* w, const int* labels, float* lg,
                           float* part, int N, int V, int H, int tpc, int chunks,
                           cudaStream_t stream) {
  ce_fwd_fma_kernel<<<dim3(N / kBM, chunks), kThreads, 0, stream>>>(x, w, labels, lg, part, N,
                                                                     V, H, tpc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_wgmma(const void* x, const void* w, const int* labels, void* lg,
                             float* part, int N, int V, int H, int tpc, int chunks, int ctas,
                             cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  cudaError_t err = tensor_map<T>(&a_map, x, N, H, 128);
  if (err == cudaSuccess) err = tensor_map<T>(&b_map, w, V, H, 128);
  if (err == cudaSuccess) err = allow_smem<T, kFwd>();
  if (err != cudaSuccess) return err;
  const Sched s{N / kTM, ceil_div(V, kTN), tpc, chunks, 0};
  const Epi<T> e{labels, nullptr, nullptr, nullptr, nullptr, static_cast<T*>(lg), part, N, V};
  ce_fwd_wgmma_kernel<T><<<ctas, kWgThreads, kSmemBytes, stream>>>(a_map, b_map, H, V, s, e);
  return cudaGetLastError();
}

// The rows of dW that labels name (16-bit; see dstt_fused_ce_bwd).
struct Rows {
  const int* order;
  const int* starts;
  const int* slot;
  const int* vlist;
  float* scratch;
};

template <typename T>
cudaError_t launch_bwd(const void* lg, const float* lse, const int* labels, const float* g,
                       const void* x, const void* w, void* dlg, void* dlab, const Rows& rows,
                       void* dx, void* dw, int N, int V, int H, int dx_ctas, int dw_ctas,
                       cudaStream_t stream) {
  constexpr bool kFma = std::is_same<T, float>::value;
  const size_t nvec = (size_t)N * V / (16 / sizeof(T));
  const int blocks = int(nvec / 256 + 1 < 132 * 16 ? nvec / 256 + 1 : 132 * 16);
  ce_dlogits_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(lg), lse, labels, g,
                                                   static_cast<T*>(dlg),
                                                   kFma ? nullptr : static_cast<T*>(dlab), N, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kFma) {
    ce_bwd_dx_fma_kernel<<<dim3(H / kBN, N / kBM), kThreads, 0, stream>>>(
        static_cast<const float*>(dlg), static_cast<const float*>(w), static_cast<float*>(dx), N,
        V, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ce_bwd_dw_fma_kernel<<<dim3(H / kBN, V / kBM), kThreads, 0, stream>>>(
        static_cast<const float*>(dlg), static_cast<const float*>(x), static_cast<float*>(dw), N,
        V, H);
    return cudaGetLastError();
  } else {
    const int ht = ceil_div(H, kTN);
    CUtensorMap a_map, b_map;
    // dX = dlg (N x V, K-major) . W (V x H, MN-major)
    err = tensor_map<T>(&a_map, dlg, N, V, 128);
    if (err == cudaSuccess) err = tensor_map<T>(&b_map, w, V, H, 64);
    if (err == cudaSuccess) err = allow_smem<T, kDx>();
    if (err != cudaSuccess) return err;
    const T* lab16 = static_cast<const T*>(dlab);
    const Epi<T> ex{labels, lab16, static_cast<const T*>(w), nullptr, nullptr,
                    static_cast<T*>(dx), nullptr, N, V};
    ce_bwd_dx_wgmma_kernel<T><<<dx_ctas, kWgThreads, kSmemBytes, stream>>>(
        a_map, b_map, V, H, Sched{N / kTM, ht, 1, ht, 0}, ex);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // dW = dlg^T (V x N, MN-major) . x (N x H, MN-major)
    err = tensor_map<T>(&a_map, dlg, N, V, 64);
    if (err == cudaSuccess) err = tensor_map<T>(&b_map, x, N, H, 64);
    if (err == cudaSuccess) err = allow_smem<T, kDw>();
    if (err != cudaSuccess) return err;
    const Epi<T> ew{labels, lab16, nullptr, rows.slot, rows.scratch, static_cast<T*>(dw), nullptr,
                    N, V};
    ce_bwd_dw_wgmma_kernel<T><<<dw_ctas, kWgThreads, kSmemBytes, stream>>>(
        a_map, b_map, N, H, Sched{V / kTM, ht, 1, ht, 1}, ew);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ce_dw_label_kernel<T><<<dim3(N < V ? N : V, ceil_div(H, 1024)), 256, 0, stream>>>(
        rows.scratch, rows.vlist, rows.order, rows.starts, lab16, static_cast<const T*>(x),
        static_cast<T*>(dw), H);
    return cudaGetLastError();
  }
}

template <typename T, int P>
cudaError_t wgmma_ctas_per_sm(int* n) {
  cudaError_t err = allow_smem<T, P>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, wgmma_kernel<T, P>(), kWgThreads,
                                                       kSmemBytes);
}

}  // namespace

// dtype (of x and W): 0 float32, 1 bfloat16, 2 float16. N, V and H
// multiples of 128 (the JAX gate's shapes). The plan (ops/transformer/
// fused_ce.py `plan`): tiles_per_chunk >= 1 vocab tiles a work unit takes
// (128 columns wide for float32, 256 for 16-bit), chunks =
// ceil(vocab tiles / tiles_per_chunk), ctas the 16-bit kernel's persistent
// CTAs (float32: unused; its grid is (N / 64, chunks)). lg: (N, V) in x's
// dtype, or null for no residual. part: (3, chunks, N) fp32 scratch. lse,
// nll: (N,) fp32. Returns cudaGetLastError() after the launches (0 =
// launched), or cudaErrorInvalidValue for arguments the kernels do not
// take. Launches on `stream`; does not synchronise.
extern "C" int dstt_fused_ce_fwd(const void* x, const void* w, const void* labels, void* lg,
                                 void* part, void* lse, void* nll, int dtype, int N, int V, int H,
                                 int tiles_per_chunk, int chunks, int ctas, void* stream) {
  const int tile_n = dtype == 0 ? kBN : kTN;
  if (!shape_ok(N, V, H) || tiles_per_chunk <= 0 || chunks > kGridLimit ||
      chunks != ceil_div(ceil_div(V, tile_n), tiles_per_chunk) ||
      (dtype != 0 && (ctas <= 0 || ctas > N / kTM * chunks))) {
    return (int)cudaErrorInvalidValue;
  }
  const int* lab = static_cast<const int*>(labels);
  float* p = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_fwd_fma(static_cast<const float*>(x), static_cast<const float*>(w), lab,
                           static_cast<float*>(lg), p, N, V, H, tiles_per_chunk, chunks, s);
      break;
    case 1:
      err = launch_fwd_wgmma<__nv_bfloat16>(x, w, lab, lg, p, N, V, H, tiles_per_chunk, chunks,
                                            ctas, s);
      break;
    case 2:
      err = launch_fwd_wgmma<__half>(x, w, lab, lg, p, N, V, H, tiles_per_chunk, chunks, ctas,
                                     s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(p, static_cast<float*>(lse),
                                                   static_cast<float*>(nll), N, chunks);
  return (int)cudaGetLastError();
}

// lg (N, V) in x's dtype, lse and g (N,) fp32, labels (N,) int32, x (N, H)
// and W (V, H) of one dtype; dlg (N, V) scratch in that dtype; dx (N, H) and
// dw (V, H) out in that dtype. 16-bit only (float32: unused, may be null):
// dlab (N,) scratch in that dtype; order, starts, slot and vlist from
// dstt_fused_ce_label_rows; scratch (min(N, V), H) fp32;
// dx_ctas, dw_ctas the dX and dW kernels' persistent CTAs. Launches the
// dlogits, dX and dW kernels in that order on `stream` (16-bit: then
// ce_dw_label_kernel); returns as dstt_fused_ce_fwd.
extern "C" int dstt_fused_ce_bwd(const void* lg, const void* lse, const void* labels,
                                 const void* g, const void* x, const void* w, void* dlg,
                                 void* dlab, const void* order, const void* starts,
                                 const void* slot, const void* vlist, void* scratch, void* dx,
                                 void* dw, int dtype, int N, int V, int H, int dx_ctas,
                                 int dw_ctas, void* stream) {
  const int ht = ceil_div(H, kTN);
  if (!shape_ok(N, V, H) ||
      (dtype != 0 && (dx_ctas <= 0 || dx_ctas > N / kTM * ht || dw_ctas <= 0 ||
                      dw_ctas > V / kTM * ht))) {
    return (int)cudaErrorInvalidValue;
  }
  const float* ls = static_cast<const float*>(lse);
  const int* lab = static_cast<const int*>(labels);
  const float* gg = static_cast<const float*>(g);
  const Rows rows{static_cast<const int*>(order), static_cast<const int*>(starts),
                  static_cast<const int*>(slot), static_cast<const int*>(vlist),
                  static_cast<float*>(scratch)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_bwd<float>(lg, ls, lab, gg, x, w, dlg, nullptr, rows, dx, dw, N, V, H, 0,
                                    0, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(lg, ls, lab, gg, x, w, dlg, dlab, rows, dx, dw, N, V,
                                            H, dx_ctas, dw_ctas, s);
    case 2:
      return (int)launch_bwd<__half>(lg, ls, lab, gg, x, w, dlg, dlab, rows, dx, dw, N, V, H,
                                     dx_ctas, dw_ctas, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The index of the label terms that dstt_fused_ce_bwd takes for 16-bit
// types (see ce_label_rows_kernel): labels (N,) int32; order (N,), starts
// (V + 1,), slot (V,), vlist (min(N, V),) int32 out; work (V + N,) int32
// scratch. Launches one kernel on `stream`; returns as dstt_fused_ce_fwd.
extern "C" int dstt_fused_ce_label_rows(const void* labels, int N, int V, void* order,
                                        void* starts, void* slot, void* vlist, void* work,
                                        void* stream) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  int* w = static_cast<int*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ce_label_rows_kernel<<<1, 1024, 0, s>>>(
      static_cast<const int*>(labels), N, V, static_cast<int*>(order), static_cast<int*>(starts),
      static_cast<int*>(slot), static_cast<int*>(vlist), w, w + V);
  return (int)cudaGetLastError();
}

// CTAs of `dtype`'s forward kernel (float32: ce_fwd_fma_kernel; 16-bit:
// ce_fwd_wgmma_kernel, whose shared memory and threads the dX and dW kernels
// share) resident on one SM at once, or minus the CUDA error.
extern "C" int dstt_fused_ce_ctas_per_sm(int dtype) {
  int n = 0;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ce_fwd_fma_kernel, kThreads, 0);
      break;
    case 1: {
      int nx = 0, nw = 0;
      err = wgmma_ctas_per_sm<__nv_bfloat16, kFwd>(&n);
      if (err == cudaSuccess) err = wgmma_ctas_per_sm<__nv_bfloat16, kDx>(&nx);
      if (err == cudaSuccess) err = wgmma_ctas_per_sm<__nv_bfloat16, kDw>(&nw);
      n = n < nx ? (n < nw ? n : nw) : (nx < nw ? nx : nw);
      break;
    }
    case 2: {
      int nx = 0, nw = 0;
      err = wgmma_ctas_per_sm<__half, kFwd>(&n);
      if (err == cudaSuccess) err = wgmma_ctas_per_sm<__half, kDx>(&nx);
      if (err == cudaSuccess) err = wgmma_ctas_per_sm<__half, kDw>(&nw);
      n = n < nx ? (n < nw ? n : nw) : (nx < nw ? nx : nw);
      break;
    }
    default: return -(int)cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" const char* dstt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
