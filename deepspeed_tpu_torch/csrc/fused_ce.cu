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
// What the design does about it. Every product runs on the tensor cores
// for 16-bit types (WMMA 16x16x16, fp32 accumulators held in register
// fragments through the whole K loop) and with fp32 FMAs from an 8 x 4
// register tile a thread for fp32 (no TF32). One GEMM main loop serves the
// three products: a CTA of 8 warps owns a 64 x 128 output tile and walks K
// in steps of 64 bytes a row, with the next step's x / W / dlg tiles copied
// into shared memory by cp.async while the current one is multiplied (two
// stages). The fp32 tile then passes through shared memory once, for the
// epilogue. No kernel uses atomics and every sum runs in a fixed order, so
// forward and backward repeat bitwise.
// - `ce_fwd_kernel`: a CTA per (64-row tile, chunk of whole 128-column
//   vocab tiles). The TPU grid walks the vocab axis in order on one core,
//   carrying (m, l, gold) in VMEM; here the vocab is cut into chunks so that
//   the 64-row tiles alone (64 at N 4096) do not leave the 132 SMs short.
//   The wrapper sizes the chunks from the kernel's residency on the card
//   (dstt_fused_ce_fwd_ctas_per_sm) so that the CTAs fill whole waves; each
//   CTA carries the running (m, l, gold) of its rows over its chunk's
//   tiles in registers (4 threads a row) and writes one fp32 partial per
//   (row, chunk).
// - `ce_combine_kernel` merges each row's chunks in chunk order and writes
//   lse and nll.
// - `ce_dlogits_kernel`: dlg in one elementwise pass, 16-byte loads and
//   stores, into a scratch buffer the size of the residual.
// - `ce_bwd_dx_kernel`: a CTA per (64-row tile, 128-column tile of H), K =
//   V in order.
// - `ce_bwd_dw_kernel`: a CTA per (64-row tile of V, 128-column tile of H),
//   K = all N rows in order: no partials, no atomics.
//
// Left for later: dlg formed inside the two backward GEMMs' operand loads
// (no dlg buffer, one pass over lg fewer), and wgmma fed by TMA rings with
// a persistent, warp-specialised schedule, which the tensor-core bound
// needs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 64, kBN = 128;     // output tile of every GEMM
constexpr int kLDC = kBN + 4;          // fp32 tile in shared memory, row stride
constexpr int kStages = 2;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a ROWS x COLS tile (COLS contiguous in device memory, rows `ld`
// elements apart) into shared memory with rows COLS + 16 bytes apart (the
// pad keeps the tensor-core loads off one bank), 16 bytes a thread.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile_async(T* __restrict__ smem, const T* __restrict__ gmem,
                                                size_t ld) {
  constexpr int VEC = 16 / int(sizeof(T));
  constexpr int PER_ROW = COLS / VEC;
  constexpr int SLD = COLS + VEC;
  for (int c = threadIdx.x; c < ROWS * PER_ROW; c += kThreads) {
    const int r = c / PER_ROW, v = (c % PER_ROW) * VEC;
    cp_async16(smem + r * SLD + v, gmem + r * ld + v);
  }
}

// C (64 x 128, fp32) = A (64 x K) . B (K x 128), K a multiple of BK.
// A_KMAJOR: A's element (m, k) at a[m * lda + k], else at a[k * lda + m];
// B_KMAJOR: B's element (k, n) at b[n * ldb + k], else at b[k * ldb + n].
// `run` leaves C in shared memory as a [64][kLDC] fp32 tile (aliasing the
// operand stages) and returns after a barrier.
template <typename T, bool A_KMAJOR, bool B_KMAJOR>
struct Gemm {
  static constexpr bool kTensorCores = sizeof(T) == 2;
  static constexpr int BK = 64 / int(sizeof(T));  // 64 bytes of K a row: 32 (16-bit) or 16 (fp32)
  static constexpr int PAD = 16 / int(sizeof(T));
  static constexpr int A_LD = A_KMAJOR ? BK + PAD : kBM + PAD;
  static constexpr int B_LD = B_KMAJOR ? BK + PAD : kBN + PAD;
  static constexpr int A_ELEMS = A_KMAJOR ? kBM * A_LD : BK * A_LD;
  static constexpr int B_ELEMS = B_KMAJOR ? kBN * B_LD : BK * B_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int OPERAND_BYTES = kStages * STAGE_ELEMS * int(sizeof(T));
  static constexpr int C_BYTES = kBM * kLDC * 4;
  static constexpr int SMEM_BYTES = OPERAND_BYTES > C_BYTES ? OPERAND_BYTES : C_BYTES;
  static_assert((A_ELEMS * sizeof(T)) % 128 == 0 && (STAGE_ELEMS * sizeof(T)) % 128 == 0,
                "stages must keep 128-byte alignment");

  using ALayout = typename std::conditional<A_KMAJOR, wmma::row_major, wmma::col_major>::type;
  using BLayout = typename std::conditional<B_KMAJOR, wmma::col_major, wmma::row_major>::type;

  static __device__ __forceinline__ void load_stage(T* stage, const T* a, size_t lda,
                                                    const T* b, size_t ldb, int k0) {
    if constexpr (A_KMAJOR) {
      load_tile_async<T, kBM, BK>(stage, a + k0, lda);
    } else {
      load_tile_async<T, BK, kBM>(stage, a + (size_t)k0 * lda, lda);
    }
    if constexpr (B_KMAJOR) {
      load_tile_async<T, kBN, BK>(stage + A_ELEMS, b + k0, ldb);
    } else {
      load_tile_async<T, BK, kBN>(stage + A_ELEMS, b + (size_t)k0 * ldb, ldb);
    }
  }

  // shared-memory element (m, k) of A and (k, n) of B within a stage
  static __device__ __forceinline__ int a_at(int m, int k) {
    return A_KMAJOR ? m * A_LD + k : k * A_LD + m;
  }
  static __device__ __forceinline__ int b_at(int k, int n) {
    return A_ELEMS + (B_KMAJOR ? n * B_LD + k : k * B_LD + n);
  }

  static __device__ void run(unsigned char* smem_raw, const T* __restrict__ a, size_t lda,
                             const T* __restrict__ b, size_t ldb, int K) {
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int warp = threadIdx.x / 32;
    // tensor cores: warp (wm, wn) owns a 32 x 32 block as 2 x 2 fragments;
    // FMAs: thread owns rows tr * 8 .. tr * 8 + 7, columns tc + 32 j
    const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
    const int tr = threadIdx.x / 32, tc = threadIdx.x % 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag[2][2];
    float acc[8][4];
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
      const T* st = smem + (t % kStages) * STAGE_ELEMS;
      if constexpr (kTensorCores) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], st + a_at(wm + 16 * i, kk), A_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(fb[j], st + b_at(kk, wn + 16 * j), B_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(frag[i][j], fa[i], fb[j], frag[i][j]);
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float av[8], bv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) av[i] = to_float(st[a_at(tr * 8 + i, kk)]);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = to_float(st[b_at(kk, tc + 32 * j)]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();  // every warp is done with this stage before it is refilled
    }
    cp_async_wait<0>();

    float* sC = reinterpret_cast<float*>(smem_raw);
    if constexpr (kTensorCores) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(sC + (wm + 16 * i) * kLDC + wn + 16 * j, frag[i][j], kLDC,
                                  wmma::mem_row_major);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sC[(tr * 8 + i) * kLDC + tc + 32 * j] = acc[i][j];
    }
    __syncthreads();
  }
};

// Write the fp32 tile in shared memory to dst (64 x 128, rows `ld` apart),
// rounded to T, 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, size_t ld,
                                           const float* __restrict__ sC) {
  constexpr int VEC = 16 / int(sizeof(T));
  constexpr int PER_ROW = kBN / VEC;
  for (int c = threadIdx.x; c < kBM * PER_ROW; c += kThreads) {
    const int r = c / PER_ROW, cc = (c % PER_ROW) * VEC;
    alignas(16) T v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = from_float<T>(sC[r * kLDC + cc + e]);
    *reinterpret_cast<uint4*>(dst + r * ld + cc) = *reinterpret_cast<const uint4*>(v);
  }
}

// Grid (N / 64, chunks). Chunk c takes vocab tiles [c * tpc, min(V / 128,
// c * tpc + tpc)). The row tiles vary fastest, so the CTAs resident at once
// work on a few vocab tiles, each read from device memory about once and by
// every row tile from L2 (x, 33.5 MB at llama-7b's head, stays there). part
// is (3, chunks, N) fp32: m, l, gold of each row over the chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ labels,
              T* __restrict__ lg, float* __restrict__ part, int N, int V, int H, int tpc) {
  using G = Gemm<T, true, true>;
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
    if (lg != nullptr) store_tile<T>(lg + (size_t)m0 * V + n0, V, sC);
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
template <typename T>
__global__ void __launch_bounds__(256)
ce_dlogits_kernel(const T* __restrict__ lg, const float* __restrict__ lse,
                  const int* __restrict__ labels, const float* __restrict__ g,
                  T* __restrict__ dlg, int N, int V) {
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
    }
    *reinterpret_cast<uint4*>(dlg + e0) = *reinterpret_cast<const uint4*>(out);
  }
}

// Grid (H / 128, N / 64): dx = dlg (N, V) @ W (V, H), K = V in order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_dx_kernel(const T* __restrict__ dlg, const T* __restrict__ w, T* __restrict__ dx, int N,
                 int V, int H) {
  using G = Gemm<T, true, false>;
  __shared__ __align__(128) unsigned char smem[G::SMEM_BYTES];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  G::run(smem, dlg + (size_t)m0 * V, V, w + n0, H, V);
  store_tile<T>(dx + (size_t)m0 * H + n0, H, reinterpret_cast<const float*>(smem));
}

// Grid (H / 128, V / 64): dw = dlg^T (V, N) @ x (N, H), K = all N rows in order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ce_bwd_dw_kernel(const T* __restrict__ dlg, const T* __restrict__ x, T* __restrict__ dw, int N,
                 int V, int H) {
  using G = Gemm<T, false, false>;
  __shared__ __align__(128) unsigned char smem[G::SMEM_BYTES];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  G::run(smem, dlg + m0, V, x + n0, H, N);
  store_tile<T>(dw + (size_t)m0 * H + n0, H, reinterpret_cast<const float*>(smem));
}

bool shape_ok(int N, int V, int H) {
  return N > 0 && V > 0 && H > 0 && N % 128 == 0 && V % 128 == 0 && H % 128 == 0 &&
         N / kBM <= kGridLimit && V / kBM <= kGridLimit;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const int* labels, void* lg, float* part,
                       float* lse, float* nll, int N, int V, int H, int tpc,
                       cudaStream_t stream) {
  const int chunks = (V / kBN + tpc - 1) / tpc;
  ce_fwd_kernel<T><<<dim3(N / kBM, chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, static_cast<T*>(lg), part, N,
      V, H, tpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, lse, nll, N, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* lg, const float* lse, const int* labels, const float* g,
                       const void* x, const void* w, void* dlg, void* dx, void* dw, int N, int V,
                       int H, cudaStream_t stream) {
  const size_t nvec = (size_t)N * V / (16 / sizeof(T));
  const int blocks = int(nvec / 256 + 1 < 132 * 16 ? nvec / 256 + 1 : 132 * 16);
  ce_dlogits_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(lg), lse, labels, g,
                                                   static_cast<T*>(dlg), N, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_bwd_dx_kernel<T><<<dim3(H / kBN, N / kBM), kThreads, 0, stream>>>(
      static_cast<const T*>(dlg), static_cast<const T*>(w), static_cast<T*>(dx), N, V, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_bwd_dw_kernel<T><<<dim3(H / kBN, V / kBM), kThreads, 0, stream>>>(
      static_cast<const T*>(dlg), static_cast<const T*>(x), static_cast<T*>(dw), N, V, H);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x and W): 0 float32, 1 bfloat16, 2 float16. N, V and H
// multiples of 128 (the JAX gate's shapes); tiles_per_chunk >= 1 vocab
// tiles of 128 a forward CTA takes. lg: (N, V) in x's dtype, or null for
// no residual. part: (3, ceil(V / 128 / tiles_per_chunk), N) fp32 scratch.
// lse, nll: (N,) fp32. Returns cudaGetLastError() after the launches (0 =
// launched), or cudaErrorInvalidValue for arguments the kernels do not
// take. Launches on `stream`; does not synchronise.
extern "C" int dstt_fused_ce_fwd(const void* x, const void* w, const void* labels, void* lg,
                                 void* part, void* lse, void* nll, int dtype, int N, int V, int H,
                                 int tiles_per_chunk, void* stream) {
  if (!shape_ok(N, V, H) || tiles_per_chunk <= 0 ||
      (V / kBN + tiles_per_chunk - 1) / tiles_per_chunk > kGridLimit) {
    return (int)cudaErrorInvalidValue;
  }
  const int* lab = static_cast<const int*>(labels);
  float* p = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  float* nl = static_cast<float*>(nll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(x, w, lab, lg, p, ls, nl, N, V, H, tiles_per_chunk, s);
    case 1:
      return (int)launch_fwd<__nv_bfloat16>(x, w, lab, lg, p, ls, nl, N, V, H, tiles_per_chunk,
                                            s);
    case 2: return (int)launch_fwd<__half>(x, w, lab, lg, p, ls, nl, N, V, H, tiles_per_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// lg (N, V) in x's dtype, lse and g (N,) fp32, labels (N,) int32, x (N, H)
// and W (V, H) of one dtype; dlg (N, V) scratch in that dtype; dx (N, H) and
// dw (V, H) out in that dtype. Launches the dlogits, dX and dW kernels in
// that order on `stream`; returns as dstt_fused_ce_fwd.
extern "C" int dstt_fused_ce_bwd(const void* lg, const void* lse, const void* labels,
                                 const void* g, const void* x, const void* w, void* dlg, void* dx,
                                 void* dw, int dtype, int N, int V, int H, void* stream) {
  if (!shape_ok(N, V, H)) return (int)cudaErrorInvalidValue;
  const float* ls = static_cast<const float*>(lse);
  const int* lab = static_cast<const int*>(labels);
  const float* gg = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(lg, ls, lab, gg, x, w, dlg, dx, dw, N, V, H, s);
    case 1: return (int)launch_bwd<__nv_bfloat16>(lg, ls, lab, gg, x, w, dlg, dx, dw, N, V, H, s);
    case 2: return (int)launch_bwd<__half>(lg, ls, lab, gg, x, w, dlg, dx, dw, N, V, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Forward CTAs of `dtype` resident on one SM at once (their registers and
// shared memory allow that many), or minus the CUDA error.
extern "C" int dstt_fused_ce_fwd_ctas_per_sm(int dtype) {
  int n = 0;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ce_fwd_kernel<float>, kThreads, 0);
      break;
    case 1:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ce_fwd_kernel<__nv_bfloat16>,
                                                          kThreads, 0);
      break;
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ce_fwd_kernel<__half>, kThreads, 0);
      break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" const char* dstt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
