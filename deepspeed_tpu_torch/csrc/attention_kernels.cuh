// The attention kernels shared by flash_attention.cu and
// block_sparse_attention.cu: a forward (online softmax), a dK/dV and a dQ
// kernel, each written once over a schedule that says which tiles a CTA
// visits. flash_attention.cu gives them the dense (causal) schedule,
// block_sparse_attention.cu the block lists of a sparsity layout. Each
// source includes this header once, into its own library.
//
// What they compute. q (B, Sq, nh, hd), k / v (B, Skv, kvh, hd) in the model's
// layout, read through strides (the last dimension contiguous); query head h
// attends with KV head h / g (g = nh / kvh). Forward: an online softmax over
// the visited key tiles, o (B, Sq, nh, hd) in q's dtype and lse = m + log l
// (B, nh, Sq) in fp32; a row that visits no key gets o = 0 and lse = m =
// -1e30, as the TPU kernels do (l taken as 1). Backward, given do and delta =
// sum(do * o) (B, nh, Sq): dq, dk, dv in q's dtype. Scores, softmax statistics
// and every product accumulate in fp32; p is rounded to v's dtype before P.V
// and dS to q's dtype before the dK and dQ products. Inside a visited tile a
// key is visible when kpos < Skv and, if causal, qpos >= kpos.
//
// What the design does. A CTA of four warps stages its tiles in shared memory
// and runs every tile product on the tensor cores (WMMA 16x16x16, bf16/fp16
// in, fp32 accumulate); fp32 inputs run the same code with FMAs, so the fp32
// checks hold at 1e-5. The backward is two kernels: a dK/dV kernel (one CTA
// per (b, kv head, key tile), looping over the group's g query heads and the
// query tiles that see the tile) writes dk and dv per KV head directly, and a
// dQ kernel (one CTA per (b, head, query tile)) writes dq. Both are
// deterministic: no atomics.
//
// A schedule is a struct passed by value to the kernels, with:
//   fwd_cta(s, BQ, b, h, q0)      the forward's and dQ's CTA: batch, head, first query row
//   key_tiles(s, h, q0, q_valid, BK)  how many key tiles that query tile visits
//   key_tile(s, h, q0, q_valid, j, BK)  the j-th one's first key, or -1 to skip it
//   kv_cta(s, BK, b, kh, k0)      the dK/dV CTA: batch, KV head, first key
//   query_tiles(s, h, k0, BQ)     how many query tiles of head h see key tile k0
//   query_tile(s, h, k0, i, BQ)   the i-th one's first row, or -1 to skip it
//   q_grid(s, BQ), kv_grid(s, BK)  (host) the grids of the forward and dQ kernels,
//                                  and of the dK/dV kernel, as the *_cta functions read them
// A skip is decided alike by every thread of the CTA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Finite, as the TPU kernels' NEG_INF.
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Tile sizes for one (dtype, head_dim). 16-bit types use the tensor cores and
// 64-row query tiles; fp32 uses FMAs and 32-row tiles, so that every kernel's
// shared memory stays under the 227 KB a block can have.
template <typename T, int HD>
struct Tiles {
  static constexpr bool kTensorCores = sizeof(T) == 2;
  static constexpr int BQ = kTensorCores ? 64 : 32;
  static constexpr int BK = (kTensorCores && HD <= 128) ? 64 : 32;
  static constexpr int PAD = int(16 / sizeof(T));  // 16 bytes per row against bank conflicts
  static constexpr int LDT = HD + PAD;             // (rows, HD) tiles in T: Q, K, V, dO
  static constexpr int LDA = HD + 4;               // (rows, HD) fp32 accumulators
  static constexpr int LDS = BK + 4;               // (BQ, BK) fp32 scores
  static constexpr int LDP = BK + PAD;             // (BQ, BK) probabilities or dS in T
  static constexpr size_t tile_t(int rows) { return align128(size_t(rows) * LDT * sizeof(T)); }
  static constexpr size_t acc(int rows) { return align128(size_t(rows) * LDA * sizeof(float)); }
  static constexpr size_t scores() { return align128(size_t(BQ) * LDS * sizeof(float)); }
  static constexpr size_t probs() { return align128(size_t(BQ) * LDP * sizeof(T)); }
  static constexpr size_t rowvec() { return align128(size_t(BQ) * sizeof(float)); }
};

// Shared-memory carve-ups (byte offsets), one per kernel, used by both the
// kernel and the launch so the two cannot disagree.
template <typename T, int HD>
struct FwdLayout {
  using Tl = Tiles<T, HD>;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + Tl::tile_t(Tl::BQ);
  static constexpr size_t v = k + Tl::tile_t(Tl::BK);
  static constexpr size_t s = v + Tl::tile_t(Tl::BK);
  static constexpr size_t p = s + Tl::scores();
  static constexpr size_t o = p + Tl::probs();
  static constexpr size_t m = o + Tl::acc(Tl::BQ);
  static constexpr size_t l = m + Tl::rowvec();
  static constexpr size_t alpha = l + Tl::rowvec();
  static constexpr size_t bytes = alpha + Tl::rowvec();
};

template <typename T, int HD>
struct DkdvLayout {
  using Tl = Tiles<T, HD>;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + Tl::tile_t(Tl::BK);
  static constexpr size_t q = v + Tl::tile_t(Tl::BK);
  static constexpr size_t dout = q + Tl::tile_t(Tl::BQ);
  static constexpr size_t dk = dout + Tl::tile_t(Tl::BQ);
  static constexpr size_t dv = dk + Tl::acc(Tl::BK);
  static constexpr size_t s = dv + Tl::acc(Tl::BK);
  static constexpr size_t dp = s + Tl::scores();
  static constexpr size_t p = dp + Tl::scores();
  static constexpr size_t lse = p + Tl::probs();
  static constexpr size_t delta = lse + Tl::rowvec();
  static constexpr size_t bytes = delta + Tl::rowvec();
};

template <typename T, int HD>
struct DqLayout {
  using Tl = Tiles<T, HD>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + Tl::tile_t(Tl::BQ);
  static constexpr size_t k = dout + Tl::tile_t(Tl::BQ);
  static constexpr size_t v = k + Tl::tile_t(Tl::BK);
  static constexpr size_t dq = v + Tl::tile_t(Tl::BK);
  static constexpr size_t s = dq + Tl::acc(Tl::BQ);
  static constexpr size_t dp = s + Tl::scores();
  static constexpr size_t p = dp + Tl::scores();
  static constexpr size_t lse = p + Tl::probs();
  static constexpr size_t delta = lse + Tl::rowvec();
  static constexpr size_t bytes = delta + Tl::rowvec();
};

constexpr size_t kMaxSmem = 232448;  // what one block may use on an H100

struct Shape {
  int B, Sq, Skv, nh, kvh, g, causal;
  float scale;
  // strides in elements of the (B, S, heads, hd) inputs: batch, sequence, head
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
};

__device__ __forceinline__ bool visible(const Shape& s, int qpos, int kpos) {
  return qpos < s.Sq && kpos < s.Skv && (!s.causal || qpos >= kpos);
}

// Rows [0, R) of a (rows, HD) tile into shared memory (leading dimension ld),
// row r read at src + r * row_stride in 16-byte vectors; rows >= valid are zeros.
template <typename T, int HD, int R>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long row_stride,
                                          int valid) {
  constexpr int VEC = int(16 / sizeof(T));
  constexpr int CPR = HD / VEC;
  for (int idx = threadIdx.x; idx < R * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * VEC;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// Block-wide tile product into an fp32 shared-memory tile:
//   C (M, N) = (acc ? C : 0) + op(A) op(B), with
//   NT: A (M, K) and B (N, K), both row-major: A B^T
//   NN: A (M, K), B (K, N):                    A B
//   TN: A (K, M), B (K, N):                    A^T B
// 16-bit operands go through WMMA, one 16x16 output tile per warp at a time;
// fp32 operands through FMAs, one output element per thread at a time.
enum Kind { NT, NN, TN };

template <Kind KIND, int M, int N, int K, typename T>
__device__ __forceinline__ void block_mm(float* C, int ldc, const T* A, int lda, const T* B,
                                         int ldb, bool acc) {
  if constexpr (sizeof(T) == 2) {
    using LayoutA = std::conditional_t<KIND == TN, wmma::col_major, wmma::row_major>;
    using LayoutB = std::conditional_t<KIND == NT, wmma::col_major, wmma::row_major>;
    constexpr int TILES_N = N / 16;
    static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "WMMA tiles are 16x16x16");
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * TILES_N; t += kWarps) {
      const int m0 = (t / TILES_N) * 16;
      const int n0 = (t % TILES_N) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (acc) {
        wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
#pragma unroll 4
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LayoutA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LayoutB> b;
        wmma::load_matrix_sync(a, KIND == TN ? A + k0 * lda + m0 : A + m0 * lda + k0, lda);
        wmma::load_matrix_sync(b, KIND == NT ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N;
      const int n = idx % N;
      float s = acc ? C[m * ldc + n] : 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float a = to_float(KIND == TN ? A[k * lda + m] : A[m * lda + k]);
        const float b = to_float(KIND == NT ? B[n * ldb + k] : B[k * ldb + n]);
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = s;
    }
  }
}

template <typename T, int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, Shape s, Sched sched) {
  using Tl = Tiles<T, HD>;
  using L = FwdLayout<T, HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(128) char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  T* sP = reinterpret_cast<T*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = reinterpret_cast<float*>(smem + L::l);
  float* sAlpha = reinterpret_cast<float*>(smem + L::alpha);

  int b, h, q0;
  sched.fwd_cta(s, BQ, b, h, q0);
  const int kh = h / s.g;
  const int q_valid = min(BQ, s.Sq - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile<T, HD, BQ>(sQ, Tl::LDT, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss,
                       q_valid);
  for (int i = threadIdx.x; i < BQ * Tl::LDA; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  const T* kb = k + b * s.k_sb + kh * s.k_sh;
  const T* vb = v + b * s.v_sb + kh * s.v_sh;
  const int nkt = sched.key_tiles(s, h, q0, q_valid, BK);
  for (int j = 0; j < nkt; ++j) {
    const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
    if (k0 < 0) continue;
    const int k_valid = min(BK, s.Skv - k0);
    __syncthreads();  // the previous tile's products are done with sK, sV, sP
    load_tile<T, HD, BK>(sK, Tl::LDT, kb + k0 * s.k_ss, s.k_ss, k_valid);
    load_tile<T, HD, BK>(sV, Tl::LDT, vb + k0 * s.v_ss, s.v_ss, k_valid);
    __syncthreads();
    block_mm<NT, BQ, BK, HD>(sS, Tl::LDS, sQ, Tl::LDT, sK, Tl::LDT, false);  // S = Q K^T
    __syncthreads();
    // online softmax: one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = q0 + r;
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) {
        const float x = visible(s, qpos, k0 + c) ? sS[r * Tl::LDS + c] * s.scale : kNegInf;
        sS[r * Tl::LDS + c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float pr = visible(s, qpos, k0 + c) ? expf(sS[r * Tl::LDS + c] - m_new) : 0.f;
        sum += pr;
        sP[r * Tl::LDP + c] = from_float<T>(pr);  // rounded to v's dtype before P.V
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * HD; i += kThreads) {
      const int r = i / HD;
      sO[r * Tl::LDA + i % HD] *= sAlpha[r];
    }
    __syncthreads();
    block_mm<NN, BQ, HD, BK>(sO, Tl::LDA, sP, Tl::LDP, sV, Tl::LDT, true);  // O += P V
  }
  __syncthreads();
  T* ob = o + ((size_t(b) * s.Sq + q0) * s.nh + h) * HD;
  for (int i = threadIdx.x; i < q_valid * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    const float l = sL[r];
    ob[size_t(r) * s.nh * HD + c] = from_float<T>(sO[r * Tl::LDA + c] / (l == 0.f ? 1.f : l));
  }
  float* lb = lse + (size_t(b) * s.nh + h) * s.Sq + q0;
  for (int r = threadIdx.x; r < q_valid; r += kThreads) {
    const float l = sL[r];
    lb[r] = sM[r] + logf(l == 0.f ? 1.f : l);
  }
}

// The lse and delta rows of one query tile; rows past Sq read as 0 (they see
// no key, so their p is 0 whatever these hold).
__device__ __forceinline__ void load_rows(float* dst, const float* src, int valid, int BQ) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) dst[r] = r < valid ? src[r] : 0.f;
}

template <typename T, int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Shape s, Sched sched) {
  using Tl = Tiles<T, HD>;
  using L = DkdvLayout<T, HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(128) char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::dout);
  float* sDK = reinterpret_cast<float*>(smem + L::dk);
  float* sDV = reinterpret_cast<float*>(smem + L::dv);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  T* sP = reinterpret_cast<T*>(smem + L::p);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  int b, kh, k0;
  sched.kv_cta(s, BK, b, kh, k0);
  const int k_valid = min(BK, s.Skv - k0);
  load_tile<T, HD, BK>(sK, Tl::LDT, k + b * s.k_sb + k0 * s.k_ss + kh * s.k_sh, s.k_ss, k_valid);
  load_tile<T, HD, BK>(sV, Tl::LDT, v + b * s.v_sb + k0 * s.v_ss + kh * s.v_sh, s.v_ss, k_valid);
  for (int i = threadIdx.x; i < BK * Tl::LDA; i += kThreads) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  for (int gi = 0; gi < s.g; ++gi) {
    const int h = kh * s.g + gi;
    const int nqt = sched.query_tiles(s, h, k0, BQ);
    for (int i = 0; i < nqt; ++i) {
      const int q0 = sched.query_tile(s, h, k0, i, BQ);
      if (q0 < 0) continue;
      const int q_valid = min(BQ, s.Sq - q0);
      __syncthreads();  // the previous tile's products are done with sQ, sDO, sP
      load_tile<T, HD, BQ>(sQ, Tl::LDT, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss,
                           q_valid);
      load_tile<T, HD, BQ>(sDO, Tl::LDT, dout + b * s.d_sb + q0 * s.d_ss + h * s.d_sh, s.d_ss,
                           q_valid);
      const size_t row0 = (size_t(b) * s.nh + h) * s.Sq + q0;
      load_rows(sLse, lse + row0, q_valid, BQ);
      load_rows(sDelta, delta + row0, q_valid, BQ);
      __syncthreads();
      block_mm<NT, BQ, BK, HD>(sS, Tl::LDS, sQ, Tl::LDT, sK, Tl::LDT, false);   // S = Q K^T
      block_mm<NT, BQ, BK, HD>(sDP, Tl::LDS, sDO, Tl::LDT, sV, Tl::LDT, false);  // dP = dO V^T
      __syncthreads();
      for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
        const int r = idx / BK;
        const int c = idx % BK;
        const float pr = visible(s, q0 + r, k0 + c)
                             ? expf(sS[r * Tl::LDS + c] * s.scale - sLse[r]) : 0.f;
        sS[r * Tl::LDS + c] = pr;
        sP[r * Tl::LDP + c] = from_float<T>(pr);
      }
      __syncthreads();
      block_mm<TN, BK, HD, BQ>(sDV, Tl::LDA, sP, Tl::LDP, sDO, Tl::LDT, true);  // dV += P^T dO
      __syncthreads();
      for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
        const int r = idx / BK;
        const int c = idx % BK;
        const float ds = sS[r * Tl::LDS + c] * (sDP[r * Tl::LDS + c] - sDelta[r]) * s.scale;
        sP[r * Tl::LDP + c] = from_float<T>(ds);  // rounded to q's dtype before dS^T Q
      }
      __syncthreads();
      block_mm<TN, BK, HD, BQ>(sDK, Tl::LDA, sP, Tl::LDP, sQ, Tl::LDT, true);  // dK += dS^T Q
    }
  }
  __syncthreads();
  const size_t out0 = ((size_t(b) * s.Skv + k0) * s.kvh + kh) * HD;
  for (int i = threadIdx.x; i < k_valid * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    const size_t off = out0 + size_t(r) * s.kvh * HD + c;
    dk[off] = from_float<T>(sDK[r * Tl::LDA + c]);
    dv[off] = from_float<T>(sDV[r * Tl::LDA + c]);
  }
}

template <typename T, int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, Shape s, Sched sched) {
  using Tl = Tiles<T, HD>;
  using L = DqLayout<T, HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(128) char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::dout);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sDQ = reinterpret_cast<float*>(smem + L::dq);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  T* sP = reinterpret_cast<T*>(smem + L::p);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  int b, h, q0;
  sched.fwd_cta(s, BQ, b, h, q0);
  const int kh = h / s.g;
  const int q_valid = min(BQ, s.Sq - q0);
  load_tile<T, HD, BQ>(sQ, Tl::LDT, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss, q_valid);
  load_tile<T, HD, BQ>(sDO, Tl::LDT, dout + b * s.d_sb + q0 * s.d_ss + h * s.d_sh, s.d_ss,
                       q_valid);
  const size_t row0 = (size_t(b) * s.nh + h) * s.Sq + q0;
  load_rows(sLse, lse + row0, q_valid, BQ);
  load_rows(sDelta, delta + row0, q_valid, BQ);
  for (int i = threadIdx.x; i < BQ * Tl::LDA; i += kThreads) sDQ[i] = 0.f;
  const T* kb = k + b * s.k_sb + kh * s.k_sh;
  const T* vb = v + b * s.v_sb + kh * s.v_sh;
  const int nkt = sched.key_tiles(s, h, q0, q_valid, BK);
  for (int j = 0; j < nkt; ++j) {
    const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
    if (k0 < 0) continue;
    const int k_valid = min(BK, s.Skv - k0);
    __syncthreads();  // the previous tile's products are done with sK, sV, sP
    load_tile<T, HD, BK>(sK, Tl::LDT, kb + k0 * s.k_ss, s.k_ss, k_valid);
    load_tile<T, HD, BK>(sV, Tl::LDT, vb + k0 * s.v_ss, s.v_ss, k_valid);
    __syncthreads();
    block_mm<NT, BQ, BK, HD>(sS, Tl::LDS, sQ, Tl::LDT, sK, Tl::LDT, false);   // S = Q K^T
    block_mm<NT, BQ, BK, HD>(sDP, Tl::LDS, sDO, Tl::LDT, sV, Tl::LDT, false);  // dP = dO V^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
      const int r = idx / BK;
      const int c = idx % BK;
      const float pr = visible(s, q0 + r, k0 + c)
                           ? expf(sS[r * Tl::LDS + c] * s.scale - sLse[r]) : 0.f;
      const float ds = pr * (sDP[r * Tl::LDS + c] - sDelta[r]) * s.scale;
      sP[r * Tl::LDP + c] = from_float<T>(ds);  // rounded to q's dtype before dS K
    }
    __syncthreads();
    block_mm<NN, BQ, HD, BK>(sDQ, Tl::LDA, sP, Tl::LDP, sK, Tl::LDT, true);  // dQ += dS K
  }
  __syncthreads();
  T* qb = dq + ((size_t(b) * s.Sq + q0) * s.nh + h) * HD;
  for (int i = threadIdx.x; i < q_valid * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    qb[size_t(r) * s.nh * HD + c] = from_float<T>(sDQ[r * Tl::LDA + c]);
  }
}

// The launches over any schedule: the forward, or the dK/dV then the dQ kernel.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse;
  const void* delta;
  void* o;    // forward: o; backward: dq
  void* lse_out;
  void* dk;
  void* dv;
  Shape s;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, int HD, typename Sched>
cudaError_t run_fwd(const Args& a, const Sched& sched) {
  using Tl = Tiles<T, HD>;
  using L = FwdLayout<T, HD>;
  static_assert(L::bytes <= kMaxSmem, "forward tiles exceed shared memory");
  cudaError_t e = allow_smem(attn_fwd_kernel<T, HD, Sched>, L::bytes);
  if (e != cudaSuccess) return e;
  attn_fwd_kernel<T, HD, Sched><<<sched.q_grid(a.s, Tl::BQ), kThreads, L::bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<float*>(a.lse_out), a.s, sched);
  return cudaGetLastError();
}

template <typename T, int HD, typename Sched>
cudaError_t run_bwd(const Args& a, const Sched& sched) {
  using Tl = Tiles<T, HD>;
  using L1 = DkdvLayout<T, HD>;
  using L2 = DqLayout<T, HD>;
  static_assert(L1::bytes <= kMaxSmem && L2::bytes <= kMaxSmem,
                "backward tiles exceed shared memory");
  cudaError_t e = allow_smem(attn_bwd_dkdv_kernel<T, HD, Sched>, L1::bytes);
  if (e != cudaSuccess) return e;
  e = allow_smem(attn_bwd_dq_kernel<T, HD, Sched>, L2::bytes);
  if (e != cudaSuccess) return e;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  attn_bwd_dkdv_kernel<T, HD, Sched><<<sched.kv_grid(a.s, Tl::BK), kThreads, L1::bytes,
                                       a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, sched);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<T, HD, Sched><<<sched.q_grid(a.s, Tl::BQ), kThreads, L2::bytes,
                                     a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.o), a.s, sched);
  return cudaGetLastError();
}

template <typename T, typename Sched>
cudaError_t dispatch_head_dim(int head_dim, bool backward, const Args& a, const Sched& sched) {
  switch (head_dim) {
    case 64: return backward ? run_bwd<T, 64>(a, sched) : run_fwd<T, 64>(a, sched);
    case 128: return backward ? run_bwd<T, 128>(a, sched) : run_fwd<T, 128>(a, sched);
    case 256: return backward ? run_bwd<T, 256>(a, sched) : run_fwd<T, 256>(a, sched);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16.
template <typename Sched>
cudaError_t dispatch(int dtype, int head_dim, bool backward, const Args& a, const Sched& sched) {
  switch (dtype) {
    case 0: return dispatch_head_dim<float>(head_dim, backward, a, sched);
    case 1: return dispatch_head_dim<__nv_bfloat16>(head_dim, backward, a, sched);
    case 2: return dispatch_head_dim<__half>(head_dim, backward, a, sched);
    default: return cudaErrorInvalidValue;
  }
}

bool make_shape(Shape* s, int batch, int seq_q, int seq_kv, int num_heads, int kv_heads,
                int causal, float scale, const long long* strides) {
  if (batch <= 0 || batch > 65535 || seq_q <= 0 || seq_kv <= 0 || kv_heads <= 0 ||
      num_heads <= 0 || num_heads > 65535 || num_heads % kv_heads != 0) {
    return false;
  }
  *s = Shape{batch, seq_q, seq_kv, num_heads, kv_heads, num_heads / kv_heads, causal ? 1 : 0,
             scale, strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  return true;
}

}  // namespace

extern "C" const char* dstt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
