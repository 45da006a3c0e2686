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
// and dS to q's dtype before the dK and dQ products; l sums the unrounded p.
// Inside a visited tile a key is visible when kpos < Skv and, if causal,
// qpos + off >= kpos. head_dim is 32, 64, 128 or 256.
//
// The forward also serves the slot engine, under a schedule for which
// RowOffsets (below) holds (flash_attention.cu's SlotSched), which carries
// two (B,) device arrays: one causal offset a batch row (query qpos of row b
// sees keys <= qpos + off[b]: a segment written at position off[b] of its
// cache), and, or null, the batch row of k and v that row b reads (it picks
// K/V's batch stride alone, never q's, o's or lse's), so a group of slots
// attends to a whole slot cache in place. Its key_tiles ends a row's key
// loop at the shifted diagonal, so a short segment at a small offset walks
// its own keys, not the cache's, and a warp whose rows all lie past Sq (a
// decode call's Sq = 1) skips every tile. Every other schedule compiles to
// the code it had before (off 0, row b): with the two arrays in Shape and
// read at run time the dense forward took 0.407 ms against 0.350 and the
// backward 1.61 against 1.52 (chip_ab.py, PERF.md section 6).
//
// The design for bf16 and fp16 (the `Mma` kernels below). Every tile product
// is an inline-PTX mma.sync.m16n8k16 (16-bit in, fp32 accumulate) fed by
// ldmatrix (.trans where the operand lies the other way: V in P.V, dO and Q
// in the dV and dK products, K in dS.K). A warp owns its rows for the whole
// loop, so its scores, its running (m, l) and its accumulator stay in
// registers, in the mma's C-fragment layout, and P and dS go from the C
// fragments of one product into the A fragments of the next (rounded to
// 16 bits there) without touching shared memory. A CTA has 4 warps.
//   - forward: a warp owns 16 query rows, or two 16-row m-tiles where the
//     schedule sets FwdWarpTiles to 2 (the dense one, at hd <= 128): the
//     two share every K and V fragment, which halves the shared-memory
//     reads of a product and the K/V tiles a query row streams (64 rows
//     a CTA: 0.436 ms at the training shape, 128: 0.34; PERF.md section 6).
//     The row max and sum take two quad shuffles and O is rescaled in
//     registers. Scores are prescaled by scale * log2 e so that exp2f
//     serves; lse is written in natural-log units as m ln 2 + log l.
//   - dK/dV: a CTA per (b, kv head, 64 key rows) keeps its K and V resident;
//     each warp owns 16 key rows of dK and dV. It walks the group's g heads
//     x the query tiles that see it. S^T = K Q^T and dP^T = V dO^T put P^T
//     and dS^T in C fragments on key rows, the A operands of dV += P^T dO
//     and dK += dS^T Q. At hd 256 two launches each accumulate 128 of the
//     columns (S^T and dP^T computed twice), so that dK and dV fit.
//   - dQ: a CTA per (b, head, 64 query rows); S, dP and dS stay in
//     registers and dS is the A operand of dQ += dS K.
// Tiles stream through a two-stage ring of cp.async.cg 16-byte copies (rows
// past the end zero-filled): the forward's and dQ's K/V tiles (64 keys, 32
// at hd 256), dK/dV's Q, dO, lse and delta tiles (64 query rows at hd <= 64,
// 32 above, so that dK, dV and the two score tiles fit the registers); tile
// j + 1 lands while tile j is multiplied, with two barriers a tile. Rows are
// padded by 16 bytes, which keeps every ldmatrix free of bank conflicts.
// visible() runs only on a diagonal or tail tile (per warp); a full tile
// below the diagonal takes no per-element test, and a warp whose rows see
// none of a tile skips it. Every block the block-sparse gate admits (a
// multiple of 64) is walked as whole tiles: its schedule keeps 64-row CTAs.
//
// ptxas (CUDA 12.9, sm_90a; bf16 and fp16 alike): registers, spilled bytes
// and shared memory, dense schedule / block lists where they differ:
//   hd   forward                  dK/dV                    dQ
//   32   177/127, 0, 30720/25600  128/138, 4/0, 31744      136/131, 0, 30720
//   64   250/134, 0, 55296/46080  174/171, 0, 56320      168/166, 0, 55296
//   128  255/170, 0, 104448/87040 241/245, 0, 70144      252/251, 0, 104448
//   256  241/246, 0, 101376       255/255, 56/136, 135680  246/250, 0, 135168
// so at hd 128 two forward or dQ CTAs, and two dK/dV CTAs (registers), fit
// on an SM. dK/dV at hd 256 spilled 1208 bytes (dense) and 6792 (block
// lists, at 32 registers) while one launch accumulated all 256 columns.
//
// fp32 inputs run the `Fma` kernels: tiles staged in shared memory and every
// product on FMAs, one output element per thread at a time (48-64
// registers, up to 12 spilled bytes). They exist for the 1e-5 checks, not
// for speed.
//
// The backward is two kernels, both deterministic: no atomics, and every sum
// in a fixed order, so a repeated call is bitwise equal. The TPU kernel's
// revisited dq block would be a race between CUDA CTAs; the split costs 7
// tile products against a fused kernel's 5.
//
// Left for later: wgmma with a TMA + mbarrier ring fed by a producer warp
// (warp specialisation), and a persistent schedule.
//
// A schedule is a struct passed by value to the kernels, with:
//   fwd_cta(s, BQ, b, h, q0)      the forward's and dQ's CTA: batch, head, first query row
//   key_tiles(s, h, q0, q_valid, BK)  how many key tiles that query tile visits
//                                  (with RowOffsets, key_tiles(..., BK, off), off the
//                                  batch row's causal offset; and off, rows members)
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
#include <stdint.h>

#include <type_traits>

#include "mma_ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Finite, as the TPU kernels' NEG_INF.
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Whether a schedule's forward reads per-row offsets and kv rows (the slot
// engine's); a schedule specialises it.
template <typename Sched>
struct RowOffsets {
  static constexpr bool value = false;
};

// Batch row b's causal offset and the batch row its keys and values lie in:
// 0 and b unless the schedule holds them.
template <typename Sched>
__device__ __forceinline__ void row_of(const Sched& sched, int b, int& off, int& kvb) {
  off = 0;
  kvb = b;
  if constexpr (RowOffsets<Sched>::value) {
    off = sched.off[b];
    if (sched.rows) kvb = sched.rows[b];
  }
}

// visible() with the row's causal offset (the forward's test).
template <typename Sched>
__device__ __forceinline__ bool fwd_visible(const Shape& s, int qpos, int kpos, int off) {
  if constexpr (RowOffsets<Sched>::value) {
    return qpos < s.Sq && kpos < s.Skv && (!s.causal || qpos + off >= kpos);
  } else {
    return visible(s, qpos, kpos);
  }
}

// The forward's key tiles for a query tile of batch row with offset ``off``.
template <typename Sched>
__device__ __forceinline__ int fwd_key_tiles(const Sched& sched, const Shape& s, int h, int q0,
                                             int q_valid, int BK, int off) {
  if constexpr (RowOffsets<Sched>::value) {
    return sched.key_tiles(s, h, q0, q_valid, BK, off);
  } else {
    return sched.key_tiles(s, h, q0, q_valid, BK);
  }
}

// ---------------------------------------------------------------------------
// fp32: tiles in shared memory, products on FMAs
// ---------------------------------------------------------------------------

// 32-row query and key tiles keep every kernel's shared memory under the
// 227 KB a block can have.
template <int HD>
struct Fma {
  using T = float;
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int PAD = 4;                    // 16 bytes per row against bank conflicts
  static constexpr int LDT = HD + PAD;             // (rows, HD) tiles: Q, K, V, dO
  static constexpr int LDA = HD + 4;               // (rows, HD) accumulators
  static constexpr int LDS = BK + 4;               // (BQ, BK) scores
  static constexpr int LDP = BK + PAD;             // (BQ, BK) probabilities or dS
  static constexpr size_t tile_t(int rows) { return align128(size_t(rows) * LDT * sizeof(T)); }
  static constexpr size_t acc(int rows) { return align128(size_t(rows) * LDA * sizeof(float)); }
  static constexpr size_t scores() { return align128(size_t(BQ) * LDS * sizeof(float)); }
  static constexpr size_t probs() { return align128(size_t(BQ) * LDP * sizeof(T)); }
  static constexpr size_t rowvec() { return align128(size_t(BQ) * sizeof(float)); }
};

// Shared-memory carve-ups (byte offsets), one per kernel, used by both the
// kernel and the launch so the two cannot disagree.
template <int HD>
struct FmaFwdLayout {
  using Tl = Fma<HD>;
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

template <int HD>
struct FmaDkdvLayout {
  using Tl = Fma<HD>;
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

template <int HD>
struct FmaDqLayout {
  using Tl = Fma<HD>;
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

// Rows [0, R) of a (rows, HD) fp32 tile into shared memory (leading dimension
// ld), row r read at src + r * row_stride in 16-byte vectors; rows >= valid
// are zeros.
template <int HD, int R>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long row_stride, int valid) {
  constexpr int CPR = HD / 4;
  for (int idx = threadIdx.x; idx < R * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 4;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// Block-wide tile product into an fp32 shared-memory tile, one output element
// per thread at a time:
//   C (M, N) = (acc ? C : 0) + op(A) op(B), with
//   NT: A (M, K) and B (N, K), both row-major: A B^T
//   NN: A (M, K), B (K, N):                    A B
//   TN: A (K, M), B (K, N):                    A^T B
enum Kind { NT, NN, TN };

template <Kind KIND, int M, int N, int K>
__device__ __forceinline__ void block_mm(float* C, int ldc, const float* A, int lda,
                                         const float* B, int ldb, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int m = idx / N;
    const int n = idx % N;
    float s = acc ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = KIND == TN ? A[k * lda + m] : A[m * lda + k];
      const float b = KIND == NT ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

template <int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, Shape s, Sched sched) {
  using Tl = Fma<HD>;
  using L = FmaFwdLayout<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(128) char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sP = reinterpret_cast<float*>(smem + L::p);
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
  int off, kvb;
  row_of(sched, b, off, kvb);

  load_tile<HD, BQ>(sQ, Tl::LDT, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss, q_valid);
  for (int i = threadIdx.x; i < BQ * Tl::LDA; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  const float* kb = k + kvb * s.k_sb + kh * s.k_sh;
  const float* vb = v + kvb * s.v_sb + kh * s.v_sh;
  const int nkt = fwd_key_tiles(sched, s, h, q0, q_valid, BK, off);
  for (int j = 0; j < nkt; ++j) {
    const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
    if (k0 < 0) continue;
    const int k_valid = min(BK, s.Skv - k0);
    __syncthreads();  // the previous tile's products are done with sK, sV, sP
    load_tile<HD, BK>(sK, Tl::LDT, kb + k0 * s.k_ss, s.k_ss, k_valid);
    load_tile<HD, BK>(sV, Tl::LDT, vb + k0 * s.v_ss, s.v_ss, k_valid);
    __syncthreads();
    block_mm<NT, BQ, BK, HD>(sS, Tl::LDS, sQ, Tl::LDT, sK, Tl::LDT, false);  // S = Q K^T
    __syncthreads();
    // online softmax: one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = q0 + r;
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) {
        const float x =
            fwd_visible<Sched>(s, qpos, k0 + c, off) ? sS[r * Tl::LDS + c] * s.scale : kNegInf;
        sS[r * Tl::LDS + c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float pr =
            fwd_visible<Sched>(s, qpos, k0 + c, off) ? expf(sS[r * Tl::LDS + c] - m_new) : 0.f;
        sum += pr;
        sP[r * Tl::LDP + c] = pr;
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
  float* ob = o + ((size_t(b) * s.Sq + q0) * s.nh + h) * HD;
  for (int i = threadIdx.x; i < q_valid * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    const float l = sL[r];
    ob[size_t(r) * s.nh * HD + c] = sO[r * Tl::LDA + c] / (l == 0.f ? 1.f : l);
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

template <int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, Shape s, Sched sched) {
  using Tl = Fma<HD>;
  using L = FmaDkdvLayout<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(128) char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sDO = reinterpret_cast<float*>(smem + L::dout);
  float* sDK = reinterpret_cast<float*>(smem + L::dk);
  float* sDV = reinterpret_cast<float*>(smem + L::dv);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  float* sP = reinterpret_cast<float*>(smem + L::p);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  int b, kh, k0;
  sched.kv_cta(s, BK, b, kh, k0);
  const int k_valid = min(BK, s.Skv - k0);
  load_tile<HD, BK>(sK, Tl::LDT, k + b * s.k_sb + k0 * s.k_ss + kh * s.k_sh, s.k_ss, k_valid);
  load_tile<HD, BK>(sV, Tl::LDT, v + b * s.v_sb + k0 * s.v_ss + kh * s.v_sh, s.v_ss, k_valid);
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
      load_tile<HD, BQ>(sQ, Tl::LDT, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss,
                        q_valid);
      load_tile<HD, BQ>(sDO, Tl::LDT, dout + b * s.d_sb + q0 * s.d_ss + h * s.d_sh, s.d_ss,
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
        sP[r * Tl::LDP + c] = pr;
      }
      __syncthreads();
      block_mm<TN, BK, HD, BQ>(sDV, Tl::LDA, sP, Tl::LDP, sDO, Tl::LDT, true);  // dV += P^T dO
      __syncthreads();
      for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
        const int r = idx / BK;
        const int c = idx % BK;
        sP[r * Tl::LDP + c] = sS[r * Tl::LDS + c] * (sDP[r * Tl::LDS + c] - sDelta[r]) * s.scale;
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
    dk[off] = sDK[r * Tl::LDA + c];
    dv[off] = sDV[r * Tl::LDA + c];
  }
}

template <int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, Shape s, Sched sched) {
  using Tl = Fma<HD>;
  using L = FmaDqLayout<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK;
  extern __shared__ __align__(128) char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sDO = reinterpret_cast<float*>(smem + L::dout);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sDQ = reinterpret_cast<float*>(smem + L::dq);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  float* sP = reinterpret_cast<float*>(smem + L::p);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  int b, h, q0;
  sched.fwd_cta(s, BQ, b, h, q0);
  const int kh = h / s.g;
  const int q_valid = min(BQ, s.Sq - q0);
  load_tile<HD, BQ>(sQ, Tl::LDT, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss, q_valid);
  load_tile<HD, BQ>(sDO, Tl::LDT, dout + b * s.d_sb + q0 * s.d_ss + h * s.d_sh, s.d_ss,
                    q_valid);
  const size_t row0 = (size_t(b) * s.nh + h) * s.Sq + q0;
  load_rows(sLse, lse + row0, q_valid, BQ);
  load_rows(sDelta, delta + row0, q_valid, BQ);
  for (int i = threadIdx.x; i < BQ * Tl::LDA; i += kThreads) sDQ[i] = 0.f;
  const float* kb = k + b * s.k_sb + kh * s.k_sh;
  const float* vb = v + b * s.v_sb + kh * s.v_sh;
  const int nkt = sched.key_tiles(s, h, q0, q_valid, BK);
  for (int j = 0; j < nkt; ++j) {
    const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
    if (k0 < 0) continue;
    const int k_valid = min(BK, s.Skv - k0);
    __syncthreads();  // the previous tile's products are done with sK, sV, sP
    load_tile<HD, BK>(sK, Tl::LDT, kb + k0 * s.k_ss, s.k_ss, k_valid);
    load_tile<HD, BK>(sV, Tl::LDT, vb + k0 * s.v_ss, s.v_ss, k_valid);
    __syncthreads();
    block_mm<NT, BQ, BK, HD>(sS, Tl::LDS, sQ, Tl::LDT, sK, Tl::LDT, false);   // S = Q K^T
    block_mm<NT, BQ, BK, HD>(sDP, Tl::LDS, sDO, Tl::LDT, sV, Tl::LDT, false);  // dP = dO V^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += kThreads) {
      const int r = idx / BK;
      const int c = idx % BK;
      const float pr = visible(s, q0 + r, k0 + c)
                           ? expf(sS[r * Tl::LDS + c] * s.scale - sLse[r]) : 0.f;
      sP[r * Tl::LDP + c] = pr * (sDP[r * Tl::LDS + c] - sDelta[r]) * s.scale;
    }
    __syncthreads();
    block_mm<NN, BQ, HD, BK>(sDQ, Tl::LDA, sP, Tl::LDP, sK, Tl::LDT, true);  // dQ += dS K
  }
  __syncthreads();
  float* qb = dq + ((size_t(b) * s.Sq + q0) * s.nh + h) * HD;
  for (int i = threadIdx.x; i < q_valid * HD; i += kThreads) {
    const int r = i / HD;
    const int c = i % HD;
    qb[size_t(r) * s.nh * HD + c] = sDQ[r * Tl::LDA + c];
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: mma.sync tiles in registers, cp.async rings
// ---------------------------------------------------------------------------

// C (16 MT x 8N) += A (16 MT x 16K, rows r0.. of sA) . B^T, B (8N x 16K)
// stored [n][k]: MT m-tiles share each B fragment.
template <typename T, int LD, int K16, int N8, int MT>
__device__ __forceinline__ void mma_abt(float (&c)[MT][N8][4], const T* sA, int r0, const T* sB,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], a_at<LD>(sA, r0 + 16 * mt, kk * 16, lane));
#pragma unroll
    for (int n2 = 0; n2 < N8 / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, bn_at<LD>(sB, n2 * 16, kk * 16, lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816<T>(c[mt][2 * n2], a[mt], b[0], b[1]);
        mma16816<T>(c[mt][2 * n2 + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// C (16 MT x 8N) += P (16 MT x 8M, C fragments, rounded to T here) . B,
// B (8M x 8N) stored [k][n]. The operand P never leaves the registers.
template <typename T, int LD, int M8, int N8, int MT>
__device__ __forceinline__ void mma_pb(float (&c)[MT][N8][4], const float (&p)[MT][M8][4],
                                       const T* sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < M8 / 2; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) c_to_a<T>(a[mt], p[mt][2 * kk], p[mt][2 * kk + 1]);
#pragma unroll
    for (int n2 = 0; n2 < N8 / 2; ++n2) {
      uint32_t b[4];
      ldsm_x4_t(b, bk_at<LD>(sB, kk * 16, n2 * 16, lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816<T>(c[mt][2 * n2], a[mt], b[0], b[1]);
        mma16816<T>(c[mt][2 * n2 + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The one-m-tile forms the backward kernels use.
template <typename T, int LD, int K16, int N8>
__device__ __forceinline__ void mma_abt(float (&c)[N8][4], const T* sA, int r0, const T* sB,
                                        int lane) {
  mma_abt<T, LD, K16, N8, 1>(reinterpret_cast<float(&)[1][N8][4]>(c), sA, r0, sB, lane);
}
template <typename T, int LD, int M8, int N8>
__device__ __forceinline__ void mma_pb(float (&c)[N8][4], const float (&p)[M8][4], const T* sB,
                                       int lane) {
  mma_pb<T, LD, M8, N8, 1>(reinterpret_cast<float(&)[1][N8][4]>(c),
                           reinterpret_cast<const float(&)[1][M8][4]>(p), sB, lane);
}

template <int N8>
__device__ __forceinline__ void zero(float (&c)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Tiles of the 16-bit kernels for one head_dim. A warp owns 16 rows (the
// forward 16 x FwdWarpTiles); a CTA of 4 warps owns 64 query rows (dQ, the
// forward under the block lists) or 64 key rows (dK/dV), which divides
// every block the block-sparse gate admits. BK is the key tile that
// the forward and dQ stream, BQ2 the query tile that dK/dV streams; both are
// sized so that the fp32 fragments of a warp stay in registers.
template <typename T, int HD>
struct Mma {
  static constexpr int BQ = 16 * kWarps;
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int BQ2 = HD <= 64 ? 64 : 32;
  // dK/dV columns one dK/dV launch accumulates: at hd 256 two launches of
  // 128 each (S^T and dP^T computed twice), so that dK and dV fit the
  // registers
  static constexpr int DW = HD <= 128 ? HD : 128;
  static constexpr int LD = HD + 8;  // 16 bytes of pad a row
  static constexpr size_t tile(int rows) { return align128(size_t(rows) * LD * sizeof(T)); }
  static constexpr size_t rowvec(int rows) { return align128(size_t(rows) * sizeof(float)); }
};

// The forward's m-tiles of 16 rows a warp (a schedule may specialise it):
// 2 share each K and V fragment between two m-tiles, halving the shared-
// memory reads a product needs, but make a CTA own 128 query rows.
template <typename Sched>
struct FwdWarpTiles {
  static constexpr int value = 1;
};

template <typename T, int HD, int MT>
struct FwdLayout {
  using M = Mma<T, HD>;
  static constexpr int BQ = M::BQ * MT;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + M::tile(BQ);   // 2 stages
  static constexpr size_t v = k + 2 * M::tile(M::BK);  // 2 stages
  static constexpr size_t bytes = v + 2 * M::tile(M::BK);
};

template <typename T, int HD>
struct DkdvLayout {
  using M = Mma<T, HD>;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + M::tile(M::BQ);
  static constexpr size_t q = v + M::tile(M::BQ);        // 2 stages each from here
  static constexpr size_t dout = q + 2 * M::tile(M::BQ2);
  static constexpr size_t lse = dout + 2 * M::tile(M::BQ2);
  static constexpr size_t delta = lse + 2 * M::rowvec(M::BQ2);
  static constexpr size_t bytes = delta + 2 * M::rowvec(M::BQ2);
};

template <typename T, int HD>
struct DqLayout {
  using M = Mma<T, HD>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + M::tile(M::BQ);
  static constexpr size_t k = dout + M::tile(M::BQ);  // 2 stages
  static constexpr size_t v = k + 2 * M::tile(M::BK);  // 2 stages
  static constexpr size_t bytes = v + 2 * M::tile(M::BK);
};

// Rows [0, R) of a (rows, HD) tile into shared memory (rows LD apart) by
// cp.async, row r read at src + r * row_stride; rows >= valid zero-filled.
template <typename T, int HD, int R, int NT>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, long long row_stride,
                                                int valid) {
  constexpr int CPR = HD * int(sizeof(T)) / 16;
  constexpr int LD = HD + 8;
  for (int idx = threadIdx.x; idx < R * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * (16 / int(sizeof(T)));
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r : 0) * row_stride + c, ok);
  }
}

template <int R, int NT>
__device__ __forceinline__ void load_f32_async(float* dst, const float* src, int valid) {
  for (int r = threadIdx.x; r < R; r += NT) cp_async4(dst + r, src + (r < valid ? r : 0), r < valid);
}

// A warp's 16 rows of an fp32 accumulator (C fragments) rounded to T,
// through its own rows of shared memory (rows LD apart) to rows
// dst + r * row_stride, r < valid, 16 bytes a lane.
template <typename T, int HD, int LD>
__device__ __forceinline__ void store_rows(const float (&c)[HD / 8][4], float inv0, float inv1,
                                           T* stage, T* dst, size_t row_stride, int valid,
                                           int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + gr * LD + n * 8 + 2 * tq) =
        pack2<T>(c[n][0] * inv0, c[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + (gr + 8) * LD + n * 8 + 2 * tq) =
        pack2<T>(c[n][2] * inv1, c[n][3] * inv1);
  }
  __syncwarp();
  constexpr int CPR = HD * int(sizeof(T)) / 16;
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR;
    const int col = (idx % CPR) * (16 / int(sizeof(T)));
    if (r < valid) {
      *reinterpret_cast<uint4*>(dst + r * row_stride + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
    }
  }
}

template <typename T, int HD, int MT, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, Shape s, Sched sched) {
  using M = Mma<T, HD>;
  using L = FwdLayout<T, HD, MT>;
  constexpr int BQ = L::BQ, BK = M::BK, LD = M::LD, NT = kThreads;
  constexpr int RW = 16 * MT;  // rows a warp owns
  constexpr int SN = BK / 8, ON = HD / 8;
  extern __shared__ __align__(128) char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);

  int b, h, q0;
  sched.fwd_cta(s, BQ, b, h, q0);
  const int kh = h / s.g;
  const int q_valid = min(BQ, s.Sq - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row (and + 8), column pair
  const int r0 = warp * RW;
  const int qw = q0 + r0;  // the warp's first query row
  const float c = s.scale * kLog2e;
  int off, kvb;
  row_of(sched, b, off, kvb);
  const T* kb = k + kvb * s.k_sb + kh * s.k_sh;
  const T* vb = v + kvb * s.v_sb + kh * s.v_sh;
  const int nkt = fwd_key_tiles(sched, s, h, q0, q_valid, BK, off);

  load_rows_async<T, HD, BQ, NT>(sQ, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss, q_valid);
  auto prefetch = [&](int j) {  // key tile j into stage j % 2, one commit group
    if (j < nkt) {
      const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
      if (k0 >= 0) {
        const int kv = min(BK, s.Skv - k0);
        load_rows_async<T, HD, BK, NT>(sK + (j & 1) * BK * LD, kb + k0 * s.k_ss, s.k_ss, kv);
        load_rows_async<T, HD, BK, NT>(sV + (j & 1) * BK * LD, vb + k0 * s.v_ss, s.v_ss, kv);
      }
    }
    cp_async_commit();
  };
  prefetch(0);

  float acc[MT][ON][4];
  float m[MT][2], l[MT][2];  // rows gr, gr + 8 of each m-tile: max (log2 units), lane's sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    zero(acc[mt]);
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  for (int j = 0; j < nkt; ++j) {
    prefetch(j + 1);
    cp_async_wait<1>();  // every group but the newest: tile j has landed
    __syncthreads();
    const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
    // a warp whose rows all end before the tile (the diagonal, shifted by
    // off) skips it; under RowOffsets so does one whose rows lie past Sq
    if (k0 >= 0 && (!RowOffsets<Sched>::value || qw < s.Sq)
        && !(s.causal && k0 > qw + off + RW - 1)) {
      const T* tK = sK + (j & 1) * BK * LD;
      const T* tV = sV + (j & 1) * BK * LD;
      float sc[MT][SN][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) zero(sc[mt]);
      mma_abt<T, LD, HD / 16, SN, MT>(sc, sQ, r0, tK, lane);  // S = Q K^T
      const bool full = k0 + BK <= s.Skv && (!s.causal || k0 + BK - 1 <= qw + off);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int n = 0; n < SN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[mt][n][e] * c;
            if (!full && !fwd_visible<Sched>(s, qw + 16 * mt + gr + (e >> 1) * 8,
                                             k0 + n * 8 + 2 * tq + (e & 1), off)) {
              x = __int_as_float(0xff800000);  // -inf: p = 0 exactly
            }
            sc[mt][n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float alpha = exp2f(m[mt][i] - mx[i]);
          m[mt][i] = mx[i];
          l[mt][i] *= alpha;
#pragma unroll
          for (int n = 0; n < ON; ++n) {
            acc[mt][n][2 * i] *= alpha;
            acc[mt][n][2 * i + 1] *= alpha;
          }
        }
#pragma unroll
        for (int n = 0; n < SN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[mt][n][e] = exp2f(sc[mt][n][e] - m[mt][e >> 1]);
          l[mt][0] += sc[mt][n][0] + sc[mt][n][1];
          l[mt][1] += sc[mt][n][2] + sc[mt][n][3];
        }
      }
      mma_pb<T, LD, SN, ON, MT>(acc, sc, tV, lane);  // O += P V, P rounded to v's dtype
    }
    __syncthreads();  // every warp is done with stage j % 2 before tile j + 2 lands there
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float* li = l[mt];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      li[i] += __shfl_xor_sync(0xffffffffu, li[i], 1);
      li[i] += __shfl_xor_sync(0xffffffffu, li[i], 2);
    }
    const int rm = r0 + 16 * mt;  // the m-tile's first row in the CTA
    // the warp's own rows of sQ stage its output rows
    store_rows<T, HD, LD>(acc[mt], 1.f / (li[0] == 0.f ? 1.f : li[0]),
                          1.f / (li[1] == 0.f ? 1.f : li[1]), sQ + rm * LD,
                          o + ((size_t(b) * s.Sq + q0 + rm) * s.nh + h) * HD, size_t(s.nh) * HD,
                          q_valid - rm, lane);
    if (tq == 0) {
      float* lb = lse + (size_t(b) * s.nh + h) * s.Sq + q0 + rm;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = gr + 8 * i;
        if (rm + r < q_valid) lb[r] = li[i] == 0.f ? kNegInf : m[mt][i] * kLn2 + logf(li[i]);
      }
    }
  }
}

template <typename T, int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Shape s, Sched sched, int d0) {
  using M = Mma<T, HD>;
  using L = DkdvLayout<T, HD>;
  constexpr int BKV = M::BQ, BQ = M::BQ2, LD = M::LD, NT = kThreads;
  constexpr int SN = BQ / 8, ON = M::DW / 8;  // dK / dV columns d0 .. d0 + DW
  extern __shared__ __align__(128) char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::dout);
  float* sLse = reinterpret_cast<float*>(smem + L::lse);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  int b, kh, k0;
  sched.kv_cta(s, BKV, b, kh, k0);
  const int k_valid = min(BKV, s.Skv - k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int kw = k0 + r0;  // the warp's first key row
  const float c = s.scale * kLog2e;
  load_rows_async<T, HD, BKV, NT>(sK, k + b * s.k_sb + k0 * s.k_ss + kh * s.k_sh, s.k_ss,
                                  k_valid);
  load_rows_async<T, HD, BKV, NT>(sV, v + b * s.v_sb + k0 * s.v_ss + kh * s.v_sh, s.v_ss,
                                  k_valid);

  // the items: the group's g query heads x the query tiles of each that see
  // this key tile, in that order
  int total = 0;
  for (int gi = 0; gi < s.g; ++gi) total += sched.query_tiles(s, kh * s.g + gi, k0, BQ);
  auto locate = [&](int t, int& h) {  // item t's head and first query row (-1: skip)
    int gi = 0;
    for (; gi < s.g - 1; ++gi) {
      const int n = sched.query_tiles(s, kh * s.g + gi, k0, BQ);
      if (t < n) break;
      t -= n;
    }
    h = kh * s.g + gi;
    return sched.query_tile(s, h, k0, t, BQ);
  };
  auto prefetch = [&](int t) {  // item t into stage t % 2, one commit group
    if (t < total) {
      int h;
      const int q0 = locate(t, h);
      if (q0 >= 0) {
        const int qv = min(BQ, s.Sq - q0);
        const int st = t & 1;
        load_rows_async<T, HD, BQ, NT>(sQ + st * BQ * LD, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh,
                                       s.q_ss, qv);
        load_rows_async<T, HD, BQ, NT>(sDO + st * BQ * LD,
                                       dout + b * s.d_sb + q0 * s.d_ss + h * s.d_sh, s.d_ss, qv);
        const size_t row0 = (size_t(b) * s.nh + h) * s.Sq + q0;
        load_f32_async<BQ, NT>(sLse + st * BQ, lse + row0, qv);
        load_f32_async<BQ, NT>(sDelta + st * BQ, delta + row0, qv);
      }
    }
    cp_async_commit();
  };
  prefetch(0);  // in one group with K and V

  float dK[ON][4], dV[ON][4];
  zero(dK);
  zero(dV);
  for (int t = 0; t < total; ++t) {
    prefetch(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    int h;
    const int q0 = locate(t, h);
    if (q0 >= 0 && kw < s.Skv && !(s.causal && q0 + BQ - 1 < kw)) {
      const int st = t & 1;
      const T* tQ = sQ + st * BQ * LD;
      const T* tDO = sDO + st * BQ * LD;
      const float* tL = sLse + st * BQ;
      const float* tD = sDelta + st * BQ;
      float sp[SN][4];  // S^T, then P^T, then dS^T: key rows x query columns
      zero(sp);
      mma_abt<T, LD, HD / 16, SN>(sp, sK, r0, tQ, lane);  // S^T = K Q^T
      const bool full = q0 + BQ <= s.Sq && kw + 16 <= s.Skv && (!s.causal || q0 >= kw + 15);
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * tq + (e & 1);
          float p = exp2f(sp[n][e] * c - tL[qc] * kLog2e);
          if (!full && !visible(s, q0 + qc, kw + gr + (e >> 1) * 8)) p = 0.f;
          sp[n][e] = p;
        }
      }
      mma_pb<T, LD, SN, ON>(dV, sp, tDO + d0, lane);  // dV += P^T dO, P rounded to do's dtype
      float dp[SN][4];
      zero(dp);
      mma_abt<T, LD, HD / 16, SN>(dp, sV, r0, tDO, lane);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sp[n][e] = sp[n][e] * (dp[n][e] - tD[n * 8 + 2 * tq + (e & 1)]) * s.scale;
        }
      }
      mma_pb<T, LD, SN, ON>(dK, sp, tQ + d0, lane);  // dK += dS^T Q, dS rounded to q's dtype
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warp's own rows of sK and sV stage its dk and dv rows
  const size_t out0 = ((size_t(b) * s.Skv + kw) * s.kvh + kh) * HD + d0;
  store_rows<T, M::DW, LD>(dK, 1.f, 1.f, sK + r0 * LD + d0, dk + out0, size_t(s.kvh) * HD,
                           k_valid - r0, lane);
  store_rows<T, M::DW, LD>(dV, 1.f, 1.f, sV + r0 * LD + d0, dv + out0, size_t(s.kvh) * HD,
                           k_valid - r0, lane);
}

template <typename T, int HD, typename Sched>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, Shape s, Sched sched) {
  using M = Mma<T, HD>;
  using L = DqLayout<T, HD>;
  constexpr int BQ = M::BQ, BK = M::BK, LD = M::LD, NT = kThreads;
  constexpr int SN = BK / 8, ON = HD / 8;
  extern __shared__ __align__(128) char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::dout);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);

  int b, h, q0;
  sched.fwd_cta(s, BQ, b, h, q0);
  const int kh = h / s.g;
  const int q_valid = min(BQ, s.Sq - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int qw = q0 + r0;
  const float c = s.scale * kLog2e;
  const T* kb = k + b * s.k_sb + kh * s.k_sh;
  const T* vb = v + b * s.v_sb + kh * s.v_sh;
  const int nkt = sched.key_tiles(s, h, q0, q_valid, BK);

  load_rows_async<T, HD, BQ, NT>(sQ, q + b * s.q_sb + q0 * s.q_ss + h * s.q_sh, s.q_ss, q_valid);
  load_rows_async<T, HD, BQ, NT>(sDO, dout + b * s.d_sb + q0 * s.d_ss + h * s.d_sh, s.d_ss,
                                 q_valid);
  auto prefetch = [&](int j) {
    if (j < nkt) {
      const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
      if (k0 >= 0) {
        const int kv = min(BK, s.Skv - k0);
        load_rows_async<T, HD, BK, NT>(sK + (j & 1) * BK * LD, kb + k0 * s.k_ss, s.k_ss, kv);
        load_rows_async<T, HD, BK, NT>(sV + (j & 1) * BK * LD, vb + k0 * s.v_ss, s.v_ss, kv);
      }
    }
    cp_async_commit();
  };
  prefetch(0);  // in one group with Q and dO
  // lse (log2 units) and delta of the lane's rows gr, gr + 8; rows past Sq see no key
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + gr + 8 * i;
    const size_t row = (size_t(b) * s.nh + h) * s.Sq + r;
    lse2[i] = r < s.Sq ? lse[row] * kLog2e : 0.f;
    dl[i] = r < s.Sq ? delta[row] : 0.f;
  }

  float dQ[ON][4];
  zero(dQ);
  for (int j = 0; j < nkt; ++j) {
    prefetch(j + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = sched.key_tile(s, h, q0, q_valid, j, BK);
    if (k0 >= 0 && qw < s.Sq && !(s.causal && k0 > qw + 15)) {
      const T* tK = sK + (j & 1) * BK * LD;
      const T* tV = sV + (j & 1) * BK * LD;
      float sc[SN][4], dp[SN][4];
      zero(sc);
      zero(dp);
      mma_abt<T, LD, HD / 16, SN>(sc, sQ, r0, tK, lane);   // S = Q K^T
      mma_abt<T, LD, HD / 16, SN>(dp, sDO, r0, tV, lane);  // dP = dO V^T
      const bool full =
          k0 + BK <= s.Skv && (!s.causal || k0 + BK - 1 <= qw) && qw + 16 <= s.Sq;
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = exp2f(sc[n][e] * c - lse2[i]);
          if (!full && !visible(s, qw + gr + 8 * i, k0 + n * 8 + 2 * tq + (e & 1))) p = 0.f;
          sc[n][e] = p * (dp[n][e] - dl[i]) * s.scale;
        }
      }
      mma_pb<T, LD, SN, ON>(dQ, sc, tK, lane);  // dQ += dS K, dS rounded to q's dtype
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warp's own rows of sQ stage its dq rows
  store_rows<T, HD, LD>(dQ, 1.f, 1.f, sQ + r0 * LD, dq + ((size_t(b) * s.Sq + qw) * s.nh + h) * HD,
                        size_t(s.nh) * HD, q_valid - r0, lane);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  float* lse = static_cast<float*>(a.lse_out);
  if constexpr (sizeof(T) == 2) {
    constexpr int MT = HD <= 128 ? FwdWarpTiles<Sched>::value : 1;  // hd 256: O fills the registers
    using L = FwdLayout<T, HD, MT>;
    static_assert(L::bytes <= kMaxSmem, "forward tiles exceed shared memory");
    cudaError_t e = allow_smem(attn_fwd_kernel<T, HD, MT, Sched>, L::bytes);
    if (e != cudaSuccess) return e;
    attn_fwd_kernel<T, HD, MT, Sched><<<sched.q_grid(a.s, L::BQ), kThreads, L::bytes,
                                        a.stream>>>(q, k, v, o, lse, a.s, sched);
  } else {
    using L = FmaFwdLayout<HD>;
    static_assert(L::bytes <= kMaxSmem, "forward tiles exceed shared memory");
    cudaError_t e = allow_smem(attn_fwd_fma_kernel<HD, Sched>, L::bytes);
    if (e != cudaSuccess) return e;
    attn_fwd_fma_kernel<HD, Sched><<<sched.q_grid(a.s, Fma<HD>::BQ), kThreads, L::bytes,
                                     a.stream>>>(q, k, v, o, lse, a.s, sched);
  }
  return cudaGetLastError();
}

template <typename T, int HD, typename Sched>
cudaError_t run_bwd(const Args& a, const Sched& sched) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  T* dq = static_cast<T*>(a.o);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    using M = Mma<T, HD>;
    using L1 = DkdvLayout<T, HD>;
    using L2 = DqLayout<T, HD>;
    static_assert(L1::bytes <= kMaxSmem && L2::bytes <= kMaxSmem,
                  "backward tiles exceed shared memory");
    e = allow_smem(attn_bwd_dkdv_kernel<T, HD, Sched>, L1::bytes);
    if (e != cudaSuccess) return e;
    e = allow_smem(attn_bwd_dq_kernel<T, HD, Sched>, L2::bytes);
    if (e != cudaSuccess) return e;
    for (int d0 = 0; d0 < HD; d0 += M::DW) {
      attn_bwd_dkdv_kernel<T, HD, Sched><<<sched.kv_grid(a.s, M::BQ), kThreads, L1::bytes,
                                           a.stream>>>(q, k, v, dout, lse, delta, dk, dv, a.s,
                                                       sched, d0);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    attn_bwd_dq_kernel<T, HD, Sched><<<sched.q_grid(a.s, M::BQ), kThreads, L2::bytes,
                                       a.stream>>>(q, k, v, dout, lse, delta, dq, a.s, sched);
  } else {
    using Tl = Fma<HD>;
    using L1 = FmaDkdvLayout<HD>;
    using L2 = FmaDqLayout<HD>;
    static_assert(L1::bytes <= kMaxSmem && L2::bytes <= kMaxSmem,
                  "backward tiles exceed shared memory");
    e = allow_smem(attn_bwd_dkdv_fma_kernel<HD, Sched>, L1::bytes);
    if (e != cudaSuccess) return e;
    e = allow_smem(attn_bwd_dq_fma_kernel<HD, Sched>, L2::bytes);
    if (e != cudaSuccess) return e;
    attn_bwd_dkdv_fma_kernel<HD, Sched><<<sched.kv_grid(a.s, Tl::BK), kThreads, L1::bytes,
                                          a.stream>>>(q, k, v, dout, lse, delta, dk, dv, a.s,
                                                      sched);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    attn_bwd_dq_fma_kernel<HD, Sched><<<sched.q_grid(a.s, Tl::BQ), kThreads, L2::bytes,
                                        a.stream>>>(q, k, v, dout, lse, delta, dq, a.s, sched);
  }
  return cudaGetLastError();
}

template <typename T, typename Sched>
cudaError_t dispatch_head_dim(int head_dim, bool backward, const Args& a, const Sched& sched) {
  // a RowOffsets schedule has a forward only
  auto run = [&](auto hd) -> cudaError_t {
    constexpr int HD = decltype(hd)::value;
    if constexpr (RowOffsets<Sched>::value) {
      return backward ? cudaErrorInvalidValue : run_fwd<T, HD>(a, sched);
    } else {
      return backward ? run_bwd<T, HD>(a, sched) : run_fwd<T, HD>(a, sched);
    }
  };
  switch (head_dim) {
    case 32: return run(std::integral_constant<int, 32>{});
    case 64: return run(std::integral_constant<int, 64>{});
    case 128: return run(std::integral_constant<int, 128>{});
    case 256: return run(std::integral_constant<int, 256>{});
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
